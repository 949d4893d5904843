"""The traced run's instruments: the program's host-clock spans, kept in
memory, and one ``torch.profiler`` slice of a steady stretch of the
window, reduced to busy time, kernel times and idle gaps.

The spans come from the program's own tracer (``repro_torch.obs``); the
sink below receives each span as it closes and also opens and closes the
profiler slice at decode-step boundaries, so the slice starts and ends
where the host has just synchronised with the device.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional


class SliceDone(Exception):
    """Raised by :class:`SpanSink` once its profiler slice has closed: it
    ends the call the slice was taken from."""


class SpanSink:
    """Duck-typed JSONL writer for ``repro_torch.obs.Tracer``: keeps every
    span with its host end time, tagged with the window's call index.

    :meth:`arm` makes it run a :class:`ProfileSlice` from the ``after``-th
    decode step it sees next for ``steps`` steps, and then raise
    :class:`SliceDone` at that step's end."""

    def __init__(self, cuda: bool = True, step_name: str = "decode.step"):
        self.cuda = cuda
        self.step_name = step_name
        self.spans: List[Dict] = []
        self.call = None
        self.recording = False
        self.after: Optional[int] = None
        self.steps = 0
        self.n_steps = 0
        self.slice: Optional[ProfileSlice] = None

    def arm(self, after: int, steps: int) -> None:
        self.after, self.steps, self.n_steps = after, steps, 0

    def write(self, ev: Dict) -> None:
        if not self.recording or ev.get("kind") != "span":
            return
        ev = dict(ev, t_end=time.perf_counter(), call=self.call)
        ev["in_slice"] = self.slice is not None and self.slice.running
        self.spans.append(ev)
        if ev["name"] != self.step_name or self.after is None:
            return
        self.n_steps += 1
        if self.n_steps == self.after and self.slice is None:
            self.slice = ProfileSlice(self.cuda)
            self.slice.start()
        elif (self.slice is not None and self.slice.running
              and self.n_steps == self.after + self.steps):
            self.slice.stop()
            raise SliceDone()

    def close(self) -> None:
        if self.slice is not None and self.slice.running:
            self.slice.stop()


def _activities(cuda: bool):
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])


def _sync(cuda: bool) -> None:
    if cuda:
        import torch
        torch.cuda.synchronize()


class ProfileSlice:
    """``torch.profiler`` (CPU and CUDA activities) between ``start`` and
    ``stop``, with the host-clock bounds of the slice."""

    def __init__(self, cuda: bool = True):
        self.cuda = cuda
        self.prof = None
        self.running = False
        self.t0 = self.t1 = 0.0
        self.mark_host = 0.0

    def start(self) -> None:
        from torch.profiler import profile, record_function
        _sync(self.cuda)
        self.prof = profile(activities=_activities(self.cuda))
        self.prof.__enter__()
        with record_function("perfbench.mark"):
            self.mark_host = time.perf_counter()
        self.t0 = time.perf_counter()
        self.running = True

    def stop(self) -> None:
        _sync(self.cuda)
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.running = False

    def events(self) -> Dict:
        """The slice as plain lists: device intervals (name, start_us,
        end_us) and host op intervals, on the profiler's clock, and the
        offset that puts a host perf_counter time on that clock.  Read
        from the profiler's raw records (no event tree is built)."""
        from torch.autograd import DeviceType
        dev, host, offset = [], [], None
        for e in self.prof.profiler.kineto_results.events():
            a = e.start_ns() / 1e3
            b = a + e.duration_ns() / 1e3
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                dev.append((name, a, b))
            else:
                host.append((name, a, b))
                if name == "perfbench.mark":
                    offset = a - self.mark_host * 1e6
        return {"device": dev, "host": host, "offset_us": offset,
                "window_s": self.t1 - self.t0, "t0": self.t0, "t1": self.t1}


def merge(intervals):
    """The union of (start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_slice(ev: Dict, spans: List[Dict], top: int = 10) -> Dict:
    """Busy time (the union of device intervals), the device operations
    that took most time, and the longest idle gaps, each named by the
    program's span and the deepest host op open at the gap's middle."""
    dev = ev["device"]
    if not dev:
        return {}
    busy = merge([(a, b) for _, a, b in dev])
    busy_us = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = {}
    for name, a, b in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    edges = [busy[0][0], busy[-1][1]]
    if ev["offset_us"] is not None:
        edges = [ev["offset_us"] + ev["t0"] * 1e6,
                 ev["offset_us"] + ev["t1"] * 1e6]
    cuts = [edges[0]] + [x for ab in busy for x in ab] + [edges[1]]
    gaps = [(cuts[i], cuts[i + 1]) for i in range(0, len(cuts) - 1, 2)
            if cuts[i + 1] > cuts[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [[_host_at(0.5 * (a + b), ev, spans), (b - a) / 1e6]
             for a, b in gaps[:top]]
    return {"busy_s": busy_us / 1e6, "window_s": ev["window_s"],
            "device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def _host_at(t_us: float, ev: Dict, spans: List[Dict]) -> str:
    """What the host was doing at profiler time ``t_us``: the innermost
    program span then open and the deepest host op covering it."""
    label = "outside spans"
    if ev["offset_us"] is not None:
        t_host = (t_us - ev["offset_us"]) / 1e6
        best = None
        for s in spans:
            if s["t_end"] - s["dur_s"] <= t_host <= s["t_end"]:
                if best is None or s["dur_s"] < best["dur_s"]:
                    best = s
        if best is not None:
            label = best["name"]
    ops = [(b - a, n) for n, a, b in ev["host"]
           if a <= t_us <= b and n != "perfbench.mark"]
    if ops:
        label += " / " + min(ops)[1]
    return label
