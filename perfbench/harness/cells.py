"""Run one cell: set-up, the timed window, the per-layer record of a traced
run, and the output check.  ``run_cell`` returns the result line's fields;
``perfbench/run.py`` prints them.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional

import torch

from . import serve as SV
from . import traffic as TR
from .model_cfg import port_config
from .spec import Cell, metric_reader, reference_module
from .trace import SliceDone, SpanSink, reduce_slice
from .weights import draw


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _checks(values: Dict, limits: Dict) -> Dict:
    """Each compared number beside its limit; a number passes at or under
    it."""
    return {name: {"value": values[name], "limit": limits[name]["limit"]}
            for name in limits}


def _passed(checks: Dict) -> bool:
    return all(c["limit"] is not None and c["value"] <= c["limit"]
               for c in checks.values())


def run_serve(cell: Cell, seed: int, seconds: float, trace: bool, device,
              t_start: float, cfg_hook: Optional[Callable] = None) -> Dict:
    conf, mix = cell.config, cell.traffic
    cfg = port_config(conf)
    if cfg_hook is not None:
        cfg, conf = cfg_hook(cfg, conf)
    ref = reference_module(conf["model_type"])
    cuda = torch.device(device).type == "cuda"
    weights = draw(cfg, seed, device)
    tel = sink = None
    if trace:
        from repro_torch.obs import NULL_REGISTRY, Telemetry, Tracer
        sink = SpanSink(cuda=cuda)
        tel = Telemetry(registry=NULL_REGISTRY,
                        tracer=Tracer(enabled=True, sink=sink,
                                      max_events=1_000_000),
                        enabled=False, sparsity_every=0)
    engine = SV.engine_for(cfg, weights, mix, device, tel)
    SV.warm_up(engine, mix, cfg.vocab_size)
    _sync(device)
    setup_s = time.perf_counter() - t_start

    stream = TR.ServeStream(mix, cfg.vocab_size, seed)

    def on_call(i):
        if sink is not None:
            sink.call = i

    if sink is not None:
        sink.recording = True
    calls = SV.run_window(engine, stream, seconds, on_call)
    nums = SV.window_numbers(calls)
    peak = _peak(device)
    record = None
    if trace:
        record = {"cell": cell.name, "traffic": mix, "config": conf,
                  "port_cfg": cfg, "calls": calls,
                  "spans": list(sink.spans)}
        record["steps"] = SV.active_schedule(calls, record["spans"])
        # the profiler slice: a stretch of decode steps of the next call
        # after the window, which ends with the slice
        sl = mix["trace_slice"]
        sink.spans, sink.call = [], "slice"
        sink.arm(sl["after_step"], sl["steps"])
        try:
            SV.serve_call(engine, stream.call(len(calls)))
        except SliceDone:
            pass
        sink.recording = False
        sink.close()
        record["slice_spans"] = sink.spans
        if sink.slice is not None:
            ev = sink.slice.events()
            record["slice_events"] = ev
            record["slice"] = reduce_slice(ev, sink.spans)
            record["slice_steps"] = sum(
                1 for s in sink.spans
                if s["name"] == "decode.step" and s["in_slice"])
    del engine
    _free(device)

    out = {"attempted": nums["attempted"], "failed": nums["failed"],
           "memory_peak_bytes": peak,
           "e2e": {"gen_tok_s": (nums["gen_tok_s"], "tokens/s"),
                   "setup_s": (setup_s, "s")},
           "window": nums}
    if record is not None:
        out["record"] = record

    done = SV.check_sample(SV.finished(calls), seed,
                           int(mix["check_requests"]))
    found = SV.check_served(conf, weights, done, int(mix["max_seq"]), ref,
                            device, with_pads=cfg.is_moe)
    checks = _checks(found, cell.limits)
    out["checks"] = checks
    out["check_detail"] = found
    out["correct"] = _passed(checks) and nums["failed"] == 0
    return out


def per_layer_values(cell: Cell, record: Dict) -> Dict:
    """The cell's per-layer metrics that found something to read."""
    vals = {}
    for m in cell.per_layer:
        v = metric_reader(m["name"])(record)
        if v is not None:
            vals[m["name"]] = (float(v), m["unit"])
    return vals


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, cfg_hook: Optional[Callable] = None) -> Dict:
    kind = cell.traffic["kind"]
    if kind == "serve":
        return run_serve(cell, seed, seconds, trace, device, t_start,
                         cfg_hook)
    raise ValueError(f"unknown traffic kind {kind!r}")


def result_line(cell: Cell, out: Dict, trace: bool, device_info: Dict
                ) -> Dict:
    """The JSON object of the last line of standard output."""
    if trace:
        rec = out.get("record", {})
        metrics = per_layer_values(cell, rec)
    else:
        wanted = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: v for k, v in out["e2e"].items() if k in wanted}
    dev = dict(device_info, memory_peak_bytes=out["memory_peak_bytes"])
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "failed": out["failed"],
            "metrics": {k: {"value": v, "unit": u}
                        for k, (v, u) in metrics.items()},
            "device": dev}
    if trace:
        sl = out.get("record", {}).get("slice")
        if sl:
            dev["busy_s"] = sl["busy_s"]
            dev["window_s"] = sl["window_s"]
            line["breakdown"] = {"device_ops": sl["device_ops"],
                                 "idle_gaps": sl["idle_gaps"]}
    line["checks"] = out["checks"]
    return line
