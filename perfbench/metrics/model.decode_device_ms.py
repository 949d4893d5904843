"""Device busy time per decode step in the profiler slice (decode steps of
a call after the window at full occupancy): the union of the device
intervals that start inside a ``decode.step`` span, summed over the
slice's steps, over their number."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from harness.trace import merge  # noqa: E402


def read(record):
    ev = record.get("slice_events")
    if not ev or not ev["device"] or ev["offset_us"] is None:
        return None
    steps = [s for s in record.get("slice_spans", ())
             if s["name"] == "decode.step" and s["in_slice"]]
    if not steps:
        return None
    off = ev["offset_us"]
    total = 0.0
    for s in steps:
        a = off + (s["t_end"] - s["dur_s"]) * 1e6
        b = off + s["t_end"] * 1e6
        inside = [(x, y) for _, x, y in ev["device"] if a <= x < b]
        total += sum(y - x for x, y in merge(inside))
    return total / 1e3 / len(steps)
