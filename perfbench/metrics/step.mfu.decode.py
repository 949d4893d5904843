"""The decode steps' share of the card's bf16 peak: the FLOPs the
sparse-sparse algorithm needs for each step's decoding requests at their
contexts (frozen ``counts.flops``), over the steps' host-clock time (the
``decode.step`` spans, logits on the host) times 989 TFLOP/s, outside the
profiler slice."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from counts import flops, peaks  # noqa: E402


def read(record):
    steps = [s for s in record.get("steps") or () if not s["in_slice"]]
    if not steps:
        return None
    cfg = record["port_cfg"]
    work = sum(flops.decode_step_flops(cfg, [p + 1 for p in s["active"]
                                             .values()]) for s in steps)
    time_s = sum(s["dur_s"] for s in steps)
    return 100.0 * work / (time_s * peaks.BF16_FLOPS)
