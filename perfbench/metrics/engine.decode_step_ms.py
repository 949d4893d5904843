"""Mean ``decode.step`` span of the window (the program's span: the step
from its launch to its logits on the host), outside the profiler slice."""


def read(record):
    steps = [s["dur_s"] for s in record.get("spans", ())
             if s["name"] == "decode.step" and not s["in_slice"]]
    return 1e3 * sum(steps) / len(steps) if steps else None
