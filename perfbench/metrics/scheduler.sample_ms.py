"""Host sampling time per decode step: every ``sample`` span of the window
(greedy argmax over the vocabulary, one a request a step and one after
each prefill) over the decode steps, outside the profiler slice."""


def read(record):
    spans = [s for s in record.get("spans", ()) if not s["in_slice"]]
    n = sum(1 for s in spans if s["name"] == "decode.step")
    total = sum(s["dur_s"] for s in spans if s["name"] == "sample")
    return 1e3 * total / n if n else None
