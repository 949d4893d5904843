"""Mean ``prefill`` span of the window (one fused prefill of a prompt
padded to its bucket, with its slot insert), outside the profiler
slice."""


def read(record):
    spans = [s["dur_s"] for s in record.get("spans", ())
             if s["name"] == "prefill" and not s["in_slice"]]
    return 1e3 * sum(spans) / len(spans) if spans else None
