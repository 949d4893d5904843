"""Share of the profiler slice of the serving window in which no device
operation ran: 1 - (union of device intervals) / (slice length)."""


def read(record):
    red = record.get("slice")
    if not red or record["traffic"]["kind"] != "serve":
        return None
    return 100.0 * (1.0 - red["busy_s"] / red["window_s"])
