"""95th percentile of the gaps between consecutive decode-step ends within
one ``Engine.serve`` call, each gap counted once for every request that
decoded in both steps (what that request saw between two of its tokens),
outside the profiler slice.  The steps and who decoded in them come from
the program's spans (``record["steps"]``)."""

import numpy as np


def read(record):
    steps = record.get("steps") or []
    gaps = []
    for a, b in zip(steps, steps[1:]):
        if a["call"] != b["call"] or a["in_slice"] or b["in_slice"]:
            continue
        both = len(set(a["active"]) & set(b["active"]))
        gaps.extend([b["t_end"] - a["t_end"]] * both)
    return 1e3 * float(np.percentile(gaps, 95)) if gaps else None
