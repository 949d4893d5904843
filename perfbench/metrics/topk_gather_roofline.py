"""``topk_gather``'s share of its roofline in the profiler slice: the
least time its launches could take (the larger of flops over the CUDA
cores' peak and bytes over HBM, from the frozen ``cost`` at the decode
step's launch shape) over the time the profiler gave them.  Nothing where
the slice holds no launch (a batch too large for the sparse-sparse
path)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from counts import peaks, topk_gather  # noqa: E402


def read(record):
    ev = record.get("slice_events")
    if not ev:
        return None
    durs = [(b - a) / 1e6 for name, a, b in ev["device"]
            if "topk_gather" in name]
    if not durs:
        return None
    shape = topk_gather.launch_shape(record["port_cfg"],
                                     int(record["traffic"]["slots"]))
    flops, nbytes = topk_gather.cost(**shape)
    bound = peaks.kernel_bound_s(flops, nbytes, topk_gather.TENSOR_CORES)
    return 100.0 * bound * len(durs) / sum(durs)
