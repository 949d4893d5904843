"""Hand-written Hopper kernels for the complementary-sparsity hot spots.

Each kernel: ``csrc/<name>.cu`` (CUDA C++ for sm_90a, built by
:mod:`.build` at first use), ``<name>.py`` with its wrapper, its plain
PyTorch version and its launch count; ``ops.py`` for the public ops with
their gradients (``torch.autograd.Function``s), ``ref.py`` for the oracles
and ``registry.py`` for the reference's shape sweeps.

* ``packed_matmul``     — matmul with the CS weight decompressed on the fly.
* ``grouped_cs_matmul`` — shared-route grouped matmul (N-fold fewer flops).
* ``topk_gather``       — batched sparse-sparse contraction (K non-zeros
  only; one launch per layer per decode step).
* ``kwta_hist_cuda``    — histogram-threshold global k-WTA (paper Fig. 10),
  quantized in float32 (``repro_torch.core.kwta_hist`` quantizes in the
  input's type).

Layer code calls only ``topk_gather``, through ``packed_linear_apply``
and the executor flag ``SparsityConfig.use_pallas`` (see
:func:`repro_torch.core.api.choose_executor`); the other kernels are
reached through the ops, as in the reference.
"""

from .grouped_cs_matmul import (grouped_cs_matmul, grouped_cs_matmul_plain,
                                interleave_out, permute_activations,
                                slot_major_packed)
from .kwta_hist import kwta_hist_cuda, kwta_hist_cuda_plain
from .ops import (grouped_cs_matmul_op, kwta_hist_op, packed_matmul_op,
                  topk_gather_op, topk_gather_support_op, topk_support)
from .packed_matmul import (packed_matmul, packed_matmul_plain,
                            to_partition_major)
from .ref import ref_topk_gather
from .topk_gather import topk_gather, topk_gather_plain

__all__ = [
    "grouped_cs_matmul", "grouped_cs_matmul_plain", "interleave_out",
    "permute_activations", "slot_major_packed", "kwta_hist_cuda",
    "kwta_hist_cuda_plain", "grouped_cs_matmul_op", "kwta_hist_op",
    "packed_matmul_op", "topk_gather_op", "topk_gather_support_op",
    "topk_support", "packed_matmul", "packed_matmul_plain",
    "to_partition_major", "ref_topk_gather", "topk_gather",
    "topk_gather_plain",
]
