"""Hand-written Hopper kernels for the complementary-sparsity hot spots.

Each kernel: ``csrc/<name>.cu`` (CUDA C++ for sm_90a, built by
:mod:`.build` at first use), ``<name>.py`` with its wrapper, its plain
PyTorch version and its launch count, and ``ops.py`` for the public ops.

* ``topk_gather`` — batched sparse-sparse contraction (K non-zeros only;
  one launch per layer per decode step).

Layer code does not call these directly: ``packed_linear_apply`` routes
through the executor flag ``SparsityConfig.use_pallas`` (see
:func:`repro_torch.core.api.choose_executor`).
"""

from .ops import topk_gather_support_op, topk_support
from .ref import ref_topk_gather
from .topk_gather import topk_gather, topk_gather_plain

__all__ = ["ref_topk_gather", "topk_gather", "topk_gather_plain",
           "topk_gather_support_op", "topk_support"]
