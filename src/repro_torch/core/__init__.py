"""Complementary Sparsity — the paper's primary contribution, in PyTorch.

Public surface (the reference's, ``repro.core``):

* :class:`~repro_torch.core.masks.CSLayout`, mask/route generation,
  packing — pure numpy, kept as the port's own copy because importing the
  reference package would load JAX.
* :class:`~repro_torch.core.api.SparsityConfig` — per-layer sparsity
  settings.
* Execution paths (``cs_matmul`` faithful / ``cs_matmul_dense`` /
  ``cs_topk_matmul`` sparse-sparse) in :mod:`repro_torch.core.functional`.
* k-WTA activations in :mod:`repro_torch.core.kwta`.
* Layers (``packed_linear_*``) in :mod:`repro_torch.core.layers`.
"""

from .api import (DENSE, Executor, SparsityConfig, choose_executor,
                  choose_path)
from .functional import (cs_matmul, cs_matmul_dense, cs_topk_from_support,
                         cs_topk_matmul, decompress, flops_cs_matmul,
                         flops_cs_topk, flops_dense, topk_support_flat)
from .instrument import SelectCounter, count_selects, counted_top_k
from .kwta import (activation_sparsity, kwta, kwta_bisect, kwta_channel,
                   kwta_hist, kwta_local, kwta_mask, kwta_support)
from .masks import (CSLayout, conv_layout, make_mask, make_routes,
                    pad_to_multiple, routes_to_mask, validate_complementary)
from .packing import pack_conv, pack_dense, packed_bytes, unpack, unpack_conv

__all__ = [
    "DENSE", "Executor", "SparsityConfig", "choose_executor", "choose_path",
    "cs_matmul", "cs_matmul_dense", "cs_topk_from_support", "cs_topk_matmul",
    "decompress", "flops_cs_matmul", "flops_cs_topk", "flops_dense",
    "topk_support_flat", "SelectCounter", "count_selects", "counted_top_k",
    "activation_sparsity", "kwta", "kwta_bisect", "kwta_channel", "kwta_hist",
    "kwta_local", "kwta_mask", "kwta_support",
    "CSLayout", "conv_layout", "make_mask", "make_routes", "pad_to_multiple",
    "routes_to_mask", "validate_complementary",
    "pack_conv", "pack_dense", "packed_bytes", "unpack", "unpack_conv",
]
