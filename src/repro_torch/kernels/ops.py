"""Public wrappers around the kernels, forward only: the Select that feeds
the sparse-sparse kernel and the op the layers call.  (The reference's
custom VJPs come with the training slice.)"""

from __future__ import annotations

import torch

from repro_torch.core.instrument import counted_top_k
from .topk_gather import topk_gather


def topk_support(x: torch.Tensor, k: int, n: int):
    """Select step (paper's k-WTA + index extraction): the K largest-|x|
    positions as (vals f32, p_idx int32, s_off int32).  Exact for any
    k-sparse x."""
    _, sel = counted_top_k(x.abs(), k)
    vals = torch.gather(x, -1, sel)
    return (vals.float(), (sel // n).to(torch.int32),
            (sel % n).to(torch.int32))


def topk_gather_support_op(vals, p_idx, s_off, packed_p, route):
    """Batched sparse-sparse contraction consuming an explicit support.

    The executor target of the sparse-activation handoff: the upstream
    k-WTA already ran the layer's one Select, so this takes the support
    and makes a single kernel launch for the whole (flattened) decode
    batch.

    vals/p_idx/s_off: (..., K) support; packed_p: (P, G, N) partition-major;
    route: (G/R, P, N).  Returns (..., G*N) in ``vals.dtype``.
    """
    g, n = packed_p.shape[1], packed_p.shape[2]
    lead, k = vals.shape[:-1], vals.shape[-1]
    y = topk_gather(vals.float().reshape(-1, k).contiguous(),
                    p_idx.to(torch.int32).reshape(-1, k).contiguous(),
                    s_off.to(torch.int32).reshape(-1, k).contiguous(),
                    packed_p, route)
    return y.reshape(*lead, g * n).to(vals.dtype)
