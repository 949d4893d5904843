"""Public ops around the kernels, with gradients, so the kernels are usable
inside training graphs (the counterpart of ``repro.kernels.ops``).

Each op is a ``torch.autograd.Function`` whose forward is the kernel
wrapper (the kernel on CUDA tensors, its plain version on CPU tensors) and
whose backward is the reference's custom-VJP formula in plain PyTorch: the
sparse-cost gathers and scatters of ``repro.core.functional``, so the
backward keeps the forward's N-fold savings.  Under ``torch.no_grad()`` a
Function runs its forward only and adds no device work.

* ``packed_matmul_op``       — ``x @ decompress(packed, route)``.
* ``grouped_cs_matmul_op``   — ``out[s] = xg[s] @ packed_s[s]``.
* ``topk_gather_support_op`` — sparse-sparse contraction of a given
  support (the serving path's down projection).
* ``topk_gather_op``         — the same with its Select included.
* ``kwta_hist_op``           — histogram k-WTA, straight-through gradient.
"""

from __future__ import annotations

import torch

from repro_torch.core.functional import route_to_gather_idx
from repro_torch.core.instrument import counted_top_k
from .grouped_cs_matmul import grouped_cs_matmul
from .kwta_hist import kwta_hist_cuda
from .packed_matmul import packed_matmul
from .topk_gather import topk_gather


def topk_support(x: torch.Tensor, k: int, n: int):
    """Select step (paper's k-WTA + index extraction): the K largest-|x|
    positions as (vals f32, p_idx int32, s_off int32).  Exact for any
    k-sparse x; ``vals`` carries the gradient back to x."""
    _, sel = counted_top_k(x.abs(), k)
    vals = torch.gather(x, -1, sel)
    return (vals.float(), (sel // n).to(torch.int32),
            (sel % n).to(torch.int32))


# ---------------------------------------------------------------------------
# packed matmul
# ---------------------------------------------------------------------------

class _PackedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, packed, route):
        ctx.save_for_backward(x, packed, route)
        return packed_matmul(x, packed, route).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        """Gradients only on the packed support, through the forward's own
        static gather and its scatter (reference ``ops.py:47-61``)."""
        x, packed, route = ctx.saved_tensors
        g, p, n = packed.shape
        r = g // route.shape[0]
        idx = route_to_gather_idx(route, n)                  # (Gr, P, N)
        dyr = dy.reshape(*dy.shape[:-1], g // r, r, n)
        xg = x[..., idx]                                     # (..., Gr, P, N)
        dpacked = torch.einsum("...ups,...urs->urps", xg, dyr)
        dpacked = dpacked.reshape(g, p, n).to(packed.dtype)
        contrib = torch.einsum(
            "urps,...urs->...ups", packed.reshape(g // r, r, p, n).to(dy.dtype),
            dyr)
        dx = torch.zeros_like(x).index_add_(
            -1, idx.reshape(-1),
            contrib.reshape(*contrib.shape[:-3], -1).to(x.dtype))
        return dx, dpacked, None


def packed_matmul_op(x, packed, route):
    """``y = x @ decompress(packed, route)`` in ``x.dtype``.  x (B, D_in);
    packed (G, P, N); route (G/R, P, N) int8.  Differentiable in x and
    packed."""
    return _PackedMatmul.apply(x, packed, route)


# ---------------------------------------------------------------------------
# grouped (shared-route) CS matmul
# ---------------------------------------------------------------------------

class _GroupedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xg, packed_s):
        ctx.save_for_backward(xg, packed_s)
        return grouped_cs_matmul(xg, packed_s).to(xg.dtype)

    @staticmethod
    def backward(ctx, dy):
        """Reference ``ops.py:82-86``."""
        xg, packed_s = ctx.saved_tensors
        dxg = torch.einsum("nbg,npg->nbp", dy, packed_s.to(dy.dtype))
        dw = torch.einsum("nbp,nbg->npg", xg.to(dy.dtype), dy)
        return dxg.to(xg.dtype), dw.to(packed_s.dtype)


def grouped_cs_matmul_op(xg, packed_s):
    """``out[s] = xg[s] @ packed_s[s]`` in ``xg.dtype``: (N, B, P) x
    (N, P, G) -> (N, B, G).  Differentiable in both operands."""
    return _GroupedMatmul.apply(xg, packed_s)


# ---------------------------------------------------------------------------
# sparse-sparse topk-gather (straight-through on the selected support)
# ---------------------------------------------------------------------------

class _TopkGatherSupport(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, p_idx, s_off, packed_p, route):
        ctx.save_for_backward(vals, p_idx, s_off, packed_p, route)
        g, n = packed_p.shape[1], packed_p.shape[2]
        lead, k = vals.shape[:-1], vals.shape[-1]
        # the kernel takes the support as the layer holds it (f32 or bf16
        # values, int32 or int64 indices) and writes vals' type itself
        y = topk_gather(vals.reshape(-1, k).contiguous(),
                        p_idx.reshape(-1, k).contiguous(),
                        s_off.reshape(-1, k).contiguous(), packed_p, route,
                        out_dtype=vals.dtype)
        return y.reshape(*lead, g * n)

    @staticmethod
    def backward(ctx, dy):
        """Sparse cost on the selected support only (reference
        ``ops.py:130-151``): d_vals re-reads the forward's K packed rows;
        d_packed_p scatter-adds each non-zero's contribution into its
        partition row, in the (P, G, N) layout the op takes."""
        vals, p_idx, s_off, packed_p, route = ctx.saved_tensors
        p, g, n = packed_p.shape
        r = g // route.shape[0]
        k = vals.shape[-1]
        p_idx = p_idx.long()
        wrow = packed_p[p_idx].float()                        # (..., K, G, N)
        rrow = route[:, p_idx].movedim(0, -2)                 # (..., K, Gr, N)
        hit = rrow == s_off[..., None, None].to(rrow.dtype)
        if r > 1:
            hit = hit.repeat_interleave(r, dim=-2)            # (..., K, G, N)
        hit = hit.float()
        dyr = dy.reshape(*dy.shape[:-1], g, n).float()
        dvals = torch.einsum("...gs,...kgs->...k", dyr, wrow * hit)
        contrib = (vals.float()[..., None, None] * dyr[..., None, :, :]
                   * hit)                                     # (..., K, G, N)
        dpacked = torch.zeros((p, g, n), dtype=torch.float32,
                              device=packed_p.device).index_add_(
            0, p_idx.reshape(-1), contrib.reshape(-1, g, n))
        return (dvals.to(vals.dtype), None, None, dpacked.to(packed_p.dtype),
                None)


def topk_gather_support_op(vals, p_idx, s_off, packed_p, route):
    """Batched sparse-sparse contraction consuming an explicit support.

    The executor target of the sparse-activation handoff: the upstream
    k-WTA already ran the layer's one Select, so this takes the support
    and makes a single kernel launch for the whole (flattened) decode
    batch.

    vals/p_idx/s_off: (..., K) support; packed_p: (P, G, N) partition-major;
    route: (G/R, P, N).  Returns (..., G*N) in ``vals.dtype``.
    Differentiable in vals and packed_p (the gradient in packed_p's
    layout).
    """
    return _TopkGatherSupport.apply(vals, p_idx, s_off, packed_p, route)


def topk_gather_op(x, packed_p, route, k: int):
    """Sparse-sparse contraction, Select included: x (..., D_in) k-sparse;
    packed_p (P, G, N); route (G/R, P, N).  Returns (..., G*N) in
    ``x.dtype``.  Differentiable: d_x flows straight through onto the
    selected support (the gather in :func:`topk_support`), d_packed_p
    through :func:`topk_gather_support_op`."""
    vals, p_idx, s_off = topk_support(x, k, packed_p.shape[2])
    return topk_gather_support_op(vals, p_idx, s_off, packed_p,
                                  route).to(x.dtype)


# ---------------------------------------------------------------------------
# histogram k-WTA (straight-through gradient on the kept support)
# ---------------------------------------------------------------------------

class _KwtaHist(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k):
        y = kwta_hist_cuda(x, k)
        # the mask y != 0 is taken in backward, so a no-grad call adds no work
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        """Reference ``ops.py:185-186``: dy on the kept support (y != 0)."""
        y, = ctx.saved_tensors
        return dy * (y != 0).to(dy.dtype), None


def kwta_hist_op(x, k: int):
    """Histogram k-WTA over the last axis of x (B, D), quantized in float32
    (:func:`~repro_torch.kernels.kwta_hist.kwta_hist_cuda`), with a
    straight-through gradient on the kept elements."""
    return _KwtaHist.apply(x, k)
