"""Execution paths for complementary-sparse linear maps.

Three interchangeable paths compute ``y = x @ W`` where W is an
(unmaterialized) complementary-sparse weight held as ``(packed, route)``:

1. ``cs_matmul`` — the **faithful paper algorithm** (Multiply → Route → Sum,
   §3.1/3.2) with routing hoisted offline into the weight layout, so the
   runtime re-orders *activations* with a static gather and contracts.
   FLOPs = 2·B·D_in·D_out/N.

2. ``cs_matmul_dense`` — decompress-to-dense then matmul (dense FLOPs).

3. ``cs_topk_matmul`` — the **sparse-sparse** path (§3.2): only the K
   non-zero activations fetch weight rows.  FLOPs = 2·B·K·D_out.

Route sharing: ``route`` may be shared by chunks of R consecutive output
groups (shape (G/R, P, N)).  R=1 is the faithful layout; every path accepts
any R from 1 to G and the algebra is identical.

Index tensors are int64, PyTorch's index type; out-of-range indices raise
(the reference's gathers clamp or fill instead).
"""

from __future__ import annotations

import torch

from .instrument import counted_top_k


def _layout_from(packed: torch.Tensor, route: torch.Tensor):
    """Infer (G, P, N, R) from packed (G,P,N) and route (G/R,P,N)."""
    g, p, n = packed.shape
    gr = route.shape[0]
    if tuple(route.shape[1:]) != (p, n) or g % gr:
        raise ValueError(f"incompatible packed {tuple(packed.shape)} / "
                         f"route {tuple(route.shape)}")
    return g, p, n, g // gr


def route_to_gather_idx(route: torch.Tensor, n: int) -> torch.Tensor:
    """Flat input indices idx[gr,p,s] = p*N + route[gr,p,s] (int64)."""
    p = route.shape[1]
    return (torch.arange(p, device=route.device)[None, :, None] * n
            + route.long())


def cs_matmul(x: torch.Tensor, packed: torch.Tensor,
              route: torch.Tensor) -> torch.Tensor:
    """Faithful Multiply→Route→Sum path.

    Args:
      x: (..., D_in)
      packed: (G, P, N) pre-routed packed weights.
      route: (G/R, P, N) int permutations.

    Returns: (..., D_out = G*N)
    """
    g, p, n, r = _layout_from(packed, route)
    batch = x.shape[:-1]
    idx = route_to_gather_idx(route, n)           # (Gr, P, N)
    # Route the activations (static gather — the offline'd crossbar).
    xg = x[..., idx]                              # (..., Gr, P, N)
    pk = packed.reshape(g // r, r, p, n)          # (Gr, R, P, N)
    # Multiply + Sum: contract partitions. For R>1 this is a true matmul.
    y = torch.einsum("...ups,urps->...urs", xg, pk)  # (..., Gr, R, N)
    return y.reshape(*batch, g * n)


def decompress(packed: torch.Tensor, route: torch.Tensor) -> torch.Tensor:
    """Materialize the sparse dense-format W (D_in, D_out)."""
    g, p, n, r = _layout_from(packed, route)
    idx = route_to_gather_idx(route, n)           # (Gr, P, N)
    idx_full = idx[:, None].expand(g // r, r, p, n).reshape(g, p, n)
    w = torch.zeros((p * n, g, n), dtype=packed.dtype, device=packed.device)
    gg = torch.arange(g, device=packed.device)[:, None, None]
    ss = torch.arange(n, device=packed.device)[None, None, :]
    # w[idx_full[g,p,s], g, s] = packed[g,p,s]
    w[idx_full, gg, ss] = packed
    return w.reshape(p * n, g * n)


def cs_matmul_dense(x: torch.Tensor, packed: torch.Tensor,
                    route: torch.Tensor) -> torch.Tensor:
    """Decompress-then-matmul."""
    return x @ decompress(packed, route)


def topk_support_flat(x: torch.Tensor, k: int):
    """Select step: the K largest-|x| positions as ``(vals, idx)``.

    ``idx`` is (..., K) int64 flat positions along the last axis — the same
    support form :func:`repro_torch.core.kwta.kwta_support` hands off, so
    layers that already ran the Select skip this call.  Any superset of
    the true support is exact (extra entries multiply by x == 0).
    """
    _, sel = counted_top_k(x.abs(), k)            # (..., K) indices
    return torch.gather(x, -1, sel), sel


def cs_topk_from_support(vals: torch.Tensor, p_idx: torch.Tensor,
                         s_off: torch.Tensor, packed: torch.Tensor,
                         route: torch.Tensor) -> torch.Tensor:
    """Sparse-sparse Multiply-Route-Sum consuming an explicit support.

    Args:
      vals: (..., K) non-zero activation values.
      p_idx: (..., K) int partition index of each non-zero (flat_idx // N).
      s_off: (..., K) int offset-within-partition (flat_idx % N).
      packed: (G, P, N); route: (G/R, P, N).
    Returns: (..., D_out = G*N).
    """
    g, p, n, r = _layout_from(packed, route)
    batch = vals.shape[:-1]
    p_idx = p_idx.long()
    # Fetch the packed weight rows of the selected partitions:
    # packed (G, P, N) -> (G, ..., K, N); move G after K.
    wrow = packed[:, p_idx].movedim(0, -2)        # (..., K, G, N)
    rrow = route[:, p_idx].movedim(0, -2)         # (..., K, Gr, N)
    # An activation at offset s_off only owns slot s where route == s_off.
    hit = rrow == s_off[..., None, None].to(rrow.dtype)   # (..., K, Gr, N)
    if r > 1:
        hit = hit.repeat_interleave(r, dim=-2)    # (..., K, G, N)
    contrib = wrow * hit.to(wrow.dtype)           # (..., K, G, N)
    y = torch.einsum("...k,...kgs->...gs", vals.to(wrow.dtype), contrib)
    return y.reshape(*batch, g * n)


def cs_topk_matmul(x: torch.Tensor, packed: torch.Tensor,
                   route: torch.Tensor, k: int) -> torch.Tensor:
    """Sparse-sparse path: contract only the K largest-|x| positions.

    Exact whenever x has at most ``k`` non-zeros (the k-WTA contract).
    Runs its own Select — callers holding the k-WTA support use
    :func:`cs_topk_from_support` instead (one Select per layer).
    """
    n = packed.shape[2]
    vals, sel = topk_support_flat(x, k)
    return cs_topk_from_support(vals, sel // n, sel % n, packed, route)


def flops_cs_matmul(batch: int, d_in: int, d_out: int, n: int) -> int:
    """Theoretical MAC*2 count of the faithful path (the paper's claim)."""
    return 2 * batch * d_in * d_out // n


def flops_cs_topk(batch: int, k: int, d_out: int) -> int:
    return 2 * batch * k * d_out


def flops_dense(batch: int, d_in: int, d_out: int) -> int:
    return 2 * batch * d_in * d_out
