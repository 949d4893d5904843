"""k-Winner-Take-All activation functions (paper §2.2.2, §3.3.3).

k-WTA replaces ReLU: exactly the K largest pre-activations propagate, the
rest are zeroed (winners keep their values).

Implementations, as in ``repro.core.kwta``:

* :func:`kwta` — exact top-k via ``torch.topk`` + scatter.
* :func:`kwta_hist` — the paper's histogram-threshold global k-WTA
  (Fig. 10); keeps at least K values (threshold compare, not a sort).
* :func:`kwta_bisect` — threshold k-WTA by bisection on the value axis
  (compare + count rounds); keeps at least K values.
* :func:`kwta_local` — partitioned k-WTA (competition within partitions).
"""

from __future__ import annotations

import torch
import torch.nn.functional as tF

from .instrument import counted_top_k


def kwta(x: torch.Tensor, k: int, axis: int = -1) -> torch.Tensor:
    """Exact k-WTA: keep the K largest values along ``axis``, zero the rest."""
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    y, _ = kwta_support(x.movedim(axis, -1), k)
    return y.movedim(-1, axis)


def kwta_support(x: torch.Tensor, k: int):
    """Exact k-WTA over the last axis that ALSO returns the winner support.

    Returns ``(y, (vals, idx))`` where ``y`` is the k-sparse activation,
    ``vals`` is (..., K) winner values and ``idx`` is (..., K) int64 flat
    positions along the last axis — the handoff the next CS-packed
    projection's sparse-sparse path takes instead of re-running the Select.
    When ``k >= d`` the input is already dense and the support is ``None``.
    """
    d = x.shape[-1]
    if k >= d:
        return x, None
    vals, idx = counted_top_k(x, k)
    y = torch.zeros_like(x).scatter(-1, idx, vals)
    return y, (vals, idx)


def kwta_mask(x: torch.Tensor, k: int, axis: int = -1) -> torch.Tensor:
    """Boolean winner mask of exact k-WTA (ties broken by top-k order)."""
    x_m = x.movedim(axis, -1)
    _, idx = counted_top_k(x_m, min(k, x_m.shape[-1]))
    m = torch.zeros(x_m.shape, dtype=torch.bool, device=x.device)
    m = m.scatter(-1, idx, True)
    return m.movedim(-1, axis)


def kwta_hist(x: torch.Tensor, k: int, bins: int = 256) -> torch.Tensor:
    """Histogram-threshold global k-WTA over the last axis (paper Fig. 10).

    Quantize values to ``bins`` levels, histogram, cumulative-sum from the
    largest bin down until the running count reaches K, threshold-compare
    the inputs against the resulting cutoff.  Retains *at least* K values.
    """
    d = x.shape[-1]
    if k >= d:
        return x
    lo = x.amin(dim=-1, keepdim=True)
    hi = x.amax(dim=-1, keepdim=True)
    # a tensor numerator: `(bins - 1) / t` would be t.reciprocal() * (bins
    # - 1), one rounding more than the reference's division
    scale = torch.where(hi > lo, torch.full_like(hi, bins - 1) / (hi - lo),
                        torch.zeros_like(hi))
    # (x-lo)*scale in x's type, truncated to int, as the reference quantizes
    b = torch.clamp((x - lo) * scale, 0, bins - 1).to(torch.int64)
    hist = tF.one_hot(b, bins).sum(dim=-2)                  # (..., bins)
    # count of elements with bin >= t (reverse cumulative sum)
    ccount = hist.flip(-1).cumsum(-1).flip(-1)
    # threshold bin: the largest t whose tail-count is still >= k
    tbin = (ccount >= k).sum(dim=-1) - 1
    tbin = torch.clamp(tbin, 0, bins - 1)
    keep = b >= tbin[..., None]
    return x * keep.to(x.dtype)


def kwta_bisect(x: torch.Tensor, k: int, iters: int = 16) -> torch.Tensor:
    """Threshold k-WTA via bisection on the value axis.

    ``iters`` rounds of (compare + count) in float32; ``lo`` ends as the
    largest probed threshold with count >= k, and every value >= it is kept
    (at least K values, ties inclusive).  The f32 compare-and-count is the
    reference's exactly, so both keep the same set.
    """
    d = x.shape[-1]
    if k >= d:
        return x
    x32 = x.float()
    lo = x32.amin(dim=-1, keepdim=True)
    hi = x32.amax(dim=-1, keepdim=True)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cnt = (x32 >= mid).sum(dim=-1, keepdim=True)
        keep_going_down = cnt >= k      # threshold can move up
        lo = torch.where(keep_going_down, mid, lo)
        hi = torch.where(keep_going_down, hi, mid)
    return x * (x32 >= lo).to(x.dtype)


def kwta_local(x: torch.Tensor, k: int, partitions: int,
               axis: int = -1) -> torch.Tensor:
    """Partitioned k-WTA: split ``axis`` into ``partitions`` equal groups and
    select k/partitions winners within each."""
    x_m = x.movedim(axis, -1)
    d = x_m.shape[-1]
    if d % partitions:
        raise ValueError(f"dim {d} not divisible by partitions {partitions}")
    if k % partitions:
        raise ValueError(f"k {k} not divisible by partitions {partitions}")
    xp = x_m.reshape(*x_m.shape[:-1], partitions, d // partitions)
    yp = kwta(xp, k // partitions, axis=-1)
    return yp.reshape(x_m.shape).movedim(-1, axis)


def kwta_channel(x: torch.Tensor, k: int) -> torch.Tensor:
    """Convolutional k-WTA along the channel (last) dimension per spatial
    location."""
    return kwta(x, k, axis=-1)


def activation_sparsity(x: torch.Tensor) -> torch.Tensor:
    """Fraction of zero entries (diagnostic; paper reports 88-90%)."""
    return (x == 0).float().mean()
