"""Parameterized layers: dense and complementary-sparse linear.

Functional style, as in the reference: each layer is an
``init(gen, ...) -> params`` + ``apply(params, x, ...)`` pair, with params a
dict of tensors.  Init draws from ``gen``, a ``torch.Generator`` whose
device is the device of the new tensors.

Packed layers hold:
  packed    (G, P, N)   float  — pre-routed packed weights
  packed_p  (P, G, N)   float  — the same weights partition-major, the
                                 layout of the topk_gather kernel
  route     (G/R, P, N) int8   — static complementary routing
  b         (D_out,)    float  — optional

``packed_p`` is made once, at init or load (:func:`partition_major`):
eager PyTorch would otherwise copy the transpose of ``packed`` at every
call of the sparse-sparse path, where the reference leaves it to XLA to
fuse.  Conv/im2col layers belong to the GSC slice and are not here yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as tF

from . import functional as F
from .api import SparsityConfig, choose_executor, choose_path
from .instrument import named_scope
from .kwta import kwta_bisect, kwta_hist, kwta_local, kwta_support
from .masks import CSLayout, make_routes, pad_to_multiple
from .packing import pack_dense


def _uniform(gen: torch.Generator, shape, scale: float, dtype):
    return torch.empty(shape, dtype=dtype, device=gen.device).uniform_(
        -scale, scale, generator=gen)


def _route_share(cfg: SparsityConfig, g: int) -> int:
    """Groups per route table: ``route_share`` (0 = all groups), falling
    back to the nearest divisor of G."""
    r = g if cfg.route_share == 0 else min(cfg.route_share, g)
    while g % r:
        r -= 1
    return r


# ---------------------------------------------------------------------------
# Dense linear (baseline)
# ---------------------------------------------------------------------------

def linear_init(gen: torch.Generator, d_in: int, d_out: int,
                bias: bool = True, dtype=torch.float32):
    params = {"w": _uniform(gen, (d_in, d_out), 1.0 / np.sqrt(d_in), dtype)}
    if bias:
        params["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return params


def linear_apply(params, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# Complementary-sparse packed linear
# ---------------------------------------------------------------------------

def partition_major(packed: torch.Tensor) -> torch.Tensor:
    """(G, P, N) -> the kernel's (P, G, N), copied once."""
    return packed.transpose(0, 1).contiguous()


def packed_linear_init(gen: torch.Generator, d_in: int, d_out: int,
                       cfg: SparsityConfig, bias: bool = True, seed: int = 0,
                       dtype=torch.float32):
    """Initialize a packed CS linear layer.

    Each output has fan-in D_in/N, so weights are uniform in
    ±sqrt(N/D_in) (sparse-aware init).  Dims that don't divide the pack
    factor are padded; ``packed_linear_apply`` pads inputs / slices
    outputs back.  The bias (when present) carries the logical d_out.
    The routes come from numpy with ``seed``, bit-identical to the
    reference's.
    """
    d_in_p = pad_to_multiple(d_in, cfg.n)
    d_out_p = pad_to_multiple(d_out, cfg.n)
    layout = CSLayout(d_in_p, d_out_p, cfg.n, cfg.perm_kind)
    g, p, n = layout.groups, layout.partitions, layout.n
    r = _route_share(cfg, g)
    route_np = make_routes(CSLayout(d_in_p, n * (g // r), n, cfg.perm_kind),
                           seed)
    packed = _uniform(gen, (g, p, n), float(np.sqrt(cfg.n / d_in_p)), dtype)
    params = {"packed": packed, "packed_p": partition_major(packed),
              "route": torch.from_numpy(route_np).to(gen.device)}
    if bias:
        params["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return params


def packed_linear_from_dense(w: np.ndarray, cfg: SparsityConfig,
                             seed: int = 0, bias: Optional[np.ndarray] = None,
                             device=None):
    """Pack an existing (masked) dense weight (the paper's offline Combine)."""
    d_in, d_out = w.shape
    layout = CSLayout(d_in, d_out, cfg.n, cfg.perm_kind)
    g = layout.groups
    r = _route_share(cfg, g)
    route = make_routes(CSLayout(d_in, layout.n * (g // r), layout.n,
                                 cfg.perm_kind), seed)
    route_full = np.broadcast_to(route[:, None], (g // r, r, *route.shape[1:]))
    route_full = route_full.reshape(g, *route.shape[1:])
    packed = torch.from_numpy(
        np.ascontiguousarray(pack_dense(layout, w, route_full))).to(device)
    params = {"packed": packed, "packed_p": partition_major(packed),
              "route": torch.from_numpy(route).to(device)}
    if bias is not None:
        params["b"] = torch.from_numpy(np.asarray(bias)).to(device)
    return params


def _topk_execute(vals, idx, packed, packed_p, route, cfg: SparsityConfig):
    """Sparse-sparse Multiply-Route-Sum on an explicit support, dispatched
    to the topk_gather kernel wrapper or the PyTorch formula per the
    executor."""
    n = packed.shape[2]
    p_idx, s_off = idx // n, idx % n
    if choose_executor(cfg).use_kernel:
        # deferred import: kernels.ops imports repro_torch.core
        from repro_torch.kernels.ops import topk_gather_support_op
        return topk_gather_support_op(vals, p_idx, s_off, packed_p, route)
    return F.cs_topk_from_support(vals, p_idx, s_off, packed, route)


def packed_linear_apply(params, x: torch.Tensor, cfg: SparsityConfig,
                        x_is_sparse: bool = False, support=None):
    """Apply packed CS linear with regime dispatch.

    Inputs are zero-padded up to P*N, outputs are sliced back to the bias
    length (when a bias is present).

    ``support`` is the optional sparse-activation handoff from the
    upstream k-WTA (``apply_kwta(..., return_support=True)``): a
    ``(vals, idx)`` pair over the *unpadded* last axis.  On the topk path
    it replaces the re-derivation of the support (one Select per layer,
    paper Fig. 8a); other paths ignore it."""
    packed = params["packed"].to(x.dtype)
    route = params["route"]
    d_in = packed.shape[1] * packed.shape[2]
    if x.shape[-1] < d_in:
        x = tF.pad(x, (0, d_in - x.shape[-1]))
    batch = int(np.prod(x.shape[:-1])) if x.ndim > 1 else 1
    path = choose_path(cfg, batch, d_in, x_is_sparse)
    # The cs_<path> scope lets the linter attribute every traced op to the
    # execution path that produced it (repro_torch.analysis).
    with named_scope(f"cs_{path}"):
        if path == "topk":
            if support is None:
                # No handoff: run this layer's own Select on the k-sparse x.
                vals, idx = F.topk_support_flat(x, cfg.k_for(d_in))
            else:
                # Handoff indices address the unpadded axis; zero-padding
                # only appends positions, so they stay valid in the padded
                # layout.
                vals, idx = support
            y = _topk_execute(vals, idx, packed,
                              params["packed_p"].to(x.dtype), route, cfg)
        elif path == "dense":
            y = F.cs_matmul_dense(x, packed, route)
        else:
            y = F.cs_matmul(x, packed, route)
    if "b" in params:
        b = params["b"]
        y = y[..., :b.shape[0]] + b.to(x.dtype)
    return y


def apply_kwta(x: torch.Tensor, cfg: SparsityConfig,
               return_support: bool = False):
    """Apply the configured k-WTA activation along the last axis.

    With ``return_support=True`` returns ``(y, support)`` where ``support``
    is the ``(vals, idx)`` winner set when the exact global top-k impl ran,
    else ``None`` (hist/bisect keep >= K values with no index form; local
    k-WTA selects per-partition)."""
    if not cfg.activation_sparse:
        return (x, None) if return_support else x
    k = cfg.k_for(x.shape[-1])
    support = None
    if cfg.kwta_impl == "hist":
        y = kwta_hist(x, k)
    elif cfg.kwta_impl == "bisect":
        y = kwta_bisect(x, k)
    elif cfg.kwta_partitions > 1:
        y = kwta_local(x, k, cfg.kwta_partitions)
    else:
        y, support = kwta_support(x, k)
    return (y, support) if return_support else y
