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

A mesh rank's block of groups [g0, g1) of a layer whose route of several
tables stays whole also holds ``block_route`` (:func:`block_route`, made
once when the block is cut): the table of each of its groups, which
every path reads in place of ``route``.

``packed_p`` is made once, at init or load (:func:`partition_major`):
eager PyTorch would otherwise copy the transpose of ``packed`` at every
call of the sparse-sparse path, where the reference leaves it to XLA to
fuse.  It is a derived copy, so the training layout of the params has
none (:func:`drop_partition_major`: the optimizer would move it apart
from ``packed``); serving params made from trained ones gain it anew
(:func:`add_partition_major`).

Conv layers (dense and packed, NHWC activations, HWIO weights) run the
packed conv through :func:`im2col`, so it reuses the CS algebra.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as tF

from repro_torch.obs import sparsity as obs_sparsity
from . import functional as F
from .api import (SparsityConfig, choose_executor, choose_path,
                  dispatch_observed, notify_dispatch)
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


def block_route(route: torch.Tensor, g: int, g0: int, g1: int
                ) -> torch.Tensor:
    """The route of groups [g0, g1) of a packed layer of ``g`` groups
    whose whole ``route`` holds g/R tables (group i reads table i // R):
    one table a group.  A route stays whole beside a block of groups only
    where its tables do not divide over the axis that cuts the groups,
    so no such block is a run of whole tables."""
    r = g // route.shape[0]
    return route[torch.arange(g0, g1, device=route.device) // r]


def layer_route(params) -> torch.Tensor:
    """The route a packed layer's (or stack of routed experts') groups
    read: the block's own where a mesh cut the groups beside a whole
    route of several tables, else ``route``."""
    return params.get("block_route", params["route"])


# ---------------------------------------------------------------------------
# Dense linear (baseline)
# ---------------------------------------------------------------------------

def linear_specs(bias: bool = True, out_axis: str = "mlp",
                 in_axis=None):
    """The reference's logical specs of :func:`linear_init`'s params."""
    specs = {"w": (in_axis, out_axis)}
    if bias:
        specs["b"] = (out_axis,)
    return specs


def packed_linear_specs(bias: bool = True, out_axis: str = "mlp"):
    """The reference's logical specs of :func:`packed_linear_init`'s
    params: the groups axis shards, the route with it."""
    specs = {"packed": (out_axis, None, None),
             "route": (out_axis, None, None)}
    if bias:
        specs["b"] = (out_axis,)
    return specs


def linear_init(gen: torch.Generator, d_in: int, d_out: int,
                bias: bool = True, dtype=torch.float32):
    params = {"w": _uniform(gen, (d_in, d_out), 1.0 / np.sqrt(d_in), dtype)}
    if bias:
        params["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return params


def out_width(params) -> int:
    """The output columns a dense or packed linear layer's params hold (a
    mesh rank's block of them, or all)."""
    if "packed" in params:
        return params["packed"].shape[0] * params["packed"].shape[2]
    return params["w"].shape[-1]


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


def add_partition_major(tree):
    """A copy of the params tree in which every packed linear layer
    (``packed`` of shape (G, P, N)) holds ``packed_p`` made from its
    ``packed`` now; stacked experts (E, G, P, N) gain none (they never
    reach ``topk_gather``)."""
    if isinstance(tree, dict):
        out = {k: add_partition_major(v) for k, v in tree.items()
               if k != "packed_p"}
        if "packed" in out and out["packed"].ndim == 3:
            out["packed_p"] = partition_major(out["packed"])
        return out
    if isinstance(tree, list):
        return [add_partition_major(v) for v in tree]
    return tree


def drop_partition_major(tree):
    """The params tree without its ``packed_p`` copies: the training
    layout."""
    if isinstance(tree, dict):
        return {k: drop_partition_major(v) for k, v in tree.items()
                if k != "packed_p"}
    if isinstance(tree, list):
        return [drop_partition_major(v) for v in tree]
    return tree


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
    route = layer_route(params)
    d_in = packed.shape[1] * packed.shape[2]
    if x.shape[-1] < d_in:
        x = tF.pad(x, (0, d_in - x.shape[-1]))
    batch = int(np.prod(x.shape[:-1])) if x.ndim > 1 else 1
    path = choose_path(cfg, batch, d_in, x_is_sparse)
    if dispatch_observed():
        # Dispatch telemetry (repro_torch.obs): which path and backend this
        # layer application took.  Host-side only — nothing is launched.
        kernel = (path == "topk" and choose_executor(cfg).use_kernel
                  and x.is_cuda)
        notify_dispatch({"path": path, "backend": "cuda" if kernel
                         else "torch", "batch": batch, "d_in": d_in,
                         "d_out": packed.shape[0] * packed.shape[2],
                         "n": cfg.n, "k": cfg.k_for(d_in),
                         "weight_bytes": packed.element_size()})
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
    # Realized-sparsity capture (repro_torch.obs): when the serving engine's
    # probed decode step runs, report this layer's winner set (exact top-k:
    # tensors already made) or an nnz reduction (>=-K threshold impls).
    # With no active capture — every other step, and everything the linter
    # traces — both calls return at once and add nothing.
    if support is not None:
        obs_sparsity.observe_support(support[0], support[1], x.shape[-1])
    elif obs_sparsity.capture_active():
        obs_sparsity.observe_activation(y)
    return (y, support) if return_support else y


# ---------------------------------------------------------------------------
# Conv2D (dense + packed) — NHWC, via im2col so conv reuses the CS algebra
# ---------------------------------------------------------------------------

def _same_pad(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    ph, pw = kh // 2, kw // 2
    return tF.pad(x, (0, 0, pw, pw, ph, ph))


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
           padding: str = "VALID") -> torch.Tensor:
    """Extract patches: (B, H, W, C) -> (B, OH, OW, kh*kw*C), patch entry
    ``(i*kw + j)*C + c``, the reference's order."""
    if padding == "SAME":
        x = _same_pad(x, kh, kw)
    b, h, w, c = x.shape
    oh = (h - kh) // stride + 1
    ow = (w - kw) // stride + 1
    patches = torch.stack(
        [x[:, i:i + oh * stride:stride, j:j + ow * stride:stride, :]
         for i in range(kh) for j in range(kw)], dim=-2)
    return patches.reshape(b, oh, ow, kh * kw * c)


def conv2d_specs(bias: bool = True):
    """The reference's logical specs of :func:`conv2d_init`'s params
    (:func:`packed_linear_specs` for :func:`packed_conv2d_init`)."""
    specs = {"w": (None, None, None, "mlp")}
    if bias:
        specs["b"] = ("mlp",)
    return specs


def conv2d_init(gen: torch.Generator, kh: int, kw: int, c_in: int,
                c_out: int, bias: bool = True, dtype=torch.float32):
    """HWIO weights, uniform ±1/sqrt(kh·kw·c_in), as the reference's."""
    params = {"w": _uniform(gen, (kh, kw, c_in, c_out),
                            1.0 / np.sqrt(kh * kw * c_in), dtype)}
    if bias:
        params["b"] = torch.zeros((c_out,), dtype=dtype, device=gen.device)
    return params


def conv2d_apply(params, x: torch.Tensor, stride: int = 1,
                 padding: str = "VALID") -> torch.Tensor:
    """NHWC conv with HWIO weights: ``F.conv2d`` on permuted views.
    ``padding`` is ``"VALID"`` or ``"SAME"`` (stride 1)."""
    w = params["w"].to(x.dtype).permute(3, 2, 0, 1)        # OIHW
    y = tF.conv2d(x.permute(0, 3, 1, 2), w, stride=stride,
                  padding=padding.lower()).permute(0, 2, 3, 1)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


def packed_conv2d_init(gen: torch.Generator, kh: int, kw: int, c_in: int,
                       c_out: int, cfg: SparsityConfig, bias: bool = True,
                       seed: int = 0, dtype=torch.float32):
    """CS conv packed along the filter dimension (paper Fig. 7)."""
    return packed_linear_init(gen, kh * kw * c_in, c_out, cfg, bias=bias,
                              seed=seed, dtype=dtype)


def packed_conv2d_apply(params, x: torch.Tensor, cfg: SparsityConfig,
                        kh: int, kw: int, stride: int = 1,
                        padding: str = "VALID",
                        x_is_sparse: bool = False) -> torch.Tensor:
    cols = im2col(x, kh, kw, stride, padding)  # (B, OH, OW, kh*kw*C)
    return packed_linear_apply(params, cols, cfg, x_is_sparse=x_is_sparse)


def maxpool2d(x: torch.Tensor, size: int = 2, stride: int = 2):
    """VALID max pooling over H and W of an NHWC tensor."""
    return tF.max_pool2d(x.permute(0, 3, 1, 2), size,
                         stride).permute(0, 2, 3, 1)
