"""State-space / recurrent blocks — the reference's ``repro.models.ssm``:
a shared chunked-SSD scan used by both Mamba2 (zamba2) and mLSTM (xLSTM),
plus the strictly-sequential sLSTM.

Chunked SSD (the Mamba-2 'state-space duality' algorithm, also the
chunkwise-parallel mLSTM form): with per-step scalar decay a_t and update
S_t = a_t·S_{t-1} + k_t v_t^T, y_t = q_t·S_t, split T into chunks of L:

  intra-chunk: (Q K^T ⊙ D) V with D[i,j] = exp(cum_i - cum_j)·[j <= i]
  inter-chunk: (Q ⊙ exp(cum)) S_prev
  state carry: S_next = exp(cum_L) S_prev + Σ_j exp(cum_L - cum_j) k_j v_j^T

accumulated in float32.  A Python loop over the T/L chunks stands in for
the reference's ``lax.scan``; decode is the O(1) recurrent update.

The mLSTM normalizer n_t = f n_{t-1} + i k_t is folded in by augmenting V
with a ones column (y = (q·S)/max(|q·n|, 1)).

Each ``*_init`` draws from a ``torch.Generator`` with the reference's
distributions; each ``*_decode`` returns the block's output and its new
state, which :mod:`repro_torch.models.transformer` writes into the cache
in place.  The state ``S`` and sLSTM's ``c``/``n`` are float32; sLSTM's
``h`` and the conv cache are in the compute dtype.

On a serving mesh (:mod:`repro_torch.sharding.serving`) every mixer runs
on the rank's blocks of its params and state, the reference's specs leaf
for leaf, where each leaf is whole or a block over ``model`` as its
dimension divides: a projection whose weight is a block of columns is
gathered over ``model`` before its output is split (the blocks straddle
the split), the recurrence runs on the rank's heads (Mamba2, mLSTM), a
norm over the whole width takes its sum of squares over ``model``, and
an out projection that holds a block of rows is a row-parallel product
summed over ``model`` in float32.  sLSTM gathers its pre-activations and
runs the cell on the whole state on every rank.

A training step on a mesh runs the same forward through autograd
(:mod:`repro_torch.sharding.serving`): every tensor that every rank holds
whole enters (:func:`repro_torch.sharding.serving.enter_blocks`) where it
is cut to, or broadcast over, the rank's block of work (the input of a
column block, the gathered projections before their heads or channels
are cut, sLSTM's state before its heads), and a norm's sum of squares,
used on each rank's own columns, is summed over ``model`` in the
backward too.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as tF
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.serving import enter_blocks, serving
from .common import normal_init, rmsnorm_apply, rmsnorm_init

#: the mixers' leaves that every use casts to the compute dtype; the rest
#: (``A_log``, ``dt_bias``, ``gate_b``, sLSTM's ``b``, the norm scales)
#: enter in float32
COMPUTE_LEAVES = ("in_proj", "conv_w", "conv_b", "D", "out_proj", "qkv",
                  "gates", "skip", "wx", "r")


def _zeros(shape, device, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# The rank's blocks on a serving mesh
# ---------------------------------------------------------------------------

def _span(held: int, n: int) -> Tuple[int, int]:
    """The block [lo, hi) of ``n`` that a leaf holding ``held`` of them
    covers: its block over ``model`` on a serving mesh, else all."""
    return (0, n) if held == n else serving().block("model", n)


def _whole(*pairs):
    """Each ``(x, n)``: ``x``, whose last dimension is a block of ``n``
    over ``model`` (a product with a block of a weight's columns), made
    whole; all of them in one collective.  Whole tensors pass as they
    are."""
    out = [x for x, _ in pairs]
    cut = [i for i, (x, n) in enumerate(pairs) if x.shape[-1] < n]
    if cut:
        for i, t in zip(cut, serving().gather_last(*(out[i] for i in cut))):
            out[i] = t
    return out


def _norm_cols(params, y, lo: int, n: int):
    """RMSNorm over the whole width ``n`` of which ``y`` holds the columns
    [lo, lo + w): the sum of squares summed over ``model`` in float32,
    times the scale's columns.  The sum and the (whole) scale each meet
    the rank's own columns: both enter them."""
    w = y.shape[-1]
    if w == n:
        return rmsnorm_apply(params, y)
    y32 = y.float()
    ss = enter_blocks(serving().reduce_model(
        (y32 * y32).sum(dim=-1, keepdim=True)))
    out = y32 * torch.rsqrt(ss / n + 1e-5)
    scale = enter_blocks(params["scale"])[lo:lo + w]
    return (out * scale.float()).to(y.dtype)


def _rows_product(y, lo: int, w, n: int):
    """``y @ w`` where ``y`` holds the columns [lo, lo + y's width) of
    ``n`` and ``w`` all ``n`` rows or a block of them over ``model`` (a
    row-parallel product, summed over ``model`` in float32).  ``y`` is a
    block of heads only where the heads divide over ``model``, and then
    so do ``w``'s rows: its rows are ``y``'s, or ``y`` is whole (and then
    enters the rank's rows)."""
    r0, r1 = _span(w.shape[0], n)
    if y.shape[-1] == n and r1 - r0 < n:
        y = enter_blocks(y)
    out = y[..., r0 - lo:r1 - lo] @ w.to(y.dtype)
    if r1 - r0 < n:
        out = serving().reduce_model(out.float()).to(y.dtype)
    return out


# ---------------------------------------------------------------------------
# Chunked SSD scan
# ---------------------------------------------------------------------------

def _ssd_chunk(S, qb, kb, vb, la, causal):
    """One chunk of :func:`ssd_scan`: (y (B, L, H, Dv) f32, S_next)."""
    cum = torch.cumsum(la, dim=1)                         # (B, L, H)
    # intra-chunk
    scores = torch.einsum("bihd,bjhd->bhij", qb, kb)
    decay = (cum[:, :, None] - cum[:, None, :]).permute(0, 3, 1, 2)
    dmask = torch.where(causal, torch.exp(decay), 0.0)    # (B, H, L, L)
    y_intra = torch.einsum("bhij,bjhd->bihd", scores * dmask, vb)
    # inter-chunk
    qdec = qb * torch.exp(cum)[..., None]
    y_inter = torch.einsum("bihd,bhde->bihe", qdec, S)
    # state update
    tot = cum[:, -1:, :]                                  # (B, 1, H)
    kdec = kb * torch.exp(tot - cum)[..., None]
    S = (torch.exp(tot[:, 0, :, None, None]) * S
         + torch.einsum("bjhd,bjhe->bhde", kdec, vb))
    return y_intra + y_inter, S


def ssd_scan(q, k, v, log_a, chunk: int):
    """q,k: (B, T, H, Dk); v: (B, T, H, Dv); log_a: (B, T, H) (<= 0).

    Returns y: (B, T, H, Dv) in v's dtype, final state (B, H, Dk, Dv) f32.
    Where autograd records, each chunk runs under
    ``torch.utils.checkpoint`` (the reference's ``@jax.checkpoint``): its
    (B, H, L, L) scores are recomputed in the backward pass, not kept.
    """
    b, t, h, dk = q.shape
    L = min(chunk, t)
    if t % L:
        raise ValueError(f"T={t} not divisible by chunk={L}")
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    S = _zeros((b, h, dk, v.shape[-1]), q.device)
    ys = []
    for c in range(t // L):
        rows = slice(c * L, (c + 1) * L)
        xs = [z[:, rows].float() for z in (q, k, v)]      # (B, L, H, *)
        if torch.is_grad_enabled():
            y, S = checkpoint(_ssd_chunk, S, *xs, log_a[:, rows], causal,
                              use_reentrant=False)
        else:
            y, S = _ssd_chunk(S, *xs, log_a[:, rows], causal)
        ys.append(y.to(v.dtype))
    return torch.cat(ys, dim=1), S


def ssd_step(S, q, k, v, log_a):
    """O(1) recurrent decode step. q,k: (B,H,Dk); v: (B,H,Dv); log_a: (B,H).
    Returns (y (B,H,Dv), S_new)."""
    a = torch.exp(log_a.float())[..., None, None]
    S_new = a * S + torch.einsum("bhd,bhe->bhde", k.float(), v.float())
    y = torch.einsum("bhd,bhde->bhe", q.float(), S_new)
    return y.to(v.dtype), S_new


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def _mamba2_dims(cfg):
    """(d_inner, n_heads, state) of the mixer."""
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_head_dim, cfg.ssm_state


def mamba2_specs(cfg=None) -> Dict:
    """The reference's logical specs of :func:`mamba2_init`'s params."""
    return {"in_proj": (None, "mlp"), "conv_w": (None, "mlp"),
            "conv_b": ("mlp",), "A_log": ("mlp",), "dt_bias": ("mlp",),
            "D": ("mlp",), "out_proj": ("mlp", None),
            "norm": {"scale": (None,)}}


def mamba2_cache_specs():
    return {"S": ("batch", "mlp", None, None),
            "conv": ("batch", None, "mlp")}


def mamba2_init(gen: torch.Generator, cfg) -> Dict:
    d = cfg.d_model
    d_inner, nh, ds = _mamba2_dims(cfg)
    conv_dim = d_inner + 2 * ds
    dev = gen.device
    return {
        # projects to [x (d_inner), B (ds), C (ds), dt (nh), z (d_inner)]
        "in_proj": normal_init(gen, (d, d_inner + 2 * ds + nh + d_inner),
                               0.02),
        "conv_w": normal_init(gen, (cfg.conv_kernel, conv_dim), 0.1),
        "conv_b": _zeros((conv_dim,), dev),
        "A_log": _zeros((nh,), dev),
        "dt_bias": _zeros((nh,), dev),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "out_proj": normal_init(gen, (d_inner, d), 0.02),
        "norm": rmsnorm_init(d_inner, dev),
    }


def _causal_conv(seq, w, b, cache=None):
    """Depthwise causal conv over time. seq: (B, T, C); w: (K, C).

    With ``cache`` ((B, K-1, C) trailing context) performs the streaming
    update and returns (out, new_cache)."""
    kk = w.shape[0]
    t = seq.shape[1]
    pad = (seq.new_zeros((seq.shape[0], kk - 1, seq.shape[2]))
           if cache is None else cache)
    full = torch.cat([pad, seq], dim=1)
    out = sum(full[:, i:i + t] * w[i].to(seq.dtype) for i in range(kk))
    out = out + b.to(seq.dtype)
    new_cache = full[:, -(kk - 1):] if kk > 1 else pad
    return tF.silu(out), new_cache


def _mamba2_mix(params, x, cfg, conv_cache=None):
    """The projection, the causal conv and the gate: (xin, B, C, dt, z,
    conv_cache) with dt = softplus(dt + dt_bias) in f32; ``xin``, ``dt``
    and ``z`` of the heads the rank holds (all of them off a mesh).  On a
    mesh ``in_proj``'s block of columns straddles [x | B | C | dt | z] and
    is gathered before the split; the conv runs on the rank's block of
    channels (its weights and its cache), gathered again."""
    d_inner, nh, ds = _mamba2_dims(cfg)
    hd, conv_dim = cfg.ssm_head_dim, d_inner + 2 * ds
    width = conv_dim + nh + d_inner
    if params["in_proj"].shape[1] < width:
        x = enter_blocks(x)
    (zxbcdt,) = _whole((x @ params["in_proj"].to(x.dtype), width))
    xbc, dt, z = torch.split(zxbcdt, [conv_dim, nh, d_inner], dim=-1)
    c0, c1 = _span(params["conv_b"].shape[0], conv_dim)
    h0, h1 = _span(params["A_log"].shape[0], nh)
    if c1 - c0 < conv_dim:
        xbc = enter_blocks(xbc)
    xbc, conv_new = _causal_conv(xbc[..., c0:c1], params["conv_w"],
                                 params["conv_b"], conv_cache)
    (xbc,) = _whole((xbc, conv_dim))
    if h1 - h0 < nh:
        xbc, dt, z = (enter_blocks(t) for t in (xbc, dt, z))
    xin, B, C = torch.split(xbc, [d_inner, ds, ds], dim=-1)
    dt = tF.softplus(dt[..., h0:h1].float() + params["dt_bias"])
    return (xin[..., h0 * hd:h1 * hd], B, C, dt, z[..., h0 * hd:h1 * hd],
            conv_new)


def _mamba2_out(params, y, xh, z, cfg):
    """Skip, gate, the gated RMSNorm over the whole d_inner and the out
    projection (row parallel on a mesh) of the rank's heads."""
    d_inner, nh, _ = _mamba2_dims(cfg)
    y = y + params["D"][:, None].to(y.dtype) * xh
    y = y.reshape(*z.shape) * tF.silu(z)
    lo = _span(params["A_log"].shape[0], nh)[0] * cfg.ssm_head_dim
    y = _norm_cols(params["norm"], y, lo, d_inner)
    return _rows_product(y, lo, params["out_proj"], d_inner)


def mamba2_apply(params, x, cfg):
    """Training/prefill forward. x: (B, T, D)."""
    b, t, _ = x.shape
    ds = cfg.ssm_state
    xin, B, C, dt, z, _ = _mamba2_mix(params, x, cfg)
    nh = dt.shape[-1]                                       # heads held
    log_a = -torch.exp(params["A_log"]) * dt                # (B,T,nh) <= 0
    xh = xin.reshape(b, t, nh, cfg.ssm_head_dim)
    # B/C are shared across heads (Mamba2 'multi-value' pattern)
    k = B[:, :, None, :].expand(b, t, nh, ds)
    q = C[:, :, None, :].expand(b, t, nh, ds)
    kdt = k * dt[..., None].to(k.dtype)
    y, _ = ssd_scan(q, kdt, xh, log_a, cfg.ssm_chunk)
    return _mamba2_out(params, y, xh, z, cfg)


def mamba2_cache_init(cfg, batch: int, dtype, device=None):
    d_inner, nh, ds = _mamba2_dims(cfg)
    return {"S": _zeros((batch, nh, ds, cfg.ssm_head_dim), device),
            "conv": _zeros((batch, cfg.conv_kernel - 1, d_inner + 2 * ds),
                           device, dtype)}


def mamba2_decode(params, x, cfg, cache, pos):
    """One-token step: O(1) state update (the long_500k path)."""
    del pos
    b, ds = x.shape[0], cfg.ssm_state
    xin, B, C, dt, z, conv_new = _mamba2_mix(params, x, cfg, cache["conv"])
    nh = dt.shape[-1]                                       # heads held
    log_a = (-torch.exp(params["A_log"]) * dt)[:, 0]        # (B, nh)
    xh = xin.reshape(b, nh, cfg.ssm_head_dim)
    k = B[:, 0, None, :].expand(b, nh, ds)
    q = C[:, 0, None, :].expand(b, nh, ds)
    kdt = k * dt[:, 0, :, None].to(k.dtype)
    y, S_new = ssd_step(cache["S"], q, kdt, xh, log_a)
    return (_mamba2_out(params, y[:, None], xh[:, None], z, cfg),
            {"S": S_new, "conv": conv_new})


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM)
# ---------------------------------------------------------------------------

def mlstm_specs(cfg=None) -> Dict:
    """The reference's logical specs of :func:`mlstm_init`'s params."""
    return {"qkv": (None, "heads"), "gates": (None, "heads"),
            "gate_b": ("heads",), "out_proj": ("heads", None),
            "norm": {"scale": (None,)}, "skip": ("heads",)}


def mlstm_cache_specs():
    return {"S": ("batch", "heads", None, None)}


def mlstm_init(gen: torch.Generator, cfg) -> Dict:
    d, h = cfg.d_model, cfg.n_heads
    dev = gen.device
    return {
        "qkv": normal_init(gen, (d, 3 * d), 0.02),
        "gates": normal_init(gen, (d, 2 * h), 0.02),     # i, f per head
        "gate_b": torch.cat([_zeros((h,), dev),
                             3.0 * torch.ones((h,), device=dev)]),
        "out_proj": normal_init(gen, (d, d), 0.02),
        "norm": rmsnorm_init(d, dev),
        "skip": torch.ones((h,), dtype=torch.float32, device=dev),
    }


def _mlstm_qkvg(params, x, cfg):
    """q, k, v (B, T, H', Dh) and the gates i, log f (B, T, H') of the
    H' heads the rank holds (all of them off a mesh).  On a mesh ``qkv``'s
    and ``gates``' blocks of columns straddle q | k | v and i | f: they
    are gathered, in one collective, before the split."""
    b, t, d = x.shape
    h = cfg.n_heads
    dh = d // h
    xg = enter_blocks(x) if params["gates"].shape[1] < 2 * h else x
    xq = enter_blocks(x) if params["qkv"].shape[1] < 3 * d else x
    gates = (xg @ params["gates"].to(x.dtype)).float() + params["gate_b"]
    qkv, gates = _whole((xq @ params["qkv"].to(x.dtype), 3 * d),
                        (gates, 2 * h))
    h0, h1 = _span(params["skip"].shape[0], h)
    if h1 - h0 < h:
        qkv, gates = enter_blocks(qkv), enter_blocks(gates)
    q, k, v = (z.reshape(b, t, h, dh)[:, :, h0:h1]
               for z in qkv.chunk(3, dim=-1))
    k = k / math.sqrt(dh)
    ig, fg = (g[..., h0:h1] for g in gates.chunk(2, dim=-1))  # (B, T, H')
    log_f = tF.logsigmoid(fg)
    i = torch.exp(tF.logsigmoid(ig))  # sigmoid input gate (stabilized)
    return q, k, v, i, log_f


def _mlstm_finalize(params, y_aug, xh, cfg):
    """Split the augmented value (v, 1) -> normalize, skip, project.  The
    skip term takes ``xh`` = q, as the reference's does.  The RMSNorm
    spans the whole d_model and ``out_proj`` may hold a block of rows: on
    a mesh both combine over ``model``."""
    b, t, held = y_aug.shape[:3]
    y, nrm = y_aug[..., :-1], y_aug[..., -1:]
    y = y / torch.clamp(nrm.abs(), min=1.0)
    y = y + params["skip"][:, None].to(y.dtype) * xh
    lo = _span(held, cfg.n_heads)[0] * (cfg.d_model // cfg.n_heads)
    y = _norm_cols(params["norm"], y.reshape(b, t, -1), lo, cfg.d_model)
    return _rows_product(y, lo, params["out_proj"], cfg.d_model)


def _ones_column(v):
    return torch.cat([v, v.new_ones((*v.shape[:-1], 1))], dim=-1)


def mlstm_apply(params, x, cfg):
    q, k, v, i, log_f = _mlstm_qkvg(params, x, cfg)
    ki = k * i[..., None].to(k.dtype)
    y_aug, _ = ssd_scan(q, ki, _ones_column(v), log_f, cfg.ssm_chunk)
    return _mlstm_finalize(params, y_aug, q, cfg)


def mlstm_cache_init(cfg, batch: int, dtype, device=None):
    dh = cfg.d_model // cfg.n_heads
    return {"S": _zeros((batch, cfg.n_heads, dh, dh + 1), device)}


def mlstm_decode(params, x, cfg, cache, pos):
    del pos
    q, k, v, i, log_f = _mlstm_qkvg(params, x, cfg)
    ki = (k * i[..., None].to(k.dtype))[:, 0]
    y_aug, S_new = ssd_step(cache["S"], q[:, 0], ki, _ones_column(v)[:, 0],
                            log_f[:, 0])
    return _mlstm_finalize(params, y_aug[:, None], q, cfg), {"S": S_new}


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM): strictly sequential scalar-memory recurrence
# ---------------------------------------------------------------------------

def slstm_specs(cfg=None) -> Dict:
    """The reference's logical specs of :func:`slstm_init`'s params."""
    return {"wx": (None, "heads"), "r": ("heads", None, None),
            "b": ("heads",), "out_proj": (None, None),
            "norm": {"scale": (None,)}}


def slstm_cache_specs():
    return {"h": ("batch", None), "c": ("batch", None), "n": ("batch", None)}


def slstm_init(gen: torch.Generator, cfg) -> Dict:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    dev = gen.device
    return {
        "wx": normal_init(gen, (d, 4 * d), 0.02),          # z i f o
        "r": normal_init(gen, (h, dh, 4 * dh), 1.0 / math.sqrt(dh)),
        "b": _zeros((4 * d,), dev),
        "out_proj": normal_init(gen, (d, d), 0.02),
        "norm": rmsnorm_init(d, dev),
    }


def _slstm_pre(params, cfg, h_prev, zx):
    """The cell's pre-activations (B, 4D), f32: ``zx`` plus the recurrent
    term of ``h_prev`` (head-major, as the reference reshapes it) plus
    ``b``, added after the cast.  On a mesh ``zx`` and ``b`` hold a block
    of the columns and ``r`` the block of heads whose terms are those
    columns (or all heads): the rank forms its block, and the blocks are
    gathered."""
    d, nh = cfg.d_model, cfg.n_heads
    dh = d // nh
    c0, c1 = _span(params["b"].shape[0], 4 * d)
    g0, g1 = _span(params["r"].shape[0], nh)
    if g1 - g0 < nh:
        h_prev = enter_blocks(h_prev)
    hr = torch.einsum("bhd,hde->bhe", h_prev.reshape(-1, nh, dh)[:, g0:g1],
                      params["r"].to(h_prev.dtype)).reshape(h_prev.shape[0],
                                                            -1)
    # a whole r's product is whole on every rank: it enters the block
    if g1 - g0 == nh and c1 - c0 < 4 * d:
        hr = enter_blocks(hr)
    hr = hr[:, c0 - 4 * dh * g0:c1 - 4 * dh * g0]
    return _whole(((zx + hr).float() + params["b"], 4 * d))[0]


def _slstm_cell(params, cfg, carry, zx):
    """One recurrent step. carry: (h, c, n); zx: (B, 4D) pre-activations
    (the rank's block of them on a mesh)."""
    h_prev, c_prev, n_prev = carry
    pre = _slstm_pre(params, cfg, h_prev, zx)
    z, ig, fg, og = pre.chunk(4, dim=-1)
    z = torch.tanh(z)
    i = torch.exp(torch.clamp(ig, max=0.0))  # stabilized exponential gate
    f = torch.sigmoid(fg)
    o = torch.sigmoid(og)
    c = f * c_prev + i * z
    n = f * n_prev + i
    h_new = o * c / torch.clamp(n.abs(), min=1.0)
    return h_new.to(h_prev.dtype), c, n


def slstm_apply(params, x, cfg):
    b, t, d = x.shape
    xe = enter_blocks(x) if params["wx"].shape[1] < 4 * d else x
    zx = xe @ params["wx"].to(x.dtype)                      # (B, T, 4D)
    carry = (x.new_zeros((b, d)), _zeros((b, d), x.device),
             _zeros((b, d), x.device))
    hs = []
    for s in range(t):
        carry = _slstm_cell(params, cfg, carry, zx[:, s])
        hs.append(carry[0])
    y = rmsnorm_apply(params["norm"], torch.stack(hs, dim=1))
    return y @ params["out_proj"].to(x.dtype)


def slstm_cache_init(cfg, batch: int, dtype, device=None):
    d = cfg.d_model
    return {"h": _zeros((batch, d), device, dtype),
            "c": _zeros((batch, d), device),
            "n": _zeros((batch, d), device)}


def slstm_decode(params, x, cfg, cache, pos):
    del pos
    zx = (x @ params["wx"].to(x.dtype))[:, 0]
    h_new, c, n = _slstm_cell(params, cfg,
                              (cache["h"], cache["c"], cache["n"]), zx)
    y = rmsnorm_apply(params["norm"], h_new[:, None])
    return y @ params["out_proj"].to(x.dtype), {"h": h_new, "c": c, "n": n}


class Mixer(NamedTuple):
    init: Callable
    apply: Callable
    decode: Callable
    cache_init: Callable
    specs: Callable
    cache_specs: Callable


#: block kind -> its mixer's functions
MIXERS = {
    "mamba2": Mixer(mamba2_init, mamba2_apply, mamba2_decode,
                    mamba2_cache_init, mamba2_specs, mamba2_cache_specs),
    "mlstm": Mixer(mlstm_init, mlstm_apply, mlstm_decode, mlstm_cache_init,
                   mlstm_specs, mlstm_cache_specs),
    "slstm": Mixer(slstm_init, slstm_apply, slstm_decode, slstm_cache_init,
                   slstm_specs, slstm_cache_specs),
}
