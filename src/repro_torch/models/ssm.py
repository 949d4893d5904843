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
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import torch
import torch.nn.functional as tF
from torch.utils.checkpoint import checkpoint

from .common import normal_init, rmsnorm_apply, rmsnorm_init

#: the mixers' leaves that every use casts to the compute dtype; the rest
#: (``A_log``, ``dt_bias``, ``gate_b``, sLSTM's ``b``, the norm scales)
#: enter in float32
COMPUTE_LEAVES = ("in_proj", "conv_w", "conv_b", "D", "out_proj", "qkv",
                  "gates", "skip", "wx", "r")


def _zeros(shape, device, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=device)


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


def _mamba2_project(params, x, cfg):
    d_inner, nh, ds = _mamba2_dims(cfg)
    zxbcdt = x @ params["in_proj"].to(x.dtype)
    return torch.split(zxbcdt, [d_inner, ds, ds, nh, d_inner], dim=-1)


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
    conv_cache) with dt = softplus(dt + dt_bias) in f32."""
    d_inner, _, ds = _mamba2_dims(cfg)
    xin, B, C, dt, z = _mamba2_project(params, x, cfg)
    xbc, conv_new = _causal_conv(torch.cat([xin, B, C], dim=-1),
                                 params["conv_w"], params["conv_b"],
                                 conv_cache)
    xin, B, C = torch.split(xbc, [d_inner, ds, ds], dim=-1)
    dt = tF.softplus(dt.float() + params["dt_bias"])
    return xin, B, C, dt, z, conv_new


def _mamba2_out(params, y, xh, z, x):
    """Skip, gate, norm and the out projection."""
    d_inner = z.shape[-1]
    y = y + params["D"][:, None].to(y.dtype) * xh
    y = y.reshape(*z.shape[:2], d_inner) * tF.silu(z)
    y = rmsnorm_apply(params["norm"], y)
    return y @ params["out_proj"].to(x.dtype)


def mamba2_apply(params, x, cfg):
    """Training/prefill forward. x: (B, T, D)."""
    b, t, _ = x.shape
    _, nh, ds = _mamba2_dims(cfg)
    xin, B, C, dt, z, _ = _mamba2_mix(params, x, cfg)
    log_a = -torch.exp(params["A_log"]) * dt                # (B,T,nh) <= 0
    xh = xin.reshape(b, t, nh, cfg.ssm_head_dim)
    # B/C are shared across heads (Mamba2 'multi-value' pattern)
    k = B[:, :, None, :].expand(b, t, nh, ds)
    q = C[:, :, None, :].expand(b, t, nh, ds)
    kdt = k * dt[..., None].to(k.dtype)
    y, _ = ssd_scan(q, kdt, xh, log_a, cfg.ssm_chunk)
    return _mamba2_out(params, y, xh, z, x)


def mamba2_cache_init(cfg, batch: int, dtype, device=None):
    d_inner, nh, ds = _mamba2_dims(cfg)
    return {"S": _zeros((batch, nh, ds, cfg.ssm_head_dim), device),
            "conv": _zeros((batch, cfg.conv_kernel - 1, d_inner + 2 * ds),
                           device, dtype)}


def mamba2_decode(params, x, cfg, cache, pos):
    """One-token step: O(1) state update (the long_500k path)."""
    del pos
    b = x.shape[0]
    _, nh, ds = _mamba2_dims(cfg)
    xin, B, C, dt, z, conv_new = _mamba2_mix(params, x, cfg, cache["conv"])
    log_a = (-torch.exp(params["A_log"]) * dt)[:, 0]        # (B, nh)
    xh = xin.reshape(b, nh, cfg.ssm_head_dim)
    k = B[:, 0, None, :].expand(b, nh, ds)
    q = C[:, 0, None, :].expand(b, nh, ds)
    kdt = k * dt[:, 0, :, None].to(k.dtype)
    y, S_new = ssd_step(cache["S"], q, kdt, xh, log_a)
    return (_mamba2_out(params, y[:, None], xh[:, None], z, x),
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
    b, t, d = x.shape
    h = cfg.n_heads
    dh = d // h
    q, k, v = (x @ params["qkv"].to(x.dtype)).chunk(3, dim=-1)
    q = q.reshape(b, t, h, dh)
    k = k.reshape(b, t, h, dh) / math.sqrt(dh)
    v = v.reshape(b, t, h, dh)
    gates = (x @ params["gates"].to(x.dtype)).float() + params["gate_b"]
    ig, fg = gates.chunk(2, dim=-1)                          # (B, T, H)
    log_f = tF.logsigmoid(fg)
    i = torch.exp(tF.logsigmoid(ig))  # sigmoid input gate (stabilized)
    return q, k, v, i, log_f


def _mlstm_finalize(params, y_aug, xh, cfg):
    """Split the augmented value (v, 1) -> normalize, skip, project.  The
    skip term takes ``xh`` = q, as the reference's does."""
    b, t = y_aug.shape[:2]
    y, nrm = y_aug[..., :-1], y_aug[..., -1:]
    y = y / torch.clamp(nrm.abs(), min=1.0)
    y = y + params["skip"][:, None].to(y.dtype) * xh
    y = rmsnorm_apply(params["norm"], y.reshape(b, t, cfg.d_model))
    return y @ params["out_proj"].to(y.dtype)


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


def _slstm_cell(params, cfg, carry, zx):
    """One recurrent step. carry: (h, c, n); zx: (B, 4D) pre-activations.
    The bias ``b`` is added in f32, after the cast."""
    d, nh = cfg.d_model, cfg.n_heads
    dh = d // nh
    h_prev, c_prev, n_prev = carry
    hr = torch.einsum("bhd,hde->bhe", h_prev.reshape(-1, nh, dh),
                      params["r"].to(h_prev.dtype)).reshape(-1, 4 * d)
    pre = (zx + hr).float() + params["b"]
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
    zx = x @ params["wx"].to(x.dtype)                       # (B, T, 4D)
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
