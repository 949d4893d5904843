"""Attention blocks: GQA with RoPE (+ blockwise 'flash' softmax for long
prefill) and its KV-cache decode and chunked-prefill steps, on the
contiguous cache or the paged pool.

Conventions (the reference's):
  x          (B, S, D)
  kv cache   {"k": (B, Smax, Hkv, Dh), "v": ...}; position carried by the
             caller.  The paged layout keeps the same leaves as a pool
             ``(n_pages, page_size, Hkv, Dh)`` addressed through per-slot
             page tables (:mod:`repro_torch.runtime.kvcache.layout`).
  Projections may be complementary-sparse (cfg.proj_sparsity).

The int8 cache and MLA are later slices of the port.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from repro_torch.core.api import SparsityConfig
from repro_torch.core.instrument import named_scope
from repro_torch.core.layers import (apply_kwta, linear_apply, linear_init,
                                     packed_linear_apply, packed_linear_init)
from repro_torch.obs.sparsity import observe_site
from repro_torch.runtime.kvcache.layout import (paged_view, paged_write_chunk,
                                                paged_write_rows)
from .common import apply_rope


def _proj_init(gen, d_in, d_out, sp: SparsityConfig, name_seed):
    """Dense or CS-packed projection depending on cfg.proj_sparsity."""
    if sp.weight_sparse and d_in % sp.n == 0 and d_out % sp.n == 0:
        return packed_linear_init(gen, d_in, d_out, sp, bias=False,
                                  seed=name_seed)
    return linear_init(gen, d_in, d_out, bias=False)


def _proj_apply(params, x, sp: SparsityConfig, x_is_sparse=False,
                support=None):
    if "packed" in params:
        return packed_linear_apply(params, x, sp, x_is_sparse=x_is_sparse,
                                   support=support)
    return linear_apply(params, x)


def _o_proj(params, out_flat, sp: SparsityConfig):
    """Output projection with the sparse-activation handoff: when the
    projection family is activation-sparse, the attention output goes
    through k-WTA and its winner support is handed to the CS-packed
    o-projection (one Select per layer, as in the FFN)."""
    with named_scope("o_proj"), observe_site("o_proj"):
        if sp.activation_sparse:
            out_flat, support = apply_kwta(out_flat, sp, return_support=True)
            return _proj_apply(params, out_flat, sp, x_is_sparse=True,
                               support=support)
        return _proj_apply(params, out_flat, sp)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def gqa_init(gen: torch.Generator, cfg):
    h, hkv, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    hp = cfg.padded_heads
    sp = cfg.proj_sparsity
    return {"q": _proj_init(gen, d, h * dh, sp, 11),
            "k": _proj_init(gen, d, hkv * dh, sp, 12),
            "v": _proj_init(gen, d, hkv * dh, sp, 13),
            # o-proj rows for padded dummy heads exist but only see zeros
            "o": _proj_init(gen, hp * dh, d, sp, 14)}


def _split_heads(x, n, dh):
    return x.reshape(*x.shape[:-1], n, dh)


def _repeat_kv(k, n_rep):
    """Each kv head repeated n_rep times in place (``jnp.repeat``)."""
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=-2)


def _pad_heads(x, h_pad):
    """Pad the head axis (-2) with zero heads up to h_pad. GQA grouping is
    preserved because padding happens *after* the kv repeat."""
    h = x.shape[-2]
    if h_pad <= h:
        return x
    return tF.pad(x, (0, 0, 0, h_pad - h))


def _mask_dummy_heads(out, cfg):
    """Zero the padded heads' outputs so the o-projection sees the exact
    n_heads function (dummy heads attend uniformly — must not leak)."""
    h, hp = cfg.n_heads, cfg.padded_heads
    if hp == h:
        return out
    mask = (torch.arange(hp, device=out.device) < h).to(out.dtype)
    return out * mask[:, None]


def _causal_attn(q, k, v, scale):
    """Materialized causal attention (short seq). q/k/v: (B, S, H, Dh)."""
    s_q, s_k = q.shape[1], k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    mask = torch.ones((s_q, s_k), dtype=torch.bool,
                      device=q.device).tril(diagonal=s_k - s_q)
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _flash_attn(q, k, v, scale, block: int):
    """Blockwise (online-softmax) causal attention: O(S·block) memory.

    Loops over KV chunks carrying (acc, row_max, row_sum). Used whenever
    S_kv exceeds `block`.
    """
    b, s_q, h, dh = q.shape
    dv = v.shape[-1]
    s_k = k.shape[1]
    nblk = s_k // block
    q32 = q.float() * scale
    q_pos = torch.arange(s_q, device=q.device)
    acc = torch.zeros((b, h, s_q, dv), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_q), -torch.inf, device=q.device)
    l = torch.zeros((b, h, s_q), dtype=torch.float32, device=q.device)
    for i in range(nblk):
        kb = k[:, i * block:(i + 1) * block].float()
        vb = v[:, i * block:(i + 1) * block].float()
        scores = torch.einsum("bqhd,bkhd->bhqk", q32, kb)
        k_pos = i * block + torch.arange(block, device=q.device)
        mask = q_pos[:, None] + (s_k - s_q) >= k_pos[None, :]
        scores = torch.where(mask, scores, -1e30)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)  # (B, S, H, Dh)


def _gqa_forward(params, x, cfg, positions):
    """Full causal self-attention. Returns (y, k_rows, v_rows) where
    k_rows/v_rows are the roped true-head K/V — exactly what the decode
    cache stores per position (the fused-prefill bulk write)."""
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    hp = cfg.padded_heads
    sp = cfg.proj_sparsity
    q = _split_heads(_proj_apply(params["q"], x, sp), h, dh)
    k = _split_heads(_proj_apply(params["k"], x, sp), hkv, dh)
    v = _split_heads(_proj_apply(params["v"], x, sp), hkv, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    k_rows, v_rows = k, v
    k = _repeat_kv(k, h // hkv)
    v = _repeat_kv(v, h // hkv)
    q, k, v = (_pad_heads(t, hp) for t in (q, k, v))
    scale = 1.0 / np.sqrt(dh)
    if x.shape[1] > cfg.flash_block:
        out = _flash_attn(q, k, v, scale, cfg.flash_block)
    else:
        out = _causal_attn(q, k, v, scale)
    out = _mask_dummy_heads(out, cfg)
    y = _o_proj(params["o"], out.reshape(*x.shape[:-1], hp * dh), sp)
    return y, k_rows, v_rows


def gqa_apply(params, x, cfg, positions):
    """Training/prefill forward (full causal self-attention)."""
    return _gqa_forward(params, x, cfg, positions)[0]


def _pad_seq(x, max_seq: int):
    """Zero-pad the sequence axis (1) out to ``max_seq``."""
    s = x.shape[1]
    if s >= max_seq:
        return x[:, :max_seq]
    pad = [0, 0] * (x.ndim - 2) + [0, max_seq - s]
    return tF.pad(x, pad)


def _check_cache_kind(cfg):
    if getattr(cfg, "kv_cache_dtype", "") == "int8":
        raise NotImplementedError("the int8 KV cache is not ported yet")


def gqa_prefill(params, x, cfg, positions, max_seq: int):
    """Fused full-sequence prefill: one forward over the whole prompt that
    also emits the decode cache in bulk (rows [0, S) written at once).
    Rows >= S are scratch (pad-token K/V when the caller bucket-pads the
    prompt); decode overwrites row ``pos`` before its validity mask reads
    it.  Returns (y, cache) with the same cache dict as gqa_cache_init."""
    _check_cache_kind(cfg)
    y, k, v = _gqa_forward(params, x, cfg, positions)
    return y, {"k": _pad_seq(k, max_seq), "v": _pad_seq(v, max_seq)}


def gqa_cache_init(cfg, batch: int, max_seq: int, dtype, device=None):
    """KV cache holding the *true* kv heads (head padding happens at use).

    The paged pool is the same leaves with ``(n_pages, page_size)`` in
    place of ``(batch, max_seq)``.  Zeros, never uninitialised memory:
    masked columns still pass through ``probs @ v`` as ``0 * v``, so a
    NaN in a row nobody wrote (the null page, rows past a chain) would
    reach the logits."""
    _check_cache_kind(cfg)
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, max_seq, hkv, dh), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_seq, hkv, dh), dtype=dtype,
                             device=device)}


def _cache_write(cache, new, pos):
    """Write one position into a (B, S, ...) cache, in place: the cache is
    the largest tensor of the decode step, and the reference's masked
    rewrite of all of it would copy it every step.

    ``pos`` is an int (all rows at the same position — the static batch)
    or a (B,) tensor of per-row positions (continuous batching).  A
    position outside [0, S) writes nothing, as the reference's masked
    write drops it.
    """
    s = cache.shape[1]
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        rows = torch.arange(cache.shape[0], device=cache.device)
        inside = (pos >= 0) & (pos < s)
        at = pos.long().clamp(0, s - 1)
        old = cache[rows, at]
        keep = inside.reshape(-1, *([1] * (old.ndim - 1)))
        cache[rows, at] = torch.where(keep, new[:, 0].to(cache.dtype), old)
        return cache
    pos = int(pos)
    if 0 <= pos < s:
        cache[:, pos] = new[:, 0].to(cache.dtype)
    return cache


def _kv_update(cache, k, v, pos, pos_b=None, pages=None):
    """Write the new K/V row(s) in place and return
    ``(cache, k_view, v_view)``, the views being the readable full-length
    caches.

    ``pages=None`` — contiguous layout: a row write into the
    (B, max_seq, ...) cache at ``pos``; the view IS the cache.
    ``pages`` given — paged layout: scatter each slot's row into its page
    chain at ``pos_b`` and gather the (B, view_len, ...) slot-logical read
    view.  Inactive slots' page tables are all null, so their stale writes
    land in the null page.
    """
    if pages is None:
        _cache_write(cache["k"], k, pos)
        _cache_write(cache["v"], v, pos)
        return cache, cache["k"], cache["v"]
    paged_write_rows(cache["k"], k[:, 0], pages, pos_b)
    paged_write_rows(cache["v"], v[:, 0], pages, pos_b)
    return cache, paged_view(cache["k"], pages), paged_view(cache["v"], pages)


def _gqa_cache_attn(params, x, q, k_view, v_view, valid, cfg):
    """Attention of (B, S_q, H, Dh) queries over a full-length cache view
    with a broadcastable validity mask ``valid`` (B|1, S_q|1, V)."""
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    hp = cfg.padded_heads
    q = _pad_heads(q, hp)
    kf = _pad_heads(_repeat_kv(k_view, h // hkv), hp)
    vf = _pad_heads(_repeat_kv(v_view, h // hkv), hp)
    scale = 1.0 / np.sqrt(dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kf).float() * scale
    scores = torch.where(valid[:, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    out = _mask_dummy_heads(out, cfg)
    return _o_proj(params["o"], out.reshape(*x.shape[:-1], hp * dh),
                   cfg.proj_sparsity)


def gqa_decode(params, x, cfg, cache, pos, pages=None):
    """One-token decode step. x: (B, 1, D); pos: int current position, or
    a (B,) tensor of per-row positions (continuous batching — each slot
    sits at its own depth in the cache).

    The new K/V row is written into the cache at ``pos`` (in place);
    attention reads the full cache with a validity mask (positions > pos
    are masked).  Returns (y, cache).

    With ``pages`` (a (B, n_blocks) int64 page table) the cache leaves are
    the PAGED pool ``(n_pages, page_size, ...)``: the row write scatters
    into each slot's own page chain and attention runs over the gathered
    per-slot view — same math, same mask, decoupled memory.
    """
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sp = cfg.proj_sparsity
    b = x.shape[0]
    if isinstance(pos, torch.Tensor):
        pos_b = pos.to(device=x.device, dtype=torch.int64).expand(b)
    else:
        pos_b = torch.full((b,), int(pos), dtype=torch.int64,
                           device=x.device)
    positions = pos_b[:, None]
    q = _split_heads(_proj_apply(params["q"], x, sp), h, dh)
    k = _split_heads(_proj_apply(params["k"], x, sp), hkv, dh)
    v = _split_heads(_proj_apply(params["v"], x, sp), hkv, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    cache, k_view, v_view = _kv_update(cache, k, v, pos, pos_b, pages)
    valid = (torch.arange(k_view.shape[1], device=x.device)[None, None, :]
             <= pos_b[:, None, None])
    y = _gqa_cache_attn(params, x, q, k_view, v_view, valid, cfg)
    return y, cache


def gqa_chunk_prefill(params, x, cfg, cache, pages, pos_start: int,
                      chunk_len: int):
    """Chunked prefill over the PAGED cache: forward C prompt tokens of
    ONE slot at absolute positions [pos_start, pos_start + C), scattering
    their K/V rows into the slot's page chain (in place) and attending
    causally to the gathered history (earlier chunks are already in the
    pool).  Rows past ``chunk_len`` are bucket padding: their K/V is
    redirected to the null page and their outputs are garbage the caller
    ignores.

    x: (1, C, D); pages: (1, n_blocks) int64; pos_start/chunk_len: ints.
    Returns (y (1, C, D), cache)."""
    _check_cache_kind(cfg)
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sp = cfg.proj_sparsity
    b, c, _ = x.shape
    offs = int(pos_start) + torch.arange(c, device=x.device)
    positions = offs.expand(b, c)
    q = _split_heads(_proj_apply(params["q"], x, sp), h, dh)
    k = _split_heads(_proj_apply(params["k"], x, sp), hkv, dh)
    v = _split_heads(_proj_apply(params["v"], x, sp), hkv, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    paged_write_chunk(cache["k"], k[0], pages[0], pos_start, chunk_len)
    paged_write_chunk(cache["v"], v[0], pages[0], pos_start, chunk_len)
    k_view = paged_view(cache["k"], pages)
    v_view = paged_view(cache["v"], pages)
    # causal in slot-logical coordinates: chunk row j sees cols <= pos0+j
    valid = (torch.arange(k_view.shape[1], device=x.device)[None, None, :]
             <= offs[None, :, None])
    y = _gqa_cache_attn(params, x, q, k_view, v_view, valid, cfg)
    return y, cache
