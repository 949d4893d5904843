"""Attention blocks: GQA with RoPE (+ blockwise 'flash' softmax for long
prefill), MLA (DeepSeek-V2 latent compression), and their KV-cache decode
and chunked-prefill steps, on the contiguous cache or the paged pool.

Conventions (the reference's):
  x          (B, S, D)
  kv cache   {"k": (B, Smax, Hkv, Dh), "v": ...}; position carried by the
             caller.  With ``cfg.kv_cache_dtype == "int8"`` the rows are
             int8 with f32 ``k_scale``/``v_scale`` leaves (B, Smax, Hkv);
             MLA caches the latent ``ckv`` (B, Smax, r) and the rope key
             ``kpe`` (B, Smax, dr).  The paged layout keeps the same leaves
             as a pool ``(n_pages, page_size, ...)`` addressed through
             per-slot page tables (:mod:`repro_torch.runtime.kvcache.layout`).
  Projections may be complementary-sparse (cfg.proj_sparsity); MLA's are
  bare dense weights, cast to the compute dtype once at init.

On a serving mesh (:func:`repro_torch.sharding.serving.serving`) the GQA
functions run on the rank's blocks: q, k and v come out as blocks of
columns and are gathered over ``model`` before the heads are split (a
block need not be whole heads); a contiguous cache that holds a block of
rows is written by the rank that owns ``pos`` and attended through the
sharded softmax (each rank's maximum, sum of exponentials and weighted
values over its rows, combined over ``model`` in float32); a cache that
holds a block of kv heads is attended for those heads' queries, the head
outputs gathered before ``o``, which every rank runs whole.  In a
training step on a mesh ``x`` enters the column blocks alone (its
gradient summed over ``model`` in the backward; a whole k or v beside a
block of q takes its whole gradient on every rank).

MLA on a serving mesh holds a block of columns of ``q``, ``uk`` and
``uv`` and those rows of ``o``, and the whole ``dkv`` and ``kpe``
(:func:`_mla_split`).  Where the block is whole heads, its heads attend
and their products through ``o`` are summed over ``model`` (row
parallel); where it cuts a head (``n_heads`` does not divide over
``model``), as the GQA block does, the products of q's and of uk's and
uv's columns are gathered over ``model`` before the heads split, every
rank attends every head, and takes its columns of the head outputs
through its rows of ``o``, summed over ``model``.  A contiguous latent
cache that holds a block of rows (over ``model``, or over the DP axes
and ``model`` under ``decode_long``) is attended through the absorbed
queries and the sharded softmax over those axes
(:func:`_mla_rows_attn`); the page pools hold every row.  In a training
step ``x`` enters q's block and the latent uk's and uv's (on a block of
whole heads the rope key too), and the head outputs enter the rows of
``o`` where every rank computed every head.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from repro_torch.core.api import SparsityConfig
from repro_torch.core.instrument import named_scope
from repro_torch.core.layers import (apply_kwta, linear_apply, linear_init,
                                     linear_specs, out_width,
                                     packed_linear_apply, packed_linear_init,
                                     packed_linear_specs)
from repro_torch.obs.sparsity import observe_site
from repro_torch.runtime.kvcache.layout import (paged_view, paged_write_chunk,
                                                paged_write_rows)
from repro_torch.sharding.serving import enter_blocks, serving
from .common import apply_rope, normal_init


def _proj_init(gen, d_in, d_out, sp: SparsityConfig, name_seed):
    """Dense or CS-packed projection depending on cfg.proj_sparsity."""
    if sp.weight_sparse and d_in % sp.n == 0 and d_out % sp.n == 0:
        return packed_linear_init(gen, d_in, d_out, sp, bias=False,
                                  seed=name_seed)
    return linear_init(gen, d_in, d_out, bias=False)


def _proj_specs(d_in, d_out, sp: SparsityConfig, out_axis):
    if sp.weight_sparse and d_in % sp.n == 0 and d_out % sp.n == 0:
        return packed_linear_specs(bias=False, out_axis=out_axis)
    return linear_specs(bias=False, out_axis=out_axis)


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


def gqa_specs(cfg):
    """The reference's logical specs of :func:`gqa_init`'s params."""
    h, hkv, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    sp = cfg.proj_sparsity
    return {"q": _proj_specs(d, h * dh, sp, "heads"),
            "k": _proj_specs(d, hkv * dh, sp, "kv"),
            "v": _proj_specs(d, hkv * dh, sp, "kv"),
            "o": _proj_specs(cfg.padded_heads * dh, d, sp, "embed")}


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


def _qkv(params, x, cfg, positions):
    """Roped queries (B, S, H, Dh) and keys (B, S, Hkv, Dh), and values.
    On a mesh a projection whose weight is a block of columns is gathered
    over ``model`` first, all of them in one collective, and ``x`` enters
    those blocks alone: a whole projection beside them (k and v where the
    kv heads do not divide) takes all of its gradient on every rank."""
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sp = cfg.proj_sparsity
    names, sh = ("q", "k", "v"), serving()
    part = [] if sh is None else [
        i for i, n in enumerate((h, hkv, hkv))
        if out_width(params[names[i]]) < n * dh]
    xe = enter_blocks(x) if part else x
    outs = [_proj_apply(params[n], xe if i in part else x, sp)
            for i, n in enumerate(names)]
    if part:
        for i, t in zip(part, sh.gather_last(*(outs[i] for i in part))):
            outs[i] = t
    q, k, v = (_split_heads(t, n, dh) for t, n in zip(outs, (h, hkv, hkv)))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


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


def _gqa_forward(params, x, cfg, positions, quantize_kv: bool = False):
    """Full causal self-attention. Returns (y, k_rows, v_rows) where
    k_rows/v_rows are the roped true-head K/V — exactly what the decode
    cache stores per position (the fused-prefill bulk write).

    ``quantize_kv`` (int8 cache prefill): attention reads the
    quantize→dequantize round trip of K/V, the cache's representation,
    so fused prefill sees what chunked prefill and every later decode step
    read back.  ``k_rows``/``v_rows`` stay exact: storage quantizes the
    originals."""
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    hp = cfg.padded_heads
    sp = cfg.proj_sparsity
    q, k, v = _qkv(params, x, cfg, positions)
    k_rows, v_rows = k, v
    if quantize_kv:
        k = _dequant(*_quant_rows(k), x.dtype)
        v = _dequant(*_quant_rows(v), x.dtype)
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


def _int8_cache(cfg) -> bool:
    return getattr(cfg, "kv_cache_dtype", "") == "int8"


def gqa_prefill(params, x, cfg, positions, max_seq: int):
    """Fused full-sequence prefill: one forward over the whole prompt that
    also emits the decode cache in bulk (rows [0, S) written at once).
    Rows >= S are scratch (pad-token K/V when the caller bucket-pads the
    prompt); decode overwrites row ``pos`` before its validity mask reads
    it.  With an int8 cache, attention reads the quantized representation
    (``_gqa_forward(quantize_kv=True)``), so the fused path stays a
    token-exact oracle for chunked paged prefill.  On a serving mesh every
    rank attends over the whole prompt and keeps its block of the cache
    (its rows or kv heads, as the cache's spec gives it).  Returns (y,
    cache) with the same cache dict as gqa_cache_init."""
    int8 = _int8_cache(cfg)
    y, k, v = _gqa_forward(params, x, cfg, positions, quantize_kv=int8)
    if int8:
        kq, ks = _quant_rows(k)
        vq, vs = _quant_rows(v)
        cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        cache = {"k": k, "v": v}
    cache = {n: _pad_seq(t, max_seq) for n, t in cache.items()}
    sh = serving()
    if sh is not None:
        specs = gqa_cache_specs(cfg)
        cache = {n: sh.rules.sharding_for(specs[n], t.shape).take(t)
                 for n, t in cache.items()}
    return y, cache


def gqa_cache_specs(cfg=None):
    """The reference's logical specs of :func:`gqa_cache_init`'s leaves."""
    specs = {"k": ("batch", "kvseq", "kv", None),
             "v": ("batch", "kvseq", "kv", None)}
    if cfg is not None and getattr(cfg, "kv_cache_dtype", "") == "int8":
        specs["k_scale"] = ("batch", "kvseq", "kv")
        specs["v_scale"] = ("batch", "kvseq", "kv")
    return specs


def gqa_cache_init(cfg, batch: int, max_seq: int, dtype, device=None):
    """KV cache holding the *true* kv heads (head padding happens at use).

    With ``cfg.kv_cache_dtype == "int8"`` the rows are stored quantized,
    with one f32 scale per (batch, position, head) row: half the bytes of
    a bf16 cache plus the scales; the attention reads dequantize.

    The paged pool is the same leaves with ``(n_pages, page_size)`` in
    place of ``(batch, max_seq)``.  Zeros, never uninitialised memory:
    masked columns still pass through ``probs @ v`` as ``0 * v``, so a
    NaN in a row nobody wrote (the null page, rows past a chain) would
    reach the logits."""
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    rows = (batch, max_seq, hkv, dh)
    if _int8_cache(cfg):
        scales = (batch, max_seq, hkv)
        return {"k": torch.zeros(rows, dtype=torch.int8, device=device),
                "v": torch.zeros(rows, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(scales, dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(scales, dtype=torch.float32,
                                       device=device)}
    return {"k": torch.zeros(rows, dtype=dtype, device=device),
            "v": torch.zeros(rows, dtype=dtype, device=device)}


def _quant_rows(x):
    """Per-(..., head)-row symmetric int8 quantization over head_dim.
    Returns (int8 rows, f32 scales).

    The scale divides by a tensor of 127s, not by the number: a CUDA
    division by a CPU scalar multiplies by its reciprocal, one rounding
    more than the reference's division.  ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = (torch.clamp(amax, min=1e-8)
             / torch.full_like(amax, 127.0))
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequant(q, scale, dtype):
    """int8 rows and their scales back to ``dtype``, as the reference
    reads them: both cast to ``dtype``, then multiplied."""
    return q.to(dtype) * scale[..., None].to(dtype)


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
        def write(leaf, new):
            _cache_write(leaf, new, pos)

        def view(leaf):
            return leaf
    else:
        def write(leaf, new):
            paged_write_rows(leaf, new[:, 0], pages, pos_b)

        def view(leaf):
            return paged_view(leaf, pages)
    if "k_scale" in cache:  # int8-quantized cache
        for name, rows in (("k", k), ("v", v)):
            rows_q, scale = _quant_rows(rows)
            write(cache[name], rows_q)
            write(cache[f"{name}_scale"], scale)
        return (cache,
                _dequant(view(cache["k"]), view(cache["k_scale"]), k.dtype),
                _dequant(view(cache["v"]), view(cache["v_scale"]), k.dtype))
    write(cache["k"], k)
    write(cache["v"], v)
    return cache, view(cache["k"]), view(cache["v"])


def _scores(q, kf, valid, dh):
    """Masked float32 scores (B, H, S_q, V) of queries over keys."""
    scale = 1.0 / np.sqrt(dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kf).float() * scale
    return torch.where(valid[:, None], scores, -1e30)


def _attend(q, kf, vf, valid, dh, dtype):
    """Softmax attention (B, S_q, H, Dh) of queries over whole keys and
    values (as many heads as the queries)."""
    probs = torch.softmax(_scores(q, kf, valid, dh), dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf)


def softmax_max(scores):
    """A block of keys' term of the sharded softmax: its row maxima."""
    return scores.amax(dim=-1)


def softmax_terms(scores, v, m):
    """A block of keys' sums of exponentials (B, H, S_q) and weighted
    values (B, H, S_q, Dh) under the maxima ``m`` of every block, float32;
    summed over the blocks they give :func:`softmax_finish` the whole."""
    p = torch.exp(scores - m[..., None])
    return p.sum(dim=-1), torch.einsum("bhqk,bkhd->bhqd", p, v.float())


def softmax_finish(l, acc):
    """Softmax attention (B, S_q, H, Dh) from the summed terms."""
    return (acc / torch.clamp(l[..., None], min=1e-30)).transpose(1, 2)


def _o_of_heads(params, x, out, cfg):
    """The o projection of the (B, S_q, Hp, Dh) head outputs."""
    return _o_proj(params["o"], out.reshape(*x.shape[:-1],
                                            cfg.padded_heads * cfg.head_dim),
                   cfg.proj_sparsity)


def _gqa_cache_attn(params, x, q, k_view, v_view, valid, cfg):
    """Attention of (B, S_q, H, Dh) queries over a full-length cache view
    with a broadcastable validity mask ``valid`` (B|1, S_q|1, V)."""
    h, hkv, hp = cfg.n_heads, cfg.n_kv_heads, cfg.padded_heads
    q = _pad_heads(q, hp)
    kf = _pad_heads(_repeat_kv(k_view, h // hkv), hp)
    vf = _pad_heads(_repeat_kv(v_view, h // hkv), hp)
    out = _attend(q, kf, vf, valid, cfg.head_dim, x.dtype)
    return _o_of_heads(params, x, _mask_dummy_heads(out, cfg), cfg)


def _rows_attn(params, x, q, k_view, v_view, valid, cfg, sh, axes):
    """:func:`_gqa_cache_attn` where the cache view is this rank's block
    of rows: the sharded softmax, combined over the rows' ``axes``, for
    the true heads (the padded heads' outputs are zeros)."""
    rep = cfg.n_heads // cfg.n_kv_heads
    scores = _scores(q, _repeat_kv(k_view, rep), valid, cfg.head_dim)
    m = sh.reduce(softmax_max(scores), axes, "max")
    l, acc = softmax_terms(scores, _repeat_kv(v_view, rep), m)
    terms = sh.reduce(torch.cat([l[..., None], acc], dim=-1), axes)
    out = softmax_finish(terms[..., 0], terms[..., 1:]).to(x.dtype)
    return _o_of_heads(params, x, _pad_heads(out, cfg.padded_heads), cfg)


def _heads_attn(params, x, q, k_view, v_view, valid, cfg, sh, heads):
    """:func:`_gqa_cache_attn` where the cache view holds this rank's kv
    heads [h0, h1): their queries attend, the head outputs are gathered
    over ``model``."""
    rep = cfg.n_heads // cfg.n_kv_heads
    h0, h1 = heads
    out = _attend(q[..., h0 * rep:h1 * rep, :], _repeat_kv(k_view, rep),
                  _repeat_kv(v_view, rep), valid, cfg.head_dim, x.dtype)
    out = _pad_heads(sh.gather(out, {-2: "model"}), cfg.padded_heads)
    return _o_of_heads(params, x, out, cfg)


def _cache_split(cfg, paged: bool):
    """(serving shards, what the rank's cache block holds: "rows",
    "heads" or None, the mesh axes it is a block over, and that block
    [lo, hi))."""
    sh = serving()
    split = None if sh is None else sh.kv_split(paged, cfg.n_kv_heads)
    if split is None:
        return sh, None, None, None
    if split == "rows":
        axes = sh.rows_axes(paged, cfg.n_kv_heads)
        return sh, split, axes, sh.block(axes, sh.max_seq)
    return sh, split, "model", sh.block("model", cfg.n_kv_heads)


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
    b = x.shape[0]
    if isinstance(pos, torch.Tensor):
        pos_b = pos.to(device=x.device, dtype=torch.int64).expand(b)
    else:
        pos_b = torch.full((b,), int(pos), dtype=torch.int64,
                           device=x.device)
    q, k, v = _qkv(params, x, cfg, pos_b[:, None])
    sh, split, axes, block = _cache_split(cfg, pages is not None)
    lo = block[0] if split == "rows" else 0
    if split == "heads":
        k, v = k[..., block[0]:block[1], :], v[..., block[0]:block[1], :]
    # a block of rows [lo, ...): only the rank that owns ``pos`` writes it
    cache, k_view, v_view = _kv_update(cache, k, v, pos - lo if lo else pos,
                                       pos_b, pages)
    cols = torch.arange(k_view.shape[1], device=x.device)
    if lo:
        cols = cols + lo
    valid = cols[None, None, :] <= pos_b[:, None, None]
    if split == "rows":
        y = _rows_attn(params, x, q, k_view, v_view, valid, cfg, sh, axes)
    elif split == "heads":
        y = _heads_attn(params, x, q, k_view, v_view, valid, cfg, sh, block)
    else:
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
    b, c, _ = x.shape
    offs = int(pos_start) + torch.arange(c, device=x.device)
    q, k, v = _qkv(params, x, cfg, offs.expand(b, c))
    sh, split, _, heads = _cache_split(cfg, paged=True)
    if split == "heads":
        k, v = k[..., heads[0]:heads[1], :], v[..., heads[0]:heads[1], :]

    def write(leaf, rows):
        paged_write_chunk(leaf, rows[0], pages[0], pos_start, chunk_len)

    if "k_scale" in cache:  # int8-quantized cache
        for name, rows in (("k", k), ("v", v)):
            rows_q, scale = _quant_rows(rows)
            write(cache[name], rows_q)
            write(cache[f"{name}_scale"], scale)
        k_view = _dequant(paged_view(cache["k"], pages),
                          paged_view(cache["k_scale"], pages), x.dtype)
        v_view = _dequant(paged_view(cache["v"], pages),
                          paged_view(cache["v_scale"], pages), x.dtype)
    else:
        write(cache["k"], k)
        write(cache["v"], v)
        k_view = paged_view(cache["k"], pages)
        v_view = paged_view(cache["v"], pages)
    # causal in slot-logical coordinates: chunk row j sees cols <= pos0+j
    valid = (torch.arange(k_view.shape[1], device=x.device)[None, None, :]
             <= offs[None, :, None])
    if split == "heads":
        y = _heads_attn(params, x, q, k_view, v_view, valid, cfg, sh, heads)
    else:
        y = _gqa_cache_attn(params, x, q, k_view, v_view, valid, cfg)
    return y, cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): latent KV compression
# ---------------------------------------------------------------------------

def mla_specs(cfg=None):
    """The reference's logical specs of :func:`mla_init`'s params."""
    return {"q": (None, "heads"), "dkv": (None, None), "kpe": (None, None),
            "uk": (None, "heads"), "uv": (None, "heads"),
            "o": ("heads", None)}


def mla_init(gen: torch.Generator, cfg):
    """Bare dense weights, normal(0.02), the reference's leaves: ``q``
    (d, h·(dh+dr)), ``dkv`` (d, r), ``kpe`` (d, dr), ``uk``/``uv``
    (r, h·dh), ``o`` (h·dh, d)."""
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    r, dr = cfg.kv_lora_rank, cfg.rope_head_dim
    return {"q": normal_init(gen, (d, h * (dh + dr)), 0.02),
            "dkv": normal_init(gen, (d, r), 0.02),
            "kpe": normal_init(gen, (d, dr), 0.02),
            "uk": normal_init(gen, (r, h * dh), 0.02),
            "uv": normal_init(gen, (r, h * dh), 0.02),
            "o": normal_init(gen, (h * dh, d), 0.02)}


def _mla_split(params, cfg):
    """How the rank holds MLA's heads: None (all of them), ``"heads"``
    (a mesh's block of whole heads: q's, uk's and uv's columns and o's
    rows of heads [h0, h1)) or ``"cols"`` (blocks of those columns and
    rows that cut a head, where ``n_heads`` does not divide over
    ``model``)."""
    h, dh, dr = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    width = params["uk"].shape[1]
    if width == h * dh and params["q"].shape[1] == h * (dh + dr):
        return None
    return "heads" if width < h * dh and width % dh == 0 else "cols"


def _mla_qkv(params, x, cfg, positions):
    """Queries (nope and roped parts) of the heads ``params`` hold, the
    latent ``c_kv`` (B, S, r) and the roped shared key ``k_pe`` (B, S,
    dr).  Each weight is cast to the compute dtype at its use, as the
    reference casts it (a no-op on serving params, which
    :func:`repro_torch.models.transformer.prepare_params` cast once; the
    training layout's masters are float32).  Where the rank's block of
    q's columns cuts a head, ``x`` enters it and its product is gathered
    over ``model``: every head's query on every rank."""
    dh, dr = cfg.head_dim, cfg.rope_head_dim
    blk = params["q"].shape[1] < cfg.n_heads * (dh + dr)
    q = (enter_blocks(x) if blk else x) @ params["q"].to(x.dtype)
    if blk and _mla_split(params, cfg) == "cols":
        q = serving().gather(q, {-1: "model"})
    q = q.reshape(*x.shape[:-1], -1, dh + dr)
    q_nope, q_pe = q[..., :dh], q[..., dh:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
    c_kv = x @ params["dkv"].to(x.dtype)
    k_pe = apply_rope(x @ params["kpe"].to(x.dtype), positions,
                      cfg.rope_theta)
    return q_nope, q_pe, c_kv, k_pe


def _mla_expand(params, c_kv, cfg):
    """Per-head keys (nope part) and values from the latent rows, for the
    heads ``params`` hold; every head's where the rank's columns of uk and
    uv cut a head (their products gathered over ``model``, which the
    latent enters)."""
    dh = cfg.head_dim
    ct = c_kv.dtype
    cut = params["uk"].shape[1] < cfg.n_heads * dh and \
        _mla_split(params, cfg) == "cols"
    if cut:
        c_kv = enter_blocks(c_kv)
    k_nope = c_kv @ params["uk"].to(ct)
    v = c_kv @ params["uv"].to(ct)
    if cut:
        k_nope, v = serving().gather_last(k_nope, v)
    return (k_nope.reshape(*c_kv.shape[:-1], -1, dh),
            v.reshape(*c_kv.shape[:-1], -1, dh))


def _mla_qk(params, q_nope, q_pe, c_kv, k_pe, cfg):
    """(q, k, v): the queries and the expanded keys with the shared rope
    key broadcast over the heads; v from the latent.  On a mesh's block
    of whole heads the whole latent and rope key enter the rank's
    heads."""
    if _mla_split(params, cfg) == "heads":
        c_kv, k_pe = enter_blocks(c_kv), enter_blocks(k_pe)
    k_nope, v = _mla_expand(params, c_kv, cfg)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k_pe = k_pe[..., None, :].expand(*k_pe.shape[:-1], q.shape[-2],
                                     k_pe.shape[-1])
    return q, torch.cat([k_nope, k_pe], dim=-1), v


def _mla_o(params, out, cfg):
    """The o projection of the head outputs (..., H', dh)."""
    return _mla_o_rows(params, out.reshape(*out.shape[:-2], -1), cfg)


def _mla_o_rows(params, flat, cfg):
    """The o projection of head outputs flattened to (..., W).  On a mesh
    ``o`` holds a block of its rows (``("heads", None)``): each rank's
    product of its rows is a partial sum of the whole, summed over
    ``model`` in float32 (row parallel).  Where ``flat`` holds every
    head's output (blocks that cut a head) the rank takes the columns of
    its rows, which ``flat`` enters."""
    rows, whole = params["o"].shape[0], cfg.n_heads * cfg.head_dim
    if flat.shape[-1] > rows:
        r0 = serving().block("model", whole)[0]
        flat = enter_blocks(flat)[..., r0:r0 + rows]
    y = flat @ params["o"].to(flat.dtype)
    if rows < whole:
        y = serving().reduce_model(y.float()).to(y.dtype)
    return y


def _mla_forward(params, x, cfg, positions):
    """Full causal MLA forward. Returns (y, c_kv, k_pe) — the latent rows
    the decode cache stores (fused-prefill bulk write).  On a serving
    mesh the rank's heads attend and ``o`` sums their products."""
    dh, dr = cfg.head_dim, cfg.rope_head_dim
    q_nope, q_pe, c_kv, k_pe = _mla_qkv(params, x, cfg, positions)
    q, k, v = _mla_qk(params, q_nope, q_pe, c_kv, k_pe, cfg)
    scale = 1.0 / np.sqrt(dh + dr)
    if x.shape[1] > cfg.flash_block:
        out = _flash_attn(q, k, v, scale, cfg.flash_block)
    else:
        out = _causal_attn(q, k, v, scale)
    return _mla_o(params, out, cfg), c_kv, k_pe


def mla_apply(params, x, cfg, positions):
    return _mla_forward(params, x, cfg, positions)[0]


def mla_cache_specs():
    return {"ckv": ("batch", "kvseq", None), "kpe": ("batch", "kvseq", None)}


def mla_cache_init(cfg, batch: int, max_seq: int, dtype, device=None):
    """MLA caches the compressed latent and the rope key only: (r + dr)
    values per token.  Zeros, as :func:`gqa_cache_init`'s."""
    return {"ckv": torch.zeros((batch, max_seq, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "kpe": torch.zeros((batch, max_seq, cfg.rope_head_dim),
                               dtype=dtype, device=device)}


def mla_prefill(params, x, cfg, positions, max_seq: int):
    """Fused full-sequence MLA prefill: forward + bulk latent-cache write
    (the contract of :func:`gqa_prefill`; on a serving mesh the rank
    keeps its block of the cache's rows)."""
    y, c_kv, k_pe = _mla_forward(params, x, cfg, positions)
    cache = {"ckv": _pad_seq(c_kv, max_seq), "kpe": _pad_seq(k_pe, max_seq)}
    sh = serving()
    if sh is not None:
        specs = mla_cache_specs()
        cache = {n: sh.rules.sharding_for(specs[n], t.shape).take(t)
                 for n, t in cache.items()}
    return y, cache


def _mla_cache_attn(params, x, q_nope, q_pe, ckv_view, kpe_view, valid, cfg):
    """MLA attention of the heads ``params`` hold over full-length
    latent-cache views with a broadcastable validity mask ``valid``
    (B|1, S_q|1, V).  The latent views are expanded through ``uk``/``uv``
    over the whole view every step, as the reference does."""
    dh, dr = cfg.head_dim, cfg.rope_head_dim
    q, k, v = _mla_qk(params, q_nope, q_pe, ckv_view, kpe_view, cfg)
    scale = 1.0 / np.sqrt(dh + dr)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    scores = torch.where(valid[:, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    return _mla_o(params, torch.einsum("bhqk,bkhd->bqhd", probs, v), cfg)


def _mla_rows_attn(params, x, q_nope, q_pe, ckv_view, kpe_view, valid, cfg,
                   sh, axes):
    """:func:`_mla_cache_attn` where the latent views are this rank's
    block of rows (split over the mesh ``axes``) and ``params`` the
    rank's heads.  The rank's rows meet every head's query, but the rank
    holds ``uk``/``uv`` of its own heads only, and no weight moves: so
    each rank absorbs ``uk`` into its heads' queries (``q_nope · uk_h``
    lives in the latent space) and the absorbed and roped queries are
    gathered over ``model`` (where the rank's columns of ``uk`` cut a
    head, every head's query is whole and each rank's columns give a
    part of every absorbed query, summed over ``model``); the scores of
    the rank's rows run through a sharded softmax (each rank's maximum,
    sum of exponentials and latent rows weighted under it, float32,
    gathered over ``axes`` in one collective and rescaled to the largest
    maximum), and each rank takes its heads' (or columns') latent outputs
    through ``uv`` and its rows of ``o``, summed over ``model``."""
    h, dh, dr = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    ct = x.dtype
    r = params["uk"].shape[0]
    cols = _mla_split(params, cfg) == "cols" and \
        params["uk"].shape[1] < h * dh
    if cols:
        c0, c1 = sh.block("model", h * dh)
        # which head each of the rank's columns belongs to, one-hot (H, W)
        head = torch.arange(c0, c1, device=x.device) // dh
        onehot = (head == torch.arange(h, device=x.device)[:, None]).to(ct)
        q_lat = (q_nope.flatten(-2)[..., None, c0:c1] * onehot) \
            @ params["uk"].to(ct).t()                     # (B, S_q, H, r)
        q = torch.cat([sh.reduce_model(q_lat.float()).to(ct), q_pe], -1)
    else:
        held = q_nope.shape[-2]
        q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope,
                             params["uk"].to(ct).reshape(r, held, dh))
        q = torch.cat([q_lat, q_pe], dim=-1)              # (B, S_q, H', r+dr)
        if held < h:
            q = sh.gather_last(q.flatten(-2))[0].unflatten(-1, (h, r + dr))
    k = torch.cat([ckv_view, kpe_view], dim=-1)           # (B, V, r+dr)
    scale = 1.0 / np.sqrt(dh + dr)
    scores = torch.einsum("bqhc,bkc->bhqk", q, k).float() * scale
    scores = torch.where(valid[:, None], scores, -1e30)
    # each rank's maximum, sum of exponentials and weighted latent rows
    # under its own maximum, gathered in one collective and combined
    m = softmax_max(scores)
    p = torch.exp(scores - m[..., None])
    acc = torch.einsum("bhqk,bkr->bhqr", p, ckv_view.float())
    part = torch.cat([m[..., None], p.sum(dim=-1)[..., None], acc], dim=-1)
    part = sh.gather(part[None], {0: axes})               # (n, B, H, S_q, .)
    w = torch.exp(part[..., 0] - part[..., 0].amax(dim=0, keepdim=True))
    out = softmax_finish((part[..., 1] * w).sum(dim=0),
                         (part[..., 2:] * w[..., None]).sum(dim=0))
    if cols:
        # every head's latent output through the rank's columns of uv,
        # each column keeping its own head's
        vals = out.to(ct) @ params["uv"].to(ct)           # (B, S_q, H, W)
        return _mla_o_rows(params, (vals * onehot).sum(dim=-2), cfg)
    if held < h:
        h0 = sh.block("model", h)[0]
        out = out[..., h0:h0 + held, :]
    out = torch.einsum("bqhr,rhd->bqhd", out.to(ct),
                       params["uv"].to(ct).reshape(r, held, dh))
    return _mla_o(params, out, cfg)


def _mla_rows(paged: bool):
    """(serving shards, the mesh axes the contiguous latent cache's rows
    split over, and the first row of the rank's block) where it holds a
    block of rows, else (shards, None, None).  The latent leaves'
    ``("batch", "kvseq", None)`` resolve as a cache of one kv head does:
    over ``model`` under the decode rules, over the DP axes and ``model``
    under ``decode_long``."""
    sh = serving()
    if sh is None or sh.kv_split(paged, 1) != "rows":
        return sh, None, None
    axes = sh.rows_axes(paged, 1)
    return sh, axes, sh.block(axes, sh.max_seq)[0]


def mla_decode(params, x, cfg, cache, pos, pages=None):
    """One-token MLA decode step (the contract of :func:`gqa_decode`): the
    latent and rope-key rows are written in place at ``pos`` (through the
    page tables with ``pages``).  On a serving mesh whose cache holds a
    block of rows, the rank that owns ``pos`` writes it and the rows
    attend through :func:`_mla_rows_attn`; a cache that holds every row
    (the page pools) attends the rank's heads."""
    b = x.shape[0]
    if isinstance(pos, torch.Tensor):
        pos_b = pos.to(device=x.device, dtype=torch.int64).expand(b)
    else:
        pos_b = torch.full((b,), int(pos), dtype=torch.int64,
                           device=x.device)
    q_nope, q_pe, c_kv, k_pe = _mla_qkv(params, x, cfg, pos_b[:, None])
    sh, axes, lo = _mla_rows(pages is not None)
    if pages is None:
        at = pos - lo if lo else pos
        _cache_write(cache["ckv"], c_kv, at)
        _cache_write(cache["kpe"], k_pe, at)
        ckv_view, kpe_view = cache["ckv"], cache["kpe"]
    else:
        paged_write_rows(cache["ckv"], c_kv[:, 0], pages, pos_b)
        paged_write_rows(cache["kpe"], k_pe[:, 0], pages, pos_b)
        ckv_view = paged_view(cache["ckv"], pages)
        kpe_view = paged_view(cache["kpe"], pages)
    cols = torch.arange(ckv_view.shape[1], device=x.device)
    if lo:
        cols = cols + lo
    valid = cols[None, None, :] <= pos_b[:, None, None]
    if lo is not None:
        y = _mla_rows_attn(params, x, q_nope, q_pe, ckv_view, kpe_view,
                           valid, cfg, sh, axes)
    else:
        y = _mla_cache_attn(params, x, q_nope, q_pe, ckv_view, kpe_view,
                            valid, cfg)
    return y, cache


def mla_chunk_prefill(params, x, cfg, cache, pages, pos_start: int,
                      chunk_len: int):
    """Chunked MLA prefill over the PAGED latent cache — the MLA
    counterpart of :func:`gqa_chunk_prefill` (same contract: x (1, C, D),
    pages (1, n_blocks), padded rows sink to the null page).  On a serving
    mesh every rank holds every page and attends its heads."""
    b, c, _ = x.shape
    offs = int(pos_start) + torch.arange(c, device=x.device)
    q_nope, q_pe, c_kv, k_pe = _mla_qkv(params, x, cfg, offs.expand(b, c))
    paged_write_chunk(cache["ckv"], c_kv[0], pages[0], pos_start, chunk_len)
    paged_write_chunk(cache["kpe"], k_pe[0], pages[0], pos_start, chunk_len)
    ckv_view = paged_view(cache["ckv"], pages)
    kpe_view = paged_view(cache["kpe"], pages)
    valid = (torch.arange(ckv_view.shape[1], device=x.device)[None, None, :]
             <= offs[None, :, None])
    y = _mla_cache_attn(params, x, q_nope, q_pe, ckv_view, kpe_view, valid,
                        cfg)
    return y, cache
