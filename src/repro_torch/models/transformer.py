"""Decoder LM assembled from config-driven blocks: the attention-block
models of the reference's ``repro.models.transformer`` — GQA or MLA
attention (``cfg.use_mla``), each followed by an FFN or a MoE block
(``cfg.is_moe``), with a bf16 or an int8 KV cache.

The reference scans over stacked superblocks; here the stack is a Python
loop over ``params["layers"]``, one dict per layer (layer ``u·L + i`` is
block ``b{i}`` of unit ``u`` for a block pattern of length L), and the
decode cache is a list of per-layer dicts to match.

Entry points:
  :func:`forward` — full-sequence logits.
  :func:`prefill` + :func:`serve_step` + :func:`init_cache` — fused prompt
  prefill and one-token decode with the contiguous KV cache.
  :func:`init_paged_cache` + :func:`prefill_chunk` + :func:`serve_step`
  with ``pages=`` + :func:`copy_cache_page` — the paged KV layout: page
  pools, page-aligned chunked prefill, decode through page tables and the
  device half of copy-on-write.

The SSM/hybrid block kinds and the modality frontends are later slices
of the port.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from repro_torch.core.instrument import named_scope
from repro_torch.obs.sparsity import observe_site
from repro_torch.runtime.kvcache.layout import copy_page
from . import attention as A
from .common import (dtype_of, embedding_apply, embedding_init,
                     lm_head_apply, normal_init, resolve_device,
                     rmsnorm_apply, rmsnorm_init)
from .ffn import ffn_apply, ffn_init
from .moe import moe_apply, moe_init

#: leaves that every use casts to the compute dtype: the linear and packed
#: layers', the tables, MLA's bare weights and the MoE router
_COMPUTE_LEAVES = ("w", "b", "packed", "packed_p", "table",
                   "q", "dkv", "kpe", "uk", "uv", "o", "router")


def check_supported(cfg) -> None:
    if any(k != "attn" for k in cfg.block_pattern):
        raise NotImplementedError(
            f"{cfg.name}: block pattern {cfg.block_pattern} is not ported "
            "yet (only attention blocks)")
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: frontend {cfg.frontend!r} "
                                  "is not ported yet")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _block_scope(cfg, layer: int):
    """The reference's block scope ``b{i}_{kind}`` of layer ``u·L + i``,
    under a ``u{u}`` scope of its unit: the reference stages one unit as
    a scan body, the port runs every unit, and the linter counts each
    unit against the reference's one.  Inside it the realized-sparsity
    capture records under site ``b{i}`` and unit ``u``, so a probed
    step's layer keys are the reference's ``b{i}.<site>.u{u}``."""
    n = len(cfg.block_pattern)
    i, u = layer % n, layer // n
    with named_scope(f"u{u}/b{i}_{cfg.block_pattern[i]}"), \
            observe_site(f"b{i}", unit=u):
        yield


def _block_init(gen: torch.Generator, cfg):
    p = {"norm1": rmsnorm_init(cfg.d_model, gen.device),
         "mixer": (A.mla_init if cfg.use_mla else A.gqa_init)(gen, cfg),
         "norm2": rmsnorm_init(cfg.d_model, gen.device)}
    if cfg.is_moe:
        p["moe"] = moe_init(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                            cfg.n_shared_experts, cfg.act, cfg.ffn_sparsity)
    elif cfg.d_ff > 0:
        p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_sparsity,
                            cfg.act)
    return p


def _ffn_residual(params, x, cfg):
    """The block's second half: x + FFN or MoE of the normed x.  Returns
    (x, aux), aux the MoE's load-balancing loss (None without one)."""
    if "moe" in params:
        h = rmsnorm_apply(params["norm2"], x, cfg.norm_eps)
        h, aux = moe_apply(params["moe"], h, cfg, cfg.ffn_sparsity)
        return x + h, aux
    if "ffn" in params:
        h = rmsnorm_apply(params["norm2"], x, cfg.norm_eps)
        x = x + ffn_apply(params["ffn"], h, cfg.ffn_sparsity, cfg.act)
    return x, None


def _block_apply(params, x, cfg, positions):
    """Full-sequence forward. Returns (x, aux)."""
    h = rmsnorm_apply(params["norm1"], x, cfg.norm_eps)
    mixer = A.mla_apply if cfg.use_mla else A.gqa_apply
    x = x + mixer(params["mixer"], h, cfg, positions)
    return _ffn_residual(params, x, cfg)


def _block_prefill(params, x, cfg, positions, max_seq: int):
    h = rmsnorm_apply(params["norm1"], x, cfg.norm_eps)
    pre = A.mla_prefill if cfg.use_mla else A.gqa_prefill
    h, cache = pre(params["mixer"], h, cfg, positions, max_seq)
    return _ffn_residual(params, x + h, cfg)[0], cache


def _block_decode(params, x, cfg, cache, pos, pages=None):
    h = rmsnorm_apply(params["norm1"], x, cfg.norm_eps)
    dec = A.mla_decode if cfg.use_mla else A.gqa_decode
    h, cache = dec(params["mixer"], h, cfg, cache, pos, pages=pages)
    return _ffn_residual(params, x + h, cfg)[0], cache


def _block_chunk_prefill(params, x, cfg, cache, pages, pos_start: int,
                         chunk_len: int):
    """Chunked-prefill step of one block over the paged cache.
    Returns (x, cache)."""
    h = rmsnorm_apply(params["norm1"], x, cfg.norm_eps)
    pre = A.mla_chunk_prefill if cfg.use_mla else A.gqa_chunk_prefill
    h, cache = pre(params["mixer"], h, cfg, cache, pages, pos_start,
                   chunk_len)
    return _ffn_residual(params, x + h, cfg)[0], cache


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------

def prepare_params(params: Dict, cfg) -> Dict:
    """Cast every weight to the compute dtype, once.

    Each use in the reference casts its weight to the compute dtype, so
    the values are the same; storing them cast saves a copy of every
    weight at every step.  Norm scales stay float32, as they are used.
    """
    ct = dtype_of(cfg.compute_dtype)

    def cast(tree):
        return {k: (cast(v) if isinstance(v, dict) else
                    [cast(x) for x in v] if isinstance(v, list) else
                    v.to(ct) if k in _COMPUTE_LEAVES else v)
                for k, v in tree.items()}

    return cast(params)


def init_model(cfg, seed: int = 0, device=None) -> Dict:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``,
    drawn from the reference's distributions (uniform ±1/sqrt(fan-in) for
    dense, ±sqrt(N/D_in) for packed, normal(0.02) for tables), with the
    reference's numpy routes.  Runs on ``cuda`` unless ``device`` says
    otherwise."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = {"embed": embedding_init(gen, cfg.padded_vocab, cfg.d_model),
              "layers": [_block_init(gen, cfg) for _ in range(cfg.n_layers)],
              "final_norm": rmsnorm_init(cfg.d_model, device)}
    if not cfg.tie_embeddings:
        params["head"] = {"table": normal_init(
            gen, (cfg.padded_vocab, cfg.d_model), 0.02)}
    return prepare_params(params, cfg)


def param_count(params) -> int:
    """Parameters of the reference's layout (the partition-major copies
    of the packed weights are not counted)."""
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for k, v in tree.items() if k != "packed_p")
        if isinstance(tree, list):
            return sum(count(v) for v in tree)
        return tree.numel()
    return count(params)


# ---------------------------------------------------------------------------
# Forward / serving
# ---------------------------------------------------------------------------

def _embed(params, tokens, ct):
    return embedding_apply(params["embed"], tokens, ct)


def _logits(params, x, cfg, ct):
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return lm_head_apply(head, x, ct)


def forward(params, batch, cfg):
    """Full-sequence forward. Returns (logits, aux_loss), aux_loss the sum
    of every MoE block's load-balancing loss (0 without MoE)."""
    check_supported(cfg)
    ct = dtype_of(cfg.compute_dtype)
    x = _embed(params, batch["tokens"], ct)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j, layer in enumerate(params["layers"]):
        with _block_scope(cfg, j):
            x, a = _block_apply(layer, x, cfg, positions)
        if a is not None:
            aux = aux + a
    return _logits(params, x, cfg, ct), aux


def init_cache(cfg, batch: int, max_seq: int, device=None) -> List[Dict]:
    """One contiguous cache per layer: K/V rows in the compute dtype (int8
    rows and f32 scales with ``kv_cache_dtype="int8"``), or MLA's latent
    and rope-key rows."""
    check_supported(cfg)
    ct = dtype_of(cfg.compute_dtype)
    init = A.mla_cache_init if cfg.use_mla else A.gqa_cache_init
    return [init(cfg, batch, max_seq, ct, device)
            for _ in range(cfg.n_layers)]


def init_paged_cache(cfg, n_pages: int, page_size: int,
                     device=None) -> List[Dict]:
    """One PAGED cache per layer: every attention leaf is a page pool
    ``(n_pages, page_size, ...)`` addressed through the per-slot page
    tables that :func:`serve_step` / :func:`prefill_chunk` take as
    ``pages`` (see :mod:`repro_torch.runtime.kvcache`).

    Attention-only block patterns: the paged layout pages per-position
    KV rows, and SSM decode state is O(1) with nothing to page."""
    if not supports_fused_prefill(cfg):
        raise NotImplementedError(
            "paged KV layout requires an attention-only block pattern, "
            f"got {cfg.block_pattern}")
    return init_cache(cfg, n_pages, page_size, device)


def copy_cache_page(cache: List[Dict], src: int, dst: int) -> List[Dict]:
    """Copy physical page ``src``'s rows over page ``dst`` in every pool
    leaf of an :func:`init_paged_cache` cache, in place — the device half
    of a copy-on-write break (the allocator already swapped ``dst`` into
    the writer's chain; this puts the shared rows there before the
    writer's next scatter lands)."""
    for layer in cache:
        for leaf in layer.values():
            copy_page(leaf, src, dst)
    return cache


def supports_fused_prefill(cfg) -> bool:
    """Fused bulk-cache prefill exists for attention blocks; SSM/hybrid
    patterns would fall back to stepwise prefill (their decode state is
    the *final* recurrence state, not per-position rows)."""
    return all(k in ("attn", "shared_attn") for k in cfg.block_pattern)


def prefill(params, batch, cfg, max_seq: int):
    """Fused full-sequence prefill: ONE forward over the prompt (B, S) that
    writes every layer's KV cache in bulk — rows [0, S) of a cache padded
    to ``max_seq`` (rows >= S are overwritten by decode before any read).

    Returns (logits (B, S, vocab), cache) with the :func:`init_cache`
    layout."""
    check_supported(cfg)
    ct = dtype_of(cfg.compute_dtype)
    x = _embed(params, batch["tokens"], ct)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    cache = []
    for j, layer in enumerate(params["layers"]):
        with _block_scope(cfg, j):
            x, c = _block_prefill(layer, x, cfg, positions, max_seq)
        cache.append(c)
    return _logits(params, x, cfg, ct), cache


def serve_step(params, cache, batch, pos, cfg, pages=None):
    """Decode one token given caches of past state.

    batch: {"tokens": (B, 1)}.  pos: int position (static batch) or (B,)
    tensor of per-slot positions (continuous batching).  pages: optional
    (B, n_blocks) int64 per-slot page tables — the cache is then the
    :func:`init_paged_cache` pools and every attention read/write goes
    through the page indirection (same math, same mask).  The cache is
    updated in place.  Returns (logits (B, vocab), cache).

    Sparse-sparse decode runs the fused pipeline per layer: the FFN's
    k-WTA output (or support) goes straight to the down projection, which
    contracts the whole decode batch in one ``topk_gather`` launch when
    the executor (``cfg.ffn_sparsity.use_pallas``) engages the kernel.
    """
    check_supported(cfg)
    ct = dtype_of(cfg.compute_dtype)
    x = _embed(params, batch["tokens"], ct)
    for j, (layer, c) in enumerate(zip(params["layers"], cache,
                                       strict=True)):
        with _block_scope(cfg, j):
            x, _ = _block_decode(layer, x, cfg, c, pos, pages)
    return _logits(params, x, cfg, ct)[:, 0], cache


def prefill_chunk(params, cache, batch, pos_start: int, chunk_len: int, cfg,
                  pages):
    """Forward ONE page-aligned prompt chunk of ONE slot through every
    layer, scattering its KV rows into the slot's page chains in place
    (the paged layout's incremental prefill — long prompts run as a
    sequence of these interleaved with decode steps instead of one
    :func:`prefill` call).

    batch: {"tokens": (1, C)}; pages: (1, n_blocks) int64 — the
    prefilling slot's page table; rows past ``chunk_len`` are bucket
    padding: their KV sinks to the null page and their logits are
    garbage the engine ignores.
    Returns (logits (1, C, vocab), cache)."""
    check_supported(cfg)
    ct = dtype_of(cfg.compute_dtype)
    x = _embed(params, batch["tokens"], ct)
    for j, (layer, c) in enumerate(zip(params["layers"], cache,
                                       strict=True)):
        with _block_scope(cfg, j):
            x, _ = _block_chunk_prefill(layer, x, cfg, c, pages, pos_start,
                                        chunk_len)
    return _logits(params, x, cfg, ct), cache
