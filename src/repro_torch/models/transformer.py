"""Decoder LM assembled from config-driven blocks — the reference's
``repro.models.transformer``.

Block kinds (``cfg.block_pattern``):
  attn        — GQA or MLA attention (``cfg.use_mla``) + FFN or MoE
                (``cfg.is_moe``), pre-norm, with a bf16 or an int8 KV cache.
  mamba2      — Mamba-2 mixer (chunked SSD), :mod:`.ssm`.
  mlstm/slstm — xLSTM mixers, :mod:`.ssm`.
  shared_attn — weight-shared attention + FFN block (zamba2): one set of
                weights in ``params["shared"]``, used at every invocation,
                each invocation with its own KV cache.

The reference scans over stacked superblocks; here the stack is a Python
loop over ``params["layers"]``, one dict per layer (layer ``u·L + i`` is
block ``b{i}`` of unit ``u`` for a block pattern of length L; a
``shared_attn`` layer's dict is empty, as the reference's units skip it),
and the decode cache is a list of per-layer dicts to match: K/V rows for
attention, the O(1) recurrent state for the SSM kinds.

Frontends (``cfg.frontend``): ``embed`` takes precomputed ``embeds``
(B, S, D) in place of tokens; ``vision_prefix`` prefixes ``patch_embeds``
(B, n_prefix, D) to the token embeddings, and the loss reads the text
positions only.

Entry points:
  :func:`forward` — full-sequence logits; :func:`loss_fn` — the training
  loss, on params in the training layout (:func:`init_train_params`;
  :func:`serving_params` turns them into serving params);
  :func:`unit_step_fn` — one unit's forward, for the cost accounting.
  :func:`prefill` + :func:`serve_step` + :func:`init_cache` — fused prompt
  prefill (attention-only patterns; SSM/hybrid patterns prefill stepwise
  through :func:`serve_step`) and one-token decode with the contiguous
  cache.
  :func:`init_paged_cache` + :func:`prefill_chunk` + :func:`serve_step`
  with ``pages=`` + :func:`copy_cache_page` — the paged KV layout
  (attention-only patterns): page pools, page-aligned chunked prefill,
  decode through page tables and the device half of copy-on-write.

On a serving mesh (:mod:`repro_torch.sharding.serving`, installed by the
engine) the serving entry points run on the rank's blocks:
:func:`param_blocks` cuts whole params to them (:func:`check_blocks`
refuses what they cannot compute; :func:`add_block_routes`), ``init_cache`` and
``init_paged_cache`` with ``rules`` make the rank's cache blocks; the
lookup is vocab-parallel, a decode step on the contiguous cache computes
the rank's slots (where they shard over the DP axes), and the logits come
back whole on every rank.  Under a training step's shards
(:func:`repro_torch.launch.steps.sharded_value_and_grad`) :func:`loss_fn`
runs the same forward on the rank's param blocks through autograd and
takes the vocab-parallel loss of its block of the logits; remat's
recompute re-enters those shards.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.api import pause_dispatch
from repro_torch.core.instrument import named_scope, pause_selects
from repro_torch.core.layers import (add_partition_major, block_route,
                                     drop_partition_major)
from repro_torch.sharding.context import (UnitSpec, get_rules, map_specs,
                                          param_sharding, use_rules)
from repro_torch.sharding.serving import enter_blocks, serving, use_serving
from repro_torch.obs.sparsity import observe_site, pause_capture
from repro_torch.runtime.kvcache.layout import copy_page
from repro_torch.tree import map_tree
from . import attention as A
from . import ssm as S
from .common import (cross_entropy, dtype_of, embedding_apply,
                     embedding_block_apply, embedding_init,
                     embedding_specs, lm_head_apply,
                     normal_init, resolve_device, rmsnorm_apply,
                     rmsnorm_init, rmsnorm_specs)
from .ffn import ffn_apply, ffn_init, ffn_specs
from .moe import moe_apply, moe_init, moe_specs

#: leaves that every use casts to the compute dtype: the linear and packed
#: layers', the tables, MLA's bare weights and the MoE router (the SSM
#: mixers' are :data:`repro_torch.models.ssm.COMPUTE_LEAVES`)
_COMPUTE_LEAVES = ("w", "b", "packed", "packed_p", "table",
                   "q", "dkv", "kpe", "uk", "uv", "o", "router")
#: the block kinds with attention (and a KV cache)
ATTN_KINDS = ("attn", "shared_attn")


def check_supported(cfg) -> None:
    """Raise for a block kind the reference does not know, as its
    ``_block_init`` does."""
    for kind in cfg.block_pattern:
        if kind not in ATTN_KINDS and kind not in S.MIXERS:
            raise ValueError(f"unknown block kind {kind}")


def layer_kinds(cfg) -> List[str]:
    """The block kind of every layer, ``u·L + i`` -> ``block_pattern[i]``."""
    return list(cfg.block_pattern) * cfg.n_units


def _layers(params, cfg):
    """(kind, params) of every layer: a ``shared_attn`` layer's are
    ``params["shared"]``."""
    return [(kind, params["shared"] if kind == "shared_attn" else p)
            for kind, p in zip(layer_kinds(cfg), params["layers"],
                               strict=True)]


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


def _block_init(kind: str, gen: torch.Generator, cfg):
    if kind not in ATTN_KINDS:
        return {"norm": rmsnorm_init(cfg.d_model, gen.device),
                "mixer": S.MIXERS[kind].init(gen, cfg)}
    p = {"norm1": rmsnorm_init(cfg.d_model, gen.device),
         "mixer": (A.mla_init if cfg.use_mla else A.gqa_init)(gen, cfg),
         "norm2": rmsnorm_init(cfg.d_model, gen.device)}
    if cfg.is_moe and kind == "attn":
        p["moe"] = moe_init(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                            cfg.n_shared_experts, cfg.act, cfg.ffn_sparsity)
    elif cfg.d_ff > 0:
        p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_sparsity,
                            cfg.act)
    return p


def _block_specs(kind: str, cfg):
    """The reference's logical specs of :func:`_block_init`'s params."""
    if kind not in ATTN_KINDS:
        return {"norm": rmsnorm_specs(), "mixer": S.MIXERS[kind].specs(cfg)}
    s = {"norm1": rmsnorm_specs(),
         "mixer": A.mla_specs(cfg) if cfg.use_mla else A.gqa_specs(cfg),
         "norm2": rmsnorm_specs()}
    if cfg.is_moe and kind == "attn":
        s["moe"] = moe_specs(cfg.d_model, cfg.d_ff, cfg.n_shared_experts,
                             cfg.act, cfg.ffn_sparsity)
    elif cfg.d_ff > 0:
        s["ffn"] = ffn_specs(cfg.d_model, cfg.d_ff, cfg.ffn_sparsity, cfg.act)
    return s


def _stacked(unit_specs):
    """Specs of a stacked unit tree: the (never sharded) unit axis first."""
    return map_specs(lambda sp: (None,) + tuple(sp), unit_specs)


def param_specs(cfg) -> Dict:
    """The logical-spec tree of the reference's ``init_model(key,
    cfg)[1]``, leaf for leaf: the reference's layout, whose ``units``
    stack the layers of every block ``b{i}`` on a leading unit axis
    (:func:`layer_specs` gives the port's per-layer layout)."""
    check_supported(cfg)
    specs = {"embed": embedding_specs()}
    if "shared_attn" in cfg.block_pattern:
        specs["shared"] = _block_specs("shared_attn", cfg)
    specs["units"] = _stacked({
        f"b{i}": _block_specs(kind, cfg)
        for i, kind in enumerate(cfg.block_pattern) if kind != "shared_attn"})
    specs["final_norm"] = rmsnorm_specs()
    if not cfg.tie_embeddings:
        specs["head"] = {"table": ("vocab", "embed")}
    return specs


def layer_specs(specs: Dict, cfg) -> Dict:
    """A tree of the reference's layout (:func:`param_specs`, or specs
    made from it such as ZeRO-1's) in the port's training layout: layer
    ``u·L + i`` holds ``units["b{i}"]``'s specs as
    :class:`repro_torch.sharding.UnitSpec` of unit u; a ``shared_attn``
    layer is an empty dict."""
    n, units = len(cfg.block_pattern), specs["units"]
    layers = [{} if kind == "shared_attn" else
              map_specs(lambda sp, u=j // n: UnitSpec(sp, u, cfg.n_units),
                        units[f"b{j % n}"])
              for j, kind in enumerate(layer_kinds(cfg))]
    out = {k: v for k, v in specs.items() if k != "units"}
    out["layers"] = layers
    return out


def cache_specs(cfg, paged: bool = False) -> Dict:
    """The logical-spec tree of the reference's ``init_cache(cfg, batch,
    max_seq)[1]`` (the unit axis first); with ``paged``, of its
    ``init_paged_cache``, whose pool axes replicate (page ids stay
    global)."""
    def block(kind):
        if kind not in ATTN_KINDS:
            return S.MIXERS[kind].cache_specs()
        return A.mla_cache_specs() if cfg.use_mla else A.gqa_cache_specs(cfg)
    blocks = {f"b{i}": block(kind) for i, kind in enumerate(cfg.block_pattern)}
    if paged:
        blocks = map_specs(lambda sp: (None, None) + tuple(sp)[2:], blocks)
    return _stacked(blocks)


def layer_cache_specs(cfg, paged: bool = False) -> List:
    """:func:`cache_specs` in the port's per-layer cache layout (every
    ``shared_attn`` invocation has its own cache)."""
    units, n = cache_specs(cfg, paged), len(cfg.block_pattern)
    return [map_specs(lambda sp, u=j // n: UnitSpec(sp, u, cfg.n_units),
                      units[f"b{j % n}"]) for j in range(cfg.n_layers)]


def check_blocks(blocks, whole):
    """Raise where a rank's blocks of whole params cannot compute as the
    reference's partitioning does: a packed layer whose bias is cut at
    other columns than its groups (a padded layer, whose groups hold more
    columns than the bias).  No shipped model reaches it: only the GSC
    CNN's packed layers carry a bias, and no mesh runs that model
    (ROADMAP, Queue 3)."""
    if isinstance(blocks, list):
        for b, w in zip(blocks, whole):
            check_blocks(b, w)
        return
    if not isinstance(blocks, dict):
        return
    if "packed" in blocks and blocks["packed"].ndim == 3 and \
            blocks["packed"].shape[0] < whole["packed"].shape[0]:
        g, n = whole["packed"].shape[0], whole["packed"].shape[2]
        if "b" in whole and whole["b"].shape[0] != g * n:
            raise NotImplementedError("a padded packed layer's bias cut "
                                      "beside its groups")
    for k, v in blocks.items():
        if isinstance(v, (dict, list)):
            check_blocks(v, whole[k])


def add_block_routes(blocks, whole, shardings):
    """``blocks`` (a rank's blocks of the ``whole`` params, cut by
    ``shardings``) where every packed layer or stack of routed experts
    cut to a block of its groups beside a route of several tables kept
    whole also holds ``block_route``, the route of its own groups
    (:func:`repro_torch.core.layers.block_route`), made here once."""
    if isinstance(blocks, list):
        return [add_block_routes(b, w, s)
                for b, w, s in zip(blocks, whole, shardings)]
    if not isinstance(blocks, dict):
        return blocks
    out = {k: add_block_routes(v, whole[k], shardings[k])
           for k, v in blocks.items()}
    if "packed" in blocks:
        dim = blocks["packed"].ndim - 3       # the groups: (E,) G, P, N
        g, route = whole["packed"].shape[dim], blocks["route"]
        if blocks["packed"].shape[dim] < g and \
                1 < route.shape[0] == whole["route"].shape[0]:
            span = shardings["packed"].block(whole["packed"].shape)[dim]
            out["block_route"] = block_route(route, g, span.start,
                                             span.stop)
    return out


def drop_block_routes(tree):
    """The tree without its ``block_route`` leaves: the reference's
    layout of a rank's blocks."""
    if isinstance(tree, dict):
        return {k: drop_block_routes(v) for k, v in tree.items()
                if k != "block_route"}
    if isinstance(tree, list):
        return [drop_block_routes(v) for v in tree]
    return tree


def keep_block_routes(tree, src):
    """``tree`` (the reference's layout) with the ``block_route`` leaves
    of ``src``, a tree of the same layout that holds them."""
    if isinstance(tree, dict):
        out = {k: keep_block_routes(v, src[k]) for k, v in tree.items()}
        if "block_route" in src:
            out["block_route"] = src["block_route"]
        return out
    if isinstance(tree, list):
        return [keep_block_routes(v, w) for v, w in zip(tree, src)]
    return tree


def _blocks_of(piece, specs, rules):
    """This rank's blocks of a whole serving-params piece (a dict, a list
    of layers, or the whole tree) under its specs, each packed layer's
    ``packed_p`` made anew from its block and its ``block_route`` where
    it needs one."""
    whole = drop_partition_major(piece)
    shardings = param_sharding(specs, whole, rules)
    blocks = map_tree(lambda sh, t: sh.take(t), shardings, whole)
    check_blocks(blocks, whole)
    return add_partition_major(add_block_routes(blocks, whole, shardings))


@torch.no_grad()
def param_blocks(params: Dict, cfg, rules) -> Dict:
    """This rank's blocks of whole serving params under ``rules``: every
    leaf of the reference's layout cut by its spec (:func:`param_specs`),
    each packed layer's ``packed_p`` made anew from its block."""
    return _blocks_of(params, layer_specs(param_specs(cfg), cfg), rules)


def _cache_blocks(full: List[Dict], cfg, rules, paged: bool, device):
    """Zeros of this rank's blocks of a cache whose leaves are ``full``'s
    (shapes only: meta tensors)."""
    shardings = param_sharding(layer_cache_specs(cfg, paged), full, rules)
    return map_tree(lambda sh, t: torch.zeros(sh.local_shape(t.shape),
                                              dtype=t.dtype, device=device),
                    shardings, full)


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


def _block_apply(kind: str, params, x, cfg, positions):
    """Full-sequence forward. Returns (x, aux)."""
    if kind not in ATTN_KINDS:
        h = rmsnorm_apply(params["norm"], x, cfg.norm_eps)
        return x + S.MIXERS[kind].apply(params["mixer"], h, cfg), None
    h = rmsnorm_apply(params["norm1"], x, cfg.norm_eps)
    mixer = A.mla_apply if cfg.use_mla else A.gqa_apply
    x = x + mixer(params["mixer"], h, cfg, positions)
    return _ffn_residual(params, x, cfg)


def _block_prefill(params, x, cfg, positions, max_seq: int):
    h = rmsnorm_apply(params["norm1"], x, cfg.norm_eps)
    pre = A.mla_prefill if cfg.use_mla else A.gqa_prefill
    h, cache = pre(params["mixer"], h, cfg, positions, max_seq)
    return _ffn_residual(params, x + h, cfg)[0], cache


def _block_decode(kind: str, params, x, cfg, cache, pos, pages=None):
    """One-token step; the cache is updated in place.  ``pages`` (the
    paged KV layout's per-slot page table) is attention-only: SSM blocks
    keep O(1) recurrence state and have no per-position rows to page."""
    if kind not in ATTN_KINDS:
        if pages is not None:
            raise NotImplementedError(
                f"paged KV layout not implemented for block kind {kind!r} "
                "(SSM decode state has no sequence axis to page)")
        h = rmsnorm_apply(params["norm"], x, cfg.norm_eps)
        h, new = S.MIXERS[kind].decode(params["mixer"], h, cfg, cache, pos)
        for name, leaf in new.items():
            cache[name].copy_(leaf)
        return x + h
    h = rmsnorm_apply(params["norm1"], x, cfg.norm_eps)
    dec = A.mla_decode if cfg.use_mla else A.gqa_decode
    h, _ = dec(params["mixer"], h, cfg, cache, pos, pages=pages)
    return _ffn_residual(params, x + h, cfg)[0]


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

def _cast(tree, names, ct):
    return {k: (_cast(v, names, ct) if isinstance(v, dict) else
                [_cast(x, names, ct) for x in v] if isinstance(v, list) else
                v.to(ct) if k in names else v)
            for k, v in tree.items()}


def _compute_leaves(kind: str):
    """The leaf names a layer of ``kind`` casts to the compute dtype."""
    return _COMPUTE_LEAVES if kind in ATTN_KINDS else S.COMPUTE_LEAVES


def prepare_params(params: Dict, cfg) -> Dict:
    """Cast every weight to the compute dtype, once.

    Each use in the reference casts its weight to the compute dtype, so
    the values are the same; storing them cast saves a copy of every
    weight at every step.  Norm scales stay float32, as they are used,
    and so do the SSM mixers' leaves that enter in float32 (``A_log``,
    ``dt_bias``, ``gate_b``, sLSTM's ``b``): each kind's leaves are cast
    by that kind's rule.
    """
    ct = dtype_of(cfg.compute_dtype)
    layers = [_cast(p, _compute_leaves(kind), ct)
              for kind, p in zip(layer_kinds(cfg), params["layers"],
                                 strict=True)]
    return {k: layers if k == "layers" else
            _cast(v, _COMPUTE_LEAVES, ct) if isinstance(v, dict) else v
            for k, v in params.items()}


def _init_params(cfg, seed: int, device, keep=None) -> Dict:
    """The reference's random weights.  ``keep(path, piece)``, where
    given, takes each top-level piece (``("embed",)``, ``("layers", j)``,
    ...) as soon as it is drawn and returns what the tree holds of it."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    keep = keep or (lambda path, piece: piece)
    params = {"embed": keep(("embed",), embedding_init(gen, cfg.padded_vocab,
                                                       cfg.d_model))}
    if "shared_attn" in cfg.block_pattern:
        params["shared"] = keep(("shared",),
                                _block_init("shared_attn", gen, cfg))
    # a shared_attn layer's weights live in params["shared"]
    params["layers"] = [keep(("layers", j), {} if kind == "shared_attn" else
                             _block_init(kind, gen, cfg))
                        for j, kind in enumerate(layer_kinds(cfg))]
    params["final_norm"] = keep(("final_norm",),
                                rmsnorm_init(cfg.d_model, device))
    if not cfg.tie_embeddings:
        params["head"] = keep(("head",), {"table": normal_init(
            gen, (cfg.padded_vocab, cfg.d_model), 0.02)})
    return params


def init_model(cfg, seed: int = 0, device=None, rules=None) -> Dict:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``,
    drawn from the reference's distributions (uniform ±1/sqrt(fan-in) for
    dense, ±sqrt(N/D_in) for packed, normal(0.02) for tables), with the
    reference's numpy routes, in the serving layout
    (:func:`prepare_params`).  Runs on ``cuda`` unless ``device`` says
    otherwise.

    With ``rules`` (a serving mesh's), this rank's blocks of those weights
    (:func:`param_blocks` of them), each layer cut as soon as it is drawn:
    the whole tree is never held at once."""
    if rules is None:
        return prepare_params(_init_params(cfg, seed, device), cfg)
    ct = dtype_of(cfg.compute_dtype)
    specs, kinds = layer_specs(param_specs(cfg), cfg), layer_kinds(cfg)

    @torch.no_grad()
    def keep(path, piece):
        spec = specs
        for k in path:
            spec = spec[k]
        names = (_compute_leaves(kinds[path[1]]) if path[0] == "layers"
                 else _COMPUTE_LEAVES)
        return _blocks_of(_cast(piece, names, ct), spec, rules)

    return _init_params(cfg, seed, device, keep)


def init_train_params(cfg, seed: int = 0, device=None) -> Dict:
    """The weights of :func:`init_model` (same seed, same values) in the
    training layout: master weights in ``param_dtype`` (float32), cast to
    the compute dtype at each use as the reference does, and no
    ``packed_p`` (a derived copy the optimizer would move apart from
    ``packed``).  Runs on ``cuda`` unless ``device`` says otherwise."""
    pt = dtype_of(cfg.param_dtype)
    return map_tree(lambda t: t.to(pt) if t.is_floating_point() else t,
                    drop_partition_major(_init_params(cfg, seed, device)))


@torch.no_grad()
def serving_params(params: Dict, cfg) -> Dict:
    """Serving params from training-layout ones (trained or bridged): a
    copy, with every packed linear layer's ``packed_p`` made from its
    ``packed`` now and every weight cast to the compute dtype
    (:func:`prepare_params`).  Training on after this call does not reach
    the copy."""
    copied = map_tree(lambda t: t.detach().clone(), params)
    return prepare_params(add_partition_major(copied), cfg)


def param_count(params) -> int:
    """Parameters of the reference's layout (the partition-major copies
    of the packed weights and a block's ``block_route`` are not
    counted)."""
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for k, v in tree.items()
                       if k not in ("packed_p", "block_route"))
        if isinstance(tree, list):
            return sum(count(v) for v in tree)
        return tree.numel()
    return count(params)


# ---------------------------------------------------------------------------
# Forward / serving
# ---------------------------------------------------------------------------

def _embed(params, batch, cfg, ct):
    """Token or frontend embedding of a decode or chunk batch: precomputed
    ``embeds`` for the ``embed`` frontend, else the tokens' rows (on a
    serving mesh from the rank's block of the vocabulary, summed over
    ``model``)."""
    if cfg.frontend == "embed":
        return batch["embeds"].to(ct)
    table, sh = params["embed"]["table"], serving()
    vocab = None if sh is None else sh.vocab(cfg.padded_vocab, table.shape[0])
    if vocab is None:
        return embedding_apply(params["embed"], batch["tokens"], ct)
    return sh.reduce_model(embedding_block_apply(table, batch["tokens"], ct,
                                                 vocab[0]))


def _embed_inputs(params, batch, cfg, ct):
    """The full-sequence inputs: :func:`_embed`, with ``vision_prefix``'s
    ``patch_embeds`` (B, n_prefix, D) before the tokens."""
    x = _embed(params, batch, cfg, ct)
    if cfg.frontend == "vision_prefix":
        x = torch.cat([batch["patch_embeds"].to(ct), x], dim=1)
    return x


def _logits(params, x, cfg, ct, rows_split: bool = False,
            blocks: bool = False):
    """The logits of ``x``; on a mesh the head's block of vocabulary rows
    gives a block of their columns (the normed ``x`` enters it: its
    gradient sums over ``model``), gathered whole over ``model`` and, with
    ``rows_split``, from the rank's rows of the batch (over the DP axes),
    in one collective; with ``blocks`` the block itself (a training
    step's vocab-parallel loss reads it)."""
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    sh = serving()
    vocab = None if sh is None else sh.vocab(cfg.padded_vocab,
                                             head["table"].shape[0])
    logits = lm_head_apply(head, x if vocab is None else enter_blocks(x), ct)
    if sh is None or blocks:
        return logits
    dims = {0: sh.dp} if rows_split else {}
    if vocab is not None:
        dims[-1] = "model"
    return sh.gather(logits, dims)


@contextlib.contextmanager
def _recompute(rules, shards):
    """The context of a block's recompute in the backward: the sharding
    rules and serving shards in force when the block first ran (on the
    card autograd runs the backward on its device thread, whose
    thread-locals hold neither), with this thread's Select counters,
    support capture and dispatch observers paused, so a step counts each
    block once, as the reference, which traces a block once, does."""
    with use_rules(rules), use_serving(shards), pause_selects(), \
            pause_capture(), pause_dispatch():
        yield


def _remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint`` of a block): its activations are not kept for the
    backward, which runs it again under :func:`_recompute`.  The first
    call of ``run`` is the forward, any later one the recompute
    (checkpoint's ``context_fn`` would say so too, but under ``make_fx``,
    as the linter traces a training step, it takes only dispatch
    modes)."""
    rules, shards = get_rules(), serving()
    state = {"forward": True}

    def run(*a):
        if state.pop("forward", False):
            return fn(*a)
        with _recompute(rules, shards):
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False)


def forward(params, batch, cfg, vocab_blocks: bool = False):
    """Full-sequence forward. batch: ``tokens`` (B, S), or ``embeds`` (B,
    S, D) for the ``embed`` frontend, with ``patch_embeds`` for
    ``vision_prefix``.  Returns (logits, aux_loss), aux_loss the sum of
    every MoE block's load-balancing loss (0 without MoE).

    With ``cfg.remat``, where autograd records, each block runs under
    :func:`_remat`: the backward keeps each block's input and recomputes
    one block at a time.

    On a mesh (:func:`serving`) it runs on the rank's blocks; the logits
    come back whole, or with ``vocab_blocks`` as the rank's block of the
    vocabulary's columns (:func:`loss_fn`)."""
    ct = dtype_of(cfg.compute_dtype)
    x = _embed_inputs(params, batch, cfg, ct)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for j, (kind, layer) in enumerate(_layers(params, cfg)):
        with _block_scope(cfg, j):
            if remat:
                x, a = _remat(_block_apply, kind, layer, x, cfg, positions)
            else:
                x, a = _block_apply(kind, layer, x, cfg, positions)
        if a is not None:
            aux = aux + a
    return _logits(params, x, cfg, ct, blocks=vocab_blocks), aux


def unit_step_fn(cfg):
    """A single-superblock forward for per-unit cost accounting (the
    reference's ``unit_step_fn``): ``fn(unit_params, shared, x,
    positions)`` runs blocks ``b0..b{L-1}`` of one unit, ``unit_params``
    ``{"b{i}": layer params}`` (a ``shared_attn`` block reads ``shared``),
    and returns (x, aux), aux the MoE load-balancing loss summed."""

    def fn(unit_params, shared, x, positions):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, kind in enumerate(cfg.block_pattern):
            p = shared if kind == "shared_attn" else unit_params[f"b{i}"]
            with named_scope(f"b{i}_{kind}"):
                x, a = _block_apply(kind, p, x, cfg, positions)
            if a is not None:
                aux = aux + a
        return x, aux

    return fn


def loss_fn(params, batch, cfg):
    """Next-token LM loss: the cross-entropy of ``logits[:, :-1]`` against
    ``labels[:, 1:]`` (over the text positions, after a vision prefix)
    plus ``router_aux_weight`` times the MoE aux loss.
    Returns (loss, {"loss", "lm_loss", "aux_loss"}).

    On a mesh (a training step's :func:`serving` shards) the loss is
    vocab-parallel: the logits stay the rank's block of the vocabulary."""
    logits, aux = forward(params, batch, cfg, vocab_blocks=True)
    if cfg.frontend == "vision_prefix":
        # logits cover [prefix + text]; predict text tokens only
        logits = logits[:, batch["patch_embeds"].shape[1]:]
    sh = serving()
    vocab = None if sh is None else sh.vocab(cfg.padded_vocab,
                                             logits.shape[-1])
    lm = cross_entropy(logits[:, :-1], batch["labels"][:, 1:], vocab=vocab)
    loss = lm + cfg.router_aux_weight * aux
    return loss, {"loss": loss, "lm_loss": lm, "aux_loss": aux}


def init_cache(cfg, batch: int, max_seq: int, device=None,
               rules=None) -> List[Dict]:
    """One contiguous cache per layer: K/V rows in the compute dtype (int8
    rows and f32 scales with ``kv_cache_dtype="int8"``) or MLA's latent
    and rope-key rows for attention (every ``shared_attn`` invocation has
    its own); the recurrent state for an SSM layer.  With ``rules``, this
    rank's blocks of it (:func:`cache_specs`)."""
    check_supported(cfg)
    if rules is not None:
        return _cache_blocks(init_cache(cfg, batch, max_seq, "meta"), cfg,
                             rules, False, device)
    ct = dtype_of(cfg.compute_dtype)
    attn = A.mla_cache_init if cfg.use_mla else A.gqa_cache_init
    return [attn(cfg, batch, max_seq, ct, device) if kind in ATTN_KINDS
            else S.MIXERS[kind].cache_init(cfg, batch, ct, device)
            for kind in layer_kinds(cfg)]


def init_paged_cache(cfg, n_pages: int, page_size: int, device=None,
                     rules=None) -> List[Dict]:
    """One PAGED cache per layer: every attention leaf is a page pool
    ``(n_pages, page_size, ...)`` addressed through the per-slot page
    tables that :func:`serve_step` / :func:`prefill_chunk` take as
    ``pages`` (see :mod:`repro_torch.runtime.kvcache`).

    Attention-only block patterns: the paged layout pages per-position
    KV rows, and SSM decode state is O(1) with nothing to page.  With
    ``rules``, this rank's blocks (every page, its block of kv heads where
    they divide)."""
    if not supports_fused_prefill(cfg):
        raise NotImplementedError(
            "paged KV layout requires an attention-only block pattern, "
            f"got {cfg.block_pattern}")
    if rules is not None:
        return _cache_blocks(init_cache(cfg, n_pages, page_size, "meta"),
                             cfg, rules, True, device)
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
    patterns fall back to stepwise prefill (their decode state is the
    *final* recurrence state, not per-position rows)."""
    return all(k in ATTN_KINDS for k in cfg.block_pattern)


def _attention_only(cfg, what: str, hint: str = "") -> None:
    for kind in cfg.block_pattern:
        if kind not in ATTN_KINDS:
            raise NotImplementedError(
                f"{what} not implemented for block kind {kind!r}{hint}")


def prefill(params, batch, cfg, max_seq: int):
    """Fused full-sequence prefill: ONE forward over the prompt (B, S) that
    writes every layer's KV cache in bulk — rows [0, S) of a cache padded
    to ``max_seq`` (rows >= S are overwritten by decode before any read).
    batch as :func:`forward`'s (a vision prefix fills the first rows).
    Attention-only patterns (:func:`supports_fused_prefill`).

    Returns (logits (B, S, vocab), cache) with the :func:`init_cache`
    layout."""
    _attention_only(cfg, "fused prefill", "; use the stepwise prefill path")
    ct = dtype_of(cfg.compute_dtype)
    x = _embed_inputs(params, batch, cfg, ct)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    cache = []
    for j, (_, layer) in enumerate(_layers(params, cfg)):
        with _block_scope(cfg, j):
            x, c = _block_prefill(layer, x, cfg, positions, max_seq)
        cache.append(c)
    return _logits(params, x, cfg, ct), cache


def serve_step(params, cache, batch, pos, cfg, pages=None):
    """Decode one token given caches of past state.

    batch: {"tokens": (B, 1)} (or {"embeds": (B, 1, D)} for the ``embed``
    frontend).  pos: int position (static batch) or (B,) tensor of
    per-slot positions (continuous batching).  pages: optional (B,
    n_blocks) int64 per-slot page tables — the cache is then the
    :func:`init_paged_cache` pools and every attention read/write goes
    through the page indirection (same math, same mask).  The cache is
    updated in place.  Returns (logits (B, vocab), cache).

    Sparse-sparse decode runs the fused pipeline per layer: the FFN's
    k-WTA output (or support) goes straight to the down projection, which
    contracts the whole decode batch in one ``topk_gather`` launch when
    the executor (``cfg.ffn_sparsity.use_pallas``) engages the kernel.

    On a serving mesh whose contiguous cache holds the rank's block of
    slots, the step computes those slots' rows of ``batch`` and ``pos``
    (the page pools hold every slot: a paged step computes them all).
    """
    ct = dtype_of(cfg.compute_dtype)
    sh = serving()
    rows = None
    if sh is not None and pages is None:
        rows = sh.batch_rows(next(iter(batch.values())).shape[0])
    if rows is not None:
        batch = {k: v[rows] for k, v in batch.items()}
        if isinstance(pos, torch.Tensor) and pos.ndim:
            pos = pos[rows]
    x = _embed(params, batch, cfg, ct)
    for j, ((kind, layer), c) in enumerate(zip(_layers(params, cfg), cache,
                                               strict=True)):
        with _block_scope(cfg, j):
            x = _block_decode(kind, layer, x, cfg, c, pos, pages)
    return _logits(params, x, cfg, ct, rows is not None)[:, 0], cache


def prefill_chunk(params, cache, batch, pos_start: int, chunk_len: int, cfg,
                  pages):
    """Forward ONE page-aligned prompt chunk of ONE slot through every
    layer, scattering its KV rows into the slot's page chains in place
    (the paged layout's incremental prefill — long prompts run as a
    sequence of these interleaved with decode steps instead of one
    :func:`prefill` call).  Attention-only patterns.

    batch: {"tokens": (1, C)} (or {"embeds": (1, C, D)}); pages: (1,
    n_blocks) int64 — the prefilling slot's page table; rows past
    ``chunk_len`` are bucket padding: their KV sinks to the null page and
    their logits are garbage the engine ignores.
    Returns (logits (1, C, vocab), cache)."""
    _attention_only(cfg, "chunked prefill")
    ct = dtype_of(cfg.compute_dtype)
    x = _embed(params, batch, cfg, ct)
    for j, ((_, layer), c) in enumerate(zip(_layers(params, cfg), cache,
                                            strict=True)):
        with _block_scope(cfg, j):
            x, _ = _block_chunk_prefill(layer, x, cfg, c, pages, pos_start,
                                        chunk_len)
    return _logits(params, x, cfg, ct), cache
