"""Random weights from ``--seed``, drawn on the device by the benchmark.

The weights are the benchmark's input, like the traffic: it draws them
with a ``torch.Generator`` on the card, one large call a distribution,
in the layout ``Engine(params=...)`` takes (the port's serving layout:
compute leaves in bf16, norm scales in float32, int8 route tables, each
packed projection's partition-major copy).  The plain reference reads the
same tensors.

Distributions (those of the port's own init, with norm scales drawn near
1 so that the check sees them): dense projections uniform in
±1/sqrt(d_in); packed projections uniform in ±sqrt(N/d_in); embedding,
head, MLA and router weights normal with std 0.02; each route table a
random permutation of range(N) for every (table, partition).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

#: elements each leaf's offset in a flat buffer is rounded up to
_ALIGN = 64
#: the half-width of the norm scales' draw around 1
NORM_SPREAD = 0.1


class _Plan:
    """Leaves to draw, by distribution, and where they sit in the tree."""

    def __init__(self):
        self.leaves: List[Tuple[tuple, tuple, str, float]] = []

    def add(self, path, shape, kind, scale=0.0):
        self.leaves.append((tuple(path), tuple(int(s) for s in shape), kind,
                            float(scale)))


def _route_share(share: int, g: int) -> int:
    r = g if share == 0 else min(share, g)
    while g % r:
        r -= 1
    return r


def _packed(plan, path, d_in, d_out, sp, experts=0):
    n = sp.n
    g, p = d_out // n, d_in // n
    r = _route_share(sp.route_share, g)
    lead = (experts,) if experts else ()
    plan.add(path + ("packed",), lead + (g, p, n), "uniform",
             np.sqrt(n / d_in))
    plan.add(path + ("route",), (g // r, p, n), "route", n)


def _ffn(plan, path, d, f, sp):
    for name, (a, b) in (("up", (d, f)), ("gate", (d, f)), ("down", (f, d))):
        if sp.weight_sparse and a % sp.n == 0 and b % sp.n == 0:
            _packed(plan, path + (name,), a, b, sp)
        else:
            plan.add(path + (name, "w"), (a, b), "uniform", 1 / np.sqrt(a))


def _plan(cfg) -> _Plan:
    """Every leaf of ``cfg``'s params: GQA or MLA attention blocks with a
    (packed) SwiGLU FFN or a MoE of packed experts and shared experts."""
    if set(cfg.block_pattern) != {"attn"} or cfg.act != "silu" \
            or cfg.frontend != "none" or cfg.proj_sparsity.weight_sparse:
        raise NotImplementedError(f"{cfg.name}: no weight plan for this "
                                  "block pattern")
    d, v, sp = cfg.d_model, cfg.padded_vocab, cfg.ffn_sparsity
    plan = _Plan()
    plan.add(("embed", "table"), (v, d), "normal", 0.02)
    for j in range(cfg.n_layers):
        base = ("layers", j)
        plan.add(base + ("norm1", "scale"), (d,), "norm")
        plan.add(base + ("norm2", "scale"), (d,), "norm")
        m = base + ("mixer",)
        h, dh = cfg.n_heads, cfg.head_dim
        if cfg.use_mla:
            r, dr = cfg.kv_lora_rank, cfg.rope_head_dim
            for name, shape in (("q", (d, h * (dh + dr))), ("dkv", (d, r)),
                                ("kpe", (d, dr)), ("uk", (r, h * dh)),
                                ("uv", (r, h * dh)), ("o", (h * dh, d))):
                plan.add(m + (name,), shape, "normal", 0.02)
        else:
            hkv, hp = cfg.n_kv_heads, cfg.padded_heads
            for name, (a, b) in (("q", (d, h * dh)), ("k", (d, hkv * dh)),
                                 ("v", (d, hkv * dh)), ("o", (hp * dh, d))):
                plan.add(m + (name, "w"), (a, b), "uniform", 1 / np.sqrt(a))
        if cfg.is_moe:
            e, f = cfg.n_experts, cfg.d_ff
            moe = base + ("moe",)
            plan.add(moe + ("router",), (d, e), "normal", 0.02)
            for name, (a, b) in (("up", (d, f)), ("gate", (d, f)),
                                 ("down", (f, d))):
                _packed(plan, moe + (name,), a, b, sp, experts=e)
            if cfg.n_shared_experts:
                _ffn(plan, moe + ("shared",), d,
                     cfg.n_shared_experts * cfg.d_ff, sp)
        else:
            _ffn(plan, base + ("ffn",), d, cfg.d_ff, sp)
    plan.add(("final_norm", "scale"), (d,), "norm")
    if not cfg.tie_embeddings:
        plan.add(("head", "table"), (v, d), "normal", 0.02)
    return plan


def _set(tree, path, leaf):
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = leaf


def _flat(gen, plan, kind, dtype, device):
    """One buffer holding every leaf of ``kind``, drawn in one call."""
    items = [(path, shape, scale) for path, shape, k, scale in plan.leaves
             if k == kind]
    offsets, total = [], 0
    for _, shape, _ in items:
        offsets.append(total)
        n = int(np.prod(shape))
        total += -(-n // _ALIGN) * _ALIGN
    buf = torch.empty(total, dtype=dtype, device=device)
    if kind == "normal":
        buf.normal_(0.0, 1.0, generator=gen)
    else:
        buf.uniform_(-1.0, 1.0, generator=gen)
    out = []
    for (path, shape, scale), off in zip(items, offsets):
        n = int(np.prod(shape))
        leaf = buf[off:off + n].view(shape)
        if kind == "norm":
            leaf.mul_(NORM_SPREAD).add_(1.0)
        else:
            leaf.mul_(scale)
        out.append((path, leaf))
    return out


def draw(cfg, seed: int, device) -> Dict:
    """The params tree of ``cfg`` drawn from ``seed`` on ``device``:
    compute leaves in ``cfg.compute_dtype``, each packed projection with
    its ``packed_p``."""
    device = torch.device(device)
    plan = _plan(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2**64 - 1))
    wdt = getattr(torch, cfg.compute_dtype)
    tree: Dict = {}
    for kind, dtype in (("uniform", wdt), ("normal", wdt),
                        ("norm", torch.float32)):
        for path, leaf in _flat(gen, plan, kind, dtype, device):
            _set(tree, path, leaf)
    for path, shape, kind, n in plan.leaves:
        if kind == "route":
            keys = torch.rand(shape, generator=gen, device=device)
            _set(tree, path, keys.argsort(dim=-1).to(torch.int8))
    _add_partition_major(tree)
    return tree


def _add_partition_major(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            _add_partition_major(v)
        pk = tree.get("packed")
        if pk is not None and pk.ndim == 3:
            tree["packed_p"] = pk.transpose(0, 1).contiguous()
    elif isinstance(tree, list):
        for v in tree:
            _add_partition_major(v)

