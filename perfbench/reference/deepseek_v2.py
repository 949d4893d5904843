"""Plain reference of the ``deepseek_v2`` family as the configuration file
states it (its ``reduced`` keys and ``departures`` list what it changes
from the published model): pre-norm blocks of multi-head latent attention
(queries without a low-rank path; a latent of ``kv_lora_rank`` per token
from which every head's key and value are expanded, plus one shared rope
key) and a mixture of experts in every layer: a softmax router choosing
the top ``num_experts_per_tok`` experts, their weights renormalised, of
complementary-sparse SwiGLU experts with the k-WTA on their hidden, plus
the shared experts as one such FFN of ``n_shared_experts`` times the
width.

Capacity: within each token group (``Seq.groups``) the assignments are
taken token by token, each token's choices in order, and an expert keeps
the first ceil(T · k / E · capacity_factor) it receives; a dropped
assignment adds nothing.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from .common import (Prec, attend, k_of, kwta_bisect, plain_rope, rmsnorm,
                     rope, silu)
from .llama import ffn, ffn_weights, head_table, proj_weight


class Dims:
    def __init__(self, conf: Dict):
        self.d = conf["hidden_size"]
        self.h = conf["num_attention_heads"]
        self.dh = conf["qk_nope_head_dim"]
        self.dv = conf["v_head_dim"]
        self.dr = conf["qk_rope_head_dim"]
        self.r = conf["kv_lora_rank"]
        self.e = conf["n_routed_experts"]
        self.k = conf["num_experts_per_tok"]
        self.eps = conf["rms_norm_eps"]
        self.theta = conf["rope_theta"]
        self.norm_topk = conf["norm_topk_prob"]
        self.cf = conf["assumed"]["capacity_factor"]
        sp = conf["assumed"]["ffn_sparsity"]
        self.k_frac = sp["k_frac"]
        self.iters = sp["kwta_iters"]
        if conf["q_lora_rank"] is not None \
                or not plain_rope(conf["rope_scaling"]) \
                or conf["first_k_dense_replace"] != 0:
            raise NotImplementedError("q_lora, rope scaling and dense "
                                      "leading layers are not modelled")


def mla(x, p: Dict, dims, seq, prec: Prec):
    """``p``: q, dkv, kpe, uk, uv and o in ``prec``."""
    s = x.shape[0]
    q = prec.mm(x, p["q"]).reshape(s, dims.h, dims.dh + dims.dr)
    q = torch.cat([q[..., :dims.dh],
                   rope(q[..., dims.dh:], seq.positions, dims.theta)], -1)
    c = prec.mm(x, p["dkv"])                                   # (S, r)
    k_pe = rope(prec.mm(x, p["kpe"]), seq.positions, dims.theta)
    k_nope = prec.mm(c, p["uk"]).reshape(s, dims.h, dims.dh)
    v = prec.mm(c, p["uv"]).reshape(s, dims.h, dims.dv)
    k = torch.cat([k_nope, k_pe[:, None, :].expand(s, dims.h, dims.dr)], -1)
    out = attend(q, k, v, seq.mask, 1.0 / math.sqrt(dims.dh + dims.dr))
    return prec.mm(out.reshape(s, dims.h * dims.dv), p["o"])


def route(x, router, dims, seq, prec: Prec):
    """(top experts (S, k), their weights (S, k), kept (S, k))."""
    probs = torch.softmax(prec.mm(x, router), dim=-1)
    top_p, top_e = torch.topk(probs, dims.k, dim=-1, sorted=True)
    if dims.norm_topk:
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    kept = torch.zeros_like(top_e, dtype=torch.bool)
    for g in seq.groups:
        t = g.numel()
        cap = int(math.ceil(t * dims.k / dims.e * dims.cf))
        flat = top_e[g].reshape(-1)                          # token-major
        seen = torch.nn.functional.one_hot(flat, dims.e).cumsum(0)
        rank = seen.gather(1, flat[:, None])[:, 0] - 1
        kept[g] = (rank < cap).reshape(t, dims.k)
    return top_e, top_p, kept


def moe(x, p: Dict, dims, seq, prec: Prec, experts, router, shared):
    """Routed experts (``experts``: their dense up, gate, down, each
    (E, d_in, d_out), and the ``router``) plus the ``shared`` experts'
    weights, all in ``prec``."""
    top_e, top_p, kept = route(x, router, dims, seq, prec)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    wu, wg, wd = experts
    for e in range(dims.e):
        tok, slot = torch.nonzero((top_e == e) & kept, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = silu(prec.mm(xe, wg[e])) * prec.mm(xe, wu[e])
        h = kwta_bisect(h, k_of(h.shape[-1], dims.k_frac), dims.iters)
        y.index_add_(0, tok, prec.mm(h, wd[e]) * top_p[tok, slot][:, None])
    if shared is not None:
        y = y + ffn(x, shared, dims, prec)
    return y


def served_logits(conf: Dict, weights: Dict, seqs: List,
                  prec: Prec = Prec()) -> List[torch.Tensor]:
    """Each sequence's float32 logits at its ``logit_rows``, layer by layer
    over every sequence (one layer's dense expert weights at a time)."""
    dims = Dims(conf)
    table = weights["embed"]["table"]
    xs = [table[s.tokens].float() for s in seqs]
    for layer in weights["layers"]:
        m = layer["moe"]
        experts = [proj_weight(m[n], prec) for n in ("up", "gate", "down")]
        router = prec.weight(m["router"])
        shared = ffn_weights(m["shared"], prec) if "shared" in m else None
        attn = {k: prec.weight(v) for k, v in layer["mixer"].items()}
        for i, seq in enumerate(seqs):
            x = xs[i]
            h = rmsnorm(x, layer["norm1"]["scale"], dims.eps)
            x = x + mla(h, attn, dims, seq, prec)
            h = rmsnorm(x, layer["norm2"]["scale"], dims.eps)
            xs[i] = x + moe(h, m, dims, seq, prec, experts, router, shared)
        del experts, shared, attn
    head = prec.weight(head_table(conf, weights).T)
    out = []
    for x, seq in zip(xs, seqs):
        h = rmsnorm(x[seq.logit_rows], weights["final_norm"]["scale"],
                    dims.eps)
        out.append(prec.mm(h, head))
    return out
