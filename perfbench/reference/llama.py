"""Plain reference of the ``llama`` family (SmolLM): pre-norm decoder
blocks of grouped-query attention with split-half RoPE and a SwiGLU FFN
whose weights are complementary-sparse (packed, density 1/N) and whose
hidden goes through the configuration's k-WTA before the down
projection; final RMSNorm and LM head.

Weights are the benchmark's tree (``perfbench/harness/weights.py``'s
layout); the reference reads their values only and works out the dense
form of every packed weight itself.  A query head ``h`` reads key head
``h // (H / H_kv)``; the o projection's rows past ``H · d_head`` (heads the
program computes and zeroes) are not read.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from .common import (Prec, attend, dense_of_packed, k_of, kwta_bisect,
                     rmsnorm, rope, silu)


class Dims:
    def __init__(self, conf: Dict):
        self.d = conf["hidden_size"]
        self.h = conf["num_attention_heads"]
        self.hkv = conf["num_key_value_heads"]
        self.dh = conf.get("head_dim") or self.d // self.h
        self.eps = conf["rms_norm_eps"]
        self.theta = conf["rope_theta"]
        sp = conf["assumed"]["ffn_sparsity"]
        self.k_frac = sp["k_frac"]
        self.iters = sp["kwta_iters"]
        if sp["kwta"] != "bisect":
            raise NotImplementedError(f"k-WTA {sp['kwta']!r}")


def proj_weight(p: Dict, prec: Prec) -> torch.Tensor:
    """A projection's dense (d_in, d_out) weight in ``prec``."""
    if "packed" in p:
        return prec.weight(dense_of_packed(p["packed"], p["route"]))
    return prec.weight(p["w"])


def ffn_weights(p: Dict, prec: Prec):
    return [proj_weight(p[n], prec) for n in ("up", "gate", "down")]


def ffn(x, dense, dims, prec: Prec):
    """SwiGLU with the k-WTA on the hidden; ``dense`` its up, gate and
    down weights (:func:`ffn_weights`)."""
    wu, wg, wd = dense
    h = silu(prec.mm(x, wg)) * prec.mm(x, wu)
    h = kwta_bisect(h, k_of(h.shape[-1], dims.k_frac), dims.iters)
    return prec.mm(h, wd)


def gqa_weights(p: Dict, dims, prec: Prec):
    """q, k, v and o (the rows of the true heads) in ``prec``."""
    return {"q": prec.weight(p["q"]["w"]), "k": prec.weight(p["k"]["w"]),
            "v": prec.weight(p["v"]["w"]),
            "o": prec.weight(p["o"]["w"][:dims.h * dims.dh])}


def gqa(x, w: Dict, dims, seq, prec: Prec):
    s = x.shape[0]
    q = prec.mm(x, w["q"]).reshape(s, dims.h, dims.dh)
    k = prec.mm(x, w["k"]).reshape(s, dims.hkv, dims.dh)
    v = prec.mm(x, w["v"]).reshape(s, dims.hkv, dims.dh)
    q = rope(q, seq.positions, dims.theta)
    k = rope(k, seq.positions, dims.theta)
    rep = dims.h // dims.hkv
    k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    out = attend(q, k, v, seq.mask, 1.0 / math.sqrt(dims.dh))
    return prec.mm(out.reshape(s, dims.h * dims.dh), w["o"])


def head_table(conf: Dict, weights: Dict) -> torch.Tensor:
    """The LM head's rows: the embedding's where the configuration ties
    the two."""
    return weights["embed" if conf["tie_word_embeddings"] else "head"][
        "table"]


def served_logits(conf: Dict, weights: Dict, seqs: List,
                  prec: Prec = Prec()) -> List[torch.Tensor]:
    """Each sequence's float32 logits at its ``logit_rows``, layer by layer
    over every sequence (one layer's dense weights at a time)."""
    dims = Dims(conf)
    table = weights["embed"]["table"]
    xs = [table[s.tokens].float() for s in seqs]
    for layer in weights["layers"]:
        dense = ffn_weights(layer["ffn"], prec)
        attn = gqa_weights(layer["mixer"], dims, prec)
        for i, seq in enumerate(seqs):
            x = xs[i]
            h = rmsnorm(x, layer["norm1"]["scale"], dims.eps)
            x = x + gqa(h, attn, dims, seq, prec)
            h = rmsnorm(x, layer["norm2"]["scale"], dims.eps)
            xs[i] = x + ffn(h, dense, dims, prec)
        del dense, attn
    head = prec.weight(head_table(conf, weights).T)
    out = []
    for x, seq in zip(xs, seqs):
        h = rmsnorm(x[seq.logit_rows], weights["final_norm"]["scale"],
                    dims.eps)
        out.append(prec.mm(h, head))
    return out
