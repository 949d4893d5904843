"""Feed-forward blocks: dense SwiGLU/GELU and the complementary-sparse
sparse-sparse FFN (the paper's technique applied to Transformer linear
layers, their §6.4 future direction).

Sparse-sparse FFN dataflow (paper Fig. 8a at layer granularity):

    h   = act(W_gate x) * (W_up x)        (packed CS weights: sparse-dense)
    h_s = k-WTA(h)                        (Select — with the exact top-k
                                           impl, the layer's ONE top_k, its
                                           (vals, idx) support handed to
                                           the down projection)
    y   = W_down h_s                      (packed CS; with the k-sparse
                                           input this is the sparse-sparse
                                           Multiply-Route-Sum — the topk
                                           path when B·K < d_ff, which
                                           launches the topk_gather kernel)

On a serving mesh (:mod:`repro_torch.sharding.serving`) up and gate are
the rank's block of output groups, so ``h`` comes out as a block of
columns: it is gathered over ``model`` before the k-WTA, which picks K of
the whole row, and the down projection (whole on every rank) runs as on
one device.  A training step on a mesh runs the same, ``x`` entering the
up and gate blocks (its gradient summed over ``model`` in the backward)
and the gather's backward handing each rank its block of the hidden's
gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as tF

from repro_torch.core.api import SparsityConfig
from repro_torch.core.instrument import named_scope
from repro_torch.core.layers import (apply_kwta, linear_apply, linear_init,
                                     linear_specs, out_width,
                                     packed_linear_apply, packed_linear_init,
                                     packed_linear_specs)
from repro_torch.obs.sparsity import observe_site
from repro_torch.sharding.serving import enter_blocks, serving


def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": tF.silu,
            "gelu": lambda x: tF.gelu(x, approximate="tanh"),
            "relu": tF.relu}[name]


def ffn_init(gen: torch.Generator, d_model: int, d_ff: int,
             cfg_sp: SparsityConfig, act: str = "silu"):
    """SwiGLU (silu) or plain (gelu/relu) FFN; packed when cfg_sp.n > 1.
    The routes use the reference's seeds (21 up, 22 gate, 23 down)."""
    gated = act == "silu"

    def mk(d_in, d_out, seed):
        if cfg_sp.weight_sparse and d_in % cfg_sp.n == 0 \
                and d_out % cfg_sp.n == 0:
            return packed_linear_init(gen, d_in, d_out, cfg_sp, bias=False,
                                      seed=seed)
        return linear_init(gen, d_in, d_out, bias=False)

    params = {"up": mk(d_model, d_ff, 21)}
    if gated:
        params["gate"] = mk(d_model, d_ff, 22)
    params["down"] = mk(d_ff, d_model, 23)
    return params


def ffn_specs(d_model: int, d_ff: int, cfg_sp: SparsityConfig,
              act: str = "silu"):
    """The reference's logical specs of :func:`ffn_init`'s params: up and
    gate shard their outputs (``mlp``), down its rows' groups (``embed``,
    replicated)."""
    def mk(d_in, d_out, out_axis):
        if cfg_sp.weight_sparse and d_in % cfg_sp.n == 0 \
                and d_out % cfg_sp.n == 0:
            return packed_linear_specs(bias=False, out_axis=out_axis)
        return linear_specs(bias=False, out_axis=out_axis)

    specs = {"up": mk(d_model, d_ff, "mlp")}
    if act == "silu":
        specs["gate"] = mk(d_model, d_ff, "mlp")
    specs["down"] = mk(d_ff, d_model, "embed")
    return specs


def _apply_one(p, x, sp: SparsityConfig, x_is_sparse=False, support=None):
    if "packed" in p:
        return packed_linear_apply(p, x, sp, x_is_sparse=x_is_sparse,
                                   support=support)
    return linear_apply(p, x)


def hidden_width(p) -> int:
    """The whole hidden width of an FFN (its down projection's input; a
    packed one's padded width)."""
    p = p["down"]
    if "packed" in p:
        return p["packed"].shape[1] * p["packed"].shape[2]
    return p["w"].shape[0]


def ffn_hidden(params, x: torch.Tensor, cfg_sp: SparsityConfig,
               act: str = "silu"):
    """``act(gate x) * (up x)`` (or ``act(up x)``): on a mesh the rank's
    block of the hidden's columns where up and gate are blocks, which
    ``x`` enters."""
    a = _act(act)
    if out_width(params["up"]) < hidden_width(params):
        x = enter_blocks(x)
    with named_scope("ffn_up"):
        up = _apply_one(params["up"], x, cfg_sp)
    if "gate" in params:
        with named_scope("ffn_gate"):
            return a(_apply_one(params["gate"], x, cfg_sp)) * up
    return a(up)


def ffn_down(params, h: torch.Tensor, cfg_sp: SparsityConfig):
    """The k-WTA of the whole hidden row ``h`` and the down projection."""
    # Select (k-WTA) — identity when disabled. The winner support is handed
    # to the down projection so the sparse-sparse path never re-derives it.
    with named_scope("ffn_kwta"), observe_site("ffn"):
        h, support = apply_kwta(h, cfg_sp, return_support=True)
    with named_scope("ffn_down"):
        return _apply_one(params["down"], h, cfg_sp,
                          x_is_sparse=cfg_sp.activation_sparse,
                          support=support)


def ffn_apply(params, x: torch.Tensor, cfg_sp: SparsityConfig,
              act: str = "silu"):
    h = ffn_hidden(params, x, cfg_sp, act)
    sh = serving()
    if sh is not None and h.shape[-1] < hidden_width(params):
        h = sh.gather(h, {-1: "model"})
    return ffn_down(params, h, cfg_sp)
