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
"""

from __future__ import annotations

import torch
import torch.nn.functional as tF

from repro_torch.core.api import SparsityConfig
from repro_torch.core.instrument import named_scope
from repro_torch.core.layers import (apply_kwta, linear_apply, linear_init,
                                     packed_linear_apply, packed_linear_init)
from repro_torch.obs.sparsity import observe_site


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


def _apply_one(p, x, sp: SparsityConfig, x_is_sparse=False, support=None):
    if "packed" in p:
        return packed_linear_apply(p, x, sp, x_is_sparse=x_is_sparse,
                                   support=support)
    return linear_apply(p, x)


def ffn_apply(params, x: torch.Tensor, cfg_sp: SparsityConfig,
              act: str = "silu"):
    a = _act(act)
    with named_scope("ffn_up"):
        up = _apply_one(params["up"], x, cfg_sp)
    if "gate" in params:
        with named_scope("ffn_gate"):
            h = a(_apply_one(params["gate"], x, cfg_sp)) * up
    else:
        h = a(up)
    # Select (k-WTA) — identity when disabled. The winner support is handed
    # to the down projection so the sparse-sparse path never re-derives it.
    with named_scope("ffn_kwta"), observe_site("ffn"):
        h, support = apply_kwta(h, cfg_sp, return_support=True)
    with named_scope("ffn_down"):
        return _apply_one(params["down"], h, cfg_sp,
                          x_is_sparse=cfg_sp.activation_sparse,
                          support=support)
