"""Mixture-of-Experts with sort-based capacity dispatch (dropless up to the
capacity factor), the reference's ``repro.models.moe``.

MoE routing is coarse-grained activation sparsity (a learned top-k over
expert units); complementary sparsity composes inside each expert's FFN
(packed weights, k-WTA on the expert hidden), and the shared experts are
the sparse-sparse FFN of :mod:`repro_torch.models.ffn`, whose decode down
projection reaches the ``topk_gather`` kernel.

Dispatch, per token group (one group per batch row, batched over the
groups where the reference vmaps):
  1. top-k expert choice per token (router softmax in f32),
  2. stable argsort of the (T·k) assignments by expert id,
  3. rank within each expert from running offsets; ranks past the
     capacity C drop,
  4. scatter into a (groups, E, C, d) buffer, batched expert FFN (one
     expression over the expert axis a projection),
  5. combine: each token gathers its k expert outputs back in its own
     top-k order and sums them over that axis.  The reference
     scatter-adds the k contributions; a sum over a fixed axis gives the
     same result without atomics, so a step on the card gives the same
     logits twice.

On a serving mesh (:mod:`repro_torch.sharding.serving`) the experts are
parallel over ``model`` (the reference's ``"experts" -> "model"``): the
rank holds the router's columns and the routed weights of its block of
experts [lo, hi), each expert whole.  The router's logits are gathered
over ``model`` before the softmax, in one collective with the shared
experts' hidden (both are column blocks of the same input's products),
so every rank makes the same choices and the same dispatch (capacity,
ranks and drops are global); each computes its block of the buffer and
combines its experts' terms only, and the partial outputs are summed
over ``model`` in float32.  The shared experts then run as the FFN does on a mesh:
k-WTA over the whole hidden row, down whole on every rank.

Where ``n_experts`` does not divide over ``model`` the experts are
whole on every rank and each expert's groups split (the reference's
divisibility fallback leaves ``experts`` unsharded and ``mlp`` cuts the
groups): the router is whole, every rank makes the same dispatch and
computes every expert on its block of that expert's up and gate
groups, gathers each expert's hidden over ``model`` before its k-WTA,
and runs the down projection whole (dense experts) or on its block of
output groups (packed experts, whose combined outputs are gathered over
``model``).

A training step on a mesh runs the same forward through autograd: ``x``
enters the router's columns and the rank's experts (the dispatch buffer
is a linear function of ``x``, computed whole on every rank and cut to
the rank's experts), and ``top_p`` enters the combine of the rank's
experts, so each one's gradient is summed over ``model`` in the
backward; the gathered logits hand each rank its columns' gradient, and
the partial outputs' sum passes the whole gradient to every rank.  Where
the experts' groups are cut, ``x`` enters the up and gate blocks alone
(the router is whole), and the gathered hidden and ``top_p`` enter a
packed down's block of outputs.  The aux loss's loads are summed over
the DP group only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as tF

from repro_torch.core import functional as F
from repro_torch.core.api import SparsityConfig
from repro_torch.core.layers import (_route_share, _uniform, apply_kwta,
                                     layer_route)
from repro_torch.core.masks import CSLayout, make_routes
from repro_torch.sharding.collectives import batch_sum, dp_group, group_size
from repro_torch.sharding.serving import enter_blocks, serving
from .common import normal_init
from .ffn import ffn_down, ffn_hidden, ffn_init, ffn_specs, hidden_width


def moe_specs(d_model: int, d_ff: int, n_shared: int, act: str,
              cfg_sp: SparsityConfig):
    """The reference's logical specs of :func:`moe_init`'s params: experts
    shard over ``experts``, a packed expert's groups over ``mlp``."""
    def mk(d_in, d_out):
        if cfg_sp.weight_sparse and d_in % cfg_sp.n == 0 \
                and d_out % cfg_sp.n == 0:
            return {"packed": ("experts", "mlp", None, None),
                    "route": ("mlp", None, None)}
        return {"w": ("experts", None, "mlp" if d_out == d_ff else None)}

    specs = {"router": (None, "experts"), "up": mk(d_model, d_ff)}
    if act == "silu":
        specs["gate"] = mk(d_model, d_ff)
    specs["down"] = mk(d_ff, d_model)
    if n_shared:
        specs["shared"] = ffn_specs(d_model, n_shared * d_ff, cfg_sp, act)
    return specs


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             n_shared: int, act: str, cfg_sp: SparsityConfig):
    """A router (d, E), stacked expert SwiGLU weights and the shared
    experts (one FFN of ``n_shared·d_ff``).

    When ``cfg_sp.weight_sparse`` (and the widths divide N) the experts
    are stored packed, (E, G, P, N), with ONE route table shared across
    experts (the reference's seeds 31 up, 32 gate, 33 down); else dense
    (E, d_in, d_out).  The routed experts get no partition-major copy:
    they never reach ``topk_gather``."""
    params = {"router": normal_init(gen, (d_model, n_experts), 0.02)}

    def mk_expert(d_in, d_out, seed):
        if cfg_sp.weight_sparse and d_in % cfg_sp.n == 0 \
                and d_out % cfg_sp.n == 0:
            lay = CSLayout(d_in, d_out, cfg_sp.n, cfg_sp.perm_kind)
            g = lay.groups
            r = _route_share(cfg_sp, g)
            route = make_routes(CSLayout(d_in, cfg_sp.n * (g // r), cfg_sp.n,
                                         cfg_sp.perm_kind), seed)
            w = _uniform(gen, (n_experts, g, lay.partitions, cfg_sp.n),
                         float(np.sqrt(cfg_sp.n / d_in)), torch.float32)
            return {"packed": w,
                    "route": torch.from_numpy(route).to(gen.device)}
        return {"w": _uniform(gen, (n_experts, d_in, d_out),
                              float(1.0 / np.sqrt(d_in)), torch.float32)}

    params["up"] = mk_expert(d_model, d_ff, 31)
    if act == "silu":
        params["gate"] = mk_expert(d_model, d_ff, 32)
    params["down"] = mk_expert(d_ff, d_model, 33)
    if n_shared:
        params["shared"] = ffn_init(gen, d_model, n_shared * d_ff, cfg_sp,
                                    act)
    return params


def _expert_matmul(p, x):
    """Batched expert projection: x (groups, E, C, d_in) -> (groups, E, C,
    d_out).  Packed experts run the faithful Multiply-Route-Sum
    (:func:`repro_torch.core.functional.cs_matmul`) of every expert in
    one expression over the expert axis."""
    if "packed" in p:
        pk = p["packed"].to(x.dtype)                     # (E, G, P, N)
        route = layer_route(p)                           # (G/R, P, N)
        e, g, parts, n = pk.shape
        gr = route.shape[0]
        xg = x[..., F.route_to_gather_idx(route, n)]     # (.., Gr, P, N)
        y = torch.einsum("becups,eurps->becurs", xg,
                         pk.reshape(e, gr, g // gr, parts, n))
        return y.reshape(*x.shape[:-1], g * n)
    return torch.einsum("becd,edf->becf", x, p["w"].to(x.dtype))


def router_top_k(probs: torch.Tensor, k: int):
    """The router's choice: the k most probable experts of each token,
    largest first (``lax.top_k``).  The order of a token's k choices feeds
    the stable sort, and so decides which assignments the capacity drops."""
    return torch.topk(probs, k, dim=-1, sorted=True)


def _dispatch(xg, top_e, e: int, k: int, cap: int):
    """Sort-based dispatch of every token group at once.

    xg (G, Tg, d); top_e (G, Tg, k).  Returns (buf (G, E, C, d), rank
    (G, Tg, k), keep (G, Tg, k)): each assignment's rank within its
    expert, in the token's top-k order, and whether it fits in C.

    A dropped assignment is written to a scratch row C, sliced off: the
    reference adds its zero source at (e, C-1), which leaves the kept
    token there as it was."""
    groups, tg, d = xg.shape
    e_flat = top_e.reshape(groups, tg * k)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    e_sorted = e_flat.gather(1, order)
    tok_sorted = order // k
    counts = torch.zeros((groups, e), dtype=torch.int64,
                         device=xg.device).scatter_add_(
        1, e_sorted, torch.ones_like(e_sorted))           # (G, E)
    starts = torch.cumsum(counts, dim=1) - counts
    rank = (torch.arange(tg * k, device=xg.device)
            - starts.gather(1, e_sorted))
    keep = rank < cap
    row = torch.where(keep, rank, cap)
    buf = torch.zeros((groups, e, cap + 1, d), dtype=xg.dtype,
                      device=xg.device)
    src = xg.gather(1, tok_sorted[..., None].expand(-1, -1, d))
    src = torch.where(keep[..., None], src, 0)
    g_idx = torch.arange(groups, device=xg.device)[:, None]
    buf[g_idx, e_sorted, row] = src
    # back to each token's top-k order
    inv = torch.argsort(order, dim=-1)
    rank_u = rank.gather(1, inv).reshape(groups, tg, k)
    return buf[:, :, :cap], rank_u, rank_u < cap


def _combine(out, top_e, top_p, rank, keep, lo=None):
    """Each token's k expert outputs, weighted, summed in top-k order.
    out (G, E, C, d); top_e/top_p/rank/keep (G, Tg, k).  Returns
    (G, Tg, d).  With ``lo``, ``out`` holds experts [lo, lo + E') only (a
    serving mesh's block), and the other experts' terms are left out."""
    if lo is not None:
        keep = keep & (top_e >= lo) & (top_e < lo + out.shape[1])
        top_e = torch.where(keep, top_e - lo, 0)
    groups = out.shape[0]
    g_idx = torch.arange(groups, device=out.device)[:, None, None]
    row = torch.where(keep, rank, 0)
    gathered = out[g_idx, top_e, row]                     # (G, Tg, k, d)
    w = (top_p * keep).to(out.dtype)
    return (gathered * w[..., None]).sum(dim=2)


def _expert_cols(p, side: str) -> int:
    """The columns of a stack of routed experts' weights that the rank
    holds on the ``"in"`` or ``"out"`` side of its product."""
    if "packed" in p:                                    # (E, G, P, N)
        n = p["packed"].shape[3]
        return n * p["packed"].shape[2 if side == "in" else 1]
    return p["w"].shape[1 if side == "in" else 2]        # (E, d_in, d_out)


def moe_apply(params, x, cfg, cfg_sp: SparsityConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D). Returns (y, aux_loss).

    Dispatch runs per token group, one group per batch row, so a padded
    prompt bucket and a prefill chunk compete for expert capacity as the
    reference's do.  The router matmul runs in the compute dtype and is
    then cast to f32; the Switch aux loss is global.  On a mesh the rank
    computes its block of experts, or every expert on its block of each
    one's groups (see the module docstring)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    t = b * s
    groups = b
    held = next(iter(params["up"].values())).shape[0]     # experts held
    # experts whole but cut into blocks of their groups (``n_experts``
    # does not divide over ``model``): the hidden, and a packed down's
    # outputs, are blocks of columns
    cut_h = _expert_cols(params["up"], "out") < \
        _expert_cols(params["down"], "in")
    cut_y = _expert_cols(params["down"], "out") < d
    sh = serving()
    tg = t // groups
    # x enters the rank's block of experts (through the dispatch), and the
    # router's columns where they are a block too (they divide as the
    # experts do)
    xe = enter_blocks(x) if held < e or cut_h else x
    xg = (xe if held < e else x).reshape(groups, tg, d)
    logits = xg @ params["router"].to(x.dtype)            # (G, Tg, E)
    hidden = None
    if "shared" in params:
        hidden = ffn_hidden(params["shared"], x, cfg_sp, "silu")
    if sh is not None:
        logits, hidden = _gather_columns(
            sh, logits, e, hidden,
            hidden_width(params["shared"]) if hidden is not None else 0)
    probs = torch.softmax(logits.float(), dim=-1)         # (G, Tg, E)
    top_p, top_e = router_top_k(probs, k)                 # (G, Tg, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # load-balancing auxiliary loss (Switch-style, global: over the DP
    # group's tokens where the rules in force shard the batch)
    group = dp_group()
    t_all = t * group_size(group)
    if group is None:
        me = probs.mean(dim=(0, 1))                       # (E,)
    else:
        me = batch_sum(probs.sum(dim=(0, 1)), group) / t_all
    ce = batch_sum(torch.zeros(
        (e,), dtype=torch.float32, device=x.device).index_add_(
        0, top_e.reshape(-1),
        torch.full((t * k,), 1.0 / (t_all * k), device=x.device)), group)
    aux = e * torch.sum(me * ce)

    cap = int(np.ceil(tg * k / e * cfg.capacity_factor))
    buf, rank, keep = _dispatch(xe.reshape(groups, tg, d), top_e, e, k,
                                cap)                      # (G, E, C, d)
    lo = None
    if held < e:                # a mesh's block of experts
        lo = sh.block("model", e)[0]
        buf = buf[:, lo:lo + held]
    if held < e or cut_y:       # the combine of the rank's terms alone
        top_p = enter_blocks(top_p)

    up = _expert_matmul(params["up"], buf)
    if "gate" in params:
        h = tF.silu(_expert_matmul(params["gate"], buf)) * up
    else:
        h = tF.gelu(up, approximate="tanh")
    if cut_h:                   # each expert's k-WTA picks from its whole row
        h = sh.gather(h, {-1: "model"})
    if cfg_sp.activation_sparse:
        h = apply_kwta(h, cfg_sp)
    if cut_y:                   # the whole hidden feeds the rank's outputs
        h = enter_blocks(h)
    out = _expert_matmul(params["down"], h)               # (G, E', C, d')
    y = _combine(out, top_e, top_p, rank, keep, lo)
    if lo is not None:          # the block's terms, summed in float32
        y = sh.reduce_model(y.float()).to(x.dtype)
    if cut_y:
        y = sh.gather(y, {-1: "model"})
    y = y.reshape(b, s, d)

    if hidden is not None:
        y = y + ffn_down(params["shared"], hidden, cfg_sp)
    return y, aux


def _gather_columns(sh, logits, n_experts, hidden, width):
    """The router's logits and the shared experts' hidden (or None) made
    whole over ``model`` where each is a block of its columns, in one
    collective."""
    out = [logits, hidden]
    cut = [i for i, (t, n) in enumerate(((logits, n_experts),
                                         (hidden, width)))
           if t is not None and t.shape[-1] < n]
    if cut:
        for i, t in zip(cut, sh.gather_last(*(out[i] for i in cut))):
            out[i] = t
    return out
