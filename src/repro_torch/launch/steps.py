"""Step functions: the training step, the optimizer step alone, and the
serving and prefill steps — the reference's ``repro.launch.steps``.

The training step is eager PyTorch (no ``torch.compile``, no autocast):
the loss on the training-layout params (float32 masters cast at each
use), ``torch.autograd.grad`` over every float leaf, then AdamW in place.
No kernel of :mod:`repro_torch.kernels` runs in it: every projection of a
training batch takes the Hadamard path, as in the reference.

The spec helpers of the mesh step: :func:`batch_logical_specs` and
:func:`zero1_specs`.

For the dry run and the roofline (:mod:`repro_torch.launch.dryrun`):
:func:`abstract_params`, :func:`abstract_cache` and :func:`input_specs`
make a cell's params, cache and batch as fake tensors
(:func:`fake`: shapes and types, no storage), so the largest config is
traced on the CPU without allocating a weight; the accounting steps
:func:`make_unit_train_step`, :func:`make_unit_fwd_step` and
:func:`make_head_train_step` run one unit, and the embedding, head and
loss, alone.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T
from repro_torch.models.common import (cross_entropy, dtype_of,
                                       embedding_block_apply)
from repro_torch.optim import (AdamWConfig, apply_updates, global_norm,
                               warmup_cosine)
from repro_torch.sharding import (NamedSharding, Rules, UnitSpec, dp_axes,
                                  make_rules, param_sharding, use_rules)
from repro_torch.sharding.collectives import (gather_leaves, gather_pieces,
                                             group_size, summed)
from repro_torch.sharding.context import map_specs
from repro_torch.sharding.serving import (Shards, enter_blocks, serving,
                                          use_serving)
from repro_torch.tree import fake, flatten, leaves, map_tree, unflatten


def value_and_grad(fn: Callable, params, *args
                   ) -> Tuple[Tuple, List[Optional[torch.Tensor]]]:
    """``fn(params, *args)`` -> ``(loss, aux)`` and the gradient of
    ``loss`` for every leaf of ``params`` in :func:`repro_torch.tree.flatten`'s
    order (``None`` for an int leaf), as ``jax.value_and_grad(...,
    has_aux=True, allow_int=True)`` gives them.  The params' tensors are
    left as they are: the gradients flow through detached views."""
    flat = flatten(params)
    views = [t.detach().requires_grad_() if t.is_floating_point() else t
             for _, t in flat]
    with torch.enable_grad():
        loss, aux = fn(unflatten(params, views), *args)
        wrt = [v for v in views if v.requires_grad]
        grads = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    aux = {k: v.detach() for k, v in aux.items()}
    return (loss.detach(), aux), [next(grads) if v.requires_grad else None
                                  for v in views]


def batch_logical_specs(batch) -> Dict[str, Tuple]:
    """Every batch input shards its rows over ``batch``."""
    return {k: ("batch",) + (None,) * (v.ndim - 1) for k, v in batch.items()}


def zero1_specs(param_specs, param_shapes, rules: Rules):
    """Extend each moment leaf's spec with the DP axes on the first
    shardable (currently replicated, divisible) dimension: optimizer-state
    sharding (ZeRO-1).  ``param_shapes`` holds tensors or shape tuples at
    the places of ``param_specs``' leaves; a :class:`UnitSpec` is extended
    on its stacked shape, so the unit axis comes first.  A spec whose
    length differs from the leaf's rank is left as it is."""
    dp = dp_axes(rules.mesh)
    if not dp:
        return param_specs
    dp_size = rules.axis_size(dp)

    def extend(spec, leaf):
        shape = tuple(getattr(leaf, "shape", leaf))
        if isinstance(spec, UnitSpec):
            return dataclasses.replace(spec, spec=extend(
                spec.spec, (spec.n_units, *shape)))
        if len(spec) != len(shape):
            return spec
        spec = list(spec)
        for i, (ax, dim) in enumerate(zip(spec, shape)):
            # eligible if the dim currently resolves to no mesh axes
            resolved = rules.resolve(ax, dim) if isinstance(ax, str) else ax
            if resolved in (None, ()) and dim % dp_size == 0 and dim > 0:
                spec[i] = dp
                break
        return tuple(spec)

    return map_specs(extend, param_specs, param_shapes)


def adamw_config(tcfg: TrainConfig) -> AdamWConfig:
    return AdamWConfig(lr=tcfg.lr, b1=tcfg.b1, b2=tcfg.b2,
                       weight_decay=tcfg.weight_decay,
                       grad_clip=tcfg.grad_clip,
                       moment_dtype=dtype_of(tcfg.moment_dtype))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns ``(train_step, acfg)``; ``train_step(params, opt_state,
    batch)`` updates ``params`` and ``opt_state`` (:func:`init_state`'s)
    in place and returns them with the step's metrics (loss, lm_loss,
    aux_loss, grad_norm).  It is :func:`make_sharded_train_step` on a
    one-rank mesh of the params' device, where every leaf is its own
    block and no collective runs: the step the Trainer runs."""
    acfg = adamw_config(tcfg)
    built = []

    def train_step(params, opt_state, batch):
        if not built:
            mesh = Mesh((1, 1), ("data", "model"), leaves(params)[0].device)
            rules = make_rules(mesh, "train")
            built.append(make_sharded_train_step(
                cfg, tcfg, rules, *train_shardings(params, cfg, tcfg,
                                                   rules))[0])
        return built[0](params, opt_state, batch)

    return train_step, acfg


def train_shardings(full_params, cfg: ModelConfig, tcfg: TrainConfig,
                    rules: Rules):
    """``(shardings, shapes)`` of the training state of ``full_params``
    (the port's training layout): ``shardings`` = ``{"params", "opt"}``
    holds a :class:`repro_torch.sharding.NamedSharding` a leaf of the
    state tree (the params by the reference's specs under ``rules``, the
    moments by :func:`zero1_specs` where ``tcfg.zero1``), ``shapes`` the
    full params' shapes in :func:`repro_torch.tree.flatten`'s order."""
    specs = T.layer_specs(T.param_specs(cfg), cfg)
    zspecs = zero1_specs(specs, full_params, rules) if tcfg.zero1 else specs
    p_shapes = [tuple(t.shape) for t in leaves(full_params)]
    moments = param_sharding(zspecs, unflatten(full_params, [
        s if t.is_floating_point() else ()
        for s, t in zip(p_shapes, leaves(full_params))]), rules)
    return {"params": param_sharding(specs, full_params, rules),
            "opt": {"mu": moments, "nu": moments,
                    "step": NamedSharding(rules.mesh, ())}}, p_shapes


def shard_train_state(full_params, cfg: ModelConfig, tcfg: TrainConfig,
                      rules: Rules):
    """This rank's blocks of the training state, from the full params in
    the port's training layout: ``(params, opt_state, shardings,
    shapes)``, the last two :func:`train_shardings`', extended by every
    ``block_route`` the blocks hold (a derived leaf, as serving's blocks
    make it: :func:`repro_torch.models.transformer.add_block_routes`;
    whole on the rank, never moved, dropped by :func:`gather_state`).
    Raises where serving on the mesh would
    (:func:`repro_torch.models.transformer.check_blocks`).  A moment
    block a rank does not hold is an empty tensor."""
    shardings, p_shapes = train_shardings(full_params, cfg, tcfg, rules)
    params = map_tree(lambda t, sh: sh.take(t), full_params,
                      shardings["params"])
    T.check_blocks(params, full_params)
    params = T.add_block_routes(params, full_params, shardings["params"])
    # each block_route's place: whole on the rank, its own shape
    known = {p: i for i, (p, _) in enumerate(flatten(full_params))}
    at = [known.get(p) for p, _ in flatten(params)]
    whole = NamedSharding(rules.mesh, ())

    def extend(tree):
        flat = leaves(tree)
        return unflatten(params, [whole if i is None else flat[i]
                                  for i in at])

    shardings = {"params": extend(shardings["params"]),
                 "opt": {"mu": extend(shardings["opt"]["mu"]),
                         "nu": extend(shardings["opt"]["nu"]),
                         "step": shardings["opt"]["step"]}}
    p_shapes = [tuple(t.shape) if i is None else p_shapes[i]
                for i, t in zip(at, leaves(params))]
    moment_dtype = dtype_of(tcfg.moment_dtype)
    device = leaves(full_params)[0].device

    def zeros(t, shape, sh):
        if not t.is_floating_point():
            return torch.zeros((), dtype=torch.int32, device=device)
        return torch.zeros(sh.local_shape(shape), dtype=moment_dtype,
                           device=device)

    mu = unflatten(params, [zeros(t, s, sh) for t, s, sh in zip(
        leaves(params), p_shapes, leaves(shardings["opt"]["mu"]))])
    opt = {"mu": mu, "nu": map_tree(torch.zeros_like, mu),
           "step": torch.zeros((), dtype=torch.int32, device=device)}
    return params, opt, shardings, p_shapes


def gather_state(state, shardings, shapes):
    """The full ``{"params", "opt"}`` tree of a sharded state
    (:func:`shard_train_state`'s ``shardings`` and param ``shapes``):
    every rank takes part and gets the whole, in the training layout (no
    ``block_route``)."""
    def full(tree, sh, shp):
        return T.drop_block_routes(unflatten(
            tree, gather_leaves(leaves(tree), leaves(sh), shp)))

    params, opt = state["params"], state["opt"]
    m_shapes = [s if t.is_floating_point() else ()
                for s, t in zip(shapes, leaves(params))]
    return {"params": full(params, shardings["params"], shapes),
            "opt": {"mu": full(opt["mu"], shardings["opt"]["mu"], m_shapes),
                    "nu": full(opt["nu"], shardings["opt"]["nu"], m_shapes),
                    "step": opt["step"]}}


def sharded_value_and_grad(cfg: ModelConfig, rules: Rules, params, batch):
    """:func:`value_and_grad` of the loss of the rank's rows ``batch`` on
    the rank's param blocks ``params`` under ``rules`` and the training
    shards (:class:`Shards`; none on one rank): the gradient of every
    leaf is the gradient of its block, as the mesh step takes it."""
    shards = Shards(rules, 0) if rules.mesh.size > 1 else None
    with use_rules(rules), use_serving(shards):
        return value_and_grad(lambda p: T.loss_fn(p, batch, cfg), params)


def make_sharded_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                            rules: Rules, shardings, shapes):
    """Returns ``(train_step, acfg)``: the training step on a mesh, where
    each rank holds the blocks of the params and of the moments (ZeRO-1)
    that ``shardings`` gives it (:func:`shard_train_state`), and its rows
    of the batch.

    ``train_step(params, opt_state, batch)``:
      1. runs forward and backward on the rank's param blocks and rows
         under ``rules`` and the training shards
         (:class:`repro_torch.sharding.serving.Shards`), as the
         reference's GSPMD step partitions it: no param is gathered, each
         gradient comes out as the param's block, the loss is
         vocab-parallel and the batch statistics are the global batch's
         (:func:`repro_torch.sharding.collectives.batch_sum`);
      2. takes the gradient blocks' mean over the DP group, and their
         global norm for the clip (a block's squares summed over the axes
         that split its leaf, a whole leaf's counted once);
      3. updates, in place, the slice of each param block that its moment
         block covers, as :func:`repro_torch.optim.apply_updates` updates
         whole leaves;
      4. gathers each DP group's updated slices into the blocks where
         ZeRO-1 split a block over the group.
    At a one-rank mesh without a process group no collective runs and the
    model runs on whole tensors (:func:`make_train_step`)."""
    acfg = adamw_config(tcfg)
    mesh = rules.mesh
    dp = dp_axes(mesh)
    dp_group = mesh.group(dp) if dp else None
    p_sh = leaves(shardings["params"])
    m_sh = leaves(shardings["opt"]["mu"])
    # the group each float leaf's squares sum over (None: whole on every
    # rank, counted once)
    norm_groups = [mesh.group(sh.axes) if sh.axes else None for sh in p_sh]

    def rel(i, coords=None):
        """The slice of the rank's param block ``i`` that the moment block
        of the member at ``coords`` (this rank by default) covers: the two
        differ on the moments' extra axes alone.  None where that member
        holds none of the leaf's moments."""
        m_blk = m_sh[i].block(shapes[i], coords)
        if m_blk is None:
            return None
        return tuple(slice(m.start - p.start, m.stop - p.start)
                     for m, p in zip(m_blk, p_sh[i].block(shapes[i])))

    def mean_over_dp(grads, flat_p, floats):
        if dp_group is None:
            return grads

        def fill(j, buf):
            if grads[floats[j]] is not None:
                buf.copy_(grads[floats[j]])

        bufs = summed([flat_p[i].shape for i in floats], fill, dp_group,
                      mesh.device)
        out = list(grads)
        n = group_size(dp_group)
        for i, buf in zip(floats, bufs):
            out[i] = (buf / n).to(grads[i].dtype if grads[i] is not None
                                  else buf.dtype)
        return out

    def put_back(flat_p, floats):
        """Each DP member's updated slices into the rank's param blocks,
        where ZeRO-1 split a block over the DP axes."""
        by_key = {}
        for i in floats:
            extra = tuple(a for a in m_sh[i].axes if a not in p_sh[i].axes)
            if extra:
                by_key.setdefault((mesh.ordered(extra), flat_p[i].dtype),
                                  []).append(i)
        for (axes, _), idx in by_key.items():
            mine = [rel(i) for i in idx]
            gather_pieces(mesh, axes, [None if b is None else flat_p[i][b]
                                       for i, b in zip(idx, mine)],
                          [flat_p[i] for i in idx],
                          lambda j, coords, idx=idx: rel(idx[j], coords))

    def train_step(params, opt_state, batch):
        flat_p = leaves(params)
        (_, metrics), grads = sharded_value_and_grad(cfg, rules, params,
                                                     batch)
        floats = [i for i, t in enumerate(flat_p) if t.is_floating_point()]
        grads = mean_over_dp(grads, flat_p, floats)
        norm = global_norm(grads, norm_groups)
        mu, nu = leaves(opt_state["mu"]), leaves(opt_state["nu"])
        own = {i: rel(i) for i in floats}
        own = {i: b for i, b in own.items() if b is not None}
        lr_scale = warmup_cosine(opt_state["step"], tcfg.warmup_steps,
                                 tcfg.total_steps)
        _, _, om = apply_updates(
            [flat_p[i][b] for i, b in own.items()],
            [None if grads[i] is None else grads[i][b]
             for i, b in own.items()],
            {"mu": [mu[i] for i in own], "nu": [nu[i] for i in own],
             "step": opt_state["step"]}, acfg, lr_scale, norm=norm)
        with torch.no_grad():
            put_back(flat_p, floats)
        metrics.update(om)
        return params, opt_state, metrics

    return train_step, acfg


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, cache, batch, pos):
        return T.serve_step(params, cache, batch, pos, cfg)

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    """The forward's next-token logits (B, vocab), with no autograd
    record (so no remat)."""
    def prefill_step(params, batch):
        with torch.no_grad():
            logits, _ = T.forward(params, batch, cfg)
        return logits[:, -1]  # next-token logits

    return prefill_step


def make_opt_step(cfg: ModelConfig, tcfg: TrainConfig):
    """The optimizer update alone (default AdamW hyper-parameters with the
    run's moment dtype, as the reference's), in place."""
    acfg = AdamWConfig(moment_dtype=dtype_of(tcfg.moment_dtype))

    def step(params, grads, opt_state):
        apply_updates(params, grads, opt_state, acfg, 1.0)
        return params, opt_state

    return step


# ---------------------------------------------------------------------------
# Abstract init and input specs (fake tensors: shapes and types only)
# ---------------------------------------------------------------------------

def abstract_params(cfg: ModelConfig, rules: Optional[Rules] = None,
                    device=None, mode: Optional[FakeTensorMode] = None):
    """``(params, specs)`` without allocating: the reference's tree (its
    ``init_model``'s leaves in ``param_dtype``) in the port's training
    layout (:func:`repro_torch.models.transformer.init_train_params`) as
    fake tensors on ``device`` (``cuda`` unless it says otherwise), and
    its logical specs in that layout.  With ``rules``, this rank's blocks
    of it, each leaf cut by its spec (:meth:`NamedSharding.take`: an empty
    tensor where the rank holds none of a unit leaf).  ``mode``: the fake
    mode to make them in (:func:`fake`)."""
    specs = T.layer_specs(T.param_specs(cfg), cfg)

    def make():
        params = T.init_train_params(cfg, seed=0, device="cpu")
        if rules is None:
            return params
        return map_tree(lambda sh, t: sh.take(t),
                        param_sharding(specs, params, rules), params)

    return fake(make, device or "cuda", mode), specs


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int,
                   rules: Optional[Rules] = None, device=None,
                   mode: Optional[FakeTensorMode] = None):
    """``(cache, specs)`` of :func:`repro_torch.models.transformer.
    init_cache` as fake tensors (with ``rules``, this rank's blocks) and
    its logical specs in the port's per-layer layout."""
    return (fake(lambda: T.init_cache(cfg, batch, max_seq, "cpu",
                                      rules=rules), device or "cuda", mode),
            T.layer_cache_specs(cfg))


def input_specs(cfg: ModelConfig, shape: ShapeConfig, device=None,
                mode: Optional[FakeTensorMode] = None
                ) -> Dict[str, torch.Tensor]:
    """Fake stand-ins for every model input of this cell (the reference's
    ``input_specs``), token ids as the port's int64."""
    b, s = shape.global_batch, shape.seq_len
    ct, i64 = dtype_of(cfg.compute_dtype), torch.int64

    def make():
        if shape.kind == "decode":
            if cfg.frontend == "embed":
                return {"embeds": torch.empty((b, 1, cfg.d_model), dtype=ct)}
            return {"tokens": torch.empty((b, 1), dtype=i64)}
        if cfg.frontend == "embed":
            batch = {"embeds": torch.empty((b, s, cfg.d_model), dtype=ct),
                     "labels": torch.empty((b, s), dtype=i64)}
        elif cfg.frontend == "vision_prefix":
            s_txt = s - cfg.n_prefix
            batch = {"tokens": torch.empty((b, s_txt), dtype=i64),
                     "patch_embeds": torch.empty((b, cfg.n_prefix,
                                                  cfg.d_model), dtype=ct),
                     "labels": torch.empty((b, s_txt), dtype=i64)}
        else:
            batch = {"tokens": torch.empty((b, s), dtype=i64),
                     "labels": torch.empty((b, s), dtype=i64)}
        if shape.kind == "prefill":
            batch.pop("labels", None)
        return batch

    return fake(make, device or "cuda", mode)


# ---------------------------------------------------------------------------
# Accounting steps: one unit, and the embedding + head + loss, alone
# ---------------------------------------------------------------------------

def make_unit_train_step(cfg: ModelConfig):
    """Forward and backward through ONE unit (``{"b{i}": layer params}``,
    :func:`repro_torch.models.transformer.unit_step_fn`): the gradients of
    the unit's params and of x, in :func:`repro_torch.tree.flatten`'s
    order of ``{"unit", "x"}``."""
    unit_fn = T.unit_step_fn(cfg)

    def step(unit_params, shared, x, positions):
        def lf(p):
            y, aux = unit_fn(p["unit"], shared, p["x"], positions)
            return torch.sum(y.float() ** 2) + aux, {}

        return value_and_grad(lf, {"unit": unit_params, "x": x})[1]

    return step


def make_unit_fwd_step(cfg: ModelConfig):
    unit_fn = T.unit_step_fn(cfg)

    def step(unit_params, shared, x, positions):
        with torch.no_grad():
            return unit_fn(unit_params, shared, x, positions)[0]

    return step


def make_head_train_step(cfg: ModelConfig):
    """The embedding lookup, the LM head and the loss, forward and backward
    (the vocabulary's part of a training step): the gradients of the table
    and of x.  Under training shards whose table is a block of the
    vocabulary's rows, the lookup, the head and the loss are
    vocab-parallel, as the training step's."""
    ct = dtype_of(cfg.compute_dtype)

    def step(table, tokens, labels, x):
        def lf(p):
            t, h, sh = p["table"].to(ct), p["x"], serving()
            vocab = None if sh is None else sh.vocab(cfg.padded_vocab,
                                                     t.shape[0])
            if vocab is None:
                emb = t[tokens]
            else:
                emb = sh.reduce_model(embedding_block_apply(
                    p["table"], tokens, ct, vocab[0]))
                h = enter_blocks(h)
            logits = h @ t.T
            return (cross_entropy(logits[:, :-1], labels[:, 1:], vocab=vocab)
                    + 0.0 * torch.sum(emb.float() ** 2)), {}

        return value_and_grad(lf, {"table": table, "x": x})[1]

    return step
