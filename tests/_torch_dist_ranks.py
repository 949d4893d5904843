"""Rank functions of the port's distributed tests: each runs in a fresh
process that ``repro_torch.launch.ranks.run_ranks`` spawned and joined to
a gloo process group on the CPU.  This module imports neither JAX nor the
reference package: the tests hand it numpy arrays."""

import dataclasses

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.bridge import train_params_from_jax
from repro_torch.configs import TrainConfig, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import canonical
from repro_torch.launch import steps as St
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import Trainer, parse_mesh
from repro_torch.models import transformer as T
from repro_torch.optim.compression import (_ef_psum_leaf,
                                           make_compressed_grad_sync)
from repro_torch.runtime import pipeline_apply
from repro_torch.sharding import NamedSharding, make_rules, use_rules
from repro_torch.sharding.collectives import dp_group, gather_leaves, \
    group_size, summed
from repro_torch.tree import flatten, leaves, unflatten
from _torch_serve_ranks import config_of, mesh_serve_family

TRAIN_SHAPE = ShapeConfig("t", 32, 4, "train")


def _np(tree):
    return {k: v.detach().numpy().copy() for k, v in flatten(tree)}


def sharded_step(rank, cases, kwta_impl):
    """Test 5 and 4: for each (arch, cfg kwargs, tcfg kwargs, reference
    params as numpy, global batch) one sharded step on mesh (2, 2).
    Returns, per case: the loss and grad norm, the DP-mean gradients and
    the full params after the step (rank 0), and every rank's local
    param and moment shapes."""
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rules = make_rules(mesh, "train")
    out = []
    for arch, kw, tkw, np_params, batch in cases:
        cfg = get_config(arch).reduced(**kw)
        cfg = dataclasses.replace(cfg, ffn_sparsity=dataclasses.replace(
            cfg.ffn_sparsity, kwta_impl=kwta_impl))
        tcfg = TrainConfig(**tkw)
        full = train_params_from_jax(np_params, cfg, device="cpu")
        params, opt, shardings, shapes = St.shard_train_state(
            full, cfg, tcfg, rules)
        step, _ = St.make_sharded_train_step(cfg, tcfg, rules, shardings,
                                             shapes)
        rows = {k: rules.sharding_for(("batch", None), v.shape).take(
            torch.from_numpy(v)) for k, v in batch.items()}
        # the gradients the step averages (for the first-update bound):
        # the blocks', their DP mean made whole.  They come from the code
        # under test, so this bound cannot see a fault in the block
        # gradients: those are held against the reference's in
        # tests/_tp_train_cases.check_grads.
        _, grads = St.sharded_value_and_grad(cfg, rules, params, rows)
        with use_rules(rules):
            group = dp_group()
        floats = [i for i, g in enumerate(grads) if g is not None]
        blocks = summed([tuple(grads[i].shape) for i in floats],
                        lambda j, buf: buf.copy_(grads[floats[j]]), group,
                        "cpu")
        mean = gather_leaves(blocks, [leaves(shardings["params"])[i]
                                      for i in floats],
                             [shapes[i] for i in floats])
        local = {"params": {k: tuple(v.shape) for k, v in flatten(params)}}
        params, opt, m = step(params, opt, rows)
        # the float leaves' moments (an int leaf's is a scalar placeholder,
        # one a stacked leaf in the reference, one a layer here)
        local["mu"] = {k: tuple(v.shape) for (k, v), p in zip(
            flatten(opt["mu"]), leaves(params)) if p.is_floating_point()}
        state = St.gather_state({"params": params, "opt": opt}, shardings,
                                shapes)
        keys = [k for k, _ in flatten(params)]
        out.append({
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "aux": float(m["aux_loss"]), "local": local, "rows": {
                k: tuple(v.shape) for k, v in rows.items()},
            "grads": {keys[i]: (g / group_size(group)).numpy()
                      for i, g in zip(floats, mean)} if rank == 0 else None,
            "params": _np(state["params"]) if rank == 0 else None,
            "step": int(opt["step"])})
    return out


def mesh_refusals(rank):
    """Test 9 on a process group of four: every mesh whose size is not
    the world size raises."""
    msgs = []
    for call in (lambda: make_mesh((2, 1), ("data", "model"), "cpu"),
                 lambda: parse_mesh("1x1", "cpu"),
                 lambda: parse_mesh("2x2x2", "cpu")):
        try:
            call()
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    return msgs


def compressed_sync(rank, g_pods, extra):
    """Test 6 on mesh (2, 4) (pod, data): each pod's grads are row ``pod``
    of ``g_pods``; returns the sync's and ``_ef_psum_leaf``'s outputs and
    residuals, and the pod."""
    mesh = make_mesh((2, 4), ("pod", "data"), "cpu")
    pod = mesh.coords["pod"]
    sync = make_compressed_grad_sync(mesh, "pod")
    grads = {"w": torch.from_numpy(g_pods[pod]),
             "m": torch.from_numpy(extra[pod]),
             "i": torch.arange(3, dtype=torch.int32)}
    resids = {"w": torch.zeros((1, *g_pods.shape[1:])),
              "m": torch.zeros((1, *extra.shape[1:])),
              "i": torch.zeros((1,), dtype=torch.int32)}
    out, new = sync(grads, resids)
    leaf, leaf_r = _ef_psum_leaf(grads["w"], resids["w"][0],
                                 mesh.group("pod"), 2)
    return {"pod": pod, "out": _np(out), "resid": _np(new),
            "leaf": leaf.numpy(), "leaf_resid": leaf_r.numpy()}


def _tanh_stage(w, x):
    return torch.tanh(x @ w)


def pipeline(rank, ws, x):
    """Test 7 on mesh (4,) (pipe): the rank's stage is row ``pipe`` of
    ``ws``; then test 9's refusals on the same group."""
    mesh = make_mesh((4,), ("pipe",), "cpu")
    stage = mesh.coords["pipe"]
    y = pipeline_apply(_tanh_stage, mesh, "pipe",
                       torch.from_numpy(ws[stage:stage + 1]),
                       torch.from_numpy(x), n_micro=4)
    return y.numpy(), mesh_refusals(rank)


def resume_on_mesh(rank, ckpt_dir, cfg_kw, tcfg_kw, to_step):
    """Test 8: a Trainer on mesh (2, 2) resumes the (1, 1) run's
    checkpoint and runs to ``to_step``; returns the resumed step, each
    step's loss, the local shapes of the state and the full params at
    the end (rank 0)."""
    cfg = get_config("smollm-360m").reduced(**cfg_kw)
    tcfg = TrainConfig(ckpt_dir=ckpt_dir, **tcfg_kw)
    t = Trainer(cfg, tcfg, (2, 2), TRAIN_SHAPE, device="cpu")
    resumed = t.try_resume() and t.step
    losses = []
    check = t.guard.check
    t.guard.check = lambda loss: losses.append(loss) or check(loss)
    from repro_torch.data import batch_for
    t.run(to_step, lambda s: batch_for(cfg, TRAIN_SHAPE, s, seed=0),
          log=lambda *a: None)
    state = t.full_state()
    return {"resumed": resumed, "losses": losses, "step": t.step,
            "params": _np(state["params"]) if rank == 0 else None}


def reshard_restore(rank, directory):
    """``ckpt.restore(..., shardings=)`` onto another spec: process 0
    saves an (8, 8) leaf; every rank of mesh (2, 2) restores its block
    of it under (None, "model") and under ("data", "model")."""
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    x = torch.arange(64.0).reshape(8, 8)
    if rank == 0:
        ckpt.save(directory, 1, {"w": x})
    from repro_torch.sharding.collectives import barrier
    barrier(mesh)
    out = {}
    for spec in ((None, "model"), ("data", "model")):
        sh = NamedSharding(mesh, spec)
        _, tree, _ = ckpt.restore_latest(
            directory, {"w": torch.zeros(sh.local_shape((8, 8)))},
            {"w": sh})
        out[spec] = (tree["w"].numpy(), sh.block((8, 8)))
    return mesh.coords, out, np.asarray(x)


def sharded_remat(rank, arch, kw, np_params, batch):
    """One sharded step on mesh (2, 2) from the same state with and
    without remat: the loss and the full params after each (rank 0)."""
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rules = make_rules(mesh, "train")
    tcfg = TrainConfig()
    out = {}
    for remat in (False, True):
        cfg = get_config(arch).reduced(**kw, remat=remat)
        full = train_params_from_jax(np_params, cfg, device="cpu")
        params, opt, shardings, shapes = St.shard_train_state(
            full, cfg, tcfg, rules)
        step, _ = St.make_sharded_train_step(cfg, tcfg, rules, shardings,
                                             shapes)
        rows = {k: rules.sharding_for(("batch", None), v.shape).take(
            torch.from_numpy(v)) for k, v in batch.items()}
        params, opt, m = step(params, opt, rows)
        state = St.gather_state({"params": params, "opt": opt}, shardings,
                                shapes)
        out[remat] = {"loss": float(m["loss"]),
                      "params": _np(state["params"]) if rank == 0 else None}
    return out


def remat_other_thread(rank, arch, kw, batch):
    """The loss of the rank's rows of ``batch`` under the training rules
    of mesh (2, 1), with remat and without, its backward run on a thread
    of its own, outside the rules (as autograd runs a CUDA backward on
    its device thread): the loss and every gradient leaf."""
    import threading
    mesh = make_mesh((2, 1), ("data", "model"), "cpu")
    rules = make_rules(mesh, "train")
    rows = {k: rules.sharding_for(("batch", None), v.shape).take(
        torch.from_numpy(v)) for k, v in batch.items()}
    out = {}
    for remat in (False, True):
        cfg = get_config(arch).reduced(**kw, remat=remat)
        params = T.init_train_params(cfg, seed=0, device="cpu")
        views = [t.detach().requires_grad_() if t.is_floating_point() else t
                 for t in leaves(params)]
        with use_rules(rules):
            loss, _ = T.loss_fn(unflatten(params, views), rows, cfg)
        got = {}
        worker = threading.Thread(target=lambda: got.update(g=[
            g.numpy() for g in torch.autograd.grad(
                loss, [v for v in views if v.requires_grad])]))
        worker.start()
        worker.join()
        out[remat] = {"loss": float(loss.detach()), "grads": got["g"]}
    return out


def _tp_mesh(dims):
    axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    return make_mesh(dims, axes, "cpu")


def tp_train(rank, dims, cases, remat_check):
    """The training step on the rank's blocks on mesh ``dims`` ((data,
    model) or (pod, data, model)), for each (arch, cfg kwargs, reference
    params as numpy, global batch): the loss and gradient of the rank's
    rows on its blocks (:func:`steps.sharded_value_and_grad`, the step's
    own), their DP mean, two steps, and what the tests hold them to.
    Returns, per case: the rank's coordinates, each leaf's block slices
    and whether a mesh axis splits it, the loss, the DP-mean gradient
    blocks, the local gradients and the params after two steps of the
    whole leaves, the steps' grad norms, the collectives handed a tensor
    sharing storage with a param block, the calls of ``gather_leaves``
    inside the steps, and (with ``remat_check``) whether the loss and
    gradients without remat are bit-equal to those with it."""
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.collectives import observe_collectives
    mesh = _tp_mesh(dims)
    rules = make_rules(mesh, "train")
    tcfg = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=20, zero1=True)
    out = []
    for arch, kw, np_params, batch in cases:
        cfg = config_of(get_config, arch, kw)
        cfg = dataclasses.replace(cfg, ffn_sparsity=dataclasses.replace(
            cfg.ffn_sparsity, kwta_impl="topk"))
        full = train_params_from_jax(np_params, cfg, device="cpu")
        params, opt, shardings, shapes = St.shard_train_state(
            full, cfg, tcfg, rules)
        del full
        p_sh = leaves(shardings["params"])
        rows = {k: rules.sharding_for(("batch",) + (None,) * (v.ndim - 1),
                                      v.shape).take(torch.from_numpy(
                                          canonical(v)))
                for k, v in batch.items()}
        held = {t.untyped_storage().data_ptr() for t in leaves(params)}
        handed = []

        def watch(op, tensors):
            handed.extend(op for t in tensors
                          if t.untyped_storage().data_ptr() in held)

        with observe_collectives(watch):
            (loss, _), grads = St.sharded_value_and_grad(cfg, rules, params,
                                                         rows)
        floats = [i for i, g in enumerate(grads) if g is not None]
        with use_rules(rules):
            group = dp_group()
        mean = summed([tuple(grads[i].shape) for i in floats],
                      lambda j, buf: buf.copy_(grads[floats[j]]), group,
                      "cpu")
        keys = [k for k, _ in flatten(params)]
        rec = {"coords": mesh.coords, "loss": float(loss),
               "blocks": {keys[i]: p_sh[i].block(shapes[i]) for i in floats},
               "split": {keys[i]: bool(p_sh[i].axes) for i in floats},
               "grads": {keys[i]: (g / group_size(group)).numpy()
                         for i, g in zip(floats, mean)},
               "local_whole": {keys[i]: grads[i].numpy() for i in floats
                               if not p_sh[i].axes}}
        if remat_check:
            (loss0, _), grads0 = St.sharded_value_and_grad(
                dataclasses.replace(cfg, remat=False), rules, params, rows)
            rec["remat_equal"] = bool(torch.equal(loss0, loss)) and all(
                torch.equal(grads0[i], grads[i]) for i in floats)
        del grads, mean
        step, _ = St.make_sharded_train_step(cfg, tcfg, rules, shardings,
                                             shapes)
        calls = []
        real = C.gather_leaves

        def counted(*a, **k):
            calls.append(1)
            return real(*a, **k)

        St.gather_leaves = C.gather_leaves = counted
        norms = []
        try:
            with observe_collectives(watch):
                for _ in range(2):
                    params, opt, m = step(params, opt, rows)
                    norms.append(float(m["grad_norm"]))
        finally:
            St.gather_leaves = C.gather_leaves = real
        flat = leaves(params)
        rec.update(norms=norms, handed=handed, gathers=len(calls),
                   params_whole={keys[i]: flat[i].numpy().copy()
                                 for i in floats if not p_sh[i].axes},
                   step=int(opt["step"]))
        out.append(rec)
    return out


def trainer_round_trip(dims, cfg_kw, ckpt_dir):
    """A Trainer of smollm reduced (``config_of``'s kwargs) on mesh
    ``dims``: one step, a checkpoint, a second Trainer resuming it and
    taking one more step.  Returns whether the resumed state equals the
    saved one, the block routes the resumed rank holds, the checkpoint's
    leaf paths, and the loss of the step after the resume."""
    cfg = config_of(get_config, "smollm-360m", cfg_kw)
    tcfg = TrainConfig(ckpt_dir=ckpt_dir)

    def batches(step):
        from repro_torch.data import batch_for
        return batch_for(cfg, TRAIN_SHAPE, step, seed=0)

    first = Trainer(cfg, tcfg, dims, TRAIN_SHAPE, device="cpu")
    first.run(1, batches, log=lambda *a: None)
    first.save(async_=False)
    saved = first.full_state()
    again = Trainer(cfg, tcfg, dims, TRAIN_SHAPE, device="cpu")
    resumed = again.try_resume()
    state = again.full_state()
    out = {"resumed": resumed,
           "equal": [k for k, _ in flatten(saved)] ==
           [k for k, _ in flatten(state)] and all(
               torch.equal(a, b) for a, b in zip(leaves(saved),
                                                 leaves(state))),
           "routes": [k for k, _ in flatten(again.params)
                      if k.endswith("block_route")],
           "saved": [k for k, _ in flatten(saved["params"])]}
    # (the full state's whole leaves are the live params, which the step
    # updates in place)
    out["loss"] = float(again.train_step({
        k: torch.from_numpy(canonical(v))
        for k, v in batches(again.step).items()})["loss"])
    return out


def mesh_cuts(rank, dims, train_cases, serve_jobs, resume):
    """The training step (:func:`tp_train`'s records, under "train"), the
    engine (:func:`mesh_serve_family`'s, under "serve") and
    :func:`trainer_round_trip` of ``resume`` (its config kwargs and
    checkpoint directory, under "resume") on mesh ``dims``, in one
    spawn."""
    return {"train": tp_train(rank, dims, train_cases, False),
            "serve": mesh_serve_family(rank, dims, serve_jobs),
            "resume": trainer_round_trip(dims, *resume)}


def vocab_parallel_ce(rank, dims, logits, labels, mask):
    """:func:`repro_torch.models.common.cross_entropy` of the rank's block
    of ``logits``' vocabulary columns (and its rows, over the DP axes)
    with ``vocab=``, without and with ``mask``: the losses and the
    gradient of the block."""
    from repro_torch.models.common import cross_entropy
    mesh = _tp_mesh(dims)
    rules = make_rules(mesh, "train")
    sh = rules.sharding_for(("batch", None, "vocab"), logits.shape)
    blk = sh.block(logits.shape)
    x = torch.from_numpy(logits)[blk].clone().requires_grad_()
    lab = torch.from_numpy(labels)[blk[0]]
    m = torch.from_numpy(mask)[blk[0]]
    vocab = (blk[2].start, mesh.group("model"))
    out = {"block": blk}
    with use_rules(rules):
        for name, kw in (("mean", {}), ("masked", {"mask": m})):
            loss = cross_entropy(x, lab, vocab=vocab, **kw)
            out[name] = float(loss)
            out[f"{name}_grad"] = torch.autograd.grad(loss, x)[0].numpy()
    return out
