"""Rank functions of the port's mesh serving tests
(tests/test_torch_mesh_serve.py): each runs in a fresh process that
``repro_torch.launch.ranks.run_ranks`` spawned and joined to a gloo
process group on the CPU.  No JAX: the tests hand it numpy arrays."""

import dataclasses

import numpy as np
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.layers import drop_partition_major, partition_major
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import Engine
from repro_torch.models.transformer import drop_block_routes
from repro_torch.runtime.scheduler import Request, SamplingParams
from repro_torch.sharding.collectives import observe_collectives
from repro_torch.tree import flatten, leaves

SAMPLED = dict(temperature=0.8, top_k=5)


def _np(tree):
    return {k: v.numpy().copy() for k, v in flatten(tree)}


def config_of(get, arch, kw):
    """``get(arch).reduced(**kw)`` (``get`` either package's
    ``get_config``), a ``route_share`` in ``kw`` set on its FFN's
    sparsity."""
    kw = dict(kw)
    share = kw.pop("route_share", None)
    cfg = get(arch).reduced(**kw)
    if share is not None:
        cfg = dataclasses.replace(cfg, ffn_sparsity=dataclasses.replace(
            cfg.ffn_sparsity, route_share=share))
    return cfg


def requests(spec, sampled):
    return [Request(uid=i, prompt=p, max_new_tokens=g,
                    sampling=SamplingParams(**SAMPLED, seed=i) if sampled
                    else SamplingParams())
            for i, (p, g) in enumerate(spec)]


def _storages(tree):
    return {t.untyped_storage().data_ptr() for t in leaves(tree)}


class Recorder:
    """Every collective an engine runs: whether a decode step ran it, the
    sizes of its tensors and whether one of them is (or views) a param or
    a cache block, by storage, while both are alive."""

    def __init__(self, engine):
        self.calls, self.caches, self.in_step = [], [], False
        self.held = _storages(engine.params)
        for name in ("new_cache", "new_paged_cache"):
            make = getattr(engine, name)
            setattr(engine, name, lambda *a, make=make: self._keep(make(*a)))
        step = engine._decode_step

        def decode_step(*a, **kw):
            self.in_step = True
            try:
                return step(*a, **kw)
            finally:
                self.in_step = False
        engine._decode_step = decode_step

    def _keep(self, cache):
        self.caches.append(cache)       # alive while the recorder is
        self.held |= _storages(cache)
        return cache

    def __call__(self, op, tensors):
        self.calls.append((self.in_step, op, [t.numel() for t in tensors],
                           sum(t.untyped_storage().data_ptr() in self.held
                               for t in tensors)))

    def summary(self, n_steps):
        """The collectives of the decode steps, and how many tensors
        handed to any collective were a param or cache block."""
        step = [c for c in self.calls if c[0]]
        return {"weights_moved": sum(c[3] for c in self.calls),
                "per_step": len(step) / max(n_steps, 1),
                "largest": max((max(c[2]), c[1]) for c in step),
                "ops": sorted({c[1] for c in self.calls})}


def mesh_serve(rank, dims, np_params, cfg_kw, spec, layouts, static):
    """One mesh: for each layout, greedy and sampled tokens of ``spec``
    (every collective recorded), the rank's param and fresh cache blocks;
    on the contiguous layout the cache blocks and logits after four
    prefills, their inserts and one decode step, and
    ``generate_static``'s tokens of ``static`` (a batch of prompts, new
    tokens)."""
    cfg = get_config("smollm-360m").reduced(**cfg_kw)
    mesh = make_mesh(dims, ("data", "model"), "cpu")
    params = params_from_jax(np_params, cfg, device="cpu")
    out = {"coords": mesh.coords}
    for layout, kw in layouts.items():
        eng = Engine(cfg, max_seq=32, n_slots=4, params=params,
                     device="cpu", mesh=mesh, **kw)
        rec = Recorder(eng)
        res = {}
        with observe_collectives(rec):
            for mode in ("greedy", "sampled"):
                toks, stats = eng.serve(requests(spec, mode == "sampled"))
                res[mode] = {u: list(v) for u, v in toks.items()}
        res["collectives"] = rec.summary(2 * stats["decode_steps"])
        res["params"] = _np(drop_partition_major(eng.params))
        res["packed_p"] = all(
            torch.equal(p["packed_p"], partition_major(p["packed"]))
            for layer in eng.params["layers"] for p in layer["ffn"].values())
        fresh = (eng.new_paged_cache() if layout == "paged"
                 else eng.new_cache(4))
        res["cache"] = _np(fresh)
        if layout == "contiguous":
            with eng.on_mesh():
                for slot, (prompt, _) in enumerate(spec[:4]):
                    _, frag = eng._prefill(prompt)
                    eng._insert(fresh, frag, slot)
                toks = np.array([[p[-1]] for p, _ in spec[:4]])
                pos = np.array([len(p) for p, _ in spec[:4]])
                logits, _ = eng._decode_step(fresh, toks, pos)
            res["written"] = _np(fresh)
            res["step_logits"] = logits
            res["static"] = eng.generate_static(*static)
        out[layout] = res
    return out


def _shared_packed_p(params):
    """Every packed layer's ``packed_p`` is ``partition_major`` of its
    ``packed`` (a rank's block made anew from the block)."""
    def walk(tree):
        if isinstance(tree, dict):
            if "packed_p" in tree:
                yield torch.equal(tree["packed_p"],
                                  partition_major(tree["packed"]))
            for v in tree.values():
                yield from walk(v)
        elif isinstance(tree, list):
            for v in tree:
                yield from walk(v)
    return all(walk(params))


def mesh_serve_family(rank, dims, jobs):
    """One mesh, models of any attention family (MLA, MoE, the int8
    cache): for each job ``(name, arch, np_params, cfg_kw, spec,
    layouts)`` and each of its layouts, the greedy tokens of ``spec``
    (every collective recorded), the rank's param blocks (without their
    ``block_route``) and its fresh cache blocks, under ``name``."""
    mesh = make_mesh(dims, ("data", "model"), "cpu")
    out = {"coords": mesh.coords}
    for name, arch, np_params, cfg_kw, spec, layouts in jobs:
        cfg = config_of(get_config, arch, cfg_kw)
        params = params_from_jax(np_params, cfg, device="cpu")
        out[name] = {}
        for layout, kw in layouts.items():
            eng = Engine(cfg, max_seq=32, n_slots=4, params=params,
                         device="cpu", mesh=mesh, **kw)
            rec = Recorder(eng)
            with observe_collectives(rec):
                toks, stats = eng.serve(requests(spec, False))
            out[name][layout] = {
                "greedy": {u: list(v) for u, v in toks.items()},
                "collectives": rec.summary(stats["decode_steps"]),
                "params": _np(drop_block_routes(
                    drop_partition_major(eng.params))),
                "packed_p": _shared_packed_p(eng.params),
                "cache": _np(eng.new_paged_cache() if layout == "paged"
                             else eng.new_cache(4))}
    return out


def frontend_steps(rank, dims, arch, np_params, cfg_kw, max_seq, prompt,
                   steps):
    """``prefill`` of the frontend's stub inputs ``prompt`` and a decode
    step of each of ``steps`` (batches at positions after the prompt) on
    the rank's blocks under the serving mesh: the logits of each call."""
    from repro_torch.models import transformer as T
    from repro_torch.sharding.serving import Shards, use_serving
    cfg = get_config(arch).reduced(**cfg_kw)
    mesh = make_mesh(dims, ("data", "model"), "cpu")
    shards = Shards.of(mesh, max_seq)
    params = T.param_blocks(params_from_jax(np_params, cfg, device="cpu"),
                            cfg, shards.rules)

    def tensors(batch):
        return {k: torch.from_numpy(v) for k, v in batch.items()}

    with torch.no_grad(), use_serving(shards):
        logits, cache = T.prefill(params, tensors(prompt), cfg, max_seq)
        rows = [logits.numpy()]
        for pos, batch in steps:
            logits, cache = T.serve_step(params, cache, tensors(batch), pos,
                                         cfg)
            rows.append(logits.numpy())
    return rows


def serve_cli(rank, argv):
    """The serve CLI's body on this rank (the process group is up): what
    it prints."""
    import contextlib
    import io

    from repro_torch.launch.serve import _serve_cli, build_parser
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch).reduced()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _serve_cli(args, cfg, args.device)
    return out.getvalue()


def pod_serve(rank, dims, np_params, cfg_kw, spec):
    """A (pod, data, model) mesh: greedy tokens of ``spec`` on the
    contiguous layout, and the rank's fresh cache blocks' shapes."""
    cfg = get_config("smollm-360m").reduced(**cfg_kw)
    mesh = make_mesh(dims, ("pod", "data", "model"), "cpu")
    eng = Engine(cfg, max_seq=32, n_slots=4, device="cpu", mesh=mesh,
                 params=params_from_jax(np_params, cfg, device="cpu"))
    toks, _ = eng.serve(requests(spec, False))
    return {"coords": mesh.coords,
            "greedy": {u: list(v) for u, v in toks.items()},
            "cache": [tuple(leaf.shape) for leaf in leaves(eng.new_cache(4))]}


def mesh_serve_ssm(rank, dims, jobs, static, long=None):
    """One mesh, the SSM/hybrid patterns: for each job ``(arch,
    np_params, cfg_kw)``, under ``arch``, ``generate_static``'s tokens of
    ``static`` (prompts, new tokens; every collective recorded), the
    rank's param blocks and fresh cache blocks, its cache blocks and the
    logits after stepping through the prompts, and what ``Engine.serve``
    raises.  With ``long``, a list of ``(arch, np_params, cfg_kw,
    prompt)``, under "long" and each arch, the logits of stepping through
    ``prompt`` (one row) under the ``decode_long`` rules and the rank's
    cache shapes."""
    from repro_torch.models import transformer as T
    from repro_torch.sharding import make_rules
    from repro_torch.sharding.serving import Shards
    mesh = make_mesh(dims, ("data", "model"), "cpu")
    out = {"coords": mesh.coords}
    prompts, gen = static
    for arch, np_params, cfg_kw in jobs:
        cfg = get_config(arch).reduced(**cfg_kw)
        eng = Engine(cfg, max_seq=32, n_slots=4, device="cpu", mesh=mesh,
                     params=params_from_jax(np_params, cfg, device="cpu"))
        rec = Recorder(eng)
        rec.in_step = True
        with observe_collectives(rec):
            toks = eng.generate_static(prompts, gen)
        res = {"static": toks,
               "collectives": rec.summary(prompts.shape[1] + gen),
               "params": _np(drop_partition_major(eng.params)),
               "cache": _np(eng.new_cache(4))}
        res["written"], res["step_logits"] = _stepped(
            eng.params, eng.new_cache(prompts.shape[0]), prompts, cfg,
            eng.shards)
        try:
            eng.serve(requests([(prompts[0].tolist(), 2)], False))
        except NotImplementedError as e:
            res["serve_error"] = str(e)
        out[arch] = res
    out["long"] = {}
    for arch, np_params, cfg_kw, prompt in long or ():
        cfg = get_config(arch).reduced(**cfg_kw)
        shards = Shards(make_rules(mesh, "decode_long"), 32)
        params = T.param_blocks(params_from_jax(np_params, cfg,
                                                device="cpu"),
                                cfg, shards.rules)
        cache = T.init_cache(cfg, 1, 32, "cpu", shards.rules)
        cache, logits = _stepped(params, cache, prompt, cfg, shards)
        out["long"][arch] = {"logits": logits, "cache": {
            k: v.shape for k, v in cache.items()}}
    return out


def _stepped(params, cache, prompts, cfg, shards):
    """The cache (as numpy) and the logits after stepping every column of
    ``prompts`` through ``serve_step`` on the rank's blocks."""
    from repro_torch.models import transformer as T
    from repro_torch.sharding.serving import use_serving
    tokens = torch.from_numpy(np.asarray(prompts, np.int64))
    with torch.no_grad(), use_serving(shards):
        for pos in range(tokens.shape[1]):
            logits, cache = T.serve_step(params, cache,
                                         {"tokens": tokens[:, pos:pos + 1]},
                                         pos, cfg)
    return _np(cache), logits.numpy()
