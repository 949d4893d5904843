"""Dry run: trace every (architecture x input shape x mesh) cell's step on
the production meshes and count it — the reference's
``repro.launch.dryrun``.

The reference lowers and compiles each cell with 512 placeholder host
devices and reads XLA's analyses.  The port runs its own step eagerly, so
a cell is one run of that step on rank 0 of a fake process group of the
mesh's size (256 ranks for 16x16, 512 for 2x16x16), counted by
:func:`repro_torch.launch.hlo.census`.  Its collectives return at once, and
its params, cache and batch are fake tensors (shapes and types, no
storage, no kernel), so the largest config runs on the CPU, and on the
card's host without touching the card.  The fake process group comes from
``torch.testing._internal.distributed.fake_pg``, a module internal to
torch, imported only here, inside :func:`fake_process_group`.

A cell's step is the port's own, on the rank's blocks of the production
mesh (:func:`repro_torch.launch.mesh.make_production_mesh` and
``make_rules(mesh, kind)``):

* train: :func:`repro_torch.launch.steps.make_sharded_train_step` on the
  rank's training state (ZeRO-1 moments) and its rows of the batch: the
  forward and backward on the rank's param blocks, their collectives (the
  backward's included) counted;
* prefill: :func:`repro_torch.launch.steps.make_prefill_step` (the
  forward's last-position logits, as the reference counts it) of the
  rank's rows on the serving params a rank of the engine holds, under the
  prefill rules (:func:`repro_torch.sharding.serving.use_serving`);
* decode: :func:`repro_torch.models.transformer.serve_step` under the
  decode rules (``decode_long`` for a batch below 8), on the serving params
  and cache a rank of the engine holds.

Each record (the reference's keys, appended to a JSON results file) holds
``full`` (the census of the whole step: ``cost``, ``collectives``,
``ops``, ``host_transfers``, ``memory``), the accounting parts ``unit``
(one unit of blocks: its forward and backward for train, its forward
(:func:`repro_torch.launch.steps.make_unit_fwd_step`, no remat) for
prefill, its decode step for decode), ``head`` (the final norm and head;
with the embedding and the loss for train) and, for train, ``opt`` (the
optimizer update), and ``n_params``.  The roofline
(:mod:`repro_torch.launch.roofline`) reads ``full``: an eager trace hides
no loop body.  A cell that raises is recorded ``ok: false`` with its error,
never skipped.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
      --shape train_4k --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      [--mesh pod1|pod2|both] --device cpu

Without ``--device`` the fake tensors are CUDA tensors (no card is used,
but this CPU-only torch cannot trace them: pass ``--device cpu`` here).
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.launch import steps as St
from repro_torch.launch.hlo import census
from repro_torch.launch.mesh import make_production_mesh, parse_mesh
from repro_torch.models import transformer as T
from repro_torch.models.common import dtype_of
from repro_torch.optim import AdamWConfig, apply_updates
from repro_torch.sharding import make_rules, use_rules
from repro_torch.sharding.serving import Shards, use_serving
from repro_torch.tree import fake, leaves

#: kept apart from the reference's ``experiments/dryrun_results.json``
RESULTS_PATH = "experiments/dryrun_results_torch.json"

# Archs that run the long_500k cell (the reference's list: the others are
# pure full attention).
LONG_CONTEXT_OK = {"xlstm_350m", "zamba2_1p2b"}


def train_overrides(arch_id: str) -> TrainConfig:
    """Per-arch numerics needed to fit the assigned mesh (the
    reference's)."""
    if arch_id == "qwen3_moe_235b_a22b":
        return TrainConfig(moment_dtype="bfloat16")  # optimizer compression
    return TrainConfig()


def model_overrides(arch_id: str, cfg: ModelConfig,
                    shape: ShapeConfig) -> ModelConfig:
    if arch_id == "qwen3_moe_235b_a22b":
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    if shape.kind != "train" and shape.seq_len >= 32768:
        # prefill/decode at 32k+: keep flash blocks modest
        cfg = dataclasses.replace(cfg, flash_block=1024)
    return cfg


def apply_overrides(cfg: ModelConfig, overrides: str) -> ModelConfig:
    """--override "a=b,ffn_sparsity.n=8,..." -> dataclasses.replace chain.

    Nested SparsityConfig fields use dotted paths; values are parsed as
    python literals when possible."""
    for item in overrides.split(","):
        if not item:
            continue
        key, _, val = item.partition("=")
        try:
            val = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            pass
        if "." in key:
            outer, inner = key.split(".", 1)
            sub = dataclasses.replace(getattr(cfg, outer), **{inner: val})
            cfg = dataclasses.replace(cfg, **{outer: sub})
        else:
            cfg = dataclasses.replace(cfg, **{key: val})
    return cfg


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """This process as rank 0 of a fake process group of ``world_size``
    ranks, whose collectives return at once (torch's internal
    ``fake_pg``); a group already up is refused."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is up: the dry run makes its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rows(rules, t: torch.Tensor) -> torch.Tensor:
    """The rank's rows of a batch input (its ``batch`` block)."""
    return rules.sharding_for(("batch",) + (None,) * (t.ndim - 1),
                              t.shape).take(t)


def _unit(layers, cfg):
    """Unit 0's layers as ``{"b{i}": layer}``."""
    return {f"b{i}": layers[i] for i in range(len(cfg.block_pattern))}


def compile_cell(arch_id: str, shape_name, multi_pod: bool,
                 accounting: bool = True,
                 cfg_override=None,
                 overrides: str = "", device=None,
                 mesh_dims: Optional[Tuple[int, ...]] = None
                 ) -> Dict[str, Any]:
    """Trace one cell on rank 0 of the production mesh (or of a mesh of
    ``mesh_dims``); returns the record.  ``shape_name`` names a
    :data:`SHAPES` entry or is a ``ShapeConfig``.  ``device`` (``cuda``
    unless it says otherwise) is where the fake tensors claim to live:
    nothing is allocated there."""
    device = torch.device(device or "cuda")
    cfg = cfg_override or get_config(arch_id)
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else SHAPES[shape_name])
    cfg = model_overrides(arch_id, cfg, shape) if cfg_override is None else cfg
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    tcfg = train_overrides(arch_id)
    dims = mesh_dims or ((2, 16, 16) if multi_pod else (16, 16))
    rec: Dict[str, Any] = {
        "arch": arch_id, "shape": shape.name,
        "mesh": "x".join(map(str, dims)),
        "kind": shape.kind, "n_units": cfg.n_units,
        "pattern": list(cfg.block_pattern),
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "time": {},
    }
    t0 = time.time()
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with fake_process_group(math.prod(dims)):
        mesh = (parse_mesh(mesh_dims, device) if mesh_dims else
                make_production_mesh(multi_pod=multi_pod, device=device))
        kind = shape.kind
        if kind == "decode" and shape.global_batch < 8:
            kind = "decode_long"
        rules = make_rules(mesh, kind)
        whole, _ = St.abstract_params(cfg, device=device, mode=mode)
        rec["n_params"] = sum(t.numel() for t in leaves(whole)
                              if t.is_floating_point())
        run = {"train": _train_cell, "prefill": _prefill_cell}.get(
            shape.kind, _decode_cell)
        rec.update(run(cfg, tcfg, shape, rules, whole, mode, device,
                       accounting))
    rec["time"]["total"] = time.time() - t0
    rec["ok"] = True
    return rec


def _train_cell(cfg, tcfg, shape, rules, whole, mode, device, accounting):
    with mode:
        params, opt, shardings, shapes = St.shard_train_state(
            whole, cfg, tcfg, rules)
    batch = {k: _rows(rules, v) for k, v in St.input_specs(
        cfg, shape, device, mode).items()}
    step, _ = St.make_sharded_train_step(cfg, tcfg, rules, shardings, shapes)
    out = {"full": census(lambda p, o, b: step(p, o, b)[2]["loss"],
                          params, opt, batch)}
    if not accounting:
        return out
    # the step computes on the rank's blocks and its rows of the batch
    labels = batch["labels"]
    rows, s, ct = labels.shape[0], shape.seq_len, dtype_of(cfg.compute_dtype)
    x, positions = fake(lambda: (
        torch.empty((rows, s, cfg.d_model), dtype=ct),
        torch.arange(s).expand(rows, s)), device, mode)
    with use_rules(rules), use_serving(Shards(rules, 0)):
        out["unit"] = census(St.make_unit_train_step(cfg),
                             _unit(params["layers"], cfg),
                             params.get("shared"), x, positions)
        out["head"] = census(St.make_head_train_step(cfg),
                             params["embed"]["table"],
                             batch.get("tokens", labels), labels,
                             x[:, :labels.shape[1]])
    acfg = AdamWConfig(moment_dtype=dtype_of(tcfg.moment_dtype))
    mu, nu, full = leaves(opt["mu"]), leaves(opt["nu"]), leaves(whole)
    own = [i for i, t in enumerate(mu) if t.is_floating_point() and t.numel()]
    with mode:
        # the slices of the params and gradients the rank's moments cover
        slices = [torch.empty(mu[i].shape, dtype=full[i].dtype,
                              device=device) for i in own]
        grads = [torch.empty_like(t) for t in slices]
    out["opt"] = census(
        lambda p, g, m, v, stp: apply_updates(
            p, g, {"mu": m, "nu": v, "step": stp}, acfg, 1.0)[2],
        slices, grads, [mu[i] for i in own], [nu[i] for i in own],
        opt["step"])
    return out


def _serving_params(cfg, rules, device, mode):
    """The serving params a rank of the engine holds (``init_model(cfg,
    rules=)``), fake."""
    return fake(lambda: T.init_model(cfg, seed=0, device="cpu",
                                        rules=rules), device, mode)


def _prefill_cell(cfg, tcfg, shape, rules, whole, mode, device, accounting):
    shards = Shards(rules, shape.seq_len)
    params = _serving_params(cfg, rules, device, mode)
    batch = {k: _rows(rules, v) for k, v in St.input_specs(
        cfg, shape, device, mode).items()}
    with use_serving(shards):
        out = {"full": census(St.make_prefill_step(cfg), params, batch)}
    if not accounting:
        return out
    rows = next(iter(batch.values())).shape[0]
    s, ct = shape.seq_len, dtype_of(cfg.compute_dtype)
    x, positions = fake(lambda: (
        torch.empty((rows, s, cfg.d_model), dtype=ct),
        torch.arange(s).expand(rows, s)), device, mode)
    unit_step = St.make_unit_fwd_step(dataclasses.replace(cfg, remat=False))
    with use_serving(shards):
        out["unit"] = census(unit_step, _unit(params["layers"], cfg),
                             params.get("shared"), x, positions)
        out["head"] = census(
            lambda p, x: T._logits(p, x, cfg, ct)[:, -1], params, x)
    return out


def _decode_cell(cfg, tcfg, shape, rules, whole, mode, device, accounting):
    b, s = shape.global_batch, shape.seq_len
    shards = Shards(rules, s)
    params = _serving_params(cfg, rules, device, mode)
    cache, _ = St.abstract_cache(cfg, b, s, rules, device, mode)
    batch = St.input_specs(cfg, shape, device, mode)
    pos = fake(lambda: torch.zeros((b,), dtype=torch.int64), device, mode)
    with use_serving(shards):
        out = {"full": census(
            lambda p, c, bt, q: T.serve_step(p, c, bt, q, cfg)[0],
            params, cache, batch, pos)}
    if not accounting:
        return out
    rows = shards.batch_rows(b)
    n = b if rows is None else rows.stop - rows.start
    ct = dtype_of(cfg.compute_dtype)
    x, q = fake(lambda: (torch.empty((n, 1, cfg.d_model), dtype=ct),
                            torch.zeros((n,), dtype=torch.int64)),
                   device, mode)

    def unit_decode(unit, shared, x, unit_cache, pos):
        for i, kind in enumerate(cfg.block_pattern):
            p = shared if kind == "shared_attn" else unit[f"b{i}"]
            x = T._block_decode(kind, p, x, cfg, unit_cache[i], pos)
        return x

    with use_serving(shards):
        out["unit"] = census(unit_decode, _unit(params["layers"], cfg),
                             params.get("shared"),
                             x, cache[:len(cfg.block_pattern)], q)
        out["head"] = census(
            lambda p, x: T._logits(p, x, cfg, ct, rows is not None)[:, 0],
            params, x)
    return out


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------

def iter_cells(mesh_sel: str):
    for arch in ARCH_IDS:
        for shape in SHAPES:
            if shape == "long_500k" and arch not in LONG_CONTEXT_OK:
                continue
            for mp in ([False, True] if mesh_sel == "both"
                       else [mesh_sel == "pod2"]):
                yield arch, shape, mp


def load_results(path: str) -> Dict[str, Any]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def save_results(path: str, results: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["pod1", "pod2", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-accounting", action="store_true")
    ap.add_argument("--override", default="",
                    help="cfg overrides, e.g. kv_cache_dtype=int8,"
                         "ffn_sparsity.route_share=64")
    ap.add_argument("--tag", default="", help="suffix for the result key")
    ap.add_argument("--out", default=RESULTS_PATH)
    ap.add_argument("--device", default=None,
                    help="device of the fake tensors (default cuda; no card "
                         "is used); cpu where torch has no CUDA")
    args = ap.parse_args(argv)

    results = load_results(args.out)
    if args.all:
        cells = list(iter_cells(args.mesh))
    else:
        archs = [args.arch] if args.arch else ARCH_IDS
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells = [(a, s, mp) for a in archs for s in shapes
                 for mp in ([False, True] if args.mesh == "both"
                            else [args.mesh == "pod2"])
                 if not (s == "long_500k"
                         and a.replace("-", "_") not in LONG_CONTEXT_OK
                         and a not in LONG_CONTEXT_OK)]

    for arch, shape, mp in cells:
        arch_id = arch.replace("-", "_").replace(".", "p")
        key = f"{arch_id}|{shape}|{'pod2' if mp else 'pod1'}"
        if args.tag:
            key += f"|{args.tag}"
        if key in results and results[key].get("ok") and not args.force:
            print(f"[skip] {key}")
            continue
        print(f"[run ] {key}", flush=True)
        t0 = time.time()
        try:
            rec = compile_cell(arch_id, shape, mp,
                               accounting=not args.no_accounting,
                               overrides=args.override, device=args.device)
        except Exception as e:  # noqa: BLE001 — record failures, keep going
            rec = {"arch": arch_id, "shape": shape,
                   "mesh": "2x16x16" if mp else "16x16", "ok": False,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
        rec["wall_s"] = time.time() - t0
        results[key] = rec
        save_results(args.out, results)
        status = "OK" if rec.get("ok") else "FAIL"
        print(f"[{status:4s}] {key} ({rec['wall_s']:.1f}s)", flush=True)

    n_ok = sum(1 for r in results.values() if r.get("ok"))
    print(f"done: {n_ok}/{len(results)} cells ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
