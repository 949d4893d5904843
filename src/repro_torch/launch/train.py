"""End-to-end training loop with fault tolerance — the reference's
``repro.launch.train``.

Features (each one exercised by tests/test_torch_train.py and
tests/test_torch_distributed*.py):
  * auto-resume from the latest valid checkpoint (atomic + checksummed),
    onto any mesh (a checkpoint holds the full tree),
  * periodic async checkpointing + pruning,
  * SIGTERM/SIGINT preemption handler -> final checkpoint -> clean exit,
  * StepMonitor straggler detection -> checkpoint hook,
  * LossGuard NaN/spike detection -> rollback to last checkpoint,
  * deterministic stateless data (resume reproduces the exact batch
    sequence),
  * any (data, model) or (pod, data, model) mesh whose size is the world
    size of the process group (one rank needs none).

The step is eager (no ``torch.compile``, no autocast) on the training
layout of the params (float32 masters, no ``packed_p``;
:func:`repro_torch.models.transformer.serving_params` serves them).  On a
mesh each rank stores the reference's per-device block of every param
(``param_sharding`` of the ``train`` rules) and of every moment (ZeRO-1,
``zero1_specs``), takes its rows of the batch, and steps through
:func:`repro_torch.launch.steps.make_sharded_train_step`: the forward
and backward run on the rank's param blocks (no param is gathered; the
loss is vocab-parallel), the gradient blocks are averaged over the DP
axes, each rank updates the slices of its blocks that its moments cover,
and each DP group's updated slices are gathered into the blocks.  The int8
error-feedback sync (``TrainConfig.grad_compression``) is not wired into
the step, as in the reference.

Usage (one device; ``--device cpu`` for the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 100 --batch 8 --seq 128 --mesh 1x1 [--resume] [--device cpu]
On a mesh, one process a rank under torchrun (NCCL on the card; ``--backend
gloo`` for gloo):
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch smollm-360m --mesh 2x2 --steps 100
"""

from __future__ import annotations

import argparse
import os
import signal
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch import checkpoint as ckpt
from repro_torch.configs import TrainConfig, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import Prefetcher, batch_for
from repro_torch.launch import steps as St
from repro_torch.launch.mesh import join_process_group, parse_mesh
from repro_torch.models import transformer as T
from repro_torch.runtime import LossGuard, StepMonitor
from repro_torch.sharding import make_rules
from repro_torch.sharding.collectives import all_reduce_, barrier


class Trainer:
    """Owns params/opt-state (this rank's blocks), the mesh and the
    fault-tolerant step loop.  Runs on ``cuda`` unless ``device`` (or the
    given :class:`Mesh`'s device) says otherwise."""

    def __init__(self, cfg, tcfg: TrainConfig, mesh, shape: ShapeConfig,
                 device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.shape = shape
        self.mesh = parse_mesh(mesh, device)
        self.device = self.mesh.device
        self.rules = make_rules(self.mesh, "train")
        self.monitor = StepMonitor()
        self.guard = LossGuard()
        self.step = 0
        self._preempted = False
        #: the async checkpoint writer not yet joined (process 0)
        self._writer = None
        self._build()

    # -- construction -----------------------------------------------------

    def _build(self):
        full = T.init_train_params(self.cfg, seed=self.tcfg.seed,
                                   device=self.device)
        #: :meth:`state_tree`'s shardings, leaf for leaf, and the full
        #: params' shapes
        self.params, self.opt, self.shardings, self.shapes = \
            St.shard_train_state(full, self.cfg, self.tcfg, self.rules)
        del full
        self._step_fn, self.acfg = St.make_sharded_train_step(
            self.cfg, self.tcfg, self.rules, self.shardings, self.shapes)

    def batch_shard(self, batch):
        """This rank's rows of a global batch (every input shards its rows
        over the DP axes, replicated where they do not divide)."""
        return {k: self.rules.sharding_for(spec, v.shape).take(v)
                for (k, v), spec in zip(
                    batch.items(), St.batch_logical_specs(batch).values())}

    def train_step(self, batch):
        """One step on a global batch (tensors on this rank's device):
        each rank takes its rows.  Returns the step's metrics."""
        self.params, self.opt, metrics = self._step_fn(
            self.params, self.opt, self.batch_shard(batch))
        return metrics

    # -- checkpoint/restore ------------------------------------------------

    def state_tree(self):
        """This rank's blocks of the params and the optimizer state."""
        return {"params": self.params, "opt": self.opt}

    def full_state(self):
        """The full tree, gathered from every rank's blocks (every rank
        takes part; each gets the whole)."""
        return St.gather_state(self.state_tree(), self.shardings,
                               self.shapes)

    def save(self, async_: bool = True):
        """Every rank gathers the full tree; process 0 writes it."""
        self.wait_for_save()
        tree = self.full_state()
        if self.mesh.rank != 0:
            return None
        extra = {"step": self.step, "arch": self.cfg.name}
        if async_:
            self._writer = ckpt.save_async(self.tcfg.ckpt_dir, self.step,
                                           tree, extra)
            return self._writer
        return ckpt.save(self.tcfg.ckpt_dir, self.step, tree, extra)

    def wait_for_save(self):
        """Join the async writer of the last ``save``, if one is running:
        until it has committed, the directory may lack its step, and its
        commit would replace a later save of the same step.  On a process
        group, every rank waits for process 0's writer."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self.mesh.distributed:
            barrier(self.mesh)

    def try_resume(self) -> bool:
        """Restore the latest checkpoint, whatever mesh wrote it: each
        rank takes its blocks of the full leaves."""
        self.wait_for_save()
        state = self.state_tree()
        step, tree, extra = ckpt.restore_latest(
            self.tcfg.ckpt_dir, T.drop_block_routes(state),
            T.drop_block_routes(self.shardings))
        if step is None:
            return False
        tree = T.keep_block_routes(tree, state)
        self.params, self.opt = tree["params"], tree["opt"]
        self.step = extra.get("step", step)
        return True

    def rollback(self) -> bool:
        """Loss blew up / NaN: restore the last checkpoint and skip
        forward past the bad step (fresh data, same params)."""
        ok = self.try_resume()
        if ok:
            self.step += 1  # skip the batch that produced the blow-up
        return ok

    # -- the loop ----------------------------------------------------------

    def install_preemption_handler(self):
        def handler(signum, frame):
            self._preempted = True
        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)

    def _agree(self, *flags: bool):
        """Decisions every rank must take together (each a collective
        save): true where any rank's flag is."""
        if not self.mesh.distributed:
            return flags
        t = torch.tensor([float(f) for f in flags], device=self.device)
        all_reduce_(t, self.mesh.group(self.mesh.axis_names))
        return tuple(bool(x > 0) for x in t.tolist())

    def run(self, total_steps: int, batch_fn, log=print):
        """Train to ``total_steps``; ``batch_fn(step)`` gives the global
        batch (numpy), of which each rank takes its rows."""
        tcfg = self.tcfg
        log = log if self.mesh.rank == 0 else (lambda *a: None)
        pre = Prefetcher(batch_fn, self.step, depth=2, device=self.device)
        try:
            while self.step < total_steps and not self._preempted:
                _, batch = pre.get(expected_step=self.step)
                self.monitor.start()
                loss = float(self.train_step(batch)["loss"])
                ev = self.monitor.stop(self.step)
                if not self.guard.check(loss):
                    log(f"[guard] step {self.step}: loss {loss} unhealthy; "
                        f"rolling back")
                    if not self.rollback():
                        raise RuntimeError(
                            f"loss diverged at step {self.step} with no "
                            f"checkpoint to roll back to")
                    continue
                reshard, self._preempted = self._agree(
                    self.monitor.should_reshard, self._preempted)
                if reshard:
                    log(f"[monitor] sustained stragglers at step "
                        f"{self.step}; checkpointing")
                    self.save(async_=False)
                if self.step % tcfg.log_every == 0:
                    log(f"step {self.step:6d} loss {loss:.4f} "
                        f"({ev.duration*1e3:.0f} ms)")
                self.step += 1
                if self.step % tcfg.checkpoint_every == 0:
                    self.save()
                    if self.mesh.rank == 0:
                        ckpt.prune(tcfg.ckpt_dir, keep=3)
            if self._preempted:
                log(f"[preempt] signal received; checkpointing at step "
                    f"{self.step}")
            self.wait_for_save()
            if ckpt.latest_step(tcfg.ckpt_dir) != self.step:
                self.save(async_=False)
        finally:
            pre.close()
            if self._writer is not None:
                self._writer.join()
                self._writer = None
        return self.step


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL or PODxDATAxMODEL; its size is the "
                         "world size (torchrun's WORLD_SIZE)")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"),
                    help="process group backend under torchrun")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    tcfg = TrainConfig(lr=args.lr, total_steps=args.steps,
                       ckpt_dir=args.ckpt_dir,
                       checkpoint_every=max(10, args.steps // 5))
    device = args.device
    if "WORLD_SIZE" in os.environ:
        device = join_process_group(args.backend, device)
    try:
        trainer = Trainer(cfg, tcfg, args.mesh, shape, device=device)
        say = print if trainer.mesh.rank == 0 else (lambda *a: None)
        trainer.install_preemption_handler()
        if args.resume and trainer.try_resume():
            say(f"resumed from step {trainer.step}")

        def batch_fn(step):
            return batch_for(cfg, shape, step, seed=tcfg.seed)

        t0 = time.time()
        final = trainer.run(args.steps, batch_fn)
        say(f"finished at step {final} in {time.time()-t0:.1f}s on "
            f"{trainer.device}, mesh {'x'.join(map(str, trainer.mesh.dims))}"
            f"; monitor: {trainer.monitor.summary()}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
