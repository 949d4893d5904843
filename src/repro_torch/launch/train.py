"""End-to-end training loop with fault tolerance — the reference's
``repro.launch.train`` on one device.

Features (each one exercised by tests/test_torch_train.py):
  * auto-resume from the latest valid checkpoint (atomic + checksummed),
  * periodic async checkpointing + pruning,
  * SIGTERM/SIGINT preemption handler -> final checkpoint -> clean exit,
  * StepMonitor straggler detection -> checkpoint hook,
  * LossGuard NaN/spike detection -> rollback to last checkpoint,
  * deterministic stateless data (resume reproduces the exact batch
    sequence).

The step is eager (no ``torch.compile``, no autocast) on the training
layout of the params (float32 masters, no ``packed_p``;
:func:`repro_torch.models.transformer.serving_params` serves them).  One
device only: ``--mesh 1x1``, where ZeRO-1 is a no-op as in the reference;
meshes and the compressed gradient sync wait for ROADMAP Queue 1 item 7.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 100 --batch 8 --seq 128 --mesh 1x1 [--resume] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import signal
import tempfile
import time
from typing import Tuple

from repro_torch import checkpoint as ckpt
from repro_torch.configs import TrainConfig, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import Prefetcher, batch_for
from repro_torch.launch import steps as St
from repro_torch.models import transformer as T
from repro_torch.models.common import resolve_device
from repro_torch.optim import init_state
from repro_torch.runtime import LossGuard, StepMonitor


def parse_mesh(mesh) -> Tuple[int, ...]:
    """``"1x1"`` or ``(1, 1)``; any other mesh raises."""
    dims = (tuple(int(x) for x in mesh.split("x")) if isinstance(mesh, str)
            else tuple(mesh))
    if dims != (1, 1):
        raise NotImplementedError(
            f"mesh {dims}: the port trains on one device (mesh 1x1); "
            "meshes wait for the distribution slice (ROADMAP Queue 1 "
            "item 7)")
    return dims


class Trainer:
    """Owns params/opt-state and the fault-tolerant step loop.  Runs on
    ``cuda`` unless ``device`` says otherwise."""

    def __init__(self, cfg, tcfg: TrainConfig, mesh, shape: ShapeConfig,
                 device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.shape = shape
        self.mesh = parse_mesh(mesh)
        self.device = resolve_device(device)
        self.monitor = StepMonitor()
        self.guard = LossGuard()
        self.step = 0
        self._preempted = False
        self._build()

    # -- construction -----------------------------------------------------

    def _build(self):
        self.params = T.init_train_params(self.cfg, seed=self.tcfg.seed,
                                          device=self.device)
        self._step_fn, self.acfg = St.make_train_step(self.cfg, self.tcfg)
        self.opt = init_state(self.params, self.acfg)

    # -- checkpoint/restore ------------------------------------------------

    def state_tree(self):
        return {"params": self.params, "opt": self.opt}

    def save(self, async_: bool = True):
        tree = self.state_tree()
        extra = {"step": self.step, "arch": self.cfg.name}
        if async_:
            return ckpt.save_async(self.tcfg.ckpt_dir, self.step, tree, extra)
        return ckpt.save(self.tcfg.ckpt_dir, self.step, tree, extra)

    def try_resume(self) -> bool:
        step, tree, extra = ckpt.restore_latest(self.tcfg.ckpt_dir,
                                                self.state_tree())
        if step is None:
            return False
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

    def run(self, total_steps: int, batch_fn, log=print):
        tcfg = self.tcfg
        pre = Prefetcher(batch_fn, self.step, depth=2, device=self.device)
        try:
            while self.step < total_steps and not self._preempted:
                _, batch = pre.get(expected_step=self.step)
                self.monitor.start()
                self.params, self.opt, metrics = self._step_fn(
                    self.params, self.opt, batch)
                loss = float(metrics["loss"])
                ev = self.monitor.stop(self.step)
                if not self.guard.check(loss):
                    log(f"[guard] step {self.step}: loss {loss} unhealthy; "
                        f"rolling back")
                    if not self.rollback():
                        raise RuntimeError(
                            f"loss diverged at step {self.step} with no "
                            f"checkpoint to roll back to")
                    continue
                if self.monitor.should_reshard:
                    log(f"[monitor] sustained stragglers at step "
                        f"{self.step}; checkpointing")
                    self.save(async_=False)
                if self.step % tcfg.log_every == 0:
                    log(f"step {self.step:6d} loss {loss:.4f} "
                        f"({ev.duration*1e3:.0f} ms)")
                self.step += 1
                if self.step % tcfg.checkpoint_every == 0:
                    self.save()
                    ckpt.prune(tcfg.ckpt_dir, keep=3)
            if self._preempted:
                log(f"[preempt] signal received; checkpointing at step "
                    f"{self.step}")
            if ckpt.latest_step(tcfg.ckpt_dir) != self.step:
                self.save(async_=False)
        finally:
            pre.close()
        return self.step


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="1x1")
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
    trainer = Trainer(cfg, tcfg, args.mesh, shape, device=args.device)
    trainer.install_preemption_handler()
    if args.resume and trainer.try_resume():
        print(f"resumed from step {trainer.step}")

    def batch_fn(step):
        return batch_for(cfg, shape, step, seed=tcfg.seed)

    t0 = time.time()
    final = trainer.run(args.steps, batch_fn)
    print(f"finished at step {final} in {time.time()-t0:.1f}s on "
          f"{trainer.device}; monitor: {trainer.monitor.summary()}")


if __name__ == "__main__":
    main()
