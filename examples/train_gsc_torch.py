"""End-to-end driver on the PyTorch port: train the paper's GSC CNN
(Table 1) for a few hundred steps on synthetic keyword-spectrogram data,
in all three variants, and report loss/accuracy, held-out accuracy and
the seconds each variant takes — the reproduction of the paper's §4
experiment shape.  At these shapes every packed layer takes the Hadamard
path, so no CUDA kernel of the port runs, as in the reference.  The lines
are ``examples/train_gsc.py``'s.

Run: PYTHONPATH=src python examples/train_gsc_torch.py [--steps 300]
     [--device cpu]

It runs on ``cuda`` unless ``--device`` names another device, and raises
where there is no CUDA device and none is named.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.data import canonical, gsc_batch
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import gsc_cnn as G
from repro_torch.models.common import resolve_device
from repro_torch.optim import AdamWConfig, apply_updates, init_state

VARIANTS = ("dense", "sparse_dense", "sparse_sparse")


def _batch(step, batch, device):
    b = gsc_batch(seed=0, step=step, batch=batch)
    return {k: torch.from_numpy(canonical(v)).to(device)
            for k, v in b.items()}


def train(variant: str, steps: int, batch: int = 64, params=None,
          device=None):
    """AdamW at lr 2e-3, weight decay 0.01, from ``params`` (default the
    seed-0 weights).  Prints the reference's lines; returns the printed
    steps' loss and accuracy, the held-out accuracy on the 5 batches after
    the last step and the seconds of the training loop."""
    device = resolve_device(device)
    cfg = G.GSCConfig(variant=variant)
    if params is None:
        params = G.init_model(cfg, seed=0, device=device)
    acfg = AdamWConfig(lr=2e-3, weight_decay=0.01)
    opt = init_state(params, acfg)

    t0 = time.time()
    printed = {}
    for s in range(steps):
        tb = _batch(s, batch, device)
        (_, m), grads = value_and_grad(lambda p: G.loss_fn(p, tb, cfg),
                                       params)
        apply_updates(params, grads, opt, acfg)
        if s % 50 == 0 or s == steps - 1:
            loss, acc = float(m["loss"]), float(m["accuracy"])
            printed[s] = (loss, acc)
            print(f"  [{variant}] step {s:4d} loss {loss:.3f} acc {acc:.3f}")
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    # held-out accuracy on fresh steps
    accs = []
    with torch.no_grad():
        for s in range(steps, steps + 5):
            _, m = G.loss_fn(params, _batch(s, batch, device), cfg)
            accs.append(float(m["accuracy"]))
    print(f"  [{variant}] heldout acc {np.mean(accs):.3f} ({dt:.1f}s)")
    return {"printed": printed, "heldout": float(np.mean(accs)),
            "seconds": dt}


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap


def main(argv=None):
    """Every variant; returns each one's numbers."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    return {v: train(v, args.steps, device=device) for v in VARIANTS}


if __name__ == "__main__":
    main()
