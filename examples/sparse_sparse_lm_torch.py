"""The paper's technique inside a transformer (their §6.4 direction), on
the PyTorch port: train a reduced LM with CS-packed FFNs + k-WTA, against
the dense baseline, and compare FLOPs per step + losses.

FLOPs a step are the port's census of one training step
(``repro_torch.launch.hlo.counted_flops``), where the reference reads
XLA's count of the compiled step.  A training step launches none of the
port's CUDA kernels (every packed FFN takes the Hadamard path at this
batch), as in the reference.  The lines are
``examples/sparse_sparse_lm.py``'s.

Run: PYTHONPATH=src python examples/sparse_sparse_lm_torch.py [--steps 60]
     [--device cpu]

It runs on ``cuda`` unless ``--device`` names another device, and raises
where there is no CUDA device and none is named.
"""

import argparse

import torch

from repro_torch.configs import TrainConfig, get_config
from repro_torch.core.api import DENSE, SparsityConfig
from repro_torch.data import batch_for, canonical
from repro_torch.launch.hlo import counted_flops
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T
from repro_torch.models.common import resolve_device
from repro_torch.optim import init_state
from repro_torch.tree import map_tree

SPARSE = SparsityConfig(n=4, k_frac=0.125, kwta_impl="bisect")


class _Shape:
    seq_len = 64
    global_batch = 8


def config(sparsity):
    return get_config("smollm-360m").reduced(
        d_model=128, d_ff=512, vocab_size=512, n_heads=4, n_kv_heads=2,
        head_pad=0, ffn_sparsity=sparsity)


def _batch(cfg, step, device):
    return {k: torch.from_numpy(canonical(v)).to(device)
            for k, v in batch_for(cfg, _Shape, step).items()}


def run(tag, sparsity, steps, params=None, device=None, cfg=None):
    """Train ``steps`` steps from ``params`` (training layout; default the
    seed-0 weights) and print the reference's line.  ``cfg`` (default
    :func:`config` of ``sparsity``) is the config of injected weights.
    Returns the final loss and the FLOPs of one step (counted on copies
    of the state, so the run starts from the same weights)."""
    device = resolve_device(device)
    cfg = config(sparsity) if cfg is None else cfg
    if params is None:
        params = T.init_train_params(cfg, seed=0, device=device)
    train_step, acfg = make_train_step(cfg, TrainConfig(lr=1e-3))
    opt = init_state(params, acfg)
    flops = counted_flops(lambda p, o, b: train_step(p, o, b)[2]["loss"],
                          map_tree(torch.clone, params),
                          map_tree(torch.clone, opt), _batch(cfg, 0, device))
    for s in range(steps):
        params, opt, m = train_step(params, opt, _batch(cfg, s, device))
    loss = float(m["loss"])
    print(f"[{tag:13s}] final loss {loss:.4f} "
          f"step GFLOPs {flops/1e9:.3f}")
    return {"loss": loss, "flops": flops, "params": params}


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap


def main(argv=None):
    """Both runs and the FLOP ratio; returns their numbers."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    dense = run("dense", DENSE, args.steps, device=device)
    sparse = run("sparse-sparse", SPARSE, args.steps, device=device)
    ratio = dense["flops"] / sparse["flops"]
    print(f"FFN sparse-sparse cuts counted step FLOPs by "
          f"{ratio:.2f}x at n=4 (75% weight + 87.5% activation sparsity)")
    return {"dense": dense, "sparse_sparse": sparse, "ratio": ratio}


if __name__ == "__main__":
    main()
