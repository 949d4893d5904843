"""Quickstart, on the PyTorch port: the paper's Complementary Sparsity in
a page.

Builds a packed CS linear layer, shows the faithful Multiply-Route-Sum
and the sparse-sparse path agree with the masked dense matmul, counts the
multiplicative sparse-sparse FLOP savings, and trains a tiny
sparse-sparse MLP.  The lines are ``examples/quickstart.py``'s.

Run: PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

It runs on ``cuda`` unless ``--device`` names another device, and raises
where there is no CUDA device and none is named.
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as tF

from repro_torch.core import (CSLayout, SparsityConfig, cs_matmul,
                              cs_topk_matmul, flops_cs_matmul, flops_cs_topk,
                              flops_dense, kwta, make_routes, pack_dense,
                              packed_bytes, routes_to_mask)
from repro_torch.core.layers import (apply_kwta, drop_partition_major,
                                     packed_linear_apply, packed_linear_init)
from repro_torch.models.common import resolve_device
from repro_torch.tree import is_float, leaves, unflatten

D_IN, D_OUT, N, K = 512, 512, 8, 64
MLP_BATCH, LR = 256, 0.5
CFG1, CFG2 = SparsityConfig(n=4, k_frac=0.125), SparsityConfig(n=2)


def mlp_init(device):
    """The 64 -> 256 -> 10 MLP's packed layers, training layout, each drawn
    from a generator seeded 0 (the reference draws both from one key)."""
    p1 = packed_linear_init(torch.Generator(device).manual_seed(0), 64, 256,
                            CFG1, seed=1)
    p2 = packed_linear_init(torch.Generator(device).manual_seed(0), 256, 10,
                            CFG2, seed=2)
    return drop_partition_major({"l1": p1, "l2": p2})


def mlp_batch(device):
    """256 inputs of 64 from a generator seeded 1."""
    return torch.randn((MLP_BATCH, 64), generator=torch.Generator(
        device).manual_seed(1), device=device)


def labels_of(xb):
    """Four classes from the signs of the first two features."""
    return (xb[:, 0] > 0).long() + 2 * (xb[:, 1] > 0).long()


def loss_fn(params, xb, yb):
    h = packed_linear_apply(params["l1"], xb, CFG1)
    h = apply_kwta(torch.relu(h), CFG1)          # Select: 12.5% winners
    logits = packed_linear_apply(params["l2"], h, CFG2)[:, :4]
    return -torch.mean(tF.log_softmax(logits, dim=-1)[
        torch.arange(xb.shape[0], device=xb.device), yb])


def sgd_step(params, xb, yb):
    """One plain SGD step at lr 0.5 on the float leaves (routes stay)."""
    views = [t.detach().requires_grad_() if is_float(t) else t
             for t in leaves(params)]
    wrt = [v for v in views if v.requires_grad]
    grads = iter(torch.autograd.grad(
        loss_fn(unflatten(params, views), xb, yb), wrt))
    return unflatten(params, [(v - LR * next(grads)).detach()
                              if v.requires_grad else v for v in views])


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap


def main(argv=None, params=None, xb=None, steps=101):
    """Prints the reference's lines and returns their numbers.  ``params``
    (the MLP's layers, training layout) and ``xb`` (its (256, 64) batch)
    replace the seeded draws; ``steps`` is the number of SGD steps."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    # --- 1. Combine (offline): overlay N=8 complementary sparse columns --
    lay = CSLayout(D_IN, D_OUT, N)
    route_np = make_routes(lay, seed=0)
    rng = np.random.default_rng(0)
    w_sparse = rng.normal(size=(D_IN, D_OUT)).astype(np.float32) \
        * routes_to_mask(lay, route_np)      # 87.5% weight-sparse network
    packed = torch.from_numpy(np.ascontiguousarray(
        pack_dense(lay, w_sparse, route_np))).to(device)
    route = torch.from_numpy(route_np).to(device)
    w = torch.from_numpy(w_sparse).to(device)
    packing = packed_bytes(lay)
    print(f"packing: {packing}")

    # --- 2. Multiply-Route-Sum (sparse-dense) ----------------------------
    x = torch.from_numpy(rng.normal(size=(4, D_IN)).astype(np.float32)
                         ).to(device)
    y_faithful = cs_matmul(x, packed, route)
    err_sd = float((y_faithful - x @ w).abs().max())
    print("sparse-dense max err:", err_sd)

    # --- 3. Select (k-WTA) + sparse-sparse --------------------------------
    xs = kwta(x, K)                          # 87.5% activation-sparse
    y_ss = cs_topk_matmul(xs, packed, route, K)
    err_ss = float((y_ss - xs @ w).abs().max())
    print("sparse-sparse max err:", err_ss)
    fd = flops_dense(4, D_IN, D_OUT)
    fsd = flops_cs_matmul(4, D_IN, D_OUT, N)
    fss = flops_cs_topk(4, K, D_OUT)
    print(f"FLOPs  dense={fd:,}  sparse-dense={fsd:,} ({fd//fsd}x)  "
          f"sparse-sparse={fss:,} ({fd//fss}x compute; memory also /{N} "
          f"-> {fd//fss*N}x multiplicative, paper Fig. 1)")

    # --- 4. Train a sparse-sparse MLP end to end --------------------------
    params = mlp_init(device) if params is None else params
    xb = mlp_batch(device) if xb is None else xb.to(device)
    yb = labels_of(xb)
    losses = []
    for i in range(steps):
        params = sgd_step(params, xb, yb)
        with torch.no_grad():
            losses.append(float(loss_fn(params, xb, yb)))
        if i % 25 == 0:
            print(f"step {i:3d} sparse-sparse MLP loss {losses[-1]:.4f}")
    return {"packing": packing, "sparse_dense_err": err_sd,
            "sparse_sparse_err": err_ss,
            "flops": {"dense": fd, "sparse_dense": fsd,
                      "sparse_sparse": fss},
            "losses": losses, "params": params}


if __name__ == "__main__":
    main()
