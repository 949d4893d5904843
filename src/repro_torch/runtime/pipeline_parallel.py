"""GPipe-style pipeline parallelism over a mesh axis — the reference's
``repro.runtime.pipeline_parallel``.

Each rank of the ``pipe`` axis holds one stage's params (its block of the
stacked stage params, leading dim 1).  A microbatched GPipe schedule runs
``n_micro + n_stages - 1`` ticks; at each tick every stage applies its
stage to the activation it holds, the last stage keeps its output, and a
ring shift (the reference's ``ppermute``) hands every activation to the
next stage.  Bubble fraction = (S-1)/(M+S-1), :func:`bubble_fraction`.

The ring shift is one send to the next stage and one receive from the
previous a tick, and the last stage broadcasts the outputs at the end
(:mod:`repro_torch.sharding.collectives`).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.sharding.collectives import broadcast_, ring_shift
from repro_torch.tree import map_tree


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_apply(stage_fn: Callable, mesh, axis: str, stage_params,
                   x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """Run ``x`` through the ``n_stages`` stages of ``stage_fn`` as a GPipe
    pipeline.

    Args:
      stage_fn: (params of one stage, activation) -> activation of the
        same shape; applied by every stage (homogeneous stages).
      stage_params: this rank's stage: a tree whose leaves have leading
        dim 1 (the rank's block of the reference's stacked params).
      x: (batch, ...) the global input, the same on every rank; batch must
        divide into ``n_micro`` microbatches.

    Returns y with ``x``'s shape (the last stage's outputs), on every rank.
    """
    n_stages = mesh.shape[axis]
    stage = mesh.coords[axis]
    group = mesh.group(axis)
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} must divide n_micro {n_micro}")
    mb = b // n_micro
    params = map_tree(lambda p: p[0], stage_params)
    micro = x.reshape(n_micro, mb, *x.shape[1:])
    buf = torch.zeros_like(micro[0])
    outs = torch.zeros_like(micro)
    for t in range(n_micro + n_stages - 1):
        if stage == 0 and t < n_micro:
            buf = micro[t]                 # stage 0 feeds the pipe
        y = stage_fn(params, buf)
        if stage == n_stages - 1 and t >= n_stages - 1:
            outs[t - (n_stages - 1)] = y   # the last stage emits
        # shift activations forward one stage: i -> (i + 1) % n_stages
        buf = ring_shift(y, group)
    # every rank returns the last stage's outputs
    return broadcast_(outs, n_stages - 1, group).reshape(b, *x.shape[1:])
