"""Step functions: the training step, the optimizer step alone, and the
serving and prefill steps — the reference's ``repro.launch.steps``.

The training step is eager PyTorch (no ``torch.compile``, no autocast):
the loss on the training-layout params (float32 masters cast at each
use), ``torch.autograd.grad`` over every float leaf, then AdamW in place.
No kernel of :mod:`repro_torch.kernels` runs in it: every projection of a
training batch takes the Hadamard path, as in the reference.

The roofline and dry-run tools (``abstract_params``, ``input_specs``,
``zero1_specs``, the unit steps) wait for ROADMAP Queue 1 items 7-8.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import transformer as T
from repro_torch.models.common import dtype_of
from repro_torch.optim import AdamWConfig, apply_updates, warmup_cosine
from repro_torch.tree import flatten, unflatten


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


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns ``(train_step, acfg)``; ``train_step(params, opt_state,
    batch)`` updates ``params`` and ``opt_state`` in place and returns
    them with the step's metrics (loss, lm_loss, aux_loss, grad_norm)."""
    acfg = AdamWConfig(lr=tcfg.lr, b1=tcfg.b1, b2=tcfg.b2,
                       weight_decay=tcfg.weight_decay,
                       grad_clip=tcfg.grad_clip,
                       moment_dtype=dtype_of(tcfg.moment_dtype))

    def train_step(params, opt_state, batch):
        (_, metrics), grads = value_and_grad(
            lambda p: T.loss_fn(p, batch, cfg), params)
        lr_scale = warmup_cosine(opt_state["step"], tcfg.warmup_steps,
                                 tcfg.total_steps)
        _, _, om = apply_updates(params, grads, opt_state, acfg, lr_scale)
        metrics.update(om)
        return params, opt_state, metrics

    return train_step, acfg


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, cache, batch, pos):
        return T.serve_step(params, cache, batch, pos, cfg)

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
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
