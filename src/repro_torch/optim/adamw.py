"""AdamW from scratch, on the port's params trees, updating in place.

The semantics of the reference's ``repro.optim.adamw``:
  * integer/route leaves are left alone (CS route tables live in the
    params tree but are not trained); their moments are a
    ``zeros((), int32)`` placeholder,
  * moment dtype is configurable — ``bfloat16`` halves optimizer-state
    memory,
  * global-norm gradient clipping in fp32 over every float leaf, bias
    corrections in fp32, weight decay on every float leaf.

``apply_updates`` writes the new params and moments into the tensors it
is given, under ``torch.no_grad()``: the trainer's params, not copies.
(``torch.optim.AdamW`` clips, keeps bf16 moments and skips int leaves
differently, so it is not used.)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.tree import is_float, leaves, map_tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: torch.dtype = torch.float32


def init_state(params, cfg: AdamWConfig) -> Dict:
    """Moments mirror float params; int leaves get empty placeholders.
    ``step`` is an int32 scalar on the params' device."""

    def mk(p):
        if is_float(p):
            return torch.zeros(p.shape, dtype=cfg.moment_dtype,
                               device=p.device)
        return torch.zeros((), dtype=torch.int32, device=p.device)

    device = leaves(params)[0].device
    return {"mu": map_tree(mk, params), "nu": map_tree(mk, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(grads) -> torch.Tensor:
    """fp32 global norm over the float leaves (``None`` grads count 0)."""
    total = sum(torch.sum(g.float() ** 2) for g in leaves(grads)
                if is_float(g))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    # a tensor numerator: `max_norm / t` would be t.reciprocal() * max_norm
    return torch.clamp(torch.full_like(norm, max_norm)
                       / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """Returns (clipped grads tree, norm); the leaves are new tensors."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return map_tree(lambda g: (g.float() * scale).to(g.dtype)
                    if is_float(g) else g, grads), norm


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig,
                  lr_scale=1.0) -> Tuple[Dict, Dict, Dict]:
    """One AdamW step, in place on ``params`` and ``state``.

    ``grads`` is a tree of ``params``' structure, or a list of one grad a
    leaf in :func:`repro_torch.tree.flatten`'s order; a ``None`` grad (an
    int leaf, or a param the loss does not reach) counts as zero, as
    ``jax.grad`` gives it.  Returns ``(params, state, {"grad_norm"})``
    with the same ``params`` and ``state`` objects, updated."""
    flat_p, flat_g = leaves(params), leaves(grads)
    if len(flat_g) != len(flat_p):
        raise ValueError(f"{len(flat_g)} grads for {len(flat_p)} params")
    flat_g = [torch.zeros_like(p) if g is None and is_float(p) else g
              for p, g in zip(flat_p, flat_g)]
    norm = global_norm(flat_g)
    clip = _clip_scale(norm, cfg.grad_clip)
    state["step"] += 1
    t = state["step"].float()
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=t.device)
    for p, g, mu, nu in zip(flat_p, flat_g, leaves(state["mu"]),
                            leaves(state["nu"]), strict=True):
        if not is_float(p):
            continue
        g32 = (g.float() * clip).to(g.dtype).float()
        mu32 = cfg.b1 * mu.float() + (1 - cfg.b1) * g32
        nu32 = cfg.b2 * nu.float() + (1 - cfg.b2) * g32 * g32
        upd = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + cfg.eps)
        upd = upd + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * upd)
        mu.copy_(mu32)
        nu.copy_(nu32)
    return params, state, {"grad_norm": norm}
