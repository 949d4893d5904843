"""Learning-rate schedules (pure functions of the step counter).

The step may be an int or a tensor (the optimizer state's ``step``, on the
device); the scale is computed in float32 on the step's device, as the
reference computes it."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def warmup_cosine(step, warmup_steps: int, total_steps: int,
                  min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_frac`` of peak."""
    step = _f32(step)
    warm = torch.clamp((step + 1) / max(warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos


def constant(step, **_) -> torch.Tensor:
    return torch.ones_like(_f32(step))
