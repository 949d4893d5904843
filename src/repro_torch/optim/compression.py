"""Int8 error-feedback gradient compression: the per-tensor quantizer and
the residual state of the reference's ``repro.optim.compression``.

Quantize (grad + residual) to int8 with a per-tensor scale, send the int8
payload, dequantize, and carry the quantization error into the next
step's residual: the *accumulated* update is unbiased.  The cross-pod
all-reduce that sends it (``make_compressed_grad_sync``) belongs to the
distribution slice of the port (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.tree import is_float, map_tree


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization; returns (q, scale)."""
    x32 = x.float()
    amax = x32.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    # round half to even, as jnp.round
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_residuals(grads_like, n_pods: int):
    """Per-pod residual state: leading dim n_pods, float32 for float
    leaves, an int32 ``(n_pods,)`` placeholder for int leaves."""
    return map_tree(
        lambda g: torch.zeros((n_pods, *g.shape), dtype=torch.float32,
                              device=g.device) if is_float(g)
        else torch.zeros((n_pods,), dtype=torch.int32, device=g.device),
        grads_like)
