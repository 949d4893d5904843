"""Plain PyTorch oracles of the package's kernels, collected as the
reference's ``repro.kernels.ref`` collects its jnp oracles.

Each oracle is the plain version kept beside its kernel.  The port's
``ref_topk_gather`` takes the kernel's operands: the route in the layers'
(G/R, P, N) layout, where the reference's takes it repeated to (P, G, N).
"""

from __future__ import annotations

from .topk_gather import topk_gather_plain as ref_topk_gather

__all__ = ["ref_topk_gather"]
