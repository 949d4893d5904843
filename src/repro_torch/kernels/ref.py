"""Plain PyTorch oracles of the package's kernels, collected as the
reference's ``repro.kernels.ref`` collects its jnp oracles.

* ``ref_packed_matmul`` — decompress to the dense weight, then matmul in
  float32 (an independent formula beside ``packed_matmul_plain``'s
  gather-and-contract).
* ``ref_grouped_cs_matmul`` and ``ref_topk_gather`` — the plain versions
  kept beside their kernels.  The port's ``ref_topk_gather`` takes the
  kernel's operands: the route in the layers' (G/R, P, N) layout, where
  the reference's takes it repeated to (P, G, N).
* ``ref_kwta_hist`` — the histogram threshold quantized in the input's own
  type, as the reference's oracle does; the kernel quantizes in float32,
  so for bf16 input the two keep different elements.
* ``ref_topk_support`` — the Select, curried on N as the reference's is.
"""

from __future__ import annotations

import torch

from repro_torch.core.functional import decompress
from repro_torch.core.kwta import kwta_hist as ref_kwta_hist
from .grouped_cs_matmul import grouped_cs_matmul_plain as ref_grouped_cs_matmul
from .topk_gather import topk_gather_plain as ref_topk_gather

__all__ = ["ref_grouped_cs_matmul", "ref_kwta_hist", "ref_packed_matmul",
           "ref_topk_gather", "ref_topk_support"]


def ref_packed_matmul(x: torch.Tensor, packed: torch.Tensor,
                      route: torch.Tensor) -> torch.Tensor:
    """Decompress-and-matmul oracle.  x: (B, D_in); packed (G, P, N);
    route (G/R, P, N).  Returns (B, G·N) float32."""
    return x.float() @ decompress(packed.float(), route)


def ref_topk_support(x: torch.Tensor, k: int):
    """(vals, p_idx, s_off) of the K largest-|x| entries, for a given N."""
    def for_n(n: int):
        _, sel = torch.topk(x.abs(), k)
        vals = torch.gather(x, -1, sel)
        return (vals, (sel // n).to(torch.int32),
                (sel % n).to(torch.int32))
    return for_n
