"""What the references share: precision, the dense form of a packed
weight, norms, RoPE, the k-WTA, and the layout of one served request.

Precision: ``Prec("f32")`` is float32 with TF32 off (the reference);
``Prec("fp8")`` rounds both operands of every weight product to float8
e4m3 with a per-tensor scale for the weight and a per-row scale for the
activation, accumulating in float32 (the control: the step below the
configuration's bfloat16).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List

import torch
import torch.nn.functional as tF

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def _fp8(x: torch.Tensor, dim) -> torch.Tensor:
    amax = (x.abs().amax() if dim is None
            else x.abs().amax(dim=dim, keepdim=True))
    s = torch.clamp(amax, min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


@dataclasses.dataclass(frozen=True)
class Prec:
    kind: str = "f32"

    def __post_init__(self):
        if self.kind not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {self.kind!r}")

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A weight (d_in, d_out), or a stack of them, as this precision
        holds it: one scale a matrix."""
        w = w.float()
        if self.kind == "fp8":
            amax = w.abs().amax(dim=(-2, -1), keepdim=True)
            s = torch.clamp(amax, min=1e-30) / FP8_MAX
            w = (w / s).to(torch.float8_e4m3fn).to(torch.float32) * s
        return w

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation (or a gradient) as this precision holds it: one
        scale a row."""
        x = x.float()
        return _fp8(x, -1) if self.kind == "fp8" else x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` for a weight ``w`` already in this precision
        (:meth:`weight`); the activation rounded with one scale a row."""
        return self.act(x) @ w


def dense_of_packed(packed: torch.Tensor, route: torch.Tensor
                    ) -> torch.Tensor:
    """The (d_in, d_out) weight (leading axes kept) that a packed
    complementary-sparse weight stands for: output ``g·N + s`` reads input
    ``p·N + route[g // R, p, s]`` with weight ``packed[..., g, p, s]``,
    every other entry zero.  Differentiable in ``packed``."""
    g, p, n = packed.shape[-3:]
    r = g // route.shape[0]
    table = route.long().repeat_interleave(r, dim=0)            # (G, P, N)
    dev = packed.device
    rows = torch.arange(p, device=dev)[None, :, None] * n + table
    cols = (torch.arange(g, device=dev)[:, None, None] * n
            + torch.arange(n, device=dev)[None, None, :]).expand(g, p, n)
    lead = packed.shape[:-3]
    flat_idx = (rows * (g * n) + cols).reshape(-1)             # (G·P·N,)
    vals = packed.float().reshape(*lead, -1)
    out = torch.zeros(*lead, p * n * g * n, dtype=torch.float32, device=dev)
    out = out.index_add(-1, flat_idx, vals)
    return out.reshape(*lead, p * n, g * n)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()


def plain_rope(scaling) -> bool:
    """Whether a configuration's ``rope_scaling`` leaves RoPE plain: none,
    or a group at factor 1 or less, where YaRN interpolates no frequency
    and multiplies the softmax scale by an mscale of 1."""
    return scaling is None or scaling["factor"] <= 1


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Split-half rotary embedding of x (S, H, D) or (S, D) at
    ``positions`` (S,)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = positions.float()[:, None] * inv                      # (S, D/2)
    if x.ndim == 3:
        ang = ang[:, None, :]
    c, s = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float()[..., :d // 2], x.float()[..., d // 2:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def k_of(width: int, k_frac: float) -> int:
    return min(width, max(1, int(round(width * k_frac))))


def kwta_bisect(h: torch.Tensor, k: int, iters: int) -> torch.Tensor:
    """The configuration's k-WTA: a threshold found by ``iters`` rounds of
    bisection between the row's least and largest value (the largest
    probed threshold that keeps at least k), every value at or above it
    kept, the rest zeroed."""
    if k >= h.shape[-1]:
        return h
    lo = h.amin(-1, keepdim=True)
    hi = h.amax(-1, keepdim=True)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        up = (h >= mid).sum(-1, keepdim=True) >= k
        lo = torch.where(up, mid, lo)
        hi = torch.where(up, hi, mid)
    return h * (h >= lo).to(h.dtype)


def silu(x):
    return tF.silu(x)


@dataclasses.dataclass
class Seq:
    """One served request laid out for a single reference pass.

    The engine prefills a prompt of length L padded with token 0 to its
    bucket b (the next power of two, >= 8, at most max_seq) and then
    decodes the served tokens one at a time through its cache.  The pass
    holds the prompt, the padding where it matters (``with_pads``: a MoE
    groups the padded prompt for capacity), and the served tokens but the
    last; the padding attends only to the prompt and itself, and the
    served tokens never see it.  ``logit_rows`` are the positions whose
    logits predict the served tokens, in order."""
    tokens: torch.Tensor       # (S,) int64
    positions: torch.Tensor    # (S,) int64
    mask: torch.Tensor         # (S, S) bool: query attends key
    logit_rows: torch.Tensor   # (n_served,)
    groups: List[torch.Tensor]     # MoE token groups (index tensors)


def bucket_of(n: int, max_seq: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return min(b, max_seq)


def layout_request(prompt, served, max_seq: int, with_pads: bool,
                   device) -> Seq:
    prompt = torch.as_tensor(prompt, dtype=torch.int64)
    served = torch.as_tensor(served, dtype=torch.int64)
    ln, n = prompt.numel(), served.numel()
    b = bucket_of(ln, max_seq) if with_pads else ln
    pad = b - ln
    toks = torch.cat([prompt, torch.zeros(pad, dtype=torch.int64),
                      served[:-1]])
    pos = torch.cat([torch.arange(b), torch.arange(ln, ln + n - 1)])
    region = torch.cat([torch.zeros(ln, dtype=torch.int64),
                        torch.ones(pad, dtype=torch.int64),
                        torch.full((n - 1,), 2, dtype=torch.int64)])
    s = toks.numel()
    idx = torch.arange(s)
    mask = idx[None, :] <= idx[:, None]
    mask &= ~((region[:, None] == 2) & (region[None, :] == 1))
    rows = torch.cat([torch.tensor([ln - 1]), torch.arange(b, s)])
    groups = [torch.arange(b)] + [torch.tensor([i]) for i in range(b, s)]
    return Seq(toks.to(device), pos.to(device), mask.to(device),
               rows.to(device), [g.to(device) for g in groups])


def attend(q, k, v, mask, scale):
    """q (S, H, D), k (S, H, D), v (S, H, Dv) -> (S, H, Dv) in float32."""
    s = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * scale
    s = s.masked_fill(~mask[None], -math.inf)
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v.float())
