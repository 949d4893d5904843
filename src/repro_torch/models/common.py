"""Shared model components: device choice, dtypes, norms, RoPE,
embeddings, inits, the cross-entropy loss.

Params are nested dicts of tensors, as in the reference; every ``*_init``
returns the params of one component, drawn from a ``torch.Generator``
whose device is the device of the new tensors.
"""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another (the tests pass ``device="cpu"``).  With no CUDA device and
    none asked for, raise — an entry point never carries on on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def normal_init(gen: torch.Generator, shape, std, dtype=torch.float32):
    return std * torch.randn(shape, dtype=dtype, device=gen.device,
                             generator=gen)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm_apply(params, x: torch.Tensor, eps: float = 1e-5):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_init(d: int, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm_apply(params, x: torch.Tensor, eps: float = 1e-5):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (split-half, as the reference)
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh) or (..., S, Dh); positions: (..., S)."""
    d_head = x.shape[-1]
    freqs = rope_freqs(d_head, theta, x.device)          # (Dh/2,)
    ang = positions[..., None].float() * freqs           # (..., S, Dh/2)
    if x.ndim == ang.ndim + 1:                           # head axis present
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embedding_init(gen: torch.Generator, vocab: int, d: int):
    return {"table": normal_init(gen, (vocab, d), 0.02)}


def embedding_apply(params, tokens: torch.Tensor, compute_dtype):
    return params["table"].to(compute_dtype)[tokens]


def lm_head_apply(params, x: torch.Tensor, compute_dtype):
    """Project to vocab logits; table may be tied (vocab, d)."""
    return x @ params["table"].to(compute_dtype).T


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in fp32; with ``mask``, the mean over the
    masked-in tokens."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        m = mask.float()
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)
