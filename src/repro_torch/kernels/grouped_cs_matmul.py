"""Hopper kernel: shared-route grouped complementary-sparse matmul.

With one route shared by all G groups (``route_share=0``: R = G), the
runtime routing collapses to one static permutation of the activations
(:func:`permute_activations`), and what is left is N independent products,
one per pack slot:

  out[s] = xg[s] @ packed[s]          2·B·D_in·D_out/N flops

Layouts:
  xg      (N, B, P)  f32 or bf16, slot-major permuted activations
  packed  (N, P, G)  f32 or bf16 (:func:`slot_major_packed`, made once)
  out     (N, B, G)  f32 (:func:`interleave_out` gives (B, G·N))

The CUDA source is ``csrc/grouped_cs_matmul.cu``; its header says which TPU
kernel it replaces, what bounds it and how it is laid out.  bf16 x bf16
runs a tensor-core body; f32 and mixed operand types a CUDA-core body.
:func:`grouped_cs_matmul` launches it for CUDA tensors and runs
:func:`grouped_cs_matmul_plain` for CPU tensors; it never falls back on a
CUDA tensor.  ``grouped_cs_matmul.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .build import load_library, run_launch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(xg, packed):
    """Validate the operands; returns (N, B, P, G)."""
    if xg.ndim != 3 or xg.dtype not in _DTYPES:
        raise TypeError("xg must be (N, B, P) float32 or bfloat16, got "
                        f"{tuple(xg.shape)} {xg.dtype}")
    if packed.ndim != 3 or packed.dtype not in _DTYPES:
        raise TypeError("packed must be (N, P, G) float32 or bfloat16, got "
                        f"{tuple(packed.shape)} {packed.dtype}")
    n, b, p = xg.shape
    if tuple(packed.shape[:2]) != (n, p):
        raise ValueError(f"xg {tuple(xg.shape)} vs packed "
                         f"{tuple(packed.shape)}: want (N, B, P), (N, P, G)")
    if xg.device != packed.device:
        raise ValueError(f"operands on several devices: {xg.device}, "
                         f"{packed.device}")
    return n, b, p, packed.shape[2]


def grouped_cs_matmul_plain(xg, packed) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the reference's
    ``ref_grouped_cs_matmul``).  Returns (N, B, G) float32."""
    _check(xg, packed)
    return torch.einsum("nbp,npg->nbg", xg.float(), packed.float())


def async_staging(xg, packed) -> bool:
    """Whether the bf16 tensor-core body may stage its tiles with 16-byte
    ``cp.async`` copies: both operands' base addresses and row and slot
    strides in bytes are multiples of 16 (rows of P and of G values; a
    slot is a whole number of rows).  Where not, the same body stages with
    plain loads."""
    return all(v % 16 == 0 for v in (
        xg.data_ptr(), packed.data_ptr(), xg.shape[2] * xg.element_size(),
        packed.shape[2] * packed.element_size()))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("grouped_cs_matmul")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.grouped_cs_matmul_launch.argtypes = [ptr, i32, ptr, i32, i32, ptr,
                                             i32, i32, i32, i32, ptr]
    lib.grouped_cs_matmul_launch.restype = i32
    lib.grouped_cs_matmul_error_string.argtypes = [i32]
    lib.grouped_cs_matmul_error_string.restype = ctypes.c_char_p
    return lib


def grouped_cs_matmul(xg, packed) -> torch.Tensor:
    """``out[s] = xg[s] @ packed[s]`` for each pack slot s.  CUDA tensors:
    the kernel, on the current stream, or an exception.  CPU tensors:
    :func:`grouped_cs_matmul_plain`.  Returns (N, B, G) float32."""
    n, b, p, g = _check(xg, packed)
    dev = xg.device
    if dev.type == "cpu":
        return grouped_cs_matmul_plain(xg, packed)
    if dev.type != "cuda":
        raise ValueError(f"grouped_cs_matmul takes CPU or CUDA tensors, got "
                         f"{dev}")
    if n > 65535 or b > 32 * 65535:
        raise ValueError(f"N={n}, B={b} exceeds the kernel's grid")
    for name, t in (("xg", xg), ("packed", packed)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((n, b, g), dtype=torch.float32, device=dev)
    if n == 0 or b == 0 or g == 0:
        return out
    run_launch(_library(), "grouped_cs_matmul", dev, xg.data_ptr(),
               _DTYPES[xg.dtype], packed.data_ptr(), _DTYPES[packed.dtype],
               int(async_staging(xg, packed)), out.data_ptr(), n, b, p, g)
    grouped_cs_matmul.launches += 1
    return out


grouped_cs_matmul.launches = 0


@functools.lru_cache(maxsize=64)
def _permute_index(route_bytes: bytes, p: int, n: int,
                   device: torch.device) -> torch.Tensor:
    r = np.frombuffer(route_bytes, dtype=np.int64).reshape(p, n)
    idx = np.arange(p)[:, None] * n + r                       # (P, N)
    return torch.from_numpy(idx).to(device)


def permute_activations(x: torch.Tensor, route_shared) -> torch.Tensor:
    """Apply the shared static route to activations: (..., D_in) ->
    (N, ..., P), contiguous.

    ``route_shared`` is the (1, P, N) (or (P, N)) shared permutation, a
    numpy array or CPU tensor: its gather index is built from it on the
    host once per route and device, as the reference builds it at trace
    time."""
    if isinstance(route_shared, torch.Tensor):
        route_shared = route_shared.cpu().numpy()
    r = np.asarray(route_shared)
    r = r.reshape(r.shape[-2], r.shape[-1]).astype(np.int64)  # (P, N)
    idx = _permute_index(r.tobytes(), *r.shape, x.device)
    return x[..., idx].movedim(-1, 0).contiguous()            # (N, ..., P)


def slot_major_packed(packed: torch.Tensor) -> torch.Tensor:
    """The layers' (G, P, N) -> the kernel's (N, P, G), copied."""
    return packed.permute(2, 1, 0).contiguous()


def interleave_out(y: torch.Tensor) -> torch.Tensor:
    """The kernel's (N, B, G) -> (B, G·N), outputs ordered [g·N + s]."""
    n, b, g = y.shape
    return y.permute(1, 2, 0).reshape(b, g * n)
