"""Hopper kernel: matmul against complementary-sparse packed weights,
decompressed on the fly (the paper's Multiply-Route-Sum, §3.1):

  out[b, g·N+s] = Σ_p packed[g, p, s] · x[b, p·N + route[g // R, p, s]]

which is ``x @ decompress(packed, route)`` without the dense weight.

Layouts (the layers' own, read in place):
  x       (B, P·N)     f32 or bf16
  packed  (G, P, N)    f32 or bf16
  route   (G/R, P, N)  int8, shared by R consecutive groups
  out     (B, G·N)     f32

The reference's kernel takes the partition-major (P, G, N) copies that
:func:`to_partition_major` makes on every call; this kernel reads the
layers' layouts directly, so the op makes no per-call layout copy.

The CUDA source is ``csrc/packed_matmul.cu``; its header says which TPU
kernel it replaces, what bounds it and how it is laid out.
:func:`packed_matmul` launches it for CUDA tensors and runs
:func:`packed_matmul_plain` for CPU tensors; it never falls back on a CUDA
tensor.  ``packed_matmul.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.functional import cs_matmul
from .build import load_library, run_launch

#: pack factors the kernel is instantiated for
SUPPORTED_N = (1, 2, 4, 8, 16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x, packed, route):
    """Validate the operands; returns (B, P, G, N, R)."""
    if x.ndim != 2 or x.dtype not in _DTYPES:
        raise TypeError("x must be (B, D_in) float32 or bfloat16, got "
                        f"{tuple(x.shape)} {x.dtype}")
    if packed.ndim != 3 or packed.dtype not in _DTYPES:
        raise TypeError("packed must be (G, P, N) float32 or bfloat16, got "
                        f"{tuple(packed.shape)} {packed.dtype}")
    g, p, n = packed.shape
    if route.dtype != torch.int8:
        raise TypeError(f"route must be int8, got {route.dtype}")
    if (route.ndim != 3 or tuple(route.shape[1:]) != (p, n)
            or route.shape[0] == 0 or g % route.shape[0]):
        raise ValueError(f"route {tuple(route.shape)} does not fit packed "
                         f"{tuple(packed.shape)}: want (G/R, P, N)")
    if x.shape[1] != p * n:
        raise ValueError(f"x d_in {x.shape[1]} != P*N {p * n}")
    devices = {t.device for t in (x, packed, route)}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    return x.shape[0], p, g, n, g // route.shape[0]


def packed_matmul_plain(x, packed, route) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the port's ``cs_matmul`` on
    float32 upcasts, the reference's ``ref_packed_matmul``).  Returns
    (B, G·N) float32."""
    _check(x, packed, route)
    return cs_matmul(x.float(), packed.float(), route)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("packed_matmul")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.packed_matmul_launch.argtypes = [ptr, i32, ptr, i32, ptr, ptr,
                                         i32, i32, i32, i32, i32, ptr]
    lib.packed_matmul_launch.restype = i32
    lib.packed_matmul_error_string.argtypes = [i32]
    lib.packed_matmul_error_string.restype = ctypes.c_char_p
    return lib


def packed_matmul(x, packed, route) -> torch.Tensor:
    """``x @ decompress(packed, route)`` without the dense weight.  CUDA
    tensors: the kernel, on the current stream, or an exception.  CPU
    tensors: :func:`packed_matmul_plain`.  Returns (B, G·N) float32."""
    b, p, g, n, r = _check(x, packed, route)
    dev = x.device
    if dev.type == "cpu":
        return packed_matmul_plain(x, packed, route)
    if dev.type != "cuda":
        raise ValueError(f"packed_matmul takes CPU or CUDA tensors, got {dev}")
    if n not in SUPPORTED_N:
        raise ValueError(f"pack factor N={n} not in {SUPPORTED_N}")
    if b > 16 * 65535 or p * n >= 2**31 or g * n >= 2**31:
        raise ValueError(f"shape B={b}, P={p}, G={g}, N={n} exceeds the "
                         "kernel's grid or int indexing")
    for name, t in (("x", x), ("packed", packed), ("route", route)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((b, g * n), dtype=torch.float32, device=dev)
    if b == 0 or g == 0:
        return out
    run_launch(_library(), "packed_matmul", dev, x.data_ptr(),
               _DTYPES[x.dtype], packed.data_ptr(), _DTYPES[packed.dtype],
               route.data_ptr(), out.data_ptr(), b, p, g, n, r)
    packed_matmul.launches += 1
    return out


packed_matmul.launches = 0


def to_partition_major(packed: torch.Tensor, route: torch.Tensor):
    """The reference kernel's operands: packed (G, P, N) and route
    (G/R, P, N) as partition-major (P, G, N) copies, the route repeated out
    to G.  The port's kernels read the layers' layouts in place and need
    neither; this serves callers that hold the reference's layout."""
    g, gr = packed.shape[0], route.shape[0]
    if gr != g:
        route = route.repeat_interleave(g // gr, dim=0)
    return (packed.transpose(0, 1).contiguous(),
            route.transpose(0, 1).contiguous())
