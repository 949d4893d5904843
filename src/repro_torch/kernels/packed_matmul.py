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
kernel it replaces, what bounds it and how it is laid out.  bf16 x bf16
runs a tensor-core body that expands each chunk of packed weights into a
dense tile in shared memory (:func:`expand_tile` is that rule in plain
PyTorch); f32 and mixed operand types run a CUDA-core body.
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


def async_staging(x, packed, route) -> bool:
    """Whether the bf16 tensor-core body may stage its tiles with 16-byte
    ``cp.async`` copies: every operand's base address and row stride in
    bytes are multiples of 16 (the rows it copies are x's and packed[g]'s
    P·N bf16 and route[g/R]'s P·N int8).  Where not, the same body stages
    with plain loads."""
    row = packed.shape[1] * packed.shape[2]
    return all(v % 16 == 0 for t in (x, packed, route)
               for v in (t.data_ptr(), row * t.element_size()))


def expand_tile(packed, route, g0: int, k0: int, groups: int,
                width: int = 128) -> torch.Tensor:
    """The tensor-core body's expansion of one chunk, in plain PyTorch: the
    dense weight ``W[k][g·N+s] = packed[g, p, s] · [route[g // R, p, s] ==
    k - p·N]`` at inputs ``k0 .. k0+width`` and groups ``g0 .. g0+groups``,
    laid out as the kernel stores it, ``[(g - g0)·N + s][k - k0]`` (K
    contiguous).  Groups past G and inputs past P·N (a ragged tile) are
    zeros; a route entry outside [0, N) matches no input.  ``k0`` is a
    multiple of N.  The kernel does this in shared memory; nothing calls
    this function but the tests."""
    g, p, n = packed.shape
    r = g // route.shape[0]
    gs = torch.arange(g0, min(g0 + groups, g))
    ks = torch.arange(k0, min(k0 + width, p * n))     # k = p·N + s
    w = packed.reshape(g, p * n)[gs][:, ks]
    rt = route.reshape(-1, p * n)[gs // r][:, ks].long()
    out = torch.zeros((groups, n, width), dtype=packed.dtype)
    gl = torch.arange(len(gs))[:, None]
    kk = torch.arange(len(ks))
    s = kk % n
    for i in range(n):
        out[gl, s, kk - s + i] = torch.where(rt == i, w, torch.zeros_like(w))
    return out.reshape(groups * n, width)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("packed_matmul")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.packed_matmul_launch.argtypes = [ptr, i32, ptr, i32, ptr, i32, ptr,
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
               route.data_ptr(), int(async_staging(x, packed, route)),
               out.data_ptr(), b, p, g, n, r)
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
