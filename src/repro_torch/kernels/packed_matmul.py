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
:func:`launch_geometry` is the launcher's geometry, for the linter, and
:func:`cost` its work, for the census.  :func:`packed_matmul` validates
the operands and calls the custom op ``repro_torch::packed_matmul``, whose
body launches the kernel for CUDA tensors (:func:`launch_into`) and runs
:func:`packed_matmul_plain` for CPU tensors; it never falls back on a CUDA
tensor.  ``packed_matmul.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.functional import cs_matmul
from .build import Cost, Geometry, define_op, load_library, run_launch

#: pack factors the kernel is instantiated for
SUPPORTED_N = (1, 2, 4, 8, 16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the tensor-core body's tiles (``TileSmall``, ``TileLarge`` in the
#: source): (BM, BN, warps along M, N and K, BK), the small one for B <= 16
_TC_TILES = ((16, 16, 1, 1, 4, 128), (32, 32, 2, 1, 2, 128))
_TC_STAGES = 4


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


def tc_smem(ring: int, bm: int, bn: int, wk: int) -> int:
    """A tensor-core body's dynamic shared memory (``launch_tc``): its ring
    of ``ring`` bytes, or the epilogue's f32 scratch of ``wk`` partial
    (bm, bn) tiles with rows padded by 4, whichever is larger."""
    return max(ring, wk * bm * (bn + 4) * 4)


def launch_geometry(b: int, g: int, n: int, bf16: bool) -> Geometry:
    """The launcher's geometry (``launch`` and ``launch_tc`` in
    ``csrc/packed_matmul.cu``): bf16 x bf16 (``bf16``) runs the
    tensor-core body on a grid of (G·N/BN, B/BM) tiles; other types the
    CUDA-core body, (G/32, B/16) blocks of 32 x 8 threads."""
    if not bf16:
        return Geometry((-(-g // 32), -(-b // 16), 1), 32 * 8)
    bm, bn, wm, wn, wk, bk = _TC_TILES[0 if b <= 16 else 1]
    # per stage: the x tile in bf16, each group's packed row in bf16 and its
    # route row in int8; then two expanded weight tiles in bf16
    ring = _TC_STAGES * (bm * bk * 2 + bn // n * bk * 3) + 2 * bn * bk * 2
    smem = tc_smem(ring, bm, bn, wk)
    return Geometry((-(-g * n // bn), -(-b // bm), 1), wm * wn * wk * 32, 1,
                    smem)


def cost(b: int, p: int, g: int, n: int, r: int, x_dtype, w_dtype) -> Cost:
    """One call's work from its shapes and types (:class:`~.build.Cost`):
    the plain version's 2·B·P·N·G flops (each of the G·N outputs sums P
    products: 2·T·D_in·D_out/N), on the tensor cores where both operands
    are bf16, and the bytes of x, the packed weights, the route and the
    f32 output."""
    return Cost(2 * b * p * n * g,
                b * p * n * x_dtype.itemsize + g * p * n * w_dtype.itemsize
                + g // r * p * n + b * g * n * 4,
                x_dtype == w_dtype == torch.bfloat16)


def _op_cost(x, packed, route) -> Cost:
    g, p, n = packed.shape
    return cost(x.shape[0], p, g, n, g // route.shape[0], x.dtype,
                packed.dtype)


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


def launch_into(out, x, packed, route) -> None:
    """Launch the kernel on CUDA operands into ``out`` (B, G·N) float32, on
    the current stream, and count the launch: the custom op's CUDA body,
    and the linter's guarded launches."""
    b, p, g, n, r = _check(x, packed, route)
    if out.dtype != torch.float32 or tuple(out.shape) != (b, g * n):
        raise ValueError(f"out must be ({b}, {g * n}) float32, got "
                         f"{tuple(out.shape)} {out.dtype}")
    if n not in SUPPORTED_N:
        raise ValueError(f"pack factor N={n} not in {SUPPORTED_N}")
    if b > 16 * 65535 or p * n >= 2**31 or g * n >= 2**31:
        raise ValueError(f"shape B={b}, P={p}, G={g}, N={n} exceeds the "
                         "kernel's grid or int indexing")
    for name, t in (("x", x), ("packed", packed), ("route", route),
                    ("out", out)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, not a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if b == 0 or g == 0:
        return
    run_launch(_library(), "packed_matmul", x.device, x.data_ptr(),
               _DTYPES[x.dtype], packed.data_ptr(), _DTYPES[packed.dtype],
               route.data_ptr(), int(async_staging(x, packed, route)),
               out.data_ptr(), b, p, g, n, r)
    packed_matmul.launches += 1


def _cuda_body(x, packed, route):
    out = torch.empty((x.shape[0], packed.shape[0] * packed.shape[2]),
                      dtype=torch.float32, device=x.device)
    launch_into(out, x, packed, route)
    return out


def _fake(x, packed, route):
    return x.new_empty((x.shape[0], packed.shape[0] * packed.shape[2]),
                       dtype=torch.float32)


_OP = define_op("packed_matmul(Tensor x, Tensor packed, Tensor route) -> "
                "Tensor", packed_matmul_plain, _cuda_body, _fake, _op_cost)


def packed_matmul(x, packed, route) -> torch.Tensor:
    """``x @ decompress(packed, route)`` without the dense weight.  CUDA
    tensors: the kernel, on the current stream, or an exception.  CPU
    tensors: :func:`packed_matmul_plain`.  Returns (B, G·N) float32."""
    _check(x, packed, route)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"packed_matmul takes CPU or CUDA tensors, got "
                         f"{x.device}")
    return _OP(x, packed, route)


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
