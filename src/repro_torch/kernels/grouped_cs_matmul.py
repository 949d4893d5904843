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
:func:`launch_geometry` is the launcher's geometry, for the linter, and
:func:`cost` its work, for the census.  :func:`grouped_cs_matmul`
validates the operands and calls the custom op
``repro_torch::grouped_cs_matmul``, whose body launches the kernel for
CUDA tensors (:func:`launch_into`) and runs :func:`grouped_cs_matmul_plain`
for CPU tensors; it never falls back on a CUDA tensor.
``grouped_cs_matmul.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import Cost, Geometry, define_op, load_library, run_launch
from .packed_matmul import tc_smem

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the tensor-core body's tiles (``TileSmall``, ``TileLarge`` in the
#: source): (BM, BN, warps along M, N and K, BK), the small one for B <= 16
_TC_TILES = ((16, 16, 1, 1, 4, 64), (32, 32, 2, 1, 2, 64))
_TC_STAGES = 6


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


def launch_geometry(n: int, b: int, g: int, bf16: bool) -> Geometry:
    """The launcher's geometry (``launch`` and ``launch_tc`` in
    ``csrc/grouped_cs_matmul.cu``): bf16 x bf16 (``bf16``) runs the
    tensor-core body on a grid of (G/BN, B/BM, N) tiles; other types the
    CUDA-core body, (G/64, B/32, N) blocks of 16 x 16 threads."""
    if not bf16:
        return Geometry((-(-g // 64), -(-b // 32), n), 16 * 16)
    bm, bn, wm, wn, wk, bk = _TC_TILES[0 if b <= 16 else 1]
    # per stage: the xg and packed tiles in bf16
    smem = tc_smem(_TC_STAGES * (bm * bk + bk * bn) * 2, bm, bn, wk)
    return Geometry((-(-g // bn), -(-b // bm), n), wm * wn * wk * 32, 1,
                    smem)


def cost(n: int, b: int, p: int, g: int, x_dtype, w_dtype) -> Cost:
    """One call's work from its shapes and types (:class:`~.build.Cost`):
    the plain version's 2·N·B·P·G flops, on the tensor cores where both
    operands are bf16, and the bytes of xg, the slot-major weights and the
    f32 output."""
    return Cost(2 * n * b * p * g,
                n * b * p * x_dtype.itemsize + n * p * g * w_dtype.itemsize
                + n * b * g * 4, x_dtype == w_dtype == torch.bfloat16)


def _op_cost(xg, packed) -> Cost:
    n, b, p = xg.shape
    return cost(n, b, p, packed.shape[2], xg.dtype, packed.dtype)


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


def launch_into(out, xg, packed) -> None:
    """Launch the kernel on CUDA operands into ``out`` (N, B, G) float32,
    on the current stream, and count the launch: the custom op's CUDA
    body, and the linter's guarded launches."""
    n, b, p, g = _check(xg, packed)
    if out.dtype != torch.float32 or tuple(out.shape) != (n, b, g):
        raise ValueError(f"out must be {(n, b, g)} float32, got "
                         f"{tuple(out.shape)} {out.dtype}")
    if n > 65535 or b > 32 * 65535:
        raise ValueError(f"N={n}, B={b} exceeds the kernel's grid")
    for name, t in (("xg", xg), ("packed", packed), ("out", out)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, not a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n == 0 or b == 0 or g == 0:
        return
    run_launch(_library(), "grouped_cs_matmul", xg.device, xg.data_ptr(),
               _DTYPES[xg.dtype], packed.data_ptr(), _DTYPES[packed.dtype],
               int(async_staging(xg, packed)), out.data_ptr(), n, b, p, g)
    grouped_cs_matmul.launches += 1


def _cuda_body(xg, packed):
    out = torch.empty((xg.shape[0], xg.shape[1], packed.shape[2]),
                      dtype=torch.float32, device=xg.device)
    launch_into(out, xg, packed)
    return out


def _fake(xg, packed):
    return xg.new_empty((xg.shape[0], xg.shape[1], packed.shape[2]),
                        dtype=torch.float32)


_OP = define_op("grouped_cs_matmul(Tensor xg, Tensor packed) -> Tensor",
                grouped_cs_matmul_plain, _cuda_body, _fake, _op_cost)


def grouped_cs_matmul(xg, packed) -> torch.Tensor:
    """``out[s] = xg[s] @ packed[s]`` for each pack slot s.  CUDA tensors:
    the kernel, on the current stream, or an exception.  CPU tensors:
    :func:`grouped_cs_matmul_plain`.  Returns (N, B, G) float32."""
    _check(xg, packed)
    if xg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grouped_cs_matmul takes CPU or CUDA tensors, got "
                         f"{xg.device}")
    return _OP(xg, packed)


grouped_cs_matmul.launches = 0


def permute_activations(x: torch.Tensor, route_shared) -> torch.Tensor:
    """Apply the shared static route to activations: (..., D_in) ->
    (N, ..., P), contiguous.

    ``route_shared`` is the (1, P, N) (or (P, N)) shared permutation, a
    tensor or a numpy array.  Its gather index ``p·N + route[p, s]`` is
    computed where x lies: a route on the card never comes to the host."""
    r = torch.as_tensor(route_shared, device=x.device)
    p, n = r.shape[-2], r.shape[-1]
    idx = (torch.arange(p, device=x.device)[:, None] * n
           + r.reshape(p, n).long())                          # (P, N)
    return x[..., idx].movedim(-1, 0).contiguous()            # (N, ..., P)


def slot_major_packed(packed: torch.Tensor) -> torch.Tensor:
    """The layers' (G, P, N) -> the kernel's (N, P, G), copied."""
    return packed.permute(2, 1, 0).contiguous()


def interleave_out(y: torch.Tensor) -> torch.Tensor:
    """The kernel's (N, B, G) -> (B, G·N), outputs ordered [g·N + s]."""
    n, b, g = y.shape
    return y.permute(1, 2, 0).reshape(b, g * n)
