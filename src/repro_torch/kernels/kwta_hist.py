"""Hopper kernel: histogram-threshold global k-WTA (paper §3.3.3, Fig. 10).

Over the last axis of x (B, D): quantize each row to 256 bins over its
[min, max], find the largest bin t whose tail count #(bin >= t) is at
least K, and keep every element in a bin >= t (so >= K survive); the rest
become 0.  The output has x's shape and type.

The quantization is float32 whatever the input type, as the reference's
Pallas kernel does (``repro/kernels/kwta_hist.py:46``).  The reference's
oracle ``ref_kwta_hist`` and the port's ``repro_torch.core.kwta_hist``
quantize in the input's own type instead, so for bf16 input they keep
other elements than this kernel; for float32 input all agree bin for bin.

The CUDA source is ``csrc/kwta_hist.cu``; its header says which TPU kernel
it replaces, what bounds it and how it is laid out.  The pure function
:func:`register_path` picks between its two loops.  :func:`kwta_hist_cuda`
calls the custom op ``repro_torch::kwta_hist``, whose body launches it for
CUDA tensors (:func:`launch_into`) and runs :func:`kwta_hist_cuda_plain`
for CPU tensors; it never falls back on a CUDA tensor.
:func:`launch_geometry` is the launcher's geometry, for the linter, and
:func:`cost` its work, for the census.  ``kwta_hist_cuda.launches``
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import Cost, Geometry, define_op, load_library, run_launch

_BINS = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the longest row, in bytes, that the kernel holds in registers: 320
#: threads of four 16-byte vectors
REGISTER_ROW_BYTES = 320 * 4 * 16
#: threads of a block (``kThreads`` in the source), one block a row
THREADS = 320


def _check(x: torch.Tensor, k: int):
    """Validate the operands; returns (B, D)."""
    if x.ndim != 2:
        raise ValueError(f"x must be (B, D), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if isinstance(k, bool) or not isinstance(k, int):
        raise TypeError(f"k must be an int, got {k!r}")
    return x.shape


def kwta_hist_cuda_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``ref_kwta_hist``'s
    histogram threshold, quantized in float32 as the kernel does."""
    _check(x, k)
    x32 = x.float()
    lo = x32.amin(dim=-1, keepdim=True)
    hi = x32.amax(dim=-1, keepdim=True)
    # a tensor numerator: `255 / t` would be t.reciprocal() * 255, which is
    # not the division the kernel rounds
    scale = torch.where(hi > lo, torch.full_like(hi, _BINS - 1) / (hi - lo),
                        torch.zeros_like(hi))
    q = torch.clamp((x32 - lo) * scale, 0, _BINS - 1).to(torch.int64)
    hist = torch.zeros((*q.shape[:-1], _BINS), dtype=torch.int64,
                       device=x.device).scatter_add_(-1, q, torch.ones_like(q))
    tail = hist.flip(-1).cumsum(-1).flip(-1)        # #(bin >= t)
    t = ((tail >= k).sum(-1, keepdim=True) - 1).clamp(min=0)
    return torch.where(q >= t, x, torch.zeros_like(x))


def launch_geometry(b: int) -> Geometry:
    """The launcher's geometry (``launch`` in ``csrc/kwta_hist.cu``): one
    block of :data:`THREADS` a row, static shared memory only."""
    return Geometry((b, 1, 1), THREADS)


#: float32 operations an element: the row's min and max, the quantizing
#: subtract and multiply, two clamps and the compare with the threshold
OPS_PER_ELEMENT = 7


def cost(b: int, d: int, dtype) -> Cost:
    """One call's work from its shapes and types (:class:`~.build.Cost`):
    :data:`OPS_PER_ELEMENT` float32 operations an element on the CUDA cores
    (no product), x read once and y written once."""
    return Cost(OPS_PER_ELEMENT * b * d, 2 * b * d * dtype.itemsize)


def register_path(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether the kernel reads each row of x once into registers and
    writes y with 16-byte stores: a row is at most ``REGISTER_ROW_BYTES``
    long, its length in bytes and both bases are multiples of 16.  Where
    not, the same kernel takes its plain-load loop."""
    row = x.shape[-1] * x.element_size()
    return (row % 16 == 0 and row <= REGISTER_ROW_BYTES
            and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("kwta_hist")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.kwta_hist_launch.argtypes = [ptr, i32, ptr, i32, i32, i32, i32, ptr]
    lib.kwta_hist_launch.restype = i32
    lib.kwta_hist_error_string.argtypes = [i32]
    lib.kwta_hist_error_string.restype = ctypes.c_char_p
    return lib


def launch_into(y: torch.Tensor, x: torch.Tensor, k: int) -> None:
    """Launch the kernel on CUDA ``x`` into ``y`` (x's shape and type), on
    the current stream, and count the launch: the custom op's CUDA body,
    and the linter's guarded launches."""
    b, d = _check(x, k)
    if y.dtype != x.dtype or y.shape != x.shape:
        raise ValueError(f"y must be {tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(y.shape)} {y.dtype}")
    for name, t in (("x", x), ("y", y)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, not a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if b == 0 or d == 0:
        return
    # every k <= 0 keeps bin 255 and every k > d the whole row: the clamp
    # keeps the bins and fits k into the kernel's int
    run_launch(_library(), "kwta_hist", x.device, x.data_ptr(),
               _DTYPES[x.dtype], y.data_ptr(), b, d, min(max(k, 0), d + 1),
               int(register_path(x, y)))
    kwta_hist_cuda.launches += 1


def _cuda_body(x, k):
    y = torch.empty_like(x)
    launch_into(y, x, k)
    return y


_OP = define_op("kwta_hist(Tensor x, int k) -> Tensor", kwta_hist_cuda_plain,
                _cuda_body, lambda x, k: torch.empty_like(x),
                lambda x, k: cost(x.shape[0], x.shape[1], x.dtype))


def kwta_hist_cuda(x: torch.Tensor, k: int) -> torch.Tensor:
    """Histogram k-WTA over the last axis of x (B, D), quantized in float32.
    CUDA tensors: the kernel, on the current stream, or an exception.  CPU
    tensors: :func:`kwta_hist_cuda_plain`.  Returns x's shape and type."""
    _check(x, k)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"kwta_hist_cuda takes CPU or CUDA tensors, got "
                         f"{x.device}")
    return _OP(x, k)


kwta_hist_cuda.launches = 0
