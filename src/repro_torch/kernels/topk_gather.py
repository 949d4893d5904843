"""Hopper kernel: sparse-sparse CS contraction (paper §3.2 / Fig. 8).

For each of the K non-zero activations of a row, fetch the corresponding
packed weight row, mask it by Kernel-ID match (route == offset), scale it
by the activation value, and accumulate:

  out[b, g·N+s] = Σ_k vals[b,k] · packed_p[p_idx[b,k], g, s]
                              · [route[g // R, p_idx[b,k], s] == s_off[b,k]]

Layouts:
  vals     (B, K)       f32 or bf16 activation values
  p_idx    (B, K)       int32 or int64 partition index of each non-zero
  s_off    (B, K)       the same type: offset-within-partition of each one
  packed_p (P, G, N)    f32 or bf16, partition-major (made once at load)
  route    (G/R, P, N)  int8, the layers' own layout (never repeated to G)
  out      (B, G·N)     f32, or ``out_dtype`` (bf16: the f32 sums rounded
                        once)

The CUDA source is ``csrc/topk_gather.cu``; its header says which TPU
kernel it replaces, what bounds it and how it is laid out.  Two pure
functions here decide how it is launched: :func:`launch_rule` (the cluster
size and strip width) and :func:`async_staging` (16-byte ``cp.async``
copies or plain loads); :func:`launch_geometry` is the launcher's whole
geometry, for the linter.  :func:`topk_gather` validates the operands and
calls the custom op ``repro_torch::topk_gather``, a single node in a traced
graph, whose body launches the kernel for CUDA tensors
(:func:`launch_into`) and runs :func:`topk_gather_plain` for CPU tensors;
it never falls back on a CUDA tensor.  ``topk_gather.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import Geometry, define_op, load_library, run_launch

#: pack factors the kernel is instantiated for
SUPPORTED_N = (1, 2, 4, 8, 16)
_FLOAT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INDEX_DTYPES = {torch.int32: 0, torch.int64: 1}
#: blocks the launcher rule aims for: about one on each of the card's 132 SMs
TARGET_BLOCKS = 128
#: the largest portable thread-block cluster
MAX_CLUSTER = 8
#: threads of a block (``kThreads`` in the source)
THREADS = 256


def _check(vals, p_idx, s_off, packed_p, route):
    """Validate the operands; returns (B, K, P, G, N, R)."""
    if vals.ndim != 2:
        raise ValueError(f"vals must be (B, K), got {tuple(vals.shape)}")
    b, k = vals.shape
    if k < 1:
        raise ValueError(f"k_nnz={k} must be >= 1 (at least one non-zero "
                         "per row)")
    if vals.dtype not in _FLOAT_DTYPES:
        raise TypeError(f"vals must be float32 or bfloat16, got {vals.dtype}")
    for name, t in (("p_idx", p_idx), ("s_off", s_off)):
        if tuple(t.shape) != (b, k):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(b, k)}")
        if t.dtype not in _INDEX_DTYPES:
            raise TypeError(f"{name} must be int32 or int64, got {t.dtype}")
    if p_idx.dtype != s_off.dtype:
        raise TypeError(f"p_idx {p_idx.dtype} and s_off {s_off.dtype} must "
                        "have one type")
    if packed_p.ndim != 3 or packed_p.dtype not in _FLOAT_DTYPES:
        raise TypeError("packed_p must be (P, G, N) float32 or bfloat16, got "
                        f"{tuple(packed_p.shape)} {packed_p.dtype}")
    p, g, n = packed_p.shape
    if route.dtype != torch.int8:
        raise TypeError(f"route must be int8, got {route.dtype}")
    if (route.ndim != 3 or tuple(route.shape[1:]) != (p, n)
            or g % route.shape[0]):
        raise ValueError(f"route {tuple(route.shape)} does not fit packed_p "
                         f"{tuple(packed_p.shape)}: want (G/R, P, N)")
    devices = {t.device for t in (vals, p_idx, s_off, packed_p, route)}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    return b, k, p, g, n, g // route.shape[0]


def topk_gather_plain(vals, p_idx, s_off, packed_p, route,
                      out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on the kernel's operands
    (ported from ``repro.kernels.ref.ref_topk_gather``).  Returns (B, G·N)
    in ``out_dtype``, summed in float32."""
    b, k, p, g, n, r = _check(vals, p_idx, s_off, packed_p, route)
    p_idx = p_idx.long()
    wrow = packed_p[p_idx].float()                       # (B, K, G, N)
    rrow = route[:, p_idx].permute(1, 2, 0, 3)           # (B, K, G/R, N)
    hit = rrow == s_off[:, :, None, None].to(rrow.dtype)
    if r > 1:
        hit = hit.repeat_interleave(r, dim=2)            # (B, K, G, N)
    y = torch.einsum("bk,bkgs->bgs", vals.float(), wrow * hit)
    return y.reshape(b, g * n).to(out_dtype)


def launch_rule(b: int, k: int, g: int, n: int, elem_size: int):
    """The kernel's grid, as (cluster, lanes): a strip is ``lanes`` 16-byte
    vectors of a partition row (32, one warp's sweep of 512 B, where the
    row of G·N elements of ``elem_size`` bytes is that long, else the next
    power of two above it), and ``cluster`` blocks (1 to 8, a power of two)
    split each row's K entries.  The grid is (strips × cluster, B): the
    rule takes the least cluster that gives it ``TARGET_BLOCKS`` blocks, and
    never more blocks in a cluster than entries in a row."""
    row_vecs = -(-g * n * elem_size // 16)
    lanes = min(32, 1 << (row_vecs - 1).bit_length())
    strips = -(-row_vecs // lanes)
    cluster = 1
    while (cluster < MAX_CLUSTER and b * strips * cluster < TARGET_BLOCKS
           and 2 * cluster <= k):
        cluster *= 2
    return cluster, lanes


def launch_geometry(b: int, k: int, g: int, n: int,
                    elem_size: int) -> Geometry:
    """The launcher's geometry (``launch`` in ``csrc/topk_gather.cu``):
    a grid of (strips × cluster, B) blocks of :data:`THREADS`, clusters of
    :func:`launch_rule`'s size, no dynamic shared memory."""
    cluster, lanes = launch_rule(b, k, g, n, elem_size)
    row_vecs = -(-g * n * elem_size // 16)
    strips = -(-row_vecs // lanes)
    return Geometry((strips * cluster, b, 1), THREADS, cluster, 0)


def static_smem(elem_size: int) -> int:
    """Bytes of the kernel's static shared arrays for weights of
    ``elem_size`` bytes (the ``__shared__`` declarations of
    ``topk_gather_kernel``: the weight strips, three entry arrays of
    ``kMaxEntries``, the warps' partials and the cluster's inbox, with
    V = 16 / elem_size elements a 16-byte vector)."""
    v = 16 // elem_size
    strip_bytes, max_entries, warps = 24 * 1024, 256, THREADS // 32
    return (strip_bytes + 3 * 4 * max_entries + warps * 32 * v * 4
            + (32 * v + MAX_CLUSTER) * 4)


def async_staging(packed_p) -> bool:
    """Whether the kernel may stage the weight strips with 16-byte
    ``cp.async`` copies: packed_p's base address and its partition rows of
    G·N elements are multiples of 16 bytes.  Where not, the same kernel
    stages with plain loads."""
    row = packed_p.shape[1] * packed_p.shape[2] * packed_p.element_size()
    return packed_p.data_ptr() % 16 == 0 and row % 16 == 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("topk_gather")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.topk_gather_launch.argtypes = [ptr, i32, ptr, ptr, i32, ptr, i32, ptr,
                                       ptr, i32, i32, i32, i32, i32, i32, i32,
                                       i32, i32, i32, ptr]
    lib.topk_gather_launch.restype = i32
    lib.topk_gather_error_string.argtypes = [i32]
    lib.topk_gather_error_string.restype = ctypes.c_char_p
    return lib


def launch_into(out, vals, p_idx, s_off, packed_p, route) -> None:
    """Launch the kernel on CUDA operands into ``out`` (B, G·N), f32 or
    bf16, on the current stream, and count the launch: the custom op's
    CUDA body, and the linter's guarded launches (whose ``out`` is a view
    inside a guard band)."""
    b, k, p, g, n, r = _check(vals, p_idx, s_off, packed_p, route)
    if out.dtype not in _FLOAT_DTYPES or tuple(out.shape) != (b, g * n):
        raise ValueError(f"out must be ({b}, {g * n}) float32 or bfloat16, "
                         f"got {tuple(out.shape)} {out.dtype}")
    if n not in SUPPORTED_N:
        raise ValueError(f"pack factor N={n} not in {SUPPORTED_N}")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit 65535")
    for name, t in (("vals", vals), ("p_idx", p_idx), ("s_off", s_off),
                    ("packed_p", packed_p), ("route", route), ("out", out)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, not a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    cluster, lanes = launch_rule(b, k, g, n, packed_p.element_size())
    run_launch(_library(), "topk_gather", vals.device, vals.data_ptr(),
               _FLOAT_DTYPES[vals.dtype], p_idx.data_ptr(), s_off.data_ptr(),
               _INDEX_DTYPES[p_idx.dtype], packed_p.data_ptr(),
               _FLOAT_DTYPES[packed_p.dtype], route.data_ptr(),
               out.data_ptr(), _FLOAT_DTYPES[out.dtype], b, k, p, g, n, r,
               cluster, lanes, int(async_staging(packed_p)))
    topk_gather.launches += 1


def _cuda_body(vals, p_idx, s_off, packed_p, route, out_dtype):
    out = torch.empty((vals.shape[0], packed_p.shape[1] * packed_p.shape[2]),
                      dtype=out_dtype, device=vals.device)
    launch_into(out, vals, p_idx, s_off, packed_p, route)
    return out


def _fake(vals, p_idx, s_off, packed_p, route, out_dtype):
    return vals.new_empty((vals.shape[0],
                           packed_p.shape[1] * packed_p.shape[2]),
                          dtype=out_dtype)


_OP = define_op("topk_gather(Tensor vals, Tensor p_idx, Tensor s_off, "
                "Tensor packed_p, Tensor route, ScalarType out_dtype) -> "
                "Tensor", topk_gather_plain, _cuda_body, _fake)


def topk_gather(vals, p_idx, s_off, packed_p, route,
                out_dtype=torch.float32) -> torch.Tensor:
    """Sparse-sparse contraction of K non-zeros per row against packed
    weights.  CUDA tensors: the kernel, on the current stream, or an
    exception.  CPU tensors: :func:`topk_gather_plain`.  Returns (B, G·N)
    in ``out_dtype`` (float32 or bfloat16), summed in float32."""
    _check(vals, p_idx, s_off, packed_p, route)
    if out_dtype not in _FLOAT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"topk_gather takes CPU or CUDA tensors, got "
                         f"{vals.device}")
    return _OP(vals, p_idx, s_off, packed_p, route, out_dtype)


topk_gather.launches = 0
