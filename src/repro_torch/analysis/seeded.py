"""The linter's two seeded-fault kernels: hand-written CUDA ports of the
reference's deliberately broken Pallas kernels, which the self-test must
catch (``analysis/lint.py:_oob_gather_kernel`` and
``_missing_init_kernel`` of the JAX package).

* ``oob_gather`` — ``out[b, e] = Σ_j vals[b, j]·packed[pidx[b, j]+1, e]``:
  an off-by-one gather that reads one partition past the one the index
  names, unclamped (``csrc/oob_gather.cu``).
* ``missing_init`` — ``out[s] += xg[s, :, kb] @ packed[s, kb, :]`` over
  the K blocks ``kb``, with no zero-store before the first: the result
  adds to whatever the output buffer held (``csrc/missing_init.cu``).

Each has its plain PyTorch version here, faults included: on the CPU,
``oob_gather_plain`` indexes ``packed`` one row past and torch's bounds
check raises where the kernel would read past the end; ``missing_init_
plain`` accumulates into the buffer it is given.  The ``*_into`` functions
write into a given output (the linter's guarded launches): the kernel on
CUDA tensors, the plain version on CPU tensors, never the plain version on
a CUDA tensor.  ``oob_gather.launches`` and ``missing_init.launches``
count the kernels' launches.  The OOB kernel is launched only with
in-range indices or inside guard bands (``kernel_checks``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import Geometry, load_library, run_launch

#: the seeded shapes of the reference (``lint.py:770``, ``:818-829``)
OOB_SHAPE = dict(b=2, k=8, p=16, g=4, n=4)
MISSING_SHAPE = dict(s=2, m=8, k=16, c=8, bk=8)


def _threads(work: int) -> int:
    """Threads of a block: one an output element, whole warps, at most 256."""
    return min(256, 32 * -(-work // 32))


_P, _I32 = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"oob_gather": [_P] * 4 + [_I32] * 4 + [_P],
             "missing_init": [_P] * 3 + [_I32] * 6 + [_P]}


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    lib = load_library(name)
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes, launch.restype = _ARGTYPES[name], ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


def _on_cuda(*tensors) -> bool:
    """True for CUDA tensors, False for CPU ones; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds != {"cuda"}:
        raise ValueError(f"operands on {sorted(kinds)}: want all on the CPU "
                         "or all on one CUDA device")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    return True


# ---------------------------------------------------------------------------
# oob_gather
# ---------------------------------------------------------------------------

def _check_oob(vals, pidx, packed):
    if vals.dtype != torch.float32 or packed.dtype != torch.float32:
        raise TypeError("vals and packed must be float32")
    if pidx.dtype != torch.int32 or pidx.shape != vals.shape:
        raise TypeError("pidx must be int32 of vals' shape")
    if vals.ndim != 2 or packed.ndim != 3:
        raise ValueError("want vals (B, K), pidx (B, K), packed (P, G, N)")
    return vals.shape[0], vals.shape[1], packed.shape[1] * packed.shape[2]


def oob_gather_plain(vals, pidx, packed) -> torch.Tensor:
    """The seeded kernel's function in plain PyTorch, fault included:
    (B, G·N) f32.  ``pidx = P - 1`` indexes past packed and raises."""
    b, k, row = _check_oob(vals, pidx, packed)
    w = packed.reshape(packed.shape[0], row)[pidx.long() + 1]   # (B, K, row)
    return torch.einsum("bk,bke->be", vals, w)


def oob_gather_geometry(b: int, row: int) -> Geometry:
    """The launcher's geometry: one block a row, a thread an element."""
    return Geometry((b, 1, 1), _threads(row))


def oob_gather_into(out, vals, pidx, packed) -> None:
    """Write the seeded gather into ``out`` (B, G·N) f32."""
    b, k, row = _check_oob(vals, pidx, packed)
    if tuple(out.shape) != (b, row) or out.dtype != torch.float32:
        raise ValueError(f"out must be ({b}, {row}) float32")
    if not _on_cuda(out, vals, pidx, packed):
        out.copy_(oob_gather_plain(vals, pidx, packed))
        return
    run_launch(_library("oob_gather"), "oob_gather", vals.device,
               vals.data_ptr(), pidx.data_ptr(), packed.data_ptr(),
               out.data_ptr(), b, k, row, oob_gather_geometry(b, row).threads)
    oob_gather.launches += 1


def oob_gather(vals, pidx, packed) -> torch.Tensor:
    """The seeded gather: the kernel on CUDA tensors, the plain version on
    CPU tensors.  (B, G·N) f32."""
    b, _, row = _check_oob(vals, pidx, packed)
    out = torch.empty((b, row), dtype=torch.float32, device=vals.device)
    oob_gather_into(out, vals, pidx, packed)
    return out


oob_gather.launches = 0


# ---------------------------------------------------------------------------
# missing_init
# ---------------------------------------------------------------------------

def _check_missing(out, xg, packed, bk):
    for name, t in (("out", out), ("xg", xg), ("packed", packed)):
        if t.dtype != torch.float32 or t.ndim != 3:
            raise TypeError(f"{name} must be a 3-d float32 tensor")
    s, m, k = xg.shape
    c = packed.shape[2]
    if tuple(packed.shape[:2]) != (s, k) or tuple(out.shape) != (s, m, c):
        raise ValueError(f"xg {tuple(xg.shape)}, packed {tuple(packed.shape)}"
                         f", out {tuple(out.shape)}: want (S, M, K), "
                         "(S, K, C), (S, M, C)")
    if bk < 1:
        raise ValueError(f"bk={bk} must be >= 1")
    return s, m, k, c


def missing_init_plain(out, xg, packed, bk: int = 8) -> torch.Tensor:
    """The seeded kernel's function in plain PyTorch, fault included: adds
    each K block's product into ``out`` in place, from whatever it held."""
    _, _, k, _ = _check_missing(out, xg, packed, bk)
    for k0 in range(0, k, bk):
        out += torch.bmm(xg[:, :, k0:k0 + bk], packed[:, k0:k0 + bk, :])
    return out


def missing_init_geometry(s: int, m: int, c: int) -> Geometry:
    """The launcher's geometry: one block a slot, a thread an element."""
    return Geometry((s, 1, 1), _threads(m * c))


def missing_init_into(out, xg, packed, bk: int = 8) -> None:
    """Run the seeded accumulation on ``out`` (S, M, C) f32, which it reads
    before it writes."""
    s, m, k, c = _check_missing(out, xg, packed, bk)
    if not _on_cuda(out, xg, packed):
        missing_init_plain(out, xg, packed, bk)
        return
    run_launch(_library("missing_init"), "missing_init", xg.device,
               xg.data_ptr(), packed.data_ptr(), out.data_ptr(), s, m, k, c,
               bk, missing_init_geometry(s, m, c).threads)
    missing_init.launches += 1


def missing_init(xg, packed, bk: int = 8) -> torch.Tensor:
    """The seeded accumulation on a fresh (uninitialised) output: the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    out = torch.empty((xg.shape[0], xg.shape[1], packed.shape[2]),
                      dtype=torch.float32, device=xg.device)
    missing_init_into(out, xg, packed, bk)
    return out


missing_init.launches = 0
