"""The reference kernel verifier's fixture kernels, clean and faulty, as CUDA
kernels beside their plain PyTorch versions (``csrc/fixtures.cu``).

The reference's verifier tests (``tests/test_kernel_rules.py``, and the
whole-array copy of ``tests/test_analysis.py``) each build a small Pallas
kernel and assert what its static verifier finds.  Here each family is one
templated CUDA kernel, and the guarded-launch harness
(:mod:`.kernel_checks`) must give the counterpart findings:

========== ================================== ===================================
family     cases                              findings (card; CPU where it differs)
========== ================================== ===================================
gather     ``off`` 0 / 1                      clean / ``oob-access`` ``in[2]``
induction  ``off`` 0 / 1                      clean / ``oob-access`` ``in[0]``
accum      init, add (nk 2 and 1), overwrite  clean / ``grid-race`` ``out[2]``
                                              (both nk) / clean: a deterministic
                                              overwrite is invisible to a launch
pad        unmasked rows 6, masked rows 6,    ``oob-access`` ``in[0]`` and
           unmasked rows 8                    ``out[1]`` (CPU: ``in[0]``, the
                                              bounds check raises at the read) /
                                              clean / clean
copy       scratch 16 MiB, whole-array block  ``launch-resource`` from the
           2048² (16 MiB), scratch 64 KiB     geometry, never launched / the
                                              same / clean, launched
========== ================================== ===================================

The unmasked pad reads and writes the rows past the end: a CUDA body has
no block store that drops them, as the TPU's pipeline drops the Pallas
block's.  Its read shows because the poisoned rows it reads land in the
output's guard band.

Each ``*_into(out, ...)`` writes into a given output: the kernel on CUDA
tensors, the plain version on CPU tensors, never the plain version on a
CUDA tensor.  Each family's public function (``gather``, ``induction``,
``accum``, ``pad``, ``copy_scratch``) counts its kernel's launches in
``.launches``.  :func:`fixture_cases` gives every launched case with the
findings it must give; :func:`resource_cases` the geometries.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels.build import Geometry, load_library, run_launch

from .kernel_checks import Case
from .seeded import _on_cuda, _threads

#: the reference's fixture shapes (``tests/test_kernel_rules.py``)
GATHER_SHAPE = dict(b=2, k=8, p=16, g=4, n=4)            # :101
INDUCTION_SHAPE = dict(rows=8, c=4)                      # :134-:145
ACCUM_SHAPE = dict(s=2, m=8, k=16, c=8, bk=8)            # :163-:175
PAD_BLOCK, PAD_COLS = 4, 8                               # :226-:235
#: the scratch fixtures' (shape, f32) and the whole-array copy's array
SCRATCH_SHAPES = {"over": (4096, 1024), "within": (128, 128)}
WHOLE_ARRAY = (2048, 2048)                               # test_analysis :182
#: the copy's operand (the scratch fixtures' 8x8 block)
COPY_SHAPE = (8, 8)
ACCUM_MODES = ("init", "add", "overwrite")

_P, _I32 = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"gather": [_I32] + [_P] * 4 + [_I32] * 4 + [_P],
             "induction": [_I32] + [_P] * 2 + [_I32] * 3 + [_P],
             "accum": [_I32] + [_P] * 3 + [_I32] * 7 + [_P],
             "pad": [_I32] + [_P] * 2 + [_I32] * 4 + [_P],
             "copy_scratch": [_P] * 2 + [_I32] * 3 + [_P]}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("fixtures")
    for name, argtypes in _ARGTYPES.items():
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes, launch.restype = argtypes, ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


def _f32(*tensors):
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError("fixture operands must be float32")


def _out_shape(out, shape):
    if tuple(out.shape) != tuple(shape) or out.dtype != torch.float32:
        raise ValueError(f"out must be {tuple(shape)} float32, got "
                         f"{tuple(out.shape)} {out.dtype}")


# ---------------------------------------------------------------------------
# gather<OFF>
# ---------------------------------------------------------------------------

def gather_plain(vals, pidx, packed, off: int) -> torch.Tensor:
    """(B, G·N): Σ_j vals[b, j]·packed[pidx[b, j] + off].  ``off`` = 1 at
    ``pidx`` = P - 1 indexes past ``packed`` and raises."""
    rows = packed.reshape(packed.shape[0], -1)[pidx.long() + off]
    return torch.einsum("bk,bke->be", vals, rows)


def gather_geometry(b: int, row: int) -> Geometry:
    """One block a row, a thread an element."""
    return Geometry((b, 1, 1), _threads(row))


def gather_into(out, vals, pidx, packed, off: int) -> None:
    _f32(vals, packed)
    if pidx.dtype != torch.int32 or pidx.shape != vals.shape:
        raise TypeError("pidx must be int32 of vals' shape")
    b, k = vals.shape
    row = packed.shape[1] * packed.shape[2]
    _out_shape(out, (b, row))
    if not _on_cuda(out, vals, pidx, packed):
        out.copy_(gather_plain(vals, pidx, packed, off))
        return
    run_launch(_library(), "gather", vals.device, off, vals.data_ptr(),
               pidx.data_ptr(), packed.data_ptr(), out.data_ptr(), b, k, row,
               gather_geometry(b, row).threads)
    gather.launches += 1


def gather(vals, pidx, packed, off: int = 0) -> torch.Tensor:
    out = torch.empty((vals.shape[0], packed.shape[1] * packed.shape[2]),
                      device=vals.device)
    gather_into(out, vals, pidx, packed, off)
    return out


gather.launches = 0


# ---------------------------------------------------------------------------
# induction<OFF>
# ---------------------------------------------------------------------------

def induction_plain(x, off: int) -> torch.Tensor:
    """(C,): Σ_{j < rows} x[j + off].  ``off`` = 1 reads row ``rows``."""
    return x[torch.arange(x.shape[0], device=x.device) + off].sum(0)


def induction_geometry(c: int) -> Geometry:
    return Geometry((1, 1, 1), _threads(c))


def induction_into(out, x, off: int) -> None:
    _f32(x)
    n, c = x.shape
    _out_shape(out, (c,))
    if not _on_cuda(out, x):
        out.copy_(induction_plain(x, off))
        return
    run_launch(_library(), "induction", x.device, off, x.data_ptr(),
               out.data_ptr(), n, c, induction_geometry(c).threads)
    induction.launches += 1


def induction(x, off: int = 0) -> torch.Tensor:
    out = torch.empty((x.shape[1],), device=x.device)
    induction_into(out, x, off)
    return out


induction.launches = 0


# ---------------------------------------------------------------------------
# accum<MODE>
# ---------------------------------------------------------------------------

def accum_plain(out, x, w, mode: str, nk: int, bk: int = 8) -> torch.Tensor:
    """Over the nk K blocks of ``bk``: ``out[s] += x[s, :, kb] @ w[s, kb]``
    ("add", from whatever ``out`` held), the same after a zero-store
    ("init"), or ``out[s] = ...`` ("overwrite": the last block wins).  In
    place; returns ``out``."""
    if mode == "init":
        out.zero_()
    for kb in range(nk):
        blk = slice(kb * bk, (kb + 1) * bk)
        prod = torch.bmm(x[:, :, blk], w[:, blk, :])
        if mode == "overwrite":
            out.copy_(prod)
        else:
            out.add_(prod)
    return out


def accum_geometry(s: int, m: int, c: int) -> Geometry:
    """One block a slot, a thread an output element."""
    return Geometry((s, 1, 1), _threads(m * c))


def accum_into(out, x, w, mode: str, nk: int, bk: int = 8) -> None:
    _f32(x, w)
    s, m, kx = x.shape
    c = w.shape[2]
    _out_shape(out, (s, m, c))
    if mode not in ACCUM_MODES or not 1 <= nk * bk <= kx:
        raise ValueError(f"mode {mode!r}, nk={nk}, bk={bk} for K={kx}")
    if not _on_cuda(out, x, w):
        accum_plain(out, x, w, mode, nk, bk)
        return
    run_launch(_library(), "accum", x.device, ACCUM_MODES.index(mode),
               x.data_ptr(), w.data_ptr(), out.data_ptr(), s, m, kx, c, bk,
               nk, accum_geometry(s, m, c).threads)
    accum.launches += 1


def accum(x, w, mode: str = "init", nk: int = 2, bk: int = 8):
    out = torch.zeros((x.shape[0], x.shape[1], w.shape[2]), device=x.device)
    accum_into(out, x, w, mode, nk, bk)
    return out


accum.launches = 0


# ---------------------------------------------------------------------------
# pad<MASKED>
# ---------------------------------------------------------------------------

def pad_plain(x, masked: bool, block: int = PAD_BLOCK) -> torch.Tensor:
    """x * 2 over blocks of ``block`` rows.  Unmasked, a ragged last block
    indexes the rows past the end and raises."""
    rows = x.shape[0]
    n = rows if masked else -(-rows // block) * block
    return (x[torch.arange(n, device=x.device)] * 2.0)[:rows]


def pad_geometry(rows: int, c: int, block: int = PAD_BLOCK) -> Geometry:
    """One block a block of rows, a thread an element of it."""
    return Geometry((-(-rows // block), 1, 1), _threads(block * c))


def pad_into(out, x, masked: bool, block: int = PAD_BLOCK) -> None:
    _f32(x)
    rows, c = x.shape
    _out_shape(out, (rows, c))
    if not _on_cuda(out, x):
        out.copy_(pad_plain(x, masked, block))
        return
    run_launch(_library(), "pad", x.device, int(masked), x.data_ptr(),
               out.data_ptr(), rows, c, block,
               pad_geometry(rows, c, block).threads)
    pad.launches += 1


def pad(x, masked: bool = True, block: int = PAD_BLOCK) -> torch.Tensor:
    out = torch.empty_like(x)
    pad_into(out, x, masked, block)
    return out


pad.launches = 0


# ---------------------------------------------------------------------------
# copy_scratch
# ---------------------------------------------------------------------------

def copy_scratch_plain(x) -> torch.Tensor:
    return x.clone()


def copy_scratch_geometry(n: int, scratch_elems: int) -> Geometry:
    """One block; its dynamic shared memory is the f32 scratch."""
    return Geometry((1, 1, 1), _threads(n), 1, 4 * scratch_elems)


def copy_scratch_into(out, x, scratch_elems: int) -> None:
    """Copy ``x`` into ``out`` through a shared-memory scratch of
    ``scratch_elems`` f32 (at least x's elements)."""
    _f32(x)
    _out_shape(out, x.shape)
    if scratch_elems < x.numel():
        raise ValueError(f"scratch of {scratch_elems} cannot stage "
                         f"{x.numel()} elements")
    if not _on_cuda(out, x):
        out.copy_(copy_scratch_plain(x))
        return
    geo = copy_scratch_geometry(x.numel(), scratch_elems)
    run_launch(_library(), "copy_scratch", x.device, x.data_ptr(),
               out.data_ptr(), x.numel(), geo.smem, geo.threads)
    copy_scratch.launches += 1


def copy_scratch(x, scratch_elems: int) -> torch.Tensor:
    out = torch.empty_like(x)
    copy_scratch_into(out, x, scratch_elems)
    return out


copy_scratch.launches = 0

#: every family's counted function, by the name its row carries
FAMILIES = {"gather": gather, "induction": induction, "accum": accum,
            "pad": pad, "copy_scratch": copy_scratch}


# ---------------------------------------------------------------------------
# The cases and the findings each must give
# ---------------------------------------------------------------------------

def operands(device, seed: int = 0) -> Dict[str, tuple]:
    """Each family's inputs at the reference's shapes, from ``seed``: the
    gather's indices over [0, P - 1], both ends drawn."""
    rng = np.random.default_rng(seed)
    b, k, p, g, n = (GATHER_SHAPE[x] for x in "bkpgn")
    pidx = rng.integers(0, p, (b, k)).astype(np.int32)
    pidx[0, 0], pidx[-1, -1] = 0, p - 1
    s, m, kk, c = (ACCUM_SHAPE[x] for x in "smkc")
    arrays = {
        "gather": (rng.standard_normal((b, k)).astype(np.float32), pidx,
                   rng.standard_normal((p, g, n)).astype(np.float32)),
        "induction": (rng.standard_normal(
            (INDUCTION_SHAPE["rows"], INDUCTION_SHAPE["c"])).astype(
            np.float32),),
        "accum": (rng.standard_normal((s, m, kk)).astype(np.float32),
                  rng.standard_normal((s, kk, c)).astype(np.float32)),
        "pad6": (rng.standard_normal((6, PAD_COLS)).astype(np.float32),),
        "pad8": (rng.standard_normal((8, PAD_COLS)).astype(np.float32),),
        "copy": (rng.standard_normal(COPY_SHAPE).astype(np.float32),)}
    return {name: tuple(torch.from_numpy(a).to(device) for a in arrs)
            for name, arrs in arrays.items()}


Expect = Tuple[Tuple[str, str], ...]


def fixture_cases(device, seed: int = 0) -> List[Tuple[Case, Expect]]:
    """Every launched fixture case with the findings the harness must give
    on ``device`` (``(rule, ref)`` pairs in order)."""
    ops = operands(device, seed)
    cpu = torch.device(device).type == "cpu"
    b, g, n = (GATHER_SHAPE[x] for x in "bgn")
    s, m, c, bk = (ACCUM_SHAPE[x] for x in ("s", "m", "c", "bk"))
    f32 = torch.float32
    cases = []
    for off, expect in ((0, ()), (1, (("oob-access", "in[2]"),))):
        cases.append((Case("gather", f"gather off={off}",
                           functools.partial(_run_gather, off=off),
                           ops["gather"], [((b, g * n), f32)]), expect))
    for off, expect in ((0, ()), (1, (("oob-access", "in[0]"),))):
        cases.append((Case("induction", f"induction off={off}",
                           functools.partial(_run_induction, off=off),
                           ops["induction"],
                           [((INDUCTION_SHAPE["c"],), f32)]), expect))
    race = (("grid-race", "out[2]"),)
    for mode, nk, expect in (("init", 2, ()), ("add", 2, race),
                             ("add", 1, race), ("overwrite", 2, ())):
        cases.append((Case("accum", f"accum {mode} nk={nk}",
                           functools.partial(_run_accum, mode=mode, nk=nk,
                                             bk=bk),
                           ops["accum"], [((s, m, c), f32)]), expect))
    unmasked = ((("oob-access", "in[0]"),) if cpu else
                (("oob-access", "in[0]"), ("oob-access", "out[1]")))
    for rows, masked, expect in ((6, False, unmasked), (6, True, ()),
                                 (8, False, ())):
        cases.append((Case("pad", f"pad rows={rows} "
                           f"{'masked' if masked else 'unmasked'}",
                           functools.partial(_run_pad, masked=masked),
                           ops[f"pad{rows}"], [((rows, PAD_COLS), f32)]),
                      expect))
    within = int(np.prod(SCRATCH_SHAPES["within"]))
    cases.append((Case("copy_scratch", "copy_scratch scratch (128, 128)",
                       functools.partial(_run_copy, scratch=within),
                       ops["copy"], [(COPY_SHAPE, f32)]), ()))
    return cases


def _run_gather(outs, vals, pidx, packed, off):
    gather_into(outs[0], vals, pidx, packed, off)


def _run_induction(outs, x, off):
    induction_into(outs[0], x, off)


def _run_accum(outs, x, w, mode, nk, bk):
    accum_into(outs[0], x, w, mode, nk, bk)


def _run_pad(outs, x, masked):
    pad_into(outs[0], x, masked)


def _run_copy(outs, x, scratch):
    copy_scratch_into(outs[0], x, scratch)


def resource_cases() -> Dict[str, Tuple[Geometry, bool]]:
    """The copy's geometries: {label: (geometry, over the card's limit)}.
    The scratch fixtures stage the 8x8 block through a scratch of their
    size; the whole-array copy stages its whole 2048² array."""
    n = int(np.prod(COPY_SHAPE))
    whole = int(np.prod(WHOLE_ARRAY))
    return {
        "scratch (4096, 1024) f32": (copy_scratch_geometry(
            n, int(np.prod(SCRATCH_SHAPES["over"]))), True),
        "whole-array block (2048, 2048) f32": (copy_scratch_geometry(
            whole, whole), True),
        "scratch (128, 128) f32": (copy_scratch_geometry(
            n, int(np.prod(SCRATCH_SHAPES["within"]))), False)}
