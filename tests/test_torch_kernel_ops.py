"""The port's kernel library beside the reference's: ``packed_matmul``,
``grouped_cs_matmul`` and ``kwta_hist`` (their plain versions, which the
wrappers run for CPU tensors) against the JAX kernels run in interpret mode
and against the JAX oracles, over ``tests/test_kernels.py``'s sweep and the
registry's; the shapes the reference pads, run directly; the five ops'
gradients against ``jax.grad`` of the JAX ops; the layout helpers; the
wrappers' argument checks; what surrounds the bf16 tensor-core bodies (the
packed expansion rule against ``decompress`` and the JAX kernel's, the
16-byte alignment check that picks their staging) and the build key.

Tolerances: float32 atol=rtol=1e-4 and bf16 2e-2, as the JAX kernel tests
use (every version accumulates in float32; the sums differ in order only);
``kwta_hist`` bin for bin.  The CUDA kernels themselves run only on the
card: ``python3 chip_smoke.py`` holds them against these plain versions
there."""

import importlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CSLayout, make_routes, pack_dense, routes_to_mask
from repro.kernels import (grouped_cs_matmul as j_grouped,
                           grouped_cs_matmul_op as j_grouped_op,
                           interleave_out as j_interleave_out,
                           kwta_hist_op as j_kwta_hist_op,
                           kwta_hist_pallas as j_kwta_hist,
                           packed_matmul as j_packed_matmul,
                           packed_matmul_op as j_packed_matmul_op,
                           permute_activations as j_permute,
                           slot_major_packed as j_slot_major,
                           to_partition_major as j_to_partition_major,
                           topk_gather_op as j_topk_gather_op,
                           topk_gather_support_op as j_support_op)
from repro.kernels import ref as JR
from repro.kernels import registry as j_registry
from repro_torch.kernels import (grouped_cs_matmul, grouped_cs_matmul_op,
                                 grouped_cs_matmul_plain, interleave_out,
                                 kwta_hist_cuda, kwta_hist_op, packed_matmul,
                                 packed_matmul_op, packed_matmul_plain,
                                 permute_activations, slot_major_packed,
                                 to_partition_major, topk_gather_op,
                                 topk_gather_support_op)
from repro_torch.core.functional import decompress
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref as TR
from repro_torch.kernels import registry as t_registry

# the modules, which the package's functions of the same names shadow
packed_module = importlib.import_module("repro_torch.kernels.packed_matmul")
grouped_module = importlib.import_module(
    "repro_torch.kernels.grouped_cs_matmul")
kwta_module = importlib.import_module("repro_torch.kernels.kwta_hist")

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)

# tests/test_kernels.py's sweep: (B, d_in, d_out, n, dtype, TPU blocks)
SWEEP = [
    (8, 64, 64, 2, "float32", (8, 8, 8)),
    (16, 128, 64, 4, "float32", (8, 16, 16)),
    (16, 256, 256, 4, "bfloat16", (8, 32, 32)),
    (32, 256, 128, 8, "float32", (16, 16, 16)),
    (8, 512, 256, 16, "bfloat16", (8, 16, 8)),
]
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype):
    return BF16_TOL if dtype == "bfloat16" else F32_TOL


def _pair(a, dtype="float32"):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (rounded once to bf16, by JAX, for both)."""
    j = jnp.asarray(a).astype(J_DT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(T_DT[dtype])
    return j, t


def _np(t):
    return t.detach().float().numpy()


def _layer(d_in, d_out, n, gr, seed=0):
    """packed (G, P, N) on a CS mask and route (G/R, P, N) int8 with
    ``gr`` route tables (R = G / gr)."""
    g = d_out // n
    route = make_routes(CSLayout(d_in, n * gr, n), seed)
    full = np.repeat(route, g // gr, axis=0)
    lay = CSLayout(d_in, d_out, n)
    rng = np.random.default_rng(seed + 1)
    w = rng.normal(size=(d_in, d_out)).astype(np.float32)
    w = w * routes_to_mask(lay, full).astype(np.float32)
    return pack_dense(lay, w, full), route


# ---------------------------------------------------------------------------
# packed_matmul
# ---------------------------------------------------------------------------

PACKED_CASES = (
    [(b, d_in, d_out, n, dt, blocks, r) for b, d_in, d_out, n, dt, blocks
     in SWEEP for r in ("1", "G")]
    + [(b, p * n, g * n, n, "float32", (bb, bp, bg), "1")
       for b, p, g, n, bb, bp, bg in t_registry.PACKED_MATMUL_SWEEP])


@pytest.mark.parametrize("b,d_in,d_out,n,dtype,blocks,r", PACKED_CASES)
def test_packed_matmul_matches_jax_kernel_and_oracle(b, d_in, d_out, n,
                                                     dtype, blocks, r):
    g = d_out // n
    packed, route = _layer(d_in, d_out, n, g if r == "1" else 1, seed=b)
    x = np.random.default_rng(b).normal(size=(b, d_in))
    jx, tx = _pair(x, dtype)
    jp, tp = _pair(packed, dtype)
    jr, tr = jnp.asarray(route), torch.from_numpy(route)
    pr, rr = j_to_partition_major(jp, jr)
    bb, bp, bg = blocks
    y_jax = np.asarray(j_packed_matmul(jx, pr, rr, block_b=bb, block_p=bp,
                                       block_g=bg, interpret=True))
    y_ref = np.asarray(JR.ref_packed_matmul(jx, jp, rr.transpose(1, 0, 2)))
    before = packed_matmul.launches
    y = packed_matmul(tx, tp, tr)
    assert y.dtype == torch.float32 and packed_matmul.launches == before
    np.testing.assert_array_equal(y.numpy(),
                                  packed_matmul_plain(tx, tp, tr).numpy())
    np.testing.assert_allclose(y.numpy(), y_jax, **_tol(dtype))
    np.testing.assert_allclose(y.numpy(), y_ref, **_tol(dtype))
    np.testing.assert_allclose(TR.ref_packed_matmul(tx, tp, tr).numpy(),
                               y_ref, **_tol(dtype))


# ---------------------------------------------------------------------------
# grouped_cs_matmul
# ---------------------------------------------------------------------------

GROUPED_CASES = (
    [(n, b, d_in // n, d_out // n, dt, blocks)
     for b, d_in, d_out, n, dt, blocks in SWEEP]
    + [(n, b, p, g, "float32", (bb, bp, bg))
       for n, b, p, g, bb, bp, bg in t_registry.GROUPED_CS_SWEEP])


@pytest.mark.parametrize("n,b,p,g,dtype,blocks", GROUPED_CASES)
def test_grouped_matches_jax_kernel_and_oracle(n, b, p, g, dtype, blocks):
    rng = np.random.default_rng(n * b + p)
    jxg, txg = _pair(rng.normal(size=(n, b, p)), dtype)
    jpk, tpk = _pair(rng.normal(size=(n, p, g)), dtype)
    bb, bp, bg = blocks
    y_jax = np.asarray(j_grouped(jxg, jpk, block_b=bb, block_p=bp,
                                 block_g=bg, interpret=True))
    y_ref = np.asarray(JR.ref_grouped_cs_matmul(jxg, jpk))
    before = grouped_cs_matmul.launches
    y = grouped_cs_matmul(txg, tpk)
    assert y.dtype == torch.float32
    assert grouped_cs_matmul.launches == before
    np.testing.assert_allclose(y.numpy(), y_jax, **_tol(dtype))
    np.testing.assert_allclose(y.numpy(), y_ref, **_tol(dtype))
    assert TR.ref_grouped_cs_matmul is grouped_cs_matmul_plain


@pytest.mark.parametrize("b,d_in,d_out,n", [(4, 64, 32, 4), (6, 240, 640, 4),
                                            (3, 128, 256, 8)])
def test_grouped_equals_packed_at_a_shared_route(b, d_in, d_out, n):
    """With one route for all groups (route_share=0) the shared permutation,
    the grouped product and the interleave compute packed_matmul."""
    packed, route = _layer(d_in, d_out, n, 1, seed=d_in)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(b, d_in))
                         .astype(np.float32))
    tp, tr = torch.from_numpy(packed), torch.from_numpy(route)
    y = interleave_out(grouped_cs_matmul(permute_activations(x, tr),
                                         slot_major_packed(tp)))
    np.testing.assert_allclose(y.numpy(), packed_matmul(x, tp, tr).numpy(),
                               **F32_TOL)


def test_layout_helpers_match_jax():
    packed, route = _layer(64, 32, 4, 1, seed=3)
    x = np.random.default_rng(2).normal(size=(5, 64)).astype(np.float32)
    tx, tp, tr = (torch.from_numpy(a) for a in (x, packed, route))
    jxg = j_permute(jnp.asarray(x), route)
    for r in (route, tr, route[0]):                  # numpy, tensor, (P, N)
        xg = permute_activations(tx, r)
        assert xg.is_contiguous()
        np.testing.assert_array_equal(xg.numpy(), np.asarray(jxg))
    np.testing.assert_array_equal(slot_major_packed(tp).numpy(),
                                  np.asarray(j_slot_major(jnp.asarray(packed))))
    y = np.random.default_rng(3).normal(size=(4, 5, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        interleave_out(torch.from_numpy(y)).numpy(),
        np.asarray(j_interleave_out(jnp.asarray(y))))
    for gr in (1, 2, 8):
        packed, route = _layer(64, 32, 4, gr, seed=gr)
        got = to_partition_major(torch.from_numpy(packed),
                                 torch.from_numpy(route))
        want = j_to_partition_major(jnp.asarray(packed), jnp.asarray(route))
        for a, w in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# around the bf16 tensor-core bodies: the packed expansion, the alignment
# check, the build key
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", ["1", "2", "G"])
@pytest.mark.parametrize("p,g,groups", [(5, 6, 4), (40, 10, 16)])
def test_expand_tile_is_decompress_and_the_jax_kernels_expansion(p, g,
                                                                 groups, r):
    """The rule the packed tensor-core body expands each chunk by, tile by
    tile (ragged in K and in G), equals the dense weight of the port's
    ``decompress`` and of the JAX kernel run in interpret mode on the
    identity, route entries outside [0, N) included (they add nothing)."""
    n = 4
    gr = {"1": g, "2": g // 2, "G": 1}[r]
    packed, route = _layer(p * n, g * n, n, gr, seed=p + gr)
    route[0, 1, 2], route[-1, -1, 0] = n + 3, -1        # match no input
    eye = jnp.eye(p * n, dtype=jnp.float32)
    pr, rr = j_to_partition_major(jnp.asarray(packed), jnp.asarray(route))
    w_jax = np.asarray(j_packed_matmul(eye, pr, rr, block_b=p * n,
                                       block_p=p, block_g=g, interpret=True))
    tp, tr = torch.from_numpy(packed), torch.from_numpy(route)
    hit = (tr >= 0) & (tr < n)                          # per route row
    hit = hit.repeat_interleave(g // gr, dim=0)
    w_port = decompress(torch.where(hit, tp, torch.zeros_like(tp)),
                        tr.clamp(0, n - 1)).numpy()
    np.testing.assert_array_equal(w_port, w_jax)
    width = 128  # the kernel's chunk
    dense = np.zeros((p * n + width, (g + groups) * n), np.float32)
    dense[:p * n, :g * n] = w_jax
    for g0 in range(0, g, groups):
        for k0 in range(0, p * n, width):
            tile = packed_module.expand_tile(tp, tr, g0, k0, groups, width)
            assert tile.shape == (groups * n, width)
            np.testing.assert_array_equal(
                tile.numpy(),
                dense[k0:k0 + width, g0 * n:(g0 + groups) * n].T)


def _offset(t, elems=1):
    """A contiguous copy of ``t`` whose base lies ``elems`` elements past
    the start of its storage."""
    flat = torch.zeros(t.numel() + elems, dtype=t.dtype)
    out = flat[elems:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("p,n,move,aligned", [
    (16, 4, None, True),            # rows of 64 bf16 / 64 int8
    (4, 4, None, True),             # rows of 16 int8: the least
    (2, 4, None, False),            # route rows of 8 B
    (3, 4, None, False),            # rows of 12 inputs: 24 B / 12 B
    (16, 4, "x", False),            # bases 2 B past a 16-byte boundary
    (16, 4, "packed", False),
    (16, 4, "route", False),
])
def test_packed_async_staging_needs_16_byte_bases_and_rows(p, n, move,
                                                           aligned):
    ops = {"x": torch.zeros((3, p * n), dtype=torch.bfloat16),
           "packed": torch.zeros((6, p, n), dtype=torch.bfloat16),
           "route": torch.zeros((6, p, n), dtype=torch.int8)}
    if move:
        ops[move] = _offset(ops[move])
        assert ops[move].is_contiguous()
    assert packed_module.async_staging(**ops) is aligned


@pytest.mark.parametrize("p,g,move,aligned", [
    (16, 8, None, True),
    (20, 16, None, False),          # xg rows of 40 B
    (16, 12, None, False),          # packed rows of 24 B
    (16, 8, "xg", False),
    (16, 8, "packed", False),
])
def test_grouped_async_staging_needs_16_byte_bases_and_rows(p, g, move,
                                                            aligned):
    ops = {"xg": torch.zeros((4, 7, p), dtype=torch.bfloat16),
           "packed": torch.zeros((4, p, g), dtype=torch.bfloat16)}
    if move:
        ops[move] = _offset(ops[move])
    assert grouped_module.async_staging(**ops) is aligned


KERNEL_SOURCES = ("packed_matmul", "grouped_cs_matmul", "topk_gather",
                  "kwta_hist")


@pytest.mark.parametrize("name", KERNEL_SOURCES)
def test_build_key_follows_the_headers_a_source_includes(name, tmp_path,
                                                         monkeypatch):
    """An edited header, or a header it includes, names a new library for
    the sources that include it and for no other; a header no source
    includes changes no key.  Needs no nvcc."""
    original = kbuild.build_key(name)
    csrc = tmp_path / "csrc"
    shutil.copytree(kbuild.CSRC, csrc)
    monkeypatch.setattr(kbuild, "CSRC", csrc)
    includes = b'#include "tc_bf16.cuh"' in (csrc / f"{name}.cu").read_bytes()
    assert kbuild.build_key(name) == original
    (csrc / "unused.cuh").write_text("// included by no source\n")
    assert kbuild.build_key(name) == original
    header = csrc / "tc_bf16.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = kbuild.build_key(name)
    assert (edited != original) is includes
    header.write_text(header.read_text() + '#include "nested.cuh"\n')
    (csrc / "nested.cuh").write_text("// one\n")
    nested = kbuild.build_key(name)
    (csrc / "nested.cuh").write_text("// two\n")
    assert (kbuild.build_key(name) != nested) is includes


# ---------------------------------------------------------------------------
# kwta_hist
# ---------------------------------------------------------------------------

KWTA_CASES = ([(4, 256, 16), (8, 512, 50), (16, 1500, 180), (2, 128, 1),
               (8, 1500, 225), (16, 2560, 320)]
              + [(b, d, k) for b, d, k, _ in t_registry.KWTA_HIST_SWEEP])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,d,k", KWTA_CASES)
def test_kwta_hist_bin_for_bin(b, d, k, dtype):
    """The plain version keeps what the Pallas kernel keeps, in both types
    (both quantize in float32); in float32 that is also the oracle's set."""
    jx, tx = _pair(np.random.default_rng(d + k).normal(size=(b, d)), dtype)
    y_jax = np.asarray(j_kwta_hist(jx, k, block_b=b,
                                   interpret=True).astype(jnp.float32))
    before = kwta_hist_cuda.launches
    y = kwta_hist_cuda(tx, k)
    assert y.dtype == tx.dtype and kwta_hist_cuda.launches == before
    np.testing.assert_array_equal(_np(y), y_jax)
    assert ((y_jax != 0).sum(-1) >= k).all()
    if dtype == "float32":
        np.testing.assert_array_equal(_np(y), np.asarray(JR.ref_kwta_hist(jx, k)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,d,k", [(1024, 64, 1), (1024, 64, 2),
                                   (16, 2560, 320), (8, 1500, 225)])
def test_ref_kwta_hist_matches_the_oracle_in_its_own_type(b, d, k, dtype):
    """``ref_kwta_hist`` (the port's ``core.kwta_hist``) quantizes in x's
    type with the oracle's division: 1024 rows at k=1 and k=2 catch a
    scale one ulp off, which moves a row's maximum into bin 254."""
    jx, tx = _pair(np.random.default_rng(b + k).normal(size=(b, d)), dtype)
    np.testing.assert_array_equal(
        _np(TR.ref_kwta_hist(tx, k)),
        np.asarray(JR.ref_kwta_hist(jx, k).astype(jnp.float32)))


def test_kwta_hist_bf16_follows_the_kernel_not_the_oracle():
    """For bf16 input the Pallas kernel (and the port) quantize the float32
    upcast; the oracle quantizes in bf16 and keeps other elements."""
    jx, tx = _pair(np.random.default_rng(0).normal(size=(16, 2560)),
                   "bfloat16")
    y = _np(kwta_hist_cuda(tx, 320))
    oracle = np.asarray(JR.ref_kwta_hist(jx, 320).astype(jnp.float32))
    assert (y != oracle).any(-1).sum() > 0
    upcast = np.asarray(JR.ref_kwta_hist(jx.astype(jnp.float32), 320))
    np.testing.assert_array_equal(y, upcast)


@pytest.mark.parametrize("b,d,dtype,offset,in_registers", [
    (128, 2560, torch.bfloat16, 0, True),     # 5120 B: 320 vectors
    (128, 2560, torch.float32, 0, True),      # 10240 B
    (4, 10240, torch.bfloat16, 0, True),      # 20 KB: the longest
    (4, 10248, torch.bfloat16, 0, False),     # longer
    (4, 5124, torch.float32, 0, False),
    (8, 1500, torch.bfloat16, 0, False),      # rows of 3000 B
    (8, 1500, torch.float32, 0, True),        # rows of 6000 B
    (4, 2560, torch.bfloat16, 1, False),      # base 2 B past 16
    (4, 2560, torch.float32, 4, True),        # base 16 B past
])
def test_kwta_register_path_needs_short_16_byte_rows(b, d, dtype, offset,
                                                     in_registers):
    x = _offset(torch.zeros((b, d), dtype=dtype), offset) if offset else \
        torch.zeros((b, d), dtype=dtype)
    assert x.is_contiguous()
    y = torch.empty_like(x)
    assert kwta_module.register_path(x, y) is in_registers
    assert kwta_module.register_path(y, x) is in_registers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kwta_hist_k_at_least_d_keeps_everything(dtype):
    _, tx = _pair(np.random.default_rng(5).normal(size=(3, 64)), dtype)
    for k in (64, 65, 10**12):
        assert torch.equal(kwta_hist_cuda(tx, k), tx)


# ---------------------------------------------------------------------------
# the shapes tests/test_kernels_padded.py pads: run directly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [6, 3, 10])
def test_packed_matmul_ragged_batch(b):
    packed, route = _layer(64, 64, 4, 16, seed=3)
    x = np.random.default_rng(b).normal(size=(b, 64)).astype(np.float32)
    y = packed_matmul(*(torch.from_numpy(a) for a in (x, packed, route)))
    np.testing.assert_allclose(
        y.numpy(), np.asarray(JR.ref_packed_matmul(
            jnp.asarray(x), jnp.asarray(packed), jnp.asarray(route))),
        **F32_TOL)


@pytest.mark.parametrize("d_in,d_out,gr", [(60, 24, 6), (36, 20, 1),
                                           (240, 40, 1)])
def test_packed_matmul_ragged_partitions_and_groups(d_in, d_out, gr):
    """P = 15, 9, 60 and G = 6, 5, 10 divide no power-of-two tile."""
    packed, route = _layer(d_in, d_out, 4, gr, seed=d_in)
    x = np.random.default_rng(0).normal(size=(5, d_in)).astype(np.float32)
    y = packed_matmul(*(torch.from_numpy(a) for a in (x, packed, route)))
    full = np.repeat(route, packed.shape[0] // gr, axis=0)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(JR.ref_packed_matmul(
            jnp.asarray(x), jnp.asarray(packed), jnp.asarray(full))),
        **F32_TOL)


@pytest.mark.parametrize("b,p,g", [(6, 16, 8), (5, 16, 8), (7, 15, 6),
                                   (128, 240, 640)])
def test_grouped_ragged_shapes(b, p, g):
    rng = np.random.default_rng(b)
    xg = rng.normal(size=(4, b, p)).astype(np.float32)
    pk = rng.normal(size=(4, p, g)).astype(np.float32)
    y = grouped_cs_matmul(torch.from_numpy(xg), torch.from_numpy(pk))
    np.testing.assert_allclose(
        y.numpy(), np.asarray(JR.ref_grouped_cs_matmul(jnp.asarray(xg),
                                                       jnp.asarray(pk))),
        **F32_TOL)


@pytest.mark.parametrize("b", [6, 7])
def test_kwta_hist_ragged_batch(b):
    x = np.random.default_rng(b).normal(size=(b, 128)).astype(np.float32)
    np.testing.assert_array_equal(
        kwta_hist_cuda(torch.from_numpy(x), 16).numpy(),
        np.asarray(JR.ref_kwta_hist(jnp.asarray(x), 16)))


# ---------------------------------------------------------------------------
# the five ops' gradients against jax.grad of the JAX ops
# ---------------------------------------------------------------------------

def _leaves(*arrays):
    return [torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_()
            for a in arrays]


@pytest.mark.parametrize("gr", [16, 4, 1])
def test_packed_matmul_op_grads(gr):
    packed, route = _layer(128, 64, 4, gr, seed=9)
    x = np.random.default_rng(6).normal(size=(8, 128)).astype(np.float32)
    jr = jnp.asarray(route)
    want = jax.grad(lambda a, w: jnp.sum(j_packed_matmul_op(a, w, jr, True)
                                         ** 2), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(packed))
    tx, tp = _leaves(x, packed)
    (packed_matmul_op(tx, tp, torch.from_numpy(route)) ** 2).sum().backward()
    for got, w in zip((tx.grad, tp.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **F32_TOL)


def test_grouped_cs_matmul_op_grads():
    rng = np.random.default_rng(7)
    xg = rng.normal(size=(4, 8, 32)).astype(np.float32)
    pk = rng.normal(size=(4, 32, 16)).astype(np.float32)
    want = jax.grad(lambda a, w: jnp.sum(j_grouped_op(a, w, True) ** 2),
                    argnums=(0, 1))(jnp.asarray(xg), jnp.asarray(pk))
    txg, tpk = _leaves(xg, pk)
    (grouped_cs_matmul_op(txg, tpk) ** 2).sum().backward()
    for got, w in zip((txg.grad, tpk.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **F32_TOL)


def _support(b, k, d_in, n, seed):
    rng = np.random.default_rng(seed)
    flat = np.stack([rng.choice(d_in, size=k, replace=False)
                     for _ in range(b)])
    vals = rng.normal(size=(b, k)).astype(np.float32)
    return vals, (flat // n).astype(np.int32), (flat % n).astype(np.int32)


@pytest.mark.parametrize("gr", [8, 4, 1])
def test_topk_gather_support_op_grads(gr):
    """Through the kernel's op, the gradient of packed comes back in the
    (P, G, N) layout the op takes: the JAX op's, transposed."""
    packed, route = _layer(64, 32, 4, gr, seed=11)
    vals, p_idx, s_off = _support(3, 8, 64, 4, seed=12)
    jr = jnp.asarray(route)
    want = jax.grad(lambda v, w: jnp.sum(j_support_op(
        v, jnp.asarray(p_idx), jnp.asarray(s_off), w, jr, True) ** 2),
        argnums=(0, 1))(jnp.asarray(vals), jnp.asarray(packed))
    tv, tpp = _leaves(vals, packed.transpose(1, 0, 2))
    y = topk_gather_support_op(tv, torch.from_numpy(p_idx),
                               torch.from_numpy(s_off), tpp,
                               torch.from_numpy(route))
    (y ** 2).sum().backward()
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(want[0]),
                               **F32_TOL)
    np.testing.assert_allclose(tpp.grad.numpy(),
                               np.asarray(want[1]).transpose(1, 0, 2),
                               **F32_TOL)


@pytest.mark.parametrize("gr", [8, 1])
def test_topk_gather_support_op_grads_bf16_values(gr):
    """bf16 values with int64 indices, as the serving path holds them: the
    output and d_vals come back in bf16 and match the JAX op's on the same
    bf16 values."""
    packed, route = _layer(64, 32, 4, gr, seed=21)
    vals, p_idx, s_off = _support(3, 8, 64, 4, seed=22)
    jv, tv = _pair(vals, "bfloat16")
    jr = jnp.asarray(route)

    def loss(v, w):
        y = j_support_op(v, jnp.asarray(p_idx), jnp.asarray(s_off), w, jr,
                         True)
        return jnp.sum(y.astype(jnp.float32) ** 2)

    want = jax.grad(loss, argnums=(0, 1))(jv, jnp.asarray(packed))
    tv = tv.requires_grad_()
    tpp, = _leaves(packed.transpose(1, 0, 2))
    y = topk_gather_support_op(tv, torch.from_numpy(p_idx).long(),
                               torch.from_numpy(s_off).long(), tpp,
                               torch.from_numpy(route))
    assert y.dtype == torch.bfloat16
    (y.float() ** 2).sum().backward()
    assert tv.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tv.grad),
                               np.asarray(want[0].astype(jnp.float32)),
                               **BF16_TOL)
    np.testing.assert_allclose(tpp.grad.numpy(),
                               np.asarray(want[1]).transpose(1, 0, 2),
                               **BF16_TOL)


def test_topk_gather_op_grads():
    """d_x flows straight through onto the selected support."""
    packed, route = _layer(256, 128, 4, 1, seed=13)
    x = np.random.default_rng(14).normal(size=(4, 256)).astype(np.float32)
    x = np.where(np.abs(x) >= np.sort(np.abs(x), -1)[:, -32:-31], x, 0.0)
    jr = jnp.asarray(route)
    want = jax.grad(lambda a, w: jnp.sum(j_topk_gather_op(a, w, jr, 32, True)
                                         ** 2), argnums=(0, 1))(
        jnp.asarray(x, jnp.float32), jnp.asarray(packed))
    tx, tpp = _leaves(x, packed.transpose(1, 0, 2))
    (topk_gather_op(tx, tpp, torch.from_numpy(route), 32) ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want[0]),
                               **F32_TOL)
    np.testing.assert_allclose(tpp.grad.numpy(),
                               np.asarray(want[1]).transpose(1, 0, 2),
                               **F32_TOL)
    assert ((tx.grad.numpy() != 0) <= (x != 0)).all()


def test_kwta_hist_op_grad_straight_through():
    rng = np.random.default_rng(15)
    x = rng.normal(size=(4, 256)).astype(np.float32)
    c = rng.normal(size=(4, 256)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(j_kwta_hist_op(a, 16, True) * c))(
        jnp.asarray(x))
    tx, = _leaves(x)
    (kwta_hist_op(tx, 16) * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), **F32_TOL)
    y = kwta_hist_op(torch.from_numpy(x), 16)
    np.testing.assert_array_equal(tx.grad.numpy() != 0, y.numpy() != 0)


def test_ops_keep_the_input_type_and_record_nothing_under_no_grad():
    packed, route = _layer(64, 32, 4, 1, seed=1)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 64))
                         .astype(np.float32)).requires_grad_()
    tp, tr = torch.from_numpy(packed), torch.from_numpy(route)
    with torch.no_grad():
        outs = [packed_matmul_op(x, tp, tr),
                grouped_cs_matmul_op(permute_activations(x, tr),
                                     slot_major_packed(tp)),
                kwta_hist_op(x, 8), topk_gather_op(x, tp.transpose(0, 1)
                                                   .contiguous(), tr, 8)]
    assert all(o.grad_fn is None and not o.requires_grad for o in outs)
    xb = x.detach().to(torch.bfloat16)
    assert packed_matmul_op(xb, tp, tr).dtype == torch.bfloat16
    assert kwta_hist_op(xb, 8).dtype == torch.bfloat16
    assert grouped_cs_matmul_op(permute_activations(xb, tr),
                                slot_major_packed(tp)).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# registry and Select oracle
# ---------------------------------------------------------------------------

def test_registry_sweeps_are_the_references():
    """The reference's sweeps; ``TOPK_GATHER_SWEEP`` adds the MoE and the
    zamba2 serving shapes after them."""
    for name in ("GROUPED_CS_SWEEP", "PACKED_MATMUL_SWEEP",
                 "KWTA_HIST_SWEEP"):
        assert getattr(t_registry, name) == getattr(j_registry, name)
    n_ref = len(j_registry.TOPK_GATHER_SWEEP)
    assert (t_registry.TOPK_GATHER_SWEEP[:n_ref]
            == j_registry.TOPK_GATHER_SWEEP)
    assert t_registry.TOPK_GATHER_SWEEP[n_ref:] == (
        (4, 352, 704, 512, 4, 128), (4, 1024, 2048, 512, 4, 128))


def test_ref_topk_support_matches_jax():
    x = np.random.default_rng(4).normal(size=(3, 64)).astype(np.float32)
    vt, pt, st = TR.ref_topk_support(torch.from_numpy(x), 8)(4)
    vj, pj, sj = JR.ref_topk_support(jnp.asarray(x), 8)(4)
    assert pt.dtype == st.dtype == torch.int32
    np.testing.assert_array_equal(np.sort(pt.numpy() * 4 + st.numpy(), -1),
                                  np.sort(np.asarray(pj) * 4
                                          + np.asarray(sj), -1))
    np.testing.assert_array_equal(np.sort(vt.numpy(), -1),
                                  np.sort(np.asarray(vj), -1))


# ---------------------------------------------------------------------------
# argument validation: the wrappers raise, they do not guess
# ---------------------------------------------------------------------------

def _pm_args():
    return {"x": torch.zeros((2, 64)), "packed": torch.zeros((8, 16, 4)),
            "route": torch.zeros((1, 16, 4), dtype=torch.int8)}


@pytest.mark.parametrize("which,bad,err,match", [
    ("x", torch.zeros((2, 64), dtype=torch.float16), TypeError, "x must"),
    ("x", torch.zeros((64,)), TypeError, r"\(B, D_in\)"),
    ("x", torch.zeros((2, 60)), ValueError, "d_in"),
    ("packed", torch.zeros((8, 16, 4), dtype=torch.float64), TypeError,
     "packed must"),
    ("route", torch.zeros((1, 16, 4)), TypeError, "int8"),
    ("route", torch.zeros((3, 16, 4), dtype=torch.int8), ValueError,
     "G/R, P, N"),
    ("route", torch.zeros((1, 8, 4), dtype=torch.int8), ValueError,
     "G/R, P, N"),
])
def test_packed_matmul_rejects_bad_operands(which, bad, err, match):
    args = _pm_args()
    args[which] = bad
    with pytest.raises(err, match=match):
        packed_matmul(**args)


@pytest.mark.parametrize("xg,packed,err,match", [
    (torch.zeros((4, 2, 8)), torch.zeros((4, 8, 6), dtype=torch.int32),
     TypeError, "packed must"),
    (torch.zeros((2, 8)), torch.zeros((4, 8, 6)), TypeError, "xg must"),
    (torch.zeros((4, 2, 8)), torch.zeros((2, 8, 6)), ValueError, "want"),
    (torch.zeros((4, 2, 8)), torch.zeros((4, 7, 6)), ValueError, "want"),
])
def test_grouped_rejects_bad_operands(xg, packed, err, match):
    with pytest.raises(err, match=match):
        grouped_cs_matmul(xg, packed)


@pytest.mark.parametrize("x,k,err,match", [
    (torch.zeros((2, 3, 8)), 2, ValueError, r"\(B, D\)"),
    (torch.zeros((2, 8), dtype=torch.float16), 2, TypeError, "float32"),
    (torch.zeros((2, 8)), 2.0, TypeError, "int"),
    (torch.zeros((2, 8)), True, TypeError, "int"),
])
def test_kwta_hist_rejects_bad_operands(x, k, err, match):
    with pytest.raises(err, match=match):
        kwta_hist_cuda(x, k)


def test_never_falls_back_off_the_cpu():
    """A tensor neither on the CPU nor on a CUDA device is refused, not
    handed to the plain version; so are operands on two devices."""
    pm = {k: v.to("meta") for k, v in _pm_args().items()}
    with pytest.raises(ValueError, match="CPU or CUDA"):
        packed_matmul(**pm)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        grouped_cs_matmul(torch.zeros((4, 2, 8), device="meta"),
                          torch.zeros((4, 8, 6), device="meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        kwta_hist_cuda(torch.zeros((2, 8), device="meta"), 2)
    mixed = _pm_args()
    mixed["packed"] = mixed["packed"].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        packed_matmul(**mixed)
    with pytest.raises(ValueError, match="several devices"):
        grouped_cs_matmul(torch.zeros((4, 2, 8)),
                          torch.zeros((4, 8, 6), device="meta"))
