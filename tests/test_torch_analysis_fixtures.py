"""The reference verifier's fixture kernels, ported (``repro_torch.analysis.
fixtures``): each plain version against the reference's Pallas fixture
(``tests/test_kernel_rules.py``, and ``tests/test_analysis.py``'s
whole-array copy) run in interpret mode on the same numpy inputs, and
every case through the guarded harness with the findings the module lists.

Where a fixture reads outside its operand, interpret mode clamps the read
(the row past the end becomes the last row) and the plain version's bounds
check raises: that is the finding.  Where it accumulates into an output it
never initialised, interpret mode returns NaN and the plain version, given
a NaN output, does too.  Tolerances: the sums 1e-6 (float32, another
order); the copies and the doubling exact.  The CUDA kernels run only on
the card: ``python3 chip_smoke.py`` (phase 8) checks them there."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl

from repro_torch.analysis import check_case, fixtures
from repro_torch.analysis.rules import check_geometry

SEED = 0


def _np(device="cpu"):
    return {k: tuple(t.numpy() for t in v)
            for k, v in fixtures.operands(device, SEED).items()}


# ---------------------------------------------------------------------------
# the reference's Pallas fixtures, in interpret mode
# ---------------------------------------------------------------------------

def _pallas_gather(off, vals, pidx, packed):
    """``_gather_call(_gather_kernel(off), ...)`` (test_kernel_rules.py
    :70-:95)."""
    b, k = vals.shape
    p, g, n = packed.shape

    def kern(vals_ref, pidx_ref, packed_ref, o_ref, *, k_nnz):
        v, ix = vals_ref[0], pidx_ref[0]
        bg, nn = packed_ref.shape[1], packed_ref.shape[2]

        def body(j, acc):
            w = packed_ref[pl.ds(ix[j] + off, 1), :, :][0]
            return acc + w * v[j]

        acc = lax.fori_loop(0, k_nnz, body, jnp.zeros((bg, nn), jnp.float32))
        o_ref[0] = acc.reshape(bg * nn)

    return pl.pallas_call(
        functools.partial(kern, k_nnz=k), grid=(1, b),
        in_specs=[pl.BlockSpec((1, k), lambda ig, ib: (ib, 0)),
                  pl.BlockSpec((1, k), lambda ig, ib: (ib, 0)),
                  pl.BlockSpec((p, g, n), lambda ig, ib: (0, 0, 0))],
        out_specs=pl.BlockSpec((1, g * n), lambda ig, ib: (ib, 0)),
        out_shape=jax.ShapeDtypeStruct((b, g * n), jnp.float32),
        interpret=True)(vals, pidx, packed)


def _pallas_induction(off, x):
    """The fori_loop fixtures ok / bad (:134-:153)."""
    def kern(x_ref, o_ref):
        def body(j, acc):
            return acc + x_ref[pl.ds(j + off, 1), :][0]
        o_ref[...] = lax.fori_loop(0, 8, body, jnp.zeros((4,), jnp.float32))

    return pl.pallas_call(
        kern, grid=(1,), in_specs=[pl.BlockSpec((8, 4), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((4,), lambda i: (0,)),
        out_shape=jax.ShapeDtypeStruct((4,), jnp.float32),
        interpret=True)(x)


def _pallas_accum(mode, nk, x, w):
    """``_accum_call`` (:163-:175) with the kernels at :179 (init), :191
    and :214 (add: no init; nk=1 single visit) and :202 (overwrite)."""
    def kern(x_ref, w_ref, o_ref):
        if mode == "init":
            @pl.when(pl.program_id(3) == 0)
            def _init():
                o_ref[...] = jnp.zeros_like(o_ref)
        prod = jnp.dot(x_ref[0], w_ref[0],
                       preferred_element_type=jnp.float32)
        if mode == "overwrite":
            o_ref[0] = prod
        else:
            o_ref[0] += prod

    return pl.pallas_call(
        kern, grid=(2, 1, 1, nk),
        in_specs=[pl.BlockSpec((1, 8, 8), lambda s, ib, ig, ik: (s, ib, ik)),
                  pl.BlockSpec((1, 8, 8), lambda s, ib, ig, ik: (s, ik, ig))],
        out_specs=pl.BlockSpec((1, 8, 8), lambda s, ib, ig, ik: (s, ib, ig)),
        out_shape=jax.ShapeDtypeStruct((2, 8, 8), jnp.float32),
        interpret=True)(x, w)


def _pallas_pad(masked, x):
    """``_pad_call`` (:226-:236) with the kernels at :238 / :257
    (unmasked) and :247 (masked)."""
    rows = x.shape[0]

    def kern(x_ref, o_ref):
        if masked:
            i = pl.program_id(0)
            r = lax.broadcasted_iota(jnp.int32, (4, 8), 0) + i * 4
            o_ref[...] = jnp.where(r < rows, x_ref[...] * 2.0, 0.0)
        else:
            o_ref[...] = x_ref[...] * 2.0

    return pl.pallas_call(
        kern, grid=(-(-rows // 4),),
        in_specs=[pl.BlockSpec((4, 8), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((4, 8), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((rows, 8), jnp.float32),
        interpret=True)(x)


def _pallas_whole_copy(x):
    """``big``: ``_copy_kernel`` over the whole array as one block
    (tests/test_analysis.py:171-:183)."""
    def _copy_kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...]

    return pl.pallas_call(
        _copy_kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True)(x)


def _pallas_scratch_copy(scratch_shape, x):
    """``_scratch_call`` (:268-:283): an 8x8 copy that reserves a VMEM
    scratch of ``scratch_shape`` f32."""
    from jax.experimental.pallas import tpu as pltpu

    def kern(x_ref, o_ref, s_ref):
        o_ref[...] = x_ref[...]

    return pl.pallas_call(
        kern, grid=(1,), in_specs=[pl.BlockSpec((8, 8), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((8, 8), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((8, 8), jnp.float32),
        scratch_shapes=[pltpu.VMEM(scratch_shape, jnp.float32)],
        interpret=True)(x)


# ---------------------------------------------------------------------------
# plain versions against the Pallas fixtures
# ---------------------------------------------------------------------------

def test_gather_plain_matches_the_pallas_fixture():
    vals, pidx, packed = _np()["gather"]
    got = fixtures.gather(*map(torch.from_numpy, (vals, pidx, packed)), 0)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(_pallas_gather(0, vals, pidx,
                                                         packed)),
                               atol=1e-6, rtol=1e-6)
    assert fixtures.gather.launches == 0        # CPU: the plain version
    # off=1 at pidx = P - 1: interpret mode clamps the read to the last
    # partition; the plain version's bounds check raises
    rows = packed.reshape(packed.shape[0], -1)
    clamped = np.einsum("bk,bke->be", vals,
                        rows[np.minimum(pidx + 1, len(rows) - 1)])
    np.testing.assert_allclose(np.asarray(_pallas_gather(1, vals, pidx,
                                                         packed)),
                               clamped, atol=1e-6, rtol=1e-6)
    with pytest.raises(IndexError):
        fixtures.gather_plain(*map(torch.from_numpy, (vals, pidx, packed)),
                              1)


def test_induction_plain_matches_the_pallas_fixture():
    (x,) = _np()["induction"]
    np.testing.assert_allclose(
        fixtures.induction(torch.from_numpy(x), 0).numpy(),
        np.asarray(_pallas_induction(0, x)), atol=1e-6, rtol=1e-6)
    clamped = x[np.minimum(np.arange(8) + 1, 7)].sum(0)
    np.testing.assert_allclose(np.asarray(_pallas_induction(1, x)), clamped,
                               atol=1e-6, rtol=1e-6)
    with pytest.raises(IndexError):
        fixtures.induction_plain(torch.from_numpy(x), 1)


@pytest.mark.parametrize("mode,nk", [("init", 2), ("add", 2), ("add", 1),
                                     ("overwrite", 2)])
def test_accum_plain_matches_the_pallas_fixture(mode, nk):
    x, w = _np()["accum"]
    want = np.asarray(_pallas_accum(mode, nk, x, w))
    # the kernel reads what the output held: NaN here, as interpret mode's
    # uninitialised output
    got = fixtures.accum_plain(torch.full((2, 8, 8), float("nan")),
                               torch.from_numpy(x), torch.from_numpy(w),
                               mode, nk).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if mode == "add":
        assert np.isnan(want).all()
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
        last = slice((nk - 1) * 8, nk * 8)
        ref = (np.einsum("smk,skc->smc", x[:, :, :8 * nk], w[:, :8 * nk])
               if mode == "init" else
               np.einsum("smk,skc->smc", x[:, :, last], w[:, last]))
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("rows,masked", [(6, True), (8, False), (6, False)])
def test_pad_plain_matches_the_pallas_fixture(rows, masked):
    (x,) = _np()[f"pad{rows}"]
    want = np.asarray(_pallas_pad(masked, x))
    np.testing.assert_array_equal(want, x * 2.0)
    if rows % fixtures.PAD_BLOCK and not masked:
        # the ragged block reads past x: the bounds check raises
        with pytest.raises(IndexError):
            fixtures.pad_plain(torch.from_numpy(x), masked)
    else:
        np.testing.assert_array_equal(
            fixtures.pad(torch.from_numpy(x), masked).numpy(), want)


def test_copy_plain_matches_the_pallas_copies():
    x = np.random.default_rng(SEED).standard_normal(
        fixtures.WHOLE_ARRAY).astype(np.float32)
    np.testing.assert_array_equal(
        fixtures.copy_scratch_plain(torch.from_numpy(x)).numpy(),
        np.asarray(_pallas_whole_copy(x)))
    (small,) = _np()["copy"]
    within = fixtures.SCRATCH_SHAPES["within"]
    np.testing.assert_array_equal(
        fixtures.copy_scratch(torch.from_numpy(small),
                              int(np.prod(within))).numpy(),
        np.asarray(_pallas_scratch_copy(within, small)))
    with pytest.raises(ValueError, match="cannot stage"):
        fixtures.copy_scratch(torch.from_numpy(small), 8)


# ---------------------------------------------------------------------------
# the harness's findings on every case
# ---------------------------------------------------------------------------

_CASES = fixtures.fixture_cases("cpu")


def _refs(findings):
    return tuple((f.rule, re.search(r"(in|out)\[\d+\]", f.message).group(0))
                 for f in findings)


@pytest.mark.parametrize("index", range(len(_CASES)),
                         ids=[c.label for c, _ in _CASES])
def test_fixture_case_gives_its_findings(index):
    case, expect = fixtures.fixture_cases("cpu")[index]
    findings = check_case(case, "fixtures")
    assert _refs(findings) == expect, [f.message for f in findings]
    for f in findings:
        assert f.primitive == case.kernel
        assert f"kernel {case.kernel}" in f.message


def test_card_expectations_differ_only_for_the_unmasked_ragged_pad():
    """On the card the unmasked pad also writes past its output (the CPU's
    bounds check stops it at the read)."""
    cpu = {c.label: e for c, e in fixtures.fixture_cases("cpu")}
    card = {c.label: e for c, e in fixtures.fixture_cases("meta")}
    assert set(cpu) == set(card)
    differ = {k for k in cpu if cpu[k] != card[k]}
    assert differ == {"pad rows=6 unmasked"}
    assert card["pad rows=6 unmasked"] == (("oob-access", "in[0]"),
                                           ("oob-access", "out[1]"))


def test_every_family_has_a_case_and_a_counted_launcher():
    assert {c.kernel for c, _ in _CASES} == set(fixtures.FAMILIES)
    for fn in fixtures.FAMILIES.values():
        assert fn.launches == 0


def test_resource_cases_are_findings_from_the_geometry():
    cases = fixtures.resource_cases()
    assert len(cases) == 3
    for label, (geo, over) in cases.items():
        found = check_geometry("copy_scratch", geo)
        assert bool(found) == over, label
        if over:
            assert found[0].rule == "launch-resource"
            assert geo.smem == 16 << 20
    assert cases["scratch (128, 128) f32"][0].smem == 64 << 10
