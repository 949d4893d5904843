"""The linter's kernel side on the CPU: the two seeded-fault kernels' plain
versions against the reference's Pallas kernels run in interpret mode; the
self-test; the guarded-launch harness (``kernel_checks``) on the clean and
faulty fixtures of the reference's ``tests/test_kernel_rules.py`` that a
dynamic check can see, as plain functions; ``lint_kernels`` over the four
shipped kernels' plain versions; and the kernels as custom ops (one graph
node each, the same eager results, the same gradients).

Of the reference's fixtures a dynamic check cannot see the unguarded
overwrite (deterministic: every launch writes the same bits) and the
unbounded index (every case here declares its indices' range); the
scratch-overflow fixture is a ``launch-resource`` geometry here; and a
single-visit ``+=`` with no init, which the reference's static rule
passes, is a read before a write to a launch.

Tolerances: the seeded gather 1e-6 (float32 sums of 8 products, in
another order); the custom ops bit for bit (the op's CPU body is the plain
version); the gradients 1e-5.  The CUDA kernels run only on the card:
``python3 chip_smoke.py`` (phase 8) runs the same checks there."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl

from repro_torch.analysis import (Case, check_case, kernel_cases,
                                  lint_kernels, self_test, trace)
from repro_torch.analysis import lint as t_lint
from repro_torch.analysis import seeded
from repro_torch.analysis.graph_walk import iter_nodes, op_name
from repro_torch.analysis.kernel_checks import _Guarded
from repro_torch.analysis.rules import check_geometry
from repro_torch.kernels.build import Geometry

SEED = 0


# ---------------------------------------------------------------------------
# The seeded kernels against the reference's Pallas kernels
# ---------------------------------------------------------------------------

def _pallas_oob_gather(vals, pidx, packed):
    """The reference's ``_oob_gather_kernel`` call (``lint.py:772-799``)."""
    b, k = vals.shape
    p, g, n = packed.shape

    def _oob_gather_kernel(vals_ref, pidx_ref, packed_ref, o_ref, *, k_nnz):
        vals, pidx = vals_ref[0], pidx_ref[0]
        bg, nn = packed_ref.shape[1], packed_ref.shape[2]

        def body(j, acc):
            w = packed_ref[pl.ds(pidx[j] + 1, 1), :, :][0]
            return acc + w * vals[j]

        acc = lax.fori_loop(0, k_nnz, body, jnp.zeros((bg, nn), jnp.float32))
        o_ref[0] = acc.reshape(bg * nn)

    return pl.pallas_call(
        functools.partial(_oob_gather_kernel, k_nnz=k),
        grid=(1, b),
        in_specs=[pl.BlockSpec((1, k), lambda ig, ib: (ib, 0)),
                  pl.BlockSpec((1, k), lambda ig, ib: (ib, 0)),
                  pl.BlockSpec((p, g, n), lambda ig, ib: (0, 0, 0))],
        out_specs=pl.BlockSpec((1, g * n), lambda ig, ib: (ib, 0)),
        out_shape=jax.ShapeDtypeStruct((b, g * n), jnp.float32),
        interpret=True)(vals, pidx, packed)


def _pallas_missing_init(xg, packed):
    """The reference's ``_missing_init_kernel`` call (``lint.py:812-829``)."""
    def _missing_init_kernel(x_ref, w_ref, o_ref):
        o_ref[0] += jnp.dot(x_ref[0], w_ref[0],
                            preferred_element_type=jnp.float32)

    return pl.pallas_call(
        _missing_init_kernel,
        grid=(2, 1, 1, 2),
        in_specs=[
            pl.BlockSpec((1, 8, 8), lambda s, ib, ig, ik: (s, ib, ik)),
            pl.BlockSpec((1, 8, 8), lambda s, ib, ig, ik: (s, ik, ig)),
        ],
        out_specs=pl.BlockSpec((1, 8, 8), lambda s, ib, ig, ik: (s, ib, ig)),
        out_shape=jax.ShapeDtypeStruct((2, 8, 8), jnp.float32),
        interpret=True)(xg, packed)


def _oob_inputs(rng, top):
    b, k, p, g, n = (seeded.OOB_SHAPE[x] for x in "bkpgn")
    vals = rng.standard_normal((b, k)).astype(np.float32)
    pidx = rng.integers(0, top + 1, (b, k)).astype(np.int32)
    pidx[0, 0], pidx[-1, -1] = 0, top
    return vals, pidx, rng.standard_normal((p, g, n)).astype(np.float32)


def test_oob_gather_plain_matches_the_pallas_kernel_on_in_range_indices():
    vals, pidx, packed = _oob_inputs(np.random.default_rng(SEED),
                                     seeded.OOB_SHAPE["p"] - 2)
    want = np.asarray(_pallas_oob_gather(vals, pidx, packed))
    got = seeded.oob_gather(*map(torch.from_numpy, (vals, pidx, packed)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    # numpy's sum of the rows one past each index, as the fault reads them
    rows = packed.reshape(packed.shape[0], -1)
    ref = np.einsum("bk,bke->be", vals, rows[pidx + 1])
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-6)


def test_oob_gather_past_the_end_clamps_in_pallas_and_raises_here():
    """P - 1 reads past packed: the Pallas kernel in interpret mode clamps
    the read to row P - 1; the plain version's bounds check raises (and on
    the card the kernel reads what lies there: the guard bands)."""
    vals, pidx, packed = _oob_inputs(np.random.default_rng(SEED + 1),
                                     seeded.OOB_SHAPE["p"] - 1)
    rows = packed.reshape(packed.shape[0], -1)
    clamped = np.einsum("bk,bke->be", vals,
                        rows[np.minimum(pidx + 1, len(rows) - 1)])
    np.testing.assert_allclose(np.asarray(_pallas_oob_gather(vals, pidx,
                                                             packed)),
                               clamped, atol=1e-6, rtol=1e-6)
    with pytest.raises(IndexError):
        seeded.oob_gather_plain(*map(torch.from_numpy, (vals, pidx, packed)))


def test_missing_init_plain_is_nan_where_the_pallas_kernel_is():
    rng = np.random.default_rng(SEED + 2)
    s, m, k, c, bk = (seeded.MISSING_SHAPE[x] for x in
                      ("s", "m", "k", "c", "bk"))
    xg = rng.standard_normal((s, m, k)).astype(np.float32)
    w = rng.standard_normal((s, k, c)).astype(np.float32)
    want = np.isnan(np.asarray(_pallas_missing_init(xg, w)))
    out = torch.full((s, m, c), float("nan"))
    seeded.missing_init_plain(out, torch.from_numpy(xg), torch.from_numpy(w),
                              bk)
    assert want.all()
    np.testing.assert_array_equal(torch.isnan(out).numpy(), want)
    # on a zeroed output it is the grouped product
    zero = seeded.missing_init_plain(torch.zeros(s, m, c),
                                     torch.from_numpy(xg), torch.from_numpy(w))
    np.testing.assert_allclose(zero.numpy(), np.einsum("smk,skc->smc", xg, w),
                               atol=1e-5, rtol=1e-5)


def test_self_test_on_the_cpu_catches_every_seeded_fault():
    assert self_test("cpu") == []


# ---------------------------------------------------------------------------
# The harness on the reference's fixtures (tests/test_kernel_rules.py)
# ---------------------------------------------------------------------------

def _findings(kernel, inputs, outputs):
    case = Case(kernel.__name__, kernel.__name__, kernel,
                [torch.as_tensor(t) for t in inputs], outputs)
    return check_case(case, "test")


def _gather(off):
    """The reference's ``_gather_kernel(off)``, as a plain function."""
    def kern(outs, vals, pidx, packed):
        rows = packed.reshape(packed.shape[0], -1)[pidx.long() + off]
        outs[0].copy_(torch.einsum("bk,bke->be", vals, rows))
    kern.__name__ = f"_gather_off{off}_kernel"
    return kern


def _gather_operands(top=15):
    rng = np.random.default_rng(SEED)
    pidx = rng.integers(0, top + 1, (2, 8)).astype(np.int32)
    pidx[-1, -1] = top
    return ([rng.standard_normal((2, 8)).astype(np.float32), pidx,
             rng.standard_normal((16, 4, 4)).astype(np.float32)],
            [((2, 16), torch.float32)])


def test_gather_in_bounds_is_clean():
    ins, outs = _gather_operands()
    assert _findings(_gather(0), ins, outs) == []


def test_off_by_one_gather_names_kernel_and_ref():
    ins, outs = _gather_operands()
    fs = [f for f in _findings(_gather(1), ins, outs)
          if f.rule == "oob-access"]
    assert fs and "_gather_off1_kernel" in fs[0].message
    assert "in[2]" in fs[0].message


def _rows(off):
    """The reference's fori_loop induction fixtures: rows j (+ off) of
    x (8, 4) summed."""
    def kern(outs, x):
        outs[0].copy_(x[torch.arange(8) + off].sum(0))
    kern.__name__ = f"_rows_off{off}_kernel"
    return kern


def test_loop_induction_bounds():
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    assert _findings(_rows(0), [x], [((4,), torch.float32)]) == []
    fs = _findings(_rows(1), [x], [((4,), torch.float32)])
    assert any(f.rule == "oob-access" and "in[0]" in f.message for f in fs)


def _accumulate(init: bool, steps: int = 2, overwrite: bool = False):
    """The reference's grouped accumulation fixtures over K steps."""
    def kern(outs, x, w):
        if init:
            outs[0].zero_()
        for k0 in range(0, x.shape[2], x.shape[2] // steps):
            blk = slice(k0, k0 + x.shape[2] // steps)
            prod = torch.bmm(x[:, :, blk], w[:, blk, :])
            if overwrite:
                outs[0].copy_(prod)
            else:
                outs[0].add_(prod)
    kern.__name__ = "_accum_kernel"
    return kern


def _accum_operands():
    rng = np.random.default_rng(SEED + 3)
    return ([rng.standard_normal((2, 8, 16)).astype(np.float32),
             rng.standard_normal((2, 16, 8)).astype(np.float32)],
            [((2, 8, 8), torch.float32)])


def test_grid_race_init_then_accumulate_is_clean():
    ins, outs = _accum_operands()
    assert _findings(_accumulate(init=True), ins, outs) == []


def test_grid_race_missing_init_is_flagged():
    ins, outs = _accum_operands()
    fs = [f for f in _findings(_accumulate(init=False), ins, outs)
          if f.rule == "grid-race"]
    assert fs and "out[2]" in fs[0].message
    assert "read before written" in fs[0].message


def test_grid_race_single_visit_without_init_is_a_read_too():
    """The reference's static rule checks only revisited blocks, so one K
    step with ``+=`` and no init passes there; it still reads what the
    buffer held, and a launch shows it."""
    ins, outs = _accum_operands()
    fs = _findings(_accumulate(init=False, steps=1), ins, outs)
    assert [f.rule for f in fs] == ["grid-race"]


def test_grid_race_unguarded_overwrite_is_not_visible():
    """Last writer wins, deterministically: every launch writes the same
    bits, so a dynamic check cannot see the reference's
    ``unguarded-overwrite`` (listed in ``kernel_checks``' limits)."""
    ins, outs = _accum_operands()
    assert _findings(_accumulate(init=False, overwrite=True), ins,
                     outs) == []


def _pad(masked: bool, rows: int):
    """The reference's padded-block fixtures: blocks of 4 rows over x
    (rows, 8); the last block past the end unless masked."""
    def kern(outs, x):
        blocks = -(-rows // 4)
        r = torch.arange(blocks * 4)
        if masked:
            r = r.clamp(max=rows - 1)
        y = x[r] * 2.0
        outs[0].copy_(y[:rows])
    kern.__name__ = "_pad_kernel"
    return kern


def test_unmasked_pad_reads_outside_the_operand():
    x = np.ones((6, 8), np.float32)
    fs = _findings(_pad(False, 6), [x], [((6, 8), torch.float32)])
    assert fs and fs[0].rule == "oob-access" and "in[0]" in fs[0].message
    assert _findings(_pad(True, 6), [x], [((6, 8), torch.float32)]) == []
    x8 = np.ones((8, 8), np.float32)
    assert _findings(_pad(False, 8), [x8], [((8, 8), torch.float32)]) == []


def test_scratch_overflow_is_a_launch_resource_finding():
    over = check_geometry("k", Geometry((1, 1, 1), 256, 1, 16 << 20))
    assert over and over[0].rule == "launch-resource"
    assert "dynamic shared memory" in over[0].message
    assert check_geometry("k", Geometry((1, 1, 1), 256, 1, 64 << 10)) == []


def test_a_stray_read_past_a_float_input_shows_through_its_nan_guards():
    """What the card's launches see: a read one past x that no bounds
    check stops (a strided view over the guard band) adds 0 in the clean
    launch and NaN once x's guards are poisoned; w's guards stay clean."""
    def kern(outs, x, w):
        past = torch.as_strided(x, (x.numel() + 1,), (1,))
        outs[0].copy_(w * past.sum())
    kern.__name__ = "_read_past_kernel"
    fs = _findings(kern, [np.ones(8, np.float32), np.ones(4, np.float32)],
                   [((4,), torch.float32)])
    assert [f.rule for f in fs] == ["oob-access"]
    assert "in[0]" in fs[0].message and "non-finite" in fs[0].message


def test_a_write_past_the_output_breaks_its_canary():
    def kern(outs, x):
        outs[0].copy_(x)
        torch.as_strided(outs[0], (x.numel() + 1,), (1,))[-1] = 0.0
    kern.__name__ = "_write_past_kernel"
    fs = _findings(kern, [np.ones(8, np.float32)], [((8,), torch.float32)])
    assert [f.rule for f in fs] == ["oob-access"]
    assert "writes outside out[1]" in fs[0].message


def test_guard_bands_keep_alignment_and_see_stray_writes():
    g = _Guarded((3, 5), torch.bfloat16, "cpu")
    assert (g.view.data_ptr() - g.buf.data_ptr()) % 256 == 0
    g.fill_canary()
    assert g.canary_intact()
    g.buf[g.band + g.n] = 1.0                 # one past the operand
    assert not g.canary_intact()


# ---------------------------------------------------------------------------
# lint_kernels over the shipped kernels' plain versions
# ---------------------------------------------------------------------------

def test_lint_kernels_on_the_cpu_is_clean_and_covers_every_kernel():
    report = lint_kernels("cpu")
    assert report.ok, report.render()
    cases = kernel_cases("cpu")
    assert len(report.entries) == len(cases)
    assert {c.kernel for c in cases} == {"topk_gather", "packed_matmul",
                                         "grouped_cs_matmul", "kwta_hist"}
    # every index operand spans its declared range, both ends included
    for case in cases:
        for t in case.inputs:
            if not t.dtype.is_floating_point:
                assert int(t.min()) == 0 and int(t.max()) > 0, case.label


# ---------------------------------------------------------------------------
# The kernels as custom ops
# ---------------------------------------------------------------------------

def test_full_width_decode_step_holds_one_node_a_layer():
    """make_fx of the shipped smollm-360m decode step (full width, fake
    tensors) shows exactly one ``repro_torch::topk_gather`` node a layer
    and no other kernel.  Traced on fake CPU tensors: a CPU-only build of
    torch refuses ``Tensor.__getitem__`` on fake CUDA tensors (its device
    guard needs the CUDA library); ``chip_smoke.py`` phase 8 counts the
    same nodes on fake CUDA tensors on the card."""
    cfg = t_lint.resolve_config("smollm-360m")
    fn, args = t_lint.entry_args(cfg, "decode", "cpu")
    names = [op_name(n) for n, _ in iter_nodes(trace(fn, *args))]
    assert names.count("repro_torch.topk_gather") == cfg.n_layers == 32
    assert not [n for n in names if n.startswith("repro_torch.")
                and n != "repro_torch.topk_gather"]


def test_custom_ops_give_the_plain_versions_bit_for_bit():
    """The eager CPU results through the custom ops are the plain
    versions' (what the wrappers returned before the ops existed)."""
    from repro_torch.kernels import (grouped_cs_matmul,
                                     grouped_cs_matmul_plain, kwta_hist_cuda,
                                     kwta_hist_cuda_plain, packed_matmul,
                                     packed_matmul_plain, topk_gather,
                                     topk_gather_plain)
    plain = {"topk_gather": lambda *a: topk_gather_plain(
        *a[:5], out_dtype=a[0].dtype),
        "packed_matmul": packed_matmul_plain,
        "grouped_cs_matmul": grouped_cs_matmul_plain}
    op = {"topk_gather": lambda *a: topk_gather(*a, out_dtype=a[0].dtype),
          "packed_matmul": packed_matmul,
          "grouped_cs_matmul": grouped_cs_matmul}
    for case in kernel_cases("cpu", serving=False):
        if case.kernel == "kwta_hist":
            k = int(case.label.split("K=")[1].split(",")[0])
            got = kwta_hist_cuda(case.inputs[0], k)
            want = kwta_hist_cuda_plain(case.inputs[0], k)
        else:
            got = op[case.kernel](*case.inputs)
            want = plain[case.kernel](*case.inputs)
        assert got.dtype == want.dtype and torch.equal(got, want), case.label
    assert {"topk_gather", "packed_matmul", "grouped_cs_matmul",
            "kwta_hist"} <= set(dir(torch.ops.repro_torch))


def test_op_gradients_through_the_custom_ops_equal_autograd_on_the_plain():
    from repro_torch.kernels import (kwta_hist_op, packed_matmul_op,
                                     topk_gather_support_op)
    from repro_torch.kernels.packed_matmul import packed_matmul_plain
    from repro_torch.kernels.topk_gather import topk_gather_plain
    gen = torch.Generator().manual_seed(SEED)
    case = t_lint.topk_gather_case(3, 8, 16, 6, 4, torch.float32,
                                   torch.int32, "cpu")
    vals, p_idx, s_off, packed_p, route = case.inputs
    c = torch.randn(3, 24, generator=gen)

    def grads(f, *leaves):
        leaves = [t.clone().requires_grad_(True) for t in leaves]
        (f(*leaves) * c).sum().backward()
        return [t.grad for t in leaves]

    got = grads(lambda v, w: topk_gather_support_op(v, p_idx, s_off, w,
                                                    route), vals, packed_p)
    want = grads(lambda v, w: topk_gather_plain(v, p_idx, s_off, w, route),
                 vals, packed_p)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    x = torch.randn(5, 32, generator=gen)
    packed = torch.randn(6, 8, 4, generator=gen)
    route = case.inputs[4][:, :8]
    c = torch.randn(5, 24, generator=gen)
    got = grads(lambda a, b: packed_matmul_op(a, b, route), x, packed)
    want = grads(lambda a, b: packed_matmul_plain(a, b, route), x, packed)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    h = torch.randn(4, 64, generator=gen)
    c = torch.randn(4, 64, generator=gen)
    (g,) = grads(lambda a: kwta_hist_op(a, 8), h)
    kept = kwta_hist_op(h, 8) != 0
    torch.testing.assert_close(g, c * kept)
