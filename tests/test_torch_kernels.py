"""The topk_gather kernel's plain version (what the wrapper runs for CPU
tensors) against the JAX kernel run in interpret mode and against the
reference oracle, over the reference's shape sweep and route-shared
layouts; and the wrapper's argument checks.

Tolerance: atol=1e-5 — every version accumulates in float32 and they
differ only in the order of the sums.  The CUDA kernel itself runs only on
the card: ``python3 chip_smoke.py`` holds it against this plain version
there."""

import importlib
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CSLayout, make_routes
from repro.kernels import (to_partition_major, topk_gather_matmul,
                           topk_gather_support_op as j_support_op)
from repro.kernels import topk_support as j_topk_support
from repro.kernels.ref import ref_topk_gather as j_ref_topk_gather
from repro.kernels.registry import TOPK_GATHER_SWEEP
from repro_torch.kernels import (ref_topk_gather, topk_gather,
                                 topk_gather_plain, topk_gather_support_op,
                                 topk_support)

ATOL = 1e-5

# the module, which the package's function of the same name shadows
topk_module = importlib.import_module("repro_torch.kernels.topk_gather")


def _operands(b, k, p, g, n, r, seed=0):
    """vals/p_idx/s_off (B, K) and packed (G, P, N), route (G/R, P, N):
    support drawn without repeats, so each row is a genuine k-sparse
    activation."""
    rng = np.random.default_rng(seed)
    flat = np.stack([rng.choice(p * n, size=k, replace=False)
                     for _ in range(b)])
    vals = rng.normal(size=(b, k)).astype(np.float32)
    packed = rng.normal(size=(g, p, n)).astype(np.float32)
    route = make_routes(CSLayout(p * n, n * (g // r), n), seed)
    return (vals, (flat // n).astype(np.int32), (flat % n).astype(np.int32),
            packed, route)


def _torch(vals, p_idx, s_off, packed, route):
    packed_p = np.ascontiguousarray(packed.transpose(1, 0, 2))
    return tuple(torch.from_numpy(np.array(a))
                 for a in (vals, p_idx, s_off, packed_p, route))


# the reference's sweep (b, k, p, g, n, block_g), each with every group
# holding its own route (R=1), two groups sharing one (R=2) and all
# groups sharing one (R=G)
CASES = [(b, k, p, g, n, bg, r) for (b, k, p, g, n, bg) in TOPK_GATHER_SWEEP
         for r in (1, 2, g)]


@pytest.mark.parametrize("b,k,p,g,n,block_g,r", CASES)
def test_plain_matches_jax_kernel_and_oracle(b, k, p, g, n, block_g, r):
    vals, p_idx, s_off, packed, route = _operands(b, k, p, g, n, r,
                                                  seed=b * k + r)
    pr, rr = to_partition_major(jnp.asarray(packed), jnp.asarray(route))
    y_jax = np.asarray(topk_gather_matmul(
        jnp.asarray(vals), jnp.asarray(p_idx), jnp.asarray(s_off), pr, rr,
        block_g=block_g, interpret=True))
    y_ref = np.asarray(j_ref_topk_gather(jnp.asarray(vals),
                                         jnp.asarray(p_idx),
                                         jnp.asarray(s_off), pr, rr))
    ops = _torch(vals, p_idx, s_off, packed, route)
    y_plain = topk_gather_plain(*ops).numpy()
    np.testing.assert_allclose(y_plain, y_jax, atol=ATOL)
    np.testing.assert_allclose(y_plain, y_ref, atol=ATOL)
    # the wrapper on CPU tensors is the plain version, and launches nothing
    before = topk_gather.launches
    np.testing.assert_array_equal(topk_gather(*ops).numpy(), y_plain)
    assert topk_gather.launches == before
    assert ref_topk_gather is topk_gather_plain


@pytest.mark.parametrize("b,k,p,g,n,block_g,r",
                         [c for c in CASES if c[-1] in (1, c[3])])
def test_plain_takes_bf16_values_and_int64_indices(b, k, p, g, n, block_g, r):
    """The support as the serving path holds it (bf16 values, int64
    indices) gives the JAX kernel's output on the same values; a bf16
    output is the float32 one rounded once."""
    vals, p_idx, s_off, packed, route = _operands(b, k, p, g, n, r,
                                                  seed=b * k + r + 1)
    vals = np.asarray(jnp.asarray(vals).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    pr, rr = to_partition_major(jnp.asarray(packed), jnp.asarray(route))
    y_jax = np.asarray(topk_gather_matmul(
        jnp.asarray(vals), jnp.asarray(p_idx), jnp.asarray(s_off), pr, rr,
        block_g=block_g, interpret=True))
    tv, tp, ts, tpp, tr = _torch(vals, p_idx, s_off, packed, route)
    tv, tp, ts = tv.to(torch.bfloat16), tp.long(), ts.long()
    y = topk_gather_plain(tv, tp, ts, tpp, tr)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), y_jax, atol=ATOL)
    yb = topk_gather(tv, tp, ts, tpp, tr, out_dtype=torch.bfloat16)
    assert yb.dtype == torch.bfloat16
    assert torch.equal(yb, y.to(torch.bfloat16))


# (B, K, G, N, element size) -> (cluster, lanes)
LAUNCH_RULE_CASES = [
    (4, 320, 240, 4, 2, 8, 32),   # main shape: 4 strips x 4 rows x 8 = 128
    (1, 320, 240, 4, 2, 8, 32),   # decode batch 1: the cluster at its limit
    (2, 320, 240, 4, 2, 8, 32),
    (3, 320, 240, 4, 2, 8, 32),
    (7, 320, 240, 4, 2, 8, 32),   # 28 x 8 = 224 blocks
    (16, 320, 240, 4, 2, 2, 32),  # 64 x 2 = 128
    (32, 320, 240, 4, 2, 1, 32),  # 128 blocks without a cluster
    (4, 320, 240, 4, 4, 4, 32),   # f32 rows: 8 strips
    (4, 320, 240, 8, 2, 4, 32),   # N=8: 8 strips
    (4, 16, 8, 4, 4, 8, 8),       # sweep: a row of 8 vectors, one strip
    (2, 8, 4, 4, 4, 8, 4),        # a row of 4 vectors; 8 entries, 8 ranks
    (4, 3, 240, 4, 2, 2, 32),     # no more ranks than entries
    (4, 1, 240, 4, 2, 1, 32),
    (2, 8, 250, 1, 2, 8, 32),     # a row of 500 B: 32 vectors, the last part
    (1, 4, 1, 1, 2, 4, 1),        # a row of 2 B
]


@pytest.mark.parametrize("b,k,g,n,size,cluster,lanes", LAUNCH_RULE_CASES)
def test_launch_rule(b, k, g, n, size, cluster, lanes):
    assert topk_module.launch_rule(b, k, g, n, size) == (cluster, lanes)


def test_launch_rule_fills_the_card_with_the_least_cluster():
    """Over decode and prefill shapes: a strip covers the row or is one
    warp's 512 B; the cluster is a power of two of at most 8 blocks and at
    most K; it stops growing once the grid has 128 blocks."""
    for b, k, g, n, size in itertools.product(
            (1, 2, 3, 4, 7, 8, 64, 1000), (1, 2, 5, 40, 320, 2560),
            (1, 3, 8, 240, 250, 640), (1, 2, 4, 8, 16), (2, 4)):
        cluster, lanes = topk_module.launch_rule(b, k, g, n, size)
        row_vecs = -(-g * n * size // 16)
        assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32
        assert lanes == 32 or lanes >= row_vecs > lanes // 2
        assert cluster in (1, 2, 4, 8) and cluster <= k
        blocks = b * -(-row_vecs // lanes) * cluster
        assert (blocks >= topk_module.TARGET_BLOCKS or cluster == 8
                or 2 * cluster > k)
        assert cluster == 1 or blocks // 2 < topk_module.TARGET_BLOCKS


def _at_offset(t, elems):
    """A contiguous copy of ``t`` whose base lies ``elems`` elements past
    the start of its storage."""
    flat = torch.zeros(t.numel() + elems, dtype=t.dtype)
    out = flat[elems:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("p,g,n,dtype,offset,aligned", [
    (640, 240, 4, torch.bfloat16, 0, True),   # rows of 1920 B
    (8, 250, 1, torch.bfloat16, 0, False),    # rows of 500 B
    (8, 2, 4, torch.float32, 0, True),        # rows of 32 B
    (8, 3, 1, torch.float32, 0, False),       # rows of 12 B
    (8, 8, 4, torch.bfloat16, 1, False),      # base 2 B past 16
    (8, 8, 4, torch.bfloat16, 8, True),       # base 16 B past
])
def test_async_staging_needs_16_byte_rows_and_base(p, g, n, dtype, offset,
                                                   aligned):
    packed_p = _at_offset(torch.zeros((p, g, n), dtype=dtype), offset)
    assert packed_p.is_contiguous()
    assert topk_module.async_staging(packed_p) is aligned


@pytest.mark.parametrize("lead", [(4,), (4, 1), (2, 3)])
def test_support_op_matches_jax(lead):
    b, k, p, g, n, r = int(np.prod(lead)), 8, 16, 8, 4, 8
    vals, p_idx, s_off, packed, route = _operands(b, k, p, g, n, r, seed=3)
    shape = lead + (k,)
    y_jax = np.asarray(j_support_op(
        jnp.asarray(vals.reshape(shape)), jnp.asarray(p_idx.reshape(shape)),
        jnp.asarray(s_off.reshape(shape)), jnp.asarray(packed),
        jnp.asarray(route), True))
    ops = _torch(vals.reshape(shape), p_idx.reshape(shape),
                 s_off.reshape(shape), packed, route)
    y = topk_gather_support_op(ops[0], ops[1].long(), ops[2].long(), ops[3],
                               ops[4])
    assert tuple(y.shape) == lead + (g * n,) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), y_jax, atol=ATOL)
    yb = topk_gather_support_op(ops[0].to(torch.bfloat16), ops[1], ops[2],
                                ops[3].to(torch.bfloat16), ops[4])
    assert yb.dtype == torch.bfloat16


def test_topk_support_matches_jax():
    x = np.random.default_rng(4).normal(size=(3, 64)).astype(np.float32)
    x[np.abs(x) < 1.0] = 0.0
    vt, pt, st = topk_support(torch.from_numpy(x), 8, 4)
    vj, pj, sj = j_topk_support(jnp.asarray(x), 8, 4)
    assert pt.dtype == st.dtype == torch.int32 and vt.dtype == torch.float32
    # top-k ties may order differently: compare the support as sets
    flat_t = np.sort(pt.numpy() * 4 + st.numpy(), -1)
    flat_j = np.sort(np.asarray(pj) * 4 + np.asarray(sj), -1)
    np.testing.assert_array_equal(flat_t, flat_j)
    np.testing.assert_array_equal(np.sort(vt.numpy(), -1),
                                  np.sort(np.asarray(vj), -1))


# ---------------------------------------------------------------------------
# argument validation: the wrapper raises, it does not guess
# ---------------------------------------------------------------------------

def _args(p=16, g=8, n=4, b=1, k=2, gr=1):
    v = torch.zeros((b, k))
    i = torch.zeros((b, k), dtype=torch.int32)
    return (v, i, i, torch.zeros((p, g, n)),
            torch.zeros((gr, p, n), dtype=torch.int8))


def test_rejects_empty_support():
    v, pi, so, pp, rr = _args()
    with pytest.raises(ValueError, match=r"k_nnz=0"):
        topk_gather(v[:, :0], pi[:, :0], so[:, :0], pp, rr)


@pytest.mark.parametrize("which,bad,err,match", [
    ("vals", torch.zeros((1, 2), dtype=torch.float64), TypeError, "float32"),
    ("vals", torch.zeros((2,)), ValueError, r"\(B, K\)"),
    ("p_idx", torch.zeros((1, 2), dtype=torch.int16), TypeError, "int32"),
    ("s_off", torch.zeros((1, 3), dtype=torch.int32), ValueError, "shape"),
    ("packed_p", torch.zeros((16, 8, 4), dtype=torch.float16), TypeError,
     "packed_p"),
    ("route", torch.zeros((1, 16, 4)), TypeError, "int8"),
    ("route", torch.zeros((3, 16, 4), dtype=torch.int8), ValueError,
     "G/R, P, N"),
    ("route", torch.zeros((1, 8, 4), dtype=torch.int8), ValueError,
     "G/R, P, N"),
])
def test_rejects_bad_operands(which, bad, err, match):
    args = dict(zip(("vals", "p_idx", "s_off", "packed_p", "route"), _args()))
    args[which] = bad
    with pytest.raises(err, match=match):
        topk_gather(**args)


def test_never_falls_back_off_the_cpu():
    """A tensor neither on the CPU nor on a CUDA device is refused, not
    handed to the plain version."""
    meta = [t.to("meta") for t in _args()]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        topk_gather(*meta)
    mixed = list(_args())
    mixed[3] = mixed[3].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        topk_gather(*mixed)
