"""The PyTorch port's configs and core algebra against the JAX package:
every arch config field for field, routes and packing bit for bit, the
execution paths and every k-WTA variant on the same seeded numpy inputs.

Tolerances: float32 paths within atol=1e-5 (the two frameworks sum in
different orders); k-WTA selections and bisect/hist thresholds exact."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import api as japi
from repro.core import functional as JF
from repro.core import masks as jmasks
from repro.core import packing as jpacking
from repro_torch import configs as tconfigs
from repro_torch.core import api as tapi
from repro_torch.core import functional as TF
from repro_torch.core import masks as tmasks
from repro_torch.core import packing as tpacking
from repro_torch.core.instrument import count_selects, counted_top_k

# the packages export a function named kwta over the module's name
jkwta = importlib.import_module("repro.core.kwta")
tkwta = importlib.import_module("repro_torch.core.kwta")

ATOL = 1e-5


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_arch_config_matches_reference(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    for prop in ("head_dim", "padded_heads", "padded_vocab", "n_units",
                 "is_moe"):
        assert getattr(t, prop) == getattr(j, prop), prop
    for r in (t, t.reduced()):
        assert r.ffn_sparsity.k_for(r.d_ff or 1) == \
            jconfigs.get_config(arch).ffn_sparsity.k_for(r.d_ff or 1)


def test_config_registry_and_dataclasses_match():
    from repro.configs import base as jbase
    from repro_torch.configs import base as tbase
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs._ALIAS == {k: v for k, v in jconfigs._ALIAS.items()}
    for alias in tconfigs._ALIAS:
        assert tconfigs.get_config(alias).name == \
            jconfigs.get_config(alias).name
    for tcls, jcls in ((tbase.ModelConfig, jbase.ModelConfig),
                       (tbase.ShapeConfig, jbase.ShapeConfig),
                       (tbase.TrainConfig, jbase.TrainConfig),
                       (tapi.SparsityConfig, japi.SparsityConfig)):
        tf = [(f.name, f.default) for f in dataclasses.fields(tcls)]
        jf = [(f.name, f.default) for f in dataclasses.fields(jcls)]
        assert [n for n, _ in tf] == [n for n, _ in jf]
        for (n, dt), (_, dj) in zip(tf, jf):
            if dataclasses.is_dataclass(dt):
                assert dataclasses.asdict(dt) == dataclasses.asdict(dj), n
            else:
                assert dt == dj, n
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


def test_reduced_override_and_validation_match():
    j = jconfigs.get_config("smollm-360m")
    t = tconfigs.get_config("smollm-360m")
    kw = dict(head_pad=0, compute_dtype="float32", d_ff=256)
    assert dataclasses.asdict(t.reduced(**kw)) == \
        dataclasses.asdict(j.reduced(**kw))
    with pytest.raises(ValueError, match="not a multiple"):
        dataclasses.replace(t, n_layers=31)


def test_k_for_and_choose_path_match():
    for n in (1, 4, 32):
        for k_frac in (None, 0.05, 0.125, 1.0):
            for parts in (0, 4):
                for path in ("auto", "dense"):
                    kw = dict(n=n, k_frac=k_frac, kwta_partitions=parts,
                              path=path)
                    tc, jc = tapi.SparsityConfig(**kw), \
                        japi.SparsityConfig(**kw)
                    for d in (64, 100, 2560):
                        assert tc.k_for(d) == jc.k_for(d)
                        for b in (1, 4, 8, 64):
                            for sparse in (False, True):
                                assert tapi.choose_path(tc, b, d, sparse) \
                                    == japi.choose_path(jc, b, d, sparse)


def test_choose_executor_modes():
    assert tapi.choose_executor(tapi.SparsityConfig()).use_kernel
    assert tapi.choose_executor(
        tapi.SparsityConfig(use_pallas="force")).use_kernel
    assert not tapi.choose_executor(
        tapi.SparsityConfig(use_pallas="off")).use_kernel
    with pytest.raises(ValueError, match="use_pallas"):
        tapi.choose_executor(tapi.SparsityConfig(use_pallas="tpu"))


# ---------------------------------------------------------------------------
# routes and packing: bit-identical
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("perm_kind", ["random", "cyclic"])
@pytest.mark.parametrize("d_in,d_out,n", [(64, 32, 4), (96, 48, 8),
                                          (2560, 960, 4)])
def test_routes_and_packing_bit_identical(perm_kind, d_in, d_out, n):
    tl = tmasks.CSLayout(d_in, d_out, n, perm_kind)
    jl = jmasks.CSLayout(d_in, d_out, n, perm_kind)
    assert (tl.groups, tl.partitions, tl.nnz) == \
        (jl.groups, jl.partitions, jl.nnz)
    for seed in (0, 23):
        rt, rj = tmasks.make_routes(tl, seed), jmasks.make_routes(jl, seed)
        assert rt.dtype == rj.dtype and np.array_equal(rt, rj)
        if d_in > 100:
            continue
        mt, mj = tmasks.routes_to_mask(tl, rt), jmasks.routes_to_mask(jl, rj)
        assert np.array_equal(mt, mj)
        w = np.random.default_rng(seed).normal(size=(d_in, d_out))
        w = (w * mt).astype(np.float32)
        pt, pj = tpacking.pack_dense(tl, w, rt), jpacking.pack_dense(jl, w, rj)
        assert np.array_equal(pt, pj)
        assert np.array_equal(tpacking.unpack(tl, pt, rt), w)
        assert tpacking.packed_bytes(tl) == jpacking.packed_bytes(jl)
        assert np.array_equal(tmasks.make_mask(d_in, d_out, n, seed, perm_kind),
                              jmasks.make_mask(d_in, d_out, n, seed, perm_kind))


def test_mask_validation_raises_alike():
    lay = tmasks.CSLayout(16, 8, 4)
    bad = np.zeros((2, 4, 4), np.int8)
    with pytest.raises(ValueError, match="not a permutation"):
        tmasks.validate_complementary(lay, bad)
    with pytest.raises(ValueError, match="not divisible"):
        tmasks.CSLayout(10, 8, 4)
    assert tmasks.pad_to_multiple(62, 4) == jmasks.pad_to_multiple(62, 4)


# ---------------------------------------------------------------------------
# execution paths, route sharing R in {1, 2, G}, padded layouts
# ---------------------------------------------------------------------------

def _case(d_in, d_out, n, r_share, seed):
    """packed (G,P,N) and route (G/R,P,N) from the reference's own init,
    so padded layouts come out as the layers make them."""
    from repro.core.layers import packed_linear_init
    cfg = japi.SparsityConfig(n=n, route_share=r_share)
    p, _ = packed_linear_init(jax.random.PRNGKey(seed), d_in, d_out, cfg,
                              bias=False, seed=seed)
    return np.asarray(p["packed"]), np.asarray(p["route"])


# (d_in, d_out, n, route_share): R=1, R=2, R=G, and a padded 62x30 layer
PATH_CASES = [(64, 32, 4, 1), (64, 32, 4, 2), (64, 32, 4, 0),
              (62, 30, 4, 1), (62, 30, 4, 0)]


@pytest.mark.parametrize("d_in,d_out,n,r_share", PATH_CASES)
def test_paths_match_reference(d_in, d_out, n, r_share):
    packed, route = _case(d_in, d_out, n, r_share, seed=d_in + r_share)
    g, p, _ = packed.shape
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, p * n)).astype(np.float32)
    x[:, d_in:] = 0.0                                      # padded tail
    tp, tr, tx = (torch.from_numpy(np.array(a)) for a in (packed, route, x))
    jp, jr, jx = (jnp.asarray(a) for a in (packed, route, x))
    np.testing.assert_array_equal(
        _np(TF.route_to_gather_idx(tr, n)),
        np.asarray(JF.route_to_gather_idx(jr, n)))
    np.testing.assert_array_equal(_np(TF.decompress(tp, tr)),
                                  np.asarray(JF.decompress(jp, jr)))
    for tfn, jfn in ((TF.cs_matmul, JF.cs_matmul),
                     (TF.cs_matmul_dense, JF.cs_matmul_dense)):
        np.testing.assert_allclose(_np(tfn(tx, tp, tr)),
                                   np.asarray(jfn(jx, jp, jr)), atol=ATOL)
    k = 8
    xs = np.asarray(jkwta.kwta(jx, k))
    _, idx = jax.lax.top_k(jnp.abs(jnp.asarray(xs)), k)
    idx = np.asarray(idx)
    vals = np.take_along_axis(xs, idx, axis=-1)
    y_t = TF.cs_topk_from_support(torch.from_numpy(vals),
                                  torch.from_numpy(idx // n),
                                  torch.from_numpy(idx % n), tp, tr)
    y_j = JF.cs_topk_from_support(jnp.asarray(vals), jnp.asarray(idx // n),
                                  jnp.asarray(idx % n), jp, jr)
    np.testing.assert_allclose(_np(y_t), np.asarray(y_j), atol=ATOL)
    np.testing.assert_allclose(
        _np(TF.cs_topk_matmul(torch.from_numpy(np.array(xs)), tp, tr, k)),
        np.asarray(JF.cs_topk_matmul(jnp.asarray(xs), jp, jr, k)), atol=ATOL)
    # and the sparse-sparse product is the masked dense product
    np.testing.assert_allclose(_np(y_t), xs @ _np(TF.decompress(tp, tr)),
                               atol=1e-4)


def test_topk_support_flat_and_flops_match():
    x = np.random.default_rng(1).normal(size=(4, 40)).astype(np.float32)
    vt, it = TF.topk_support_flat(torch.from_numpy(x), 6)
    vj, ij = JF.topk_support_flat(jnp.asarray(x), 6)
    np.testing.assert_array_equal(np.sort(_np(it), -1), np.sort(ij, -1))
    np.testing.assert_array_equal(np.sort(_np(vt), -1), np.sort(vj, -1))
    for fn in ("flops_cs_matmul", "flops_cs_topk", "flops_dense"):
        args = (4, 64, 32, 4)[:{"flops_cs_topk": 3, "flops_dense": 3}.get(
            fn, 4)]
        assert getattr(TF, fn)(*args) == getattr(JF, fn)(*args)
    with pytest.raises(ValueError, match="incompatible"):
        TF.cs_matmul(torch.zeros(2, 16), torch.zeros(4, 4, 4),
                     torch.zeros(3, 4, 4, dtype=torch.int8))


# ---------------------------------------------------------------------------
# k-WTA: every variant; selections compared as sets, thresholds exact
# ---------------------------------------------------------------------------

def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("shape,k", [((4, 128), 16), ((2, 3, 96), 12),
                                     ((5, 2560), 320)])
def test_kwta_exact_variants_match(shape, k):
    x = _x(shape, seed=k)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_array_equal(_np(tkwta.kwta(tx, k)),
                                  np.asarray(jkwta.kwta(jx, k)))
    np.testing.assert_array_equal(_np(tkwta.kwta(tx, 2, axis=0)),
                                  np.asarray(jkwta.kwta(jx, 2, axis=0)))
    yt, (vt, it) = tkwta.kwta_support(tx, k)
    yj, (vj, ij) = jkwta.kwta_support(jx, k)
    np.testing.assert_array_equal(_np(yt), np.asarray(yj))
    # top-k ties may order differently: compare the winner sets
    np.testing.assert_array_equal(np.sort(_np(it), -1), np.sort(ij, -1))
    np.testing.assert_array_equal(np.sort(_np(vt), -1), np.sort(vj, -1))
    np.testing.assert_array_equal(_np(tkwta.kwta_mask(tx, k)),
                                  np.asarray(jkwta.kwta_mask(jx, k)))
    np.testing.assert_array_equal(_np(tkwta.kwta_channel(tx, k)),
                                  np.asarray(jkwta.kwta_channel(jx, k)))
    assert tkwta.kwta_support(tx, shape[-1])[1] is None
    np.testing.assert_allclose(
        float(tkwta.activation_sparsity(tkwta.kwta(tx, k))),
        float(jkwta.activation_sparsity(jkwta.kwta(jx, k))), atol=1e-7)


@pytest.mark.parametrize("shape,k", [((4, 128), 16), ((2, 3, 96), 12),
                                     ((5, 2560), 320), ((3, 64), 8)])
def test_kwta_threshold_variants_exact(shape, k):
    x = _x(shape, seed=k + 1)
    x[0, ..., :4] = x[0, ..., 4:8]          # ties at the threshold
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    yt = _np(tkwta.kwta_bisect(tx, k))
    np.testing.assert_array_equal(yt, np.asarray(jkwta.kwta_bisect(jx, k)))
    assert ((yt != 0).sum(-1) >= k).all()
    np.testing.assert_array_equal(_np(tkwta.kwta_hist(tx, k)),
                                  np.asarray(jkwta.kwta_hist(jx, k)))
    np.testing.assert_array_equal(_np(tkwta.kwta_hist(tx, k, bins=16)),
                                  np.asarray(jkwta.kwta_hist(jx, k, bins=16)))
    xb = tx.to(torch.bfloat16)
    np.testing.assert_array_equal(
        _np(tkwta.kwta_bisect(xb, k).float()),
        np.asarray(jkwta.kwta_bisect(jx.astype(jnp.bfloat16), k),
                   np.float32))


def test_kwta_local_matches_and_validates():
    x = _x((3, 64), seed=5)
    np.testing.assert_array_equal(
        _np(tkwta.kwta_local(torch.from_numpy(x), 8, 4)),
        np.asarray(jkwta.kwta_local(jnp.asarray(x), 8, 4)))
    with pytest.raises(ValueError, match="partitions"):
        tkwta.kwta_local(torch.from_numpy(x), 8, 3)
    with pytest.raises(ValueError, match="k must be positive"):
        tkwta.kwta(torch.from_numpy(x), 0)


def test_select_counter_counts_topk_calls():
    x = torch.from_numpy(_x((2, 32)))
    with count_selects() as outer:
        counted_top_k(x, 3)
        with count_selects() as inner:
            tkwta.kwta(x, 4)
            tkwta.kwta_bisect(x, 4)     # compare-and-count: no Select
        TF.topk_support_flat(x, 2)
    assert inner.top_k == 1 and outer.top_k == 3
    outer.reset()
    assert outer.top_k == 0
