"""The port's layers, common blocks and FFN against the JAX package on the
same weights (the JAX init, handed over as numpy) and the same seeded
inputs: packed linear on all three paths with the support handoff and the
bias slice, k-WTA dispatch, norms/RoPE/embedding, the FFN on both sides of
the B·K < d_ff crossover, and one Select per sparse FFN.

Tolerance: atol=1e-5 on float32 outputs (sums in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SparsityConfig as JSparsity
from repro.core.layers import apply_kwta as j_apply_kwta
from repro.core.layers import linear_apply as j_linear_apply
from repro.core.layers import linear_init as j_linear_init
from repro.core.layers import packed_linear_apply as j_packed_apply
from repro.core.layers import packed_linear_from_dense as j_from_dense
from repro.core.layers import packed_linear_init as j_packed_init
from repro.models import common as jcommon
from repro.models.ffn import ffn_apply as j_ffn_apply
from repro.models.ffn import ffn_init as j_ffn_init
from repro_torch.core import SparsityConfig, count_selects
from repro_torch.core.layers import (apply_kwta, linear_apply, linear_init,
                                     packed_linear_apply,
                                     packed_linear_from_dense,
                                     packed_linear_init, partition_major)
from repro_torch.models import common as tcommon
from repro_torch.models.ffn import ffn_apply, ffn_init

ATOL = 1e-5


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


def _layer(jparams):
    """A JAX layer's params as the port's (packed layers gain packed_p)."""
    out = {k: _t(v) for k, v in jparams.items()}
    if "packed" in out:
        out["packed_p"] = partition_major(out["packed"])
    return out


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# linear layers
# ---------------------------------------------------------------------------

def test_dense_linear_matches():
    jp, _ = j_linear_init(jax.random.PRNGKey(0), 24, 12)
    jp["b"] = jnp.asarray(_x((12,), 1))
    x = _x((3, 24), 2)
    np.testing.assert_allclose(_np(linear_apply(_layer(jp), _t(x))),
                               np.asarray(j_linear_apply(jp, x)), atol=ATOL)


@pytest.mark.parametrize("path", ["hadamard", "dense", "topk"])
@pytest.mark.parametrize("use_pallas", ["auto", "off"])
@pytest.mark.parametrize("route_share", [1, 0])
def test_packed_linear_paths_with_padding_and_bias(path, use_pallas,
                                                   route_share):
    """d_in/d_out not divisible by N: inputs zero-pad, outputs slice back
    to the bias length; with and without the k-WTA support handoff."""
    d_in, d_out, n, k = 62, 30, 4, 8
    kw = dict(n=n, k_frac=k / d_in, path=path, route_share=route_share)
    jcfg = JSparsity(**kw)
    cfg = SparsityConfig(**kw, use_pallas=use_pallas)
    jp, _ = j_packed_init(jax.random.PRNGKey(0), d_in, d_out, jcfg)
    jp["b"] = jnp.asarray(_x((d_out,), 3))
    params = _layer(jp)
    x = _x((3, d_in), 4)
    hj, sup_j = j_apply_kwta(jnp.asarray(x), jcfg, return_support=True)
    h, sup = apply_kwta(_t(x), cfg, return_support=True)
    np.testing.assert_array_equal(_np(h), np.asarray(hj))
    y_ref = np.asarray(j_packed_apply(jp, hj, jcfg, x_is_sparse=True,
                                      support=sup_j))
    y_hand = packed_linear_apply(params, h, cfg, x_is_sparse=True,
                                 support=sup)
    y_self = packed_linear_apply(params, h, cfg, x_is_sparse=True)
    assert tuple(y_hand.shape) == (3, d_out)
    np.testing.assert_allclose(_np(y_hand), y_ref, atol=ATOL)
    np.testing.assert_allclose(_np(y_self), y_ref, atol=ATOL)


def test_packed_linear_leading_dims_and_auto_crossover():
    d_in, d_out, n, k = 64, 32, 4, 8
    jcfg = JSparsity(n=n, k_frac=k / d_in)
    cfg = SparsityConfig(n=n, k_frac=k / d_in)
    jp, _ = j_packed_init(jax.random.PRNGKey(1), d_in, d_out, jcfg)
    params = _layer(jp)
    for shape in ((2, 1, d_in), (4, 1, d_in), (8, 4, d_in)):   # topk..had.
        x = np.asarray(j_apply_kwta(jnp.asarray(_x(shape, 5)), jcfg))
        np.testing.assert_allclose(
            _np(packed_linear_apply(params, _t(x), cfg, x_is_sparse=True)),
            np.asarray(j_packed_apply(jp, x, jcfg, x_is_sparse=True)),
            atol=ATOL)


def test_packed_linear_init_and_from_dense_layouts():
    cfg = SparsityConfig(n=4, route_share=0)
    gen = torch.Generator().manual_seed(0)
    p = packed_linear_init(gen, 62, 30, cfg, seed=21)
    jp, _ = j_packed_init(jax.random.PRNGKey(0), 62, 30,
                          JSparsity(n=4, route_share=0), seed=21)
    assert tuple(p["packed"].shape) == jp["packed"].shape
    np.testing.assert_array_equal(_np(p["route"]), np.asarray(jp["route"]))
    np.testing.assert_array_equal(_np(p["packed_p"]),
                                  _np(p["packed"]).transpose(1, 0, 2))
    scale = np.sqrt(4 / 64)
    assert float(p["packed"].abs().max()) <= scale
    assert tuple(p["b"].shape) == (30,) and not p["b"].any()
    w = _x((64, 32), 6)
    for share in (1, 2, 0):
        tp = packed_linear_from_dense(w, SparsityConfig(n=4,
                                                        route_share=share))
        jpd = j_from_dense(w, JSparsity(n=4, route_share=share))
        np.testing.assert_array_equal(_np(tp["packed"]),
                                      np.asarray(jpd["packed"]))
        np.testing.assert_array_equal(_np(tp["route"]),
                                      np.asarray(jpd["route"]))


@pytest.mark.parametrize("impl,parts", [("topk", 0), ("topk", 4),
                                        ("hist", 0), ("bisect", 0)])
def test_apply_kwta_dispatch_matches(impl, parts):
    kw = dict(n=4, k_frac=0.125, kwta_impl=impl, kwta_partitions=parts)
    x = _x((3, 128), 7)
    yj, sj = j_apply_kwta(jnp.asarray(x), JSparsity(**kw),
                          return_support=True)
    y, s = apply_kwta(_t(x), SparsityConfig(**kw), return_support=True)
    np.testing.assert_array_equal(_np(y), np.asarray(yj))
    assert (s is None) == (sj is None)
    if s is not None:
        np.testing.assert_array_equal(np.sort(_np(s[1]), -1),
                                      np.sort(np.asarray(sj[1]), -1))
    dense = apply_kwta(_t(x), SparsityConfig(n=4))
    np.testing.assert_array_equal(_np(dense), x)


# ---------------------------------------------------------------------------
# norms, RoPE, embedding, LM head
# ---------------------------------------------------------------------------

def test_common_blocks_match():
    x = _x((2, 5, 3, 16), 8)
    pos = np.tile(np.arange(5), (2, 1)) + 3
    np.testing.assert_allclose(
        _np(tcommon.apply_rope(_t(x), _t(pos), 10000.0)),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      10000.0)), atol=ATOL)
    x2 = _x((2, 5, 16), 9)
    np.testing.assert_allclose(
        _np(tcommon.apply_rope(_t(x2), _t(pos), 500.0)),
        np.asarray(jcommon.apply_rope(jnp.asarray(x2), jnp.asarray(pos),
                                      500.0)), atol=ATOL)
    scale = {"scale": _x((16,), 10)}
    np.testing.assert_allclose(
        _np(tcommon.rmsnorm_apply({"scale": _t(scale["scale"])}, _t(x2))),
        np.asarray(jcommon.rmsnorm_apply(scale, jnp.asarray(x2))), atol=ATOL)
    ln = {"scale": _x((16,), 11), "bias": _x((16,), 12)}
    np.testing.assert_allclose(
        _np(tcommon.layernorm_apply({k: _t(v) for k, v in ln.items()},
                                    _t(x2))),
        np.asarray(jcommon.layernorm_apply(ln, jnp.asarray(x2))), atol=ATOL)
    xb = _t(x2).to(torch.bfloat16)
    assert tcommon.rmsnorm_apply({"scale": _t(scale["scale"])},
                                 xb).dtype == torch.bfloat16
    table = {"table": _x((32, 16), 13)}
    toks = np.array([[1, 5, 31], [0, 2, 2]])
    np.testing.assert_array_equal(
        _np(tcommon.embedding_apply({"table": _t(table["table"])}, _t(toks),
                                    torch.float32)),
        np.asarray(jcommon.embedding_apply(table, jnp.asarray(toks),
                                           jnp.float32)))
    np.testing.assert_allclose(
        _np(tcommon.lm_head_apply({"table": _t(table["table"])}, _t(x2),
                                  torch.float32)),
        np.asarray(jcommon.lm_head_apply(table, jnp.asarray(x2),
                                         jnp.float32)), atol=ATOL)
    assert tcommon.dtype_of("bfloat16") == torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    emb = tcommon.embedding_init(gen, 4096, 8)["table"]
    assert abs(float(emb.std()) - 0.02) < 1e-3


# ---------------------------------------------------------------------------
# the sparse-sparse FFN
# ---------------------------------------------------------------------------

FFN_CFGS = {"topk": dict(n=4, k_frac=0.125),
            "bisect": dict(n=4, k_frac=0.125, route_share=0,
                           kwta_impl="bisect")}


@pytest.mark.parametrize("impl", sorted(FFN_CFGS))
@pytest.mark.parametrize("use_pallas", ["auto", "off"])
@pytest.mark.parametrize("batch", [(2, 1), (4, 1), (8, 1), (2, 9)])
def test_ffn_matches_across_crossover(impl, use_pallas, batch):
    """d_ff=128, K=16: B·K < d_ff (topk path) for 2 and 4 rows, not for 8
    or 18 (hadamard path)."""
    kw = FFN_CFGS[impl]
    jcfg = JSparsity(**kw)
    cfg = SparsityConfig(**kw, use_pallas=use_pallas)
    jp, _ = j_ffn_init(jax.random.PRNGKey(2), 64, 128, jcfg)
    params = {k: _layer(v) for k, v in jp.items()}
    x = _x(batch + (64,), 14)
    np.testing.assert_allclose(
        _np(ffn_apply(params, _t(x), cfg)),
        np.asarray(j_ffn_apply(jp, jnp.asarray(x), jcfg)), atol=ATOL)


def test_dense_gelu_ffn_matches():
    jp, _ = j_ffn_init(jax.random.PRNGKey(3), 32, 64, JSparsity(), "gelu")
    params = {k: _layer(v) for k, v in jp.items()}
    assert "gate" not in params
    x = _x((3, 32), 15)
    np.testing.assert_allclose(
        _np(ffn_apply(params, _t(x), SparsityConfig(), "gelu")),
        np.asarray(j_ffn_apply(jp, jnp.asarray(x), JSparsity(), "gelu")),
        atol=ATOL)


@pytest.mark.parametrize("impl", sorted(FFN_CFGS))
def test_ffn_runs_exactly_one_topk(impl):
    """One Select per sparse FFN at a decode shape: the exact k-WTA's
    support is handed to the down projection; the threshold k-WTA leaves
    the down projection's own Select as the only one."""
    cfg = SparsityConfig(**FFN_CFGS[impl])
    gen = torch.Generator().manual_seed(0)
    params = ffn_init(gen, 64, 256, cfg)
    assert set(params) == {"up", "gate", "down"}
    x = torch.from_numpy(_x((2, 1, 64), 16))
    with count_selects() as c:
        ffn_apply(params, x, cfg)
    assert c.top_k == 1
    with count_selects() as c:
        ffn_apply(params, x, dataclasses.replace(cfg, use_pallas="off"))
    assert c.top_k == 1
