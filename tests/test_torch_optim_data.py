"""The port's training substrate against the JAX package on the CPU:
synthetic batches bit-identical (``lm_batch``, ``gsc_batch``,
``embed_batch``, ``batch_for``), the ``Prefetcher``'s placement, the
learning-rate schedules, AdamW over 5 steps on a tree with an int leaf
(float32 moments within 1e-6; bfloat16 moments within one bf16 ulp of
the moment), global-norm clipping, int8 quantization and error-feedback
accumulation (as tests/test_substrates.py), on inputs from a numpy seed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShape
from repro.data import batch_for as j_batch_for
from repro.data import embed_batch as j_embed_batch
from repro.data import lm_batch as j_lm_batch
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import (Prefetcher, batch_for, embed_batch, gsc_batch,
                              lm_batch)
from repro_torch.optim import (AdamWConfig, apply_updates,
                               clip_by_global_norm, constant,
                               dequantize_int8, global_norm, init_residuals,
                               init_state, quantize_int8, warmup_cosine)
from repro_torch.tree import flatten


def _same(got, want):
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_lm_and_embed_batches_bit_identical(shard):
    s, n = shard
    _same(lm_batch(7, 42, 8, 32, 1000, s, n),
          j_lm_batch(7, 42, 8, 32, 1000, s, n))
    _same(embed_batch(3, 5, 4, 16, 8, 100, s, n),
          j_embed_batch(3, 5, 4, 16, 8, 100, s, n))
    _same(embed_batch(3, 5, 4, 16, 8, 100, s, n, prefix=4),
          j_embed_batch(3, 5, 4, 16, 8, 100, s, n, prefix=4))


@pytest.mark.parametrize("arch", ["smollm-360m", "musicgen-large",
                                  "internvl2-2b"])
def test_batch_for_bit_identical(arch):
    got = batch_for(get_config(arch).reduced(), ShapeConfig("t", 16, 4,
                                                            "train"), 3)
    want = j_batch_for(jget_config(arch).reduced(), JShape("t", 16, 4,
                                                           "train"), 3)
    _same(got, want)


def test_data_resumable_and_structured():
    a = lm_batch(seed=7, step=42, batch=8, seq=32, vocab=1000)
    c = lm_batch(seed=7, step=43, batch=8, seq=32, vocab=1000)
    assert not np.array_equal(a["tokens"], c["tokens"])
    b = gsc_batch(seed=0, step=0, batch=32)
    assert b["x"].shape == (32, 32, 32, 1)
    assert set(np.unique(b["y"])) <= set(range(12))


def test_prefetcher_places_batches_in_order():
    pre = Prefetcher(lambda s: lm_batch(0, s, 2, 4, 50), start_step=3,
                     device="cpu")
    try:
        step, batch = pre.get(expected_step=3)
        assert step == 3
        assert batch["tokens"].dtype == torch.int64
        np.testing.assert_array_equal(batch["tokens"].numpy(),
                                      lm_batch(0, 3, 2, 4, 50)["tokens"])
        # a restart moved the counter: the batch is made for that step
        step, batch = pre.get(expected_step=9)
        assert step == 9
        np.testing.assert_array_equal(batch["labels"].numpy(),
                                      lm_batch(0, 9, 2, 4, 50)["labels"])
    finally:
        pre.close()
    assert not pre._thread.is_alive()
    g = Prefetcher(lambda s: gsc_batch(0, s, 2), 0, device="cpu")
    try:
        assert g.get()[1]["x"].dtype == torch.float32
    finally:
        g.close()


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def test_warmup_cosine_matches_reference():
    for warm, total in ((10, 100), (2, 20), (0, 5)):
        for s in range(total + 3):
            got = float(warmup_cosine(torch.tensor(s, dtype=torch.int32),
                                      warm, total))
            want = float(jopt.warmup_cosine(jnp.asarray(s, jnp.int32), warm,
                                            total))
            assert abs(got - want) <= 1e-6, (warm, total, s)
            assert float(warmup_cosine(s, warm, total)) == got
    assert float(constant(torch.tensor(4))) == 1.0


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _params(rng):
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "blk": {"packed": rng.normal(size=(3, 4, 2)).astype(np.float32),
                    "route": rng.integers(0, 2, (1, 4, 2)).astype(np.int8),
                    "b": rng.normal(size=(6,)).astype(np.float32)}}


def _grads(rng, params, scale):
    return {k: _grads(rng, v, scale) if isinstance(v, dict) else
            (rng.normal(size=v.shape).astype(np.float32) * scale
             if v.dtype.kind == "f" else np.zeros_like(v))
            for k, v in params.items()}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else
            torch.from_numpy(v.copy())
            for k, v in tree.items()}


def _jax(tree):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [0.3, 30.0], ids=["unclipped", "clipped"])
def test_adamw_5_steps_match_reference(moments, scale):
    rng = np.random.default_rng(0)
    p_np = _params(rng)
    tp, jp = _torch(p_np), _jax(p_np)
    kw = dict(lr=0.05, weight_decay=0.1, grad_clip=1.0)
    cfg = AdamWConfig(moment_dtype=getattr(torch, moments), **kw)
    jcfg = jopt.AdamWConfig(moment_dtype=getattr(jnp, moments), **kw)
    ts, js = init_state(tp, cfg), jopt.init_state(jp, jcfg)
    assert ts["mu"]["blk"]["route"].shape == ()
    assert ts["mu"]["blk"]["route"].dtype == torch.int32
    for step in range(5):
        g_np = _grads(rng, p_np, scale)
        lr_scale = warmup_cosine(step, 2, 5)
        _, _, tm = apply_updates(tp, _torch(g_np), ts, cfg, lr_scale)
        jp, js, jm = jopt.apply_updates(
            jp, _jax(g_np), js, jcfg,
            jopt.warmup_cosine(jnp.asarray(step), 2, 5))
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
    assert int(ts["step"]) == int(js["step"]) == 5
    for tree, jtree in ((tp, jp), (ts["mu"], js["mu"]), (ts["nu"], js["nu"])):
        want = dict(flatten(jax.tree.map(np.asarray, jtree)))
        for k, t in flatten(tree):
            w = want[k]
            if t.dtype == torch.bfloat16:
                # one bf16 ulp of the moment (8 bits of mantissa)
                got = t.float().numpy()
                w = w.astype(np.float32)
                ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w),
                                                          1e-30))) - 7)
                assert (np.abs(got - w) <= ulp).all(), k
            elif t.is_floating_point():
                np.testing.assert_allclose(t.numpy(), w, atol=1e-6,
                                           rtol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(t.numpy(), w, err_msg=k)
    np.testing.assert_array_equal(tp["blk"]["route"].numpy(),
                                  p_np["blk"]["route"])


def test_adamw_converges_quadratic_and_leaves_int_leaves():
    params = {"w": torch.tensor([5.0, -3.0]),
              "route": torch.zeros((2,), dtype=torch.int8)}
    cfg = AdamWConfig(lr=0.2, weight_decay=0.0, grad_clip=100.0)
    state = init_state(params, cfg)
    for _ in range(200):
        apply_updates(params, {"w": 2 * params["w"], "route": None}, state,
                      cfg)
    assert float(params["w"].abs().max()) < 1e-2
    assert torch.equal(params["route"], torch.zeros(2, dtype=torch.int8))


def test_adamw_bf16_moments_close_to_fp32():
    def run(dtype):
        params = {"w": torch.full((4,), 2.0)}
        cfg = AdamWConfig(lr=0.1, weight_decay=0.0, moment_dtype=dtype)
        state = init_state(params, cfg)
        for _ in range(50):
            apply_updates(params, {"w": params["w"] * 2.0}, state, cfg)
        return params["w"].numpy()

    np.testing.assert_allclose(run(torch.bfloat16), run(torch.float32),
                               atol=0.05)


def test_grad_clip_norm():
    g = {"a": torch.full((10,), 10.0), "i": torch.zeros(3, dtype=torch.int8)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert abs(float(global_norm(clipped)) - 1.0) < 1e-5
    assert float(norm) > 30
    assert clipped["i"] is g["i"]
    jc, jn = jopt.clip_by_global_norm({"a": jnp.full((10,), 10.0)}, 1.0)
    np.testing.assert_allclose(clipped["a"].numpy(), np.asarray(jc["a"]),
                               rtol=1e-6)
    assert abs(float(norm) - float(jn)) <= 1e-5


# ---------------------------------------------------------------------------
# int8 error-feedback compression
# ---------------------------------------------------------------------------

def test_int8_quant_roundtrip_matches_reference():
    x = np.random.default_rng(0).normal(size=(256,)) * 3
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = jopt.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == pytest.approx(float(js), rel=1e-7)
    err = np.abs(dequantize_int8(q, s).numpy() - x)
    assert err.max() <= float(s) * 0.51


def test_error_feedback_unbiased_accumulation():
    rng = np.random.default_rng(1)
    resid = init_residuals({"g": torch.zeros(64),
                            "r": torch.zeros(2, dtype=torch.int8)}, 1)
    assert resid["r"].shape == (1,) and resid["g"].shape == (1, 64)
    resid = resid["g"][0]
    total_true = np.zeros(64)
    total_sent = np.zeros(64)
    for _ in range(100):
        g = torch.from_numpy(rng.normal(size=64) * 0.01).float()
        comp_in = g + resid
        q, s = quantize_int8(comp_in)
        sent = dequantize_int8(q, s)
        resid = comp_in - sent
        total_true += g.numpy()
        total_sent += sent.numpy()
    assert np.abs(total_true - total_sent).max() <= \
        float(resid.abs().max()) + 1e-6


def test_configs_equal_reference_dataclasses():
    assert dataclasses.asdict(AdamWConfig()).keys() == \
        dataclasses.asdict(jopt.AdamWConfig()).keys()
