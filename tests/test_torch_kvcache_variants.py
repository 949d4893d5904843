"""The port's int8 KV cache against the JAX package's, on reduced smollm in
float32 with the JAX ``init_model`` weights bridged into the port:
``_quant_rows`` bit for bit (halves round to even), fused prefill with
``quantize_kv`` (logits and the four cache leaves), decode and chunked
prefill through the quantized rows; the port's ``Engine`` token for token
against the JAX ``Engine`` on both KV layouts; and the mirror of
tests/test_kvcache.py's int8 paged-against-contiguous engine test.

Tolerance 1e-4 on logits (float32, sums in another order); the int8 rows
and their scales are compared exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.mesh import make_mesh
from repro.launch.serve import Engine as JEngine
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.runtime.scheduler import Request as JRequest
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch.serve import Engine
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.runtime.scheduler import Request, SamplingParams

ATOL = 1e-4
BASE = dict(head_pad=0, compute_dtype="float32", param_dtype="float32",
            kv_cache_dtype="int8")


def _cfgs(**overrides):
    kw = dict(BASE, **overrides)
    return (jget_config("smollm-360m").reduced(**kw),
            get_config("smollm-360m").reduced(**kw))


@pytest.fixture(scope="module")
def int8_model():
    jcfg, cfg = _cfgs()
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jcfg, cfg, jparams, params


def _quant_both(x):
    jq, js = JA._quant_rows(jnp.asarray(x))
    q, s = A._quant_rows(torch.from_numpy(x))
    return np.asarray(jq), np.asarray(js), q, s


def test_quant_rows_bit_for_bit():
    """Random rows (f32 and a row of zeros) and rows on exact half steps:
    amax 127 makes the scale 1.0, so 2.5, -3.5, 0.5 and 126.5 land on a
    tie, rounded to even as ``jnp.round`` does."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0
    jq, js, q, s = _quant_both(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)
    halves = np.array([[127.0, 2.5, -3.5, 0.5, 126.5, -0.5, 1.5, -127.0]],
                      np.float32)
    jq, js, q, s = _quant_both(halves)
    np.testing.assert_array_equal(s.numpy(), [1.0])
    np.testing.assert_array_equal(q.numpy(),
                                  [[127, 2, -4, 0, 126, 0, 2, -127]])
    np.testing.assert_array_equal(q.numpy(), jq)


def test_quant_rows_of_bf16_rows_match():
    """bf16 K/V rows as the bf16 engine hands them over."""
    x = np.random.default_rng(1).standard_normal((4, 3, 32)).astype(
        np.float32)
    jq, js = JA._quant_rows(jnp.asarray(x, jnp.bfloat16))
    q, s = A._quant_rows(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_int8_cache_leaves_and_bytes():
    """int8 rows and f32 (B, S, Hkv) scales: half a bf16 cache's bytes
    plus the scales."""
    _, cfg = _cfgs(compute_dtype="bfloat16")
    c8 = T.init_cache(cfg, 2, 16, device="cpu")[0]
    assert {k: v.dtype for k, v in c8.items()} == {
        "k": torch.int8, "v": torch.int8, "k_scale": torch.float32,
        "v_scale": torch.float32}
    assert c8["k_scale"].shape == (2, 16, cfg.n_kv_heads)
    c16 = T.init_cache(dataclasses.replace(cfg, kv_cache_dtype="bfloat16"),
                       2, 16, device="cpu")[0]
    nbytes = lambda c: sum(v.numel() * v.element_size() for v in c.values())
    assert nbytes(c8) == nbytes(c16) // 2 + 2 * 2 * 16 * cfg.n_kv_heads * 4


def _cache_from_jax(jcache, cfg):
    return [{k: torch.from_numpy(np.array(v[u]))
             for k, v in jcache[f"b{i}"].items()}
            for u in range(cfg.n_units)
            for i in range(len(cfg.block_pattern))]


def _assert_int8_cache_equal(cache, jcache, cfg, rows):
    for c, r in zip(cache, _cache_from_jax(jcache, cfg), strict=True):
        assert c.keys() == r.keys() == {"k", "v", "k_scale", "v_scale"}
        for name in ("k", "v"):
            assert c[name].dtype == torch.int8
            np.testing.assert_array_equal(c[name][:, :rows].numpy(),
                                          r[name][:, :rows].numpy())
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(c[name][:, :rows].numpy(),
                                       r[name][:, :rows].numpy(), rtol=1e-6)


def test_int8_prefill_and_decode_match_the_reference(int8_model):
    """Fused prefill attends over the quantize→dequantize round trip
    (``quantize_kv``) and stores the exact rows quantized; decode writes
    and reads the quantized rows."""
    jcfg, cfg, jparams, params = int8_model
    b, p_len, max_seq = 2, 9, 24
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (b, p_len))
    jl, jc = JT.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                        max_seq)
    tl, tc = T.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg,
                       max_seq)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    _assert_int8_cache_equal(tc, jc, cfg, p_len)
    for i in range(3):
        nt = rng.integers(0, cfg.vocab_size, (b, 1))
        pos = np.array([p_len + i, p_len + i - 2])
        jl, jc = JT.serve_step(jparams, jc, {"tokens": jnp.asarray(nt)},
                               jnp.asarray(pos, jnp.int32), jcfg)
        tl, tc = T.serve_step(params, tc, {"tokens": torch.from_numpy(nt)},
                              torch.from_numpy(pos), cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    _assert_int8_cache_equal(tc, jc, cfg, p_len + 3)


def test_quantize_kv_prefill_attends_over_the_round_trip(int8_model):
    """``_gqa_forward(quantize_kv=True)`` against the reference's, and
    apart from the exact forward: the round trip is what it reads."""
    jcfg, cfg, jparams, params = int8_model
    jmix = jax.tree.map(lambda a: a[0], jparams["units"]["b0"]["mixer"])
    mix = params["layers"][0]["mixer"]
    x = np.random.default_rng(3).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12)).copy()
    jy, jk, _ = JA._gqa_forward(jmix, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                quantize_kv=True)
    y, k, _ = A._gqa_forward(mix, torch.from_numpy(x), cfg,
                             torch.from_numpy(pos), quantize_kv=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-5)
    exact, _, _ = A._gqa_forward(mix, torch.from_numpy(x), cfg,
                                 torch.from_numpy(pos))
    assert float((exact - y).abs().max()) > 1e-6


def test_int8_chunked_prefill_matches_the_reference(int8_model):
    """Two chunks of 8 into scattered pages of the int8 pool, then a paged
    decode step: logits and the pool's rows and scales."""
    jcfg, cfg, jparams, params = int8_model
    table = np.array([[4, 1, 3]])
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, 12)
    jpool, _ = JT.init_paged_cache(jcfg, 6, 8)
    pool = T.init_paged_cache(cfg, 6, 8, device="cpu")
    for start in (0, 8):
        ln = min(8, 12 - start)
        buf = np.zeros((1, 8), np.int64)
        buf[0, :ln] = prompt[start:start + ln]
        jl, jpool = JT.prefill_chunk(jparams, jpool,
                                     {"tokens": jnp.asarray(buf)}, start, ln,
                                     jcfg, jnp.asarray(table, jnp.int32))
        tl, pool = T.prefill_chunk(params, pool,
                                   {"tokens": torch.from_numpy(buf)}, start,
                                   ln, cfg, torch.from_numpy(table))
        np.testing.assert_allclose(tl[0, :ln].numpy(),
                                   np.asarray(jl)[0, :ln], atol=ATOL)
    jl, jpool = JT.serve_step(jparams, jpool, {"tokens": jnp.asarray([[7]])},
                              jnp.asarray([12], jnp.int32), jcfg,
                              pages=jnp.asarray(table, jnp.int32))
    tl, pool = T.serve_step(params, pool, {"tokens": torch.tensor([[7]])},
                            torch.tensor([12]), cfg,
                            pages=torch.from_numpy(table))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for got, want in zip(pool, _cache_from_jax(jpool, cfg), strict=True):
        for name in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_allclose(got[name][table[0]].numpy(),
                                       want[name][table[0]].numpy(),
                                       rtol=1e-6)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_int8_engine_matches_the_jax_engine(layout):
    """8 mixed-length requests on 4 slots, greedy, int8 cache: the port's
    tokens equal the JAX engine's on the same layout."""
    jcfg, cfg = _cfgs()
    kw = ({} if layout == "contiguous" else
          dict(kv_layout="paged", page_size=8, n_pages=13, prefill_chunk=8))
    jeng = JEngine(jcfg, make_mesh((1, 1), ("data", "model")), max_seq=40,
                   n_slots=4, **kw)
    rng = np.random.default_rng(0)
    spec = [(rng.integers(0, cfg.vocab_size, n).tolist(), g)
            for n, g in zip([5, 19, 3, 26, 9, 14, 7, 22],
                            [6, 7, 8, 9, 10, 6, 7, 8])]
    jout, jstats = jeng.serve([JRequest(uid=i, prompt=p, max_new_tokens=g)
                               for i, (p, g) in enumerate(spec)])
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg,
                             device="cpu")
    out, stats = Engine(cfg, max_seq=40, n_slots=4, params=params,
                        device="cpu", **kw).serve(
        [Request(uid=i, prompt=p, max_new_tokens=g)
         for i, (p, g) in enumerate(spec)])
    assert out == {u: [int(t) for t in v] for u, v in jout.items()}
    assert stats["decode_steps"] == jstats["decode_steps"]


def test_paged_engine_int8_cache_variant():
    """The mirror of tests/test_kvcache.py's: the quantized leaves (int8
    rows, f32 scales) go through the same gathers and scatters; the paged
    engine's tokens equal the contiguous engine's."""
    _, cfg = _cfgs()
    rng = np.random.default_rng(0)
    reqs = lambda: [Request(uid=i, prompt=p, max_new_tokens=g,
                            sampling=SamplingParams(seed=i))
                    for i, (p, g) in enumerate(spec)]
    spec = [(rng.integers(0, cfg.vocab_size, n).tolist(), g)
            for n, g in zip([11, 4, 17, 6], [5, 6, 5, 6])]
    eng_c = Engine(cfg, max_seq=32, n_slots=2, device="cpu")
    out_c, _ = eng_c.serve(reqs())
    eng_p = Engine(cfg, max_seq=32, n_slots=2, kv_layout="paged",
                   page_size=8, prefill_chunk=8, params=eng_c.params,
                   device="cpu")
    out_p, _ = eng_p.serve(reqs())
    assert out_p == out_c
    assert eng_p.new_paged_cache()[0]["k"].dtype == torch.int8
