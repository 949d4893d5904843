"""The port's decoder stack against the JAX package on reduced smollm in
float32, with the JAX ``init_model`` weights bridged into the port:
prefill plus 4 decode steps (logits and cache), vector against scalar
positions, padded heads, the blockwise attention of long prefill, and the
port's own init.

Tolerance: atol=1e-4 on logits and cache rows, as tests/test_serving.py
uses (float32, sums in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import transformer as T

ATOL = 1e-4
BASE = dict(head_pad=0, compute_dtype="float32", param_dtype="float32")


def _cfgs(**overrides):
    kw = dict(BASE, **overrides)
    return (jget_config("smollm-360m").reduced(**kw),
            get_config("smollm-360m").reduced(**kw))


def _bridged(jcfg, cfg, seed=0):
    jparams, _ = JT.init_model(jax.random.PRNGKey(seed), jcfg)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")


def _cache_from_jax(jcache, cfg):
    """The reference's stacked cache ({"b{i}": leaves (n_units, ...)}) as
    the port's per-layer list (layer u*L + i)."""
    return [{k: torch.from_numpy(np.array(v[u]))
             for k, v in jcache[f"b{i}"].items()}
            for u in range(cfg.n_units)
            for i in range(len(cfg.block_pattern))]


def _assert_cache_close(cache, jcache, cfg, rows):
    ref = _cache_from_jax(jcache, cfg)
    assert len(cache) == len(ref) == cfg.n_layers
    for c, r in zip(cache, ref):
        assert c.keys() == r.keys()
        for name in c:
            np.testing.assert_allclose(c[name][:, :rows].numpy(),
                                       r[name][:, :rows].numpy(), atol=ATOL)


@pytest.fixture(scope="module")
def smollm():
    jcfg, cfg = _cfgs()
    jparams, params = _bridged(jcfg, cfg)
    return jcfg, cfg, jparams, params


def test_prefill_and_decode_match_reference(smollm):
    jcfg, cfg, jparams, params = smollm
    b, p_len, max_seq = 2, 9, 24
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (b, p_len))
    jl, jc = jax.jit(lambda p, t: JT.prefill(p, {"tokens": t}, jcfg,
                                             max_seq))(jparams,
                                                       jnp.asarray(toks))
    tl, tc = T.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg,
                       max_seq)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    _assert_cache_close(tc, jc, cfg, p_len)
    step = jax.jit(lambda p, c, t, pos: JT.serve_step(p, c, {"tokens": t},
                                                      pos, jcfg))
    for i in range(4):
        nt = rng.integers(0, cfg.vocab_size, (b, 1))
        pos = np.array([p_len + i, p_len + i - 2])   # slots at own depths
        jl, jc = step(jparams, jc, jnp.asarray(nt),
                      jnp.asarray(pos, jnp.int32))
        tl, tc = T.serve_step(params, tc, {"tokens": torch.from_numpy(nt)},
                              torch.from_numpy(pos), cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    _assert_cache_close(tc, jc, cfg, p_len + 4)


@pytest.mark.parametrize("kwta_impl", ["topk", "bisect"])
def test_proj_sparsity_matches_reference(kwta_impl):
    """``proj_sparsity`` set (n=4, k_frac=0.25): q/k/v/o CS-packed and the
    attention output's k-WTA support handed to the o-projection
    (``_o_proj``), with exact top-k and with ``bisect``.  The forward, a
    prefill and 4 decode steps (2 slots: B·K < d_in, the topk path) within
    ATOL of the reference's."""
    from repro.core import SparsityConfig as JSparsity
    from repro_torch.core import SparsityConfig
    sp = dict(n=4, k_frac=0.25, kwta_impl=kwta_impl)
    jcfg = jget_config("smollm-360m").reduced(**BASE,
                                              proj_sparsity=JSparsity(**sp))
    cfg = get_config("smollm-360m").reduced(
        **BASE, proj_sparsity=SparsityConfig(**sp))
    jparams, params = _bridged(jcfg, cfg, seed=4)
    assert "packed_p" in params["layers"][0]["mixer"]["o"]
    b, p_len, max_seq = 2, 9, 16
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (b, p_len))
    jf, _ = jax.jit(lambda p, t: JT.forward(p, {"tokens": t}, jcfg))(
        jparams, jnp.asarray(toks))
    tf, _ = T.forward(params, {"tokens": torch.from_numpy(toks)}, cfg)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=ATOL)
    jl, jc = jax.jit(lambda p, t: JT.prefill(p, {"tokens": t}, jcfg,
                                             max_seq))(jparams,
                                                       jnp.asarray(toks))
    tl, tc = T.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg,
                       max_seq)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    step = jax.jit(lambda p, c, t, pos: JT.serve_step(p, c, {"tokens": t},
                                                      pos, jcfg))
    for i in range(4):
        nt = rng.integers(0, cfg.vocab_size, (b, 1))
        jl, jc = step(jparams, jc, jnp.asarray(nt), p_len + i)
        tl, tc = T.serve_step(params, tc, {"tokens": torch.from_numpy(nt)},
                              p_len + i, cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    _assert_cache_close(tc, jc, cfg, p_len + 4)


def test_vector_positions_match_scalar(smollm):
    """A (B,) position vector with equal entries equals the int-position
    decode — the continuous-batching contract."""
    _, cfg, _, params = smollm
    b, max_seq = 3, 16
    cache = T.init_cache(cfg, b, max_seq, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, 1)))
    for pos in range(4):
        c2 = [{k: v.clone() for k, v in c.items()} for c in cache]
        l1, c1 = T.serve_step(params, cache, {"tokens": toks}, pos, cfg)
        l2, c2 = T.serve_step(params, c2, {"tokens": toks},
                              torch.full((b,), pos), cfg)
        np.testing.assert_allclose(l1.numpy(), l2.numpy(), atol=1e-5)
        for a, bb in zip(c1, c2):
            for name in a:
                np.testing.assert_allclose(a[name].numpy(), bb[name].numpy(),
                                           atol=1e-5)
        cache = c1


def test_cache_write_drops_positions_outside_the_cache():
    """The reference's masked write drops a position past the cache; the
    in-place write does too, instead of raising."""
    from repro_torch.models.attention import _cache_write
    cache = torch.zeros((2, 4, 1, 2))
    new = torch.ones((2, 1, 1, 2))
    _cache_write(cache, new, torch.tensor([1, 4]))
    assert cache[0, 1].eq(1).all() and cache[1].eq(0).all()
    _cache_write(cache, new, 7)
    assert int(cache.sum()) == 2


def test_padded_heads_match_reference():
    """3 heads padded to 4: the dummy head is masked, the function is the
    3-head one."""
    jcfg, cfg = _cfgs(n_heads=3, n_kv_heads=1, head_pad=4)
    assert cfg.padded_heads == 4
    jparams, params = _bridged(jcfg, cfg, seed=1)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 7))
    jl, jc = JT.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg, 12)
    tl, tc = T.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg, 12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    nt = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 1))
    jl, jc = JT.serve_step(jparams, jc, {"tokens": jnp.asarray(nt)}, 7, jcfg)
    tl, tc = T.serve_step(params, tc, {"tokens": torch.from_numpy(nt)}, 7,
                          cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    _assert_cache_close(tc, jc, cfg, 8)


def test_long_prefill_runs_blockwise_attention(smollm):
    """S=64 > flash_block=32: the online-softmax path, against the
    reference's forward and against the port's materialized attention."""
    jcfg, cfg, jparams, params = smollm
    assert cfg.flash_block == 32
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 64))
    jl, _ = jax.jit(lambda p, t: JT.forward(p, {"tokens": t}, jcfg))(
        jparams, jnp.asarray(toks))
    tl, aux = T.forward(params, {"tokens": torch.from_numpy(toks)}, cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert float(aux) == 0.0
    wide = dataclasses.replace(cfg, flash_block=64)
    tl2, _ = T.forward(params, {"tokens": torch.from_numpy(toks)}, wide)
    np.testing.assert_allclose(tl.numpy(), tl2.numpy(), atol=ATOL)
    pl, _ = T.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg, 64)
    np.testing.assert_allclose(pl.numpy(), tl.numpy(), atol=ATOL)


def test_init_model_layout_routes_and_distributions():
    """The port's own init: the reference's leaves and shapes, its numpy
    routes bit for bit, its value ranges; weights cast to the compute
    dtype once."""
    jcfg, cfg = _cfgs()
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    params = T.init_model(cfg, seed=0, device="cpu")
    ref = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                          device="cpu")
    assert T.param_count(params) == T.param_count(ref) == \
        JT.param_count(jparams)

    def walk(a, b, path=""):
        assert type(a) is type(b), path
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        else:
            assert a.shape == b.shape and a.dtype == b.dtype, path
            if path.endswith("route"):
                assert torch.equal(a, b), path
    walk(params, ref)
    down = params["layers"][0]["ffn"]["down"]
    d_in = down["packed"].shape[1] * down["packed"].shape[2]
    assert float(down["packed"].abs().max()) <= np.sqrt(4 / d_in)
    assert torch.equal(down["packed_p"], down["packed"].transpose(0, 1))
    assert abs(float(params["head"]["table"].std()) - 0.02) < 2e-3
    bf = T.init_model(dataclasses.replace(cfg, compute_dtype="bfloat16"),
                      device="cpu")
    assert bf["layers"][0]["ffn"]["down"]["packed_p"].dtype == torch.bfloat16
    assert bf["layers"][0]["norm1"]["scale"].dtype == torch.float32
    assert bf["layers"][0]["ffn"]["down"]["route"].dtype == torch.int8


def test_unported_block_kinds_raise():
    """What the port refuses is what the reference refuses.  Every shipped
    block pattern and frontend is ported (the SSM/hybrid patterns and the
    frontends: tests/test_torch_archs.py, test_torch_ssm.py): the four
    last ones initialise; a block kind the reference does not know raises
    its ``ValueError``; ``Engine.serve`` raises ``NotImplementedError`` on
    a pattern without a fused prefill, on either layout."""
    from repro_torch.launch.serve import Engine
    from repro_torch.runtime.scheduler import Request
    for arch in ("zamba2-1.2b", "xlstm-350m", "musicgen-large",
                 "internvl2-2b"):
        params = T.init_model(get_config(arch).reduced(), device="cpu")
        assert T.param_count(params) > 0
    bad = dataclasses.replace(get_config("smollm-360m").reduced(),
                              block_pattern=("attn", "retention"),
                              n_layers=4)
    with pytest.raises(ValueError, match="unknown block kind retention"):
        T.init_model(bad, device="cpu")
    with pytest.raises(ValueError, match="unknown block kind retention"):
        T.init_cache(bad, 1, 8, device="cpu")
    for layout in ("contiguous", "paged"):
        eng = Engine(get_config("zamba2-1.2b").reduced(), max_seq=16,
                     n_slots=2, device="cpu", kv_layout=layout)
        with pytest.raises(NotImplementedError, match="no fused prefill"):
            eng.serve([Request(uid=0, prompt=[1, 2, 3], max_new_tokens=2)])
