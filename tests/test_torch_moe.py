"""The port's MoE block (``repro_torch.models.moe``) against the JAX
package's, in float32, with the JAX ``init_model`` weights bridged into
the port: ``moe_apply`` outputs and aux loss on qwen3-moe reduced (no
shared experts) and deepseek-v2-lite reduced (shared experts), with and
without capacity drops; the mirrors of tests/test_models_blocks.py's MoE
tests; the dispatch against a loop over the assignments; the bridge's
leaves and the port's own init.  The engine's tests are in
tests/test_torch_moe_engine.py.

Tolerance 1e-5 on outputs and aux (float32, sums in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

ATOL = 1e-5
BASE = dict(head_pad=0, compute_dtype="float32", param_dtype="float32")
ARCHS = ("qwen3-moe-235b-a22b", "deepseek-v2-lite-16b")


def _cfgs(arch, **overrides):
    kw = dict(BASE, **overrides)
    return jget_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


def _bridged(jcfg, cfg, seed=0):
    jparams, _ = JT.init_model(jax.random.PRNGKey(seed), jcfg)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, cfg = _cfgs(request.param)
    jparams, params = _bridged(jcfg, cfg)
    return jcfg, cfg, jparams, params


def _layer0(jparams, params):
    """The first MoE block's params in both packages."""
    jmoe = jax.tree.map(lambda a: a[0], jparams["units"]["b0"]["moe"])
    return jmoe, params["layers"][0]["moe"]


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _moe_pair(jcfg, cfg, jmoe, moe, x):
    jy, jaux = JM.moe_apply(jmoe, jnp.asarray(x), jcfg, jcfg.ffn_sparsity)
    y, aux = M.moe_apply(moe, torch.from_numpy(x), cfg, cfg.ffn_sparsity)
    return np.asarray(jy), float(jaux), y.numpy(), float(aux)


@pytest.mark.parametrize("shape", [(2, 16), (4, 1), (1, 5)])
def test_moe_apply_matches_the_reference(model, shape):
    """Prefill-shaped (2 x 16), decode-shaped (4 slots x 1) and a ragged
    group (1 x 5): outputs and aux within 1e-5."""
    jcfg, cfg, jparams, params = model
    jmoe, moe = _layer0(jparams, params)
    x = _x((*shape, cfg.d_model))
    jy, jaux, y, aux = _moe_pair(jcfg, cfg, jmoe, moe, x)
    assert ("shared" in moe) == (cfg.n_shared_experts > 0)
    np.testing.assert_allclose(y, jy, atol=ATOL)
    assert abs(aux - jaux) <= ATOL


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_match_the_reference(arch):
    """capacity_factor 0.3: C = ceil(16·2/4·0.3) = 3 slots an expert for
    32 assignments, so most drop; the kept ones and the aux agree."""
    jcfg, cfg = _cfgs(arch, capacity_factor=0.3)
    jparams, params = _bridged(jcfg, cfg)
    jmoe, moe = _layer0(jparams, params)
    x = _x((2, 16, cfg.d_model), seed=2)
    xt = torch.from_numpy(x).reshape(2, 16, -1)
    _, top_e = M.router_top_k(torch.softmax(
        (xt @ moe["router"]).float(), -1), cfg.experts_per_token)
    cap = int(np.ceil(16 * cfg.experts_per_token / cfg.n_experts * 0.3))
    counts = torch.stack([torch.bincount(top_e[g].reshape(-1),
                                         minlength=cfg.n_experts)
                          for g in range(2)])
    assert int((counts - cap).clamp(min=0).sum()) > 8   # drops happen
    jy, jaux, y, aux = _moe_pair(jcfg, cfg, jmoe, moe, x)
    np.testing.assert_allclose(y, jy, atol=ATOL)
    assert abs(aux - jaux) <= ATOL


def _dispatch_loop(x, top_e, e, cap):
    """The reference's dispatch as a loop over one group's assignments in
    stable expert order: the buffer and each (token, choice)'s slot."""
    tg, k = top_e.shape
    buf = np.zeros((e, cap, x.shape[-1]), x.dtype)
    slot = -np.ones((tg, k), np.int64)
    fill = [0] * e
    for j in np.argsort(top_e.reshape(-1), kind="stable"):
        t, c = divmod(int(j), k)
        ex = int(top_e[t, c])
        if fill[ex] < cap:
            buf[ex, fill[ex]] = x[t]
            slot[t, c] = fill[ex]
        fill[ex] += 1
    return buf, slot


def test_dispatch_matches_a_loop_and_drops_add_nothing():
    """Ranks, the kept flag and the buffer of ``_dispatch`` against a loop
    over the assignments; a dropped assignment leaves the kept token at
    (e, C-1) as it was (the reference adds a zero source there)."""
    rng = np.random.default_rng(3)
    groups, tg, k, e, cap, d = 3, 7, 3, 4, 2, 5
    x = rng.standard_normal((groups, tg, d)).astype(np.float32)
    top_e = np.stack([np.stack([rng.permutation(e)[:k] for _ in range(tg)])
                      for _ in range(groups)])
    buf, rank, keep = M._dispatch(torch.from_numpy(x),
                                  torch.from_numpy(top_e), e, k, cap)
    assert buf.shape == (groups, e, cap, d)
    for g in range(groups):
        want_buf, slot = _dispatch_loop(x[g], top_e[g], e, cap)
        np.testing.assert_array_equal(buf[g].numpy(), want_buf)
        np.testing.assert_array_equal(keep[g].numpy(), slot >= 0)
        np.testing.assert_array_equal(rank[g].numpy()[slot >= 0],
                                      slot[slot >= 0])
        assert (rank[g].numpy()[slot < 0] >= cap).all()


def test_moe_conserves_tokens_and_balances():
    """The mirror of tests/test_models_blocks.py's: with generous capacity
    nothing drops; finite outputs of x's shape; aux ~ 1 for near-uniform
    routing.  Then against the reference on the same weights."""
    jcfg, cfg = _cfgs("qwen3-moe-235b-a22b", n_experts=4,
                      experts_per_token=2, capacity_factor=4.0)
    jparams, params = _bridged(jcfg, cfg)
    jmoe, moe = _layer0(jparams, params)
    x = _x((2, 16, cfg.d_model), seed=4)
    y, aux = M.moe_apply(moe, torch.from_numpy(x), cfg, cfg.ffn_sparsity)
    assert y.shape == x.shape
    assert bool(torch.isfinite(y).all())
    assert 0.5 < float(aux) < 10.0
    jy, jaux, _, _ = _moe_pair(jcfg, cfg, jmoe, moe, x)
    np.testing.assert_allclose(y.numpy(), jy, atol=ATOL)
    assert abs(float(aux) - jaux) <= ATOL


def test_moe_group_vs_global_equivalence():
    """The mirror of tests/test_models_blocks.py's: grouped dispatch (4
    groups) computes the single-group function when capacity does not
    bind."""
    _, cfg = _cfgs("qwen3-moe-235b-a22b", n_experts=4, experts_per_token=2,
                   capacity_factor=8.0)
    moe = T.init_model(cfg, seed=0, device="cpu")["layers"][0]["moe"]
    x = torch.from_numpy(_x((4, 8, cfg.d_model), seed=5))
    y4, _ = M.moe_apply(moe, x, cfg, cfg.ffn_sparsity)
    y1, _ = M.moe_apply(moe, x.reshape(1, 32, -1), cfg, cfg.ffn_sparsity)
    np.testing.assert_allclose(y4.reshape(1, 32, -1).numpy(), y1.numpy(),
                               atol=1e-4)


def test_combine_is_deterministic_and_in_top_k_order():
    """Two calls give the same bits; the router's choices come largest
    first, as ``lax.top_k`` gives them."""
    _, cfg = _cfgs("deepseek-v2-lite-16b")
    moe = T.init_model(cfg, seed=1, device="cpu")["layers"][1]["moe"]
    x = torch.from_numpy(_x((3, 6, cfg.d_model), seed=6))
    a, _ = M.moe_apply(moe, x, cfg, cfg.ffn_sparsity)
    b, _ = M.moe_apply(moe, x, cfg, cfg.ffn_sparsity)
    assert torch.equal(a, b)
    probs = torch.softmax(torch.randn(5, 4, generator=torch.Generator()
                                      .manual_seed(0)), -1)
    vals, idx = M.router_top_k(probs, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_forward_logits_and_aux_match_the_reference(model):
    """The whole stack: logits and the summed aux of every MoE block."""
    jcfg, cfg, jparams, params = model
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 12))
    jl, jaux = JT.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, aux = T.forward(params, {"tokens": torch.from_numpy(toks)}, cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    assert abs(float(aux) - float(jaux)) <= ATOL * cfg.n_layers


def test_bridge_gives_routed_experts_no_partition_major_copy(model):
    """Only layers that reach ``topk_gather`` hold ``packed_p``: the shared
    experts' projections, never the routed experts' (E, G, P, N)."""
    _, cfg, _, params = model
    for layer in params["layers"]:
        moe = layer["moe"]
        for proj in ("up", "gate", "down"):
            assert moe[proj]["packed"].ndim == 4
            assert "packed_p" not in moe[proj]
        if "shared" in moe:
            for proj in ("up", "gate", "down"):
                p = moe["shared"][proj]
                assert torch.equal(p["packed_p"],
                                   p["packed"].transpose(0, 1))


def test_init_model_has_the_references_leaves(model):
    """The port's own init: the bridged layout leaf for leaf, the
    reference's numpy routes bit for bit, value ranges; bare MLA weights
    and the router cast to the compute dtype once."""
    jcfg, cfg, jparams, ref = model
    params = T.init_model(cfg, seed=0, device="cpu")
    assert T.param_count(params) == T.param_count(ref) == \
        JT.param_count(jparams)

    def walk(a, b, path=""):
        assert type(a) is type(b), path
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b, strict=True)):
                walk(x, y, f"{path}/{i}")
        else:
            assert a.shape == b.shape and a.dtype == b.dtype, path
            if path.endswith("route"):
                assert torch.equal(a, b), path
    walk(params, ref)
    up = params["layers"][0]["moe"]["up"]["packed"]
    assert float(up.abs().max()) <= np.sqrt(4 / cfg.d_model)
    bf = T.init_model(dataclasses.replace(cfg, compute_dtype="bfloat16"),
                      device="cpu")
    layer = bf["layers"][0]
    assert layer["moe"]["router"].dtype == torch.bfloat16
    assert layer["moe"]["down"]["route"].dtype == torch.int8
    if cfg.use_mla:
        assert {v.dtype for v in layer["mixer"].values()} == {torch.bfloat16}
