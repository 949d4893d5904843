"""The port's GSC CNN (the paper's Table 1 network) against the JAX
package on the CPU in float32, for the dense, sparse-dense and
sparse-sparse variants, on the reference's ``init_model`` weights bridged
into the port: routes from init, logits, loss and every leaf's gradient
against ``jax.value_and_grad``, the MAC accounting, the compression
ratio; the layers (im2col, conv, maxpool) alone; and training through
the port's AdamW: 20 sparse-sparse steps whose loss falls here, the
reference's 60-step three-variant run under ``slow``.

Tolerances: logits 1e-5 (float32, sums in another order); loss 1e-5 and
each gradient leaf within 1e-5·(1 + max|g|)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layers as JL
from repro.data import gsc_batch as j_gsc_batch
from repro.models import gsc_cnn as JG
from repro_torch.bridge import gsc_params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import layers as L
from repro_torch.core.kwta import kwta_channel
from repro_torch.data import canonical, gsc_batch
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import gsc_cnn as G
from repro_torch.optim import AdamWConfig, apply_updates, init_state
from repro_torch.tree import flatten

VARIANTS = ["dense", "sparse_dense", "sparse_sparse"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module: with torch's default (one a
    core) the suite's parallel workers oversubscribe the CPU, and these
    convolution- and scatter-heavy steps then run ten times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(step, batch=8):
    b = gsc_batch(seed=0, step=step, batch=batch)
    return b, {k: torch.from_numpy(canonical(v)) for k, v in b.items()}


@pytest.fixture(scope="module", params=VARIANTS)
def bridged(request):
    cfg = G.GSCConfig(variant=request.param)
    jcfg = JG.GSCConfig(variant=request.param)
    jparams, _ = JG.init_model(jax.random.PRNGKey(0), jcfg)
    params = gsc_params_from_jax(jax.tree.map(np.asarray, jparams),
                                 device="cpu")
    return cfg, jcfg, jparams, params


def test_registry_and_config_match_reference():
    cfg = get_config("gsc_cnn")
    assert cfg == G.GSCConfig()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JG.GSCConfig())


def test_init_routes_equal_reference(bridged):
    cfg, _, jparams, _ = bridged
    got = dict(flatten(G.init_model(cfg, device="cpu")))
    want = dict(flatten(jax.tree.map(np.asarray, jparams)))
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        if k.endswith("route"):
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    assert "packed_p" not in str(list(got))


def test_forward_loss_and_grads_match_reference(bridged):
    cfg, jcfg, jparams, params = bridged
    b, tb = _batch(3)
    jb = {"x": jnp.asarray(b["x"]), "y": jnp.asarray(b["y"])}
    np.testing.assert_allclose(
        G.forward(params, tb["x"], cfg).detach().numpy(),
        np.asarray(jax.jit(lambda p, x: JG.forward(p, x, jcfg))(
            jparams, jb["x"])), atol=1e-5)

    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JG.loss_fn(p, jb, jcfg), has_aux=True,
        allow_int=True))(jparams)
    (loss, m), grads = value_and_grad(
        lambda p: G.loss_fn(p, tb, cfg), params)
    assert abs(float(loss) - float(jloss)) <= 1e-5
    assert float(m["accuracy"]) == pytest.approx(float(jm["accuracy"]))
    want = dict(flatten(jax.tree.map(np.asarray, jgrads)))
    for (k, t), g in zip(flatten(params), grads):
        if not t.is_floating_point():
            assert g is None, k
            continue
        w = want[k]
        np.testing.assert_allclose(g.numpy(), w, rtol=0, err_msg=k,
                                   atol=1e-5 * (1 + np.abs(w).max()))


def test_theoretical_macs_and_compression():
    for v in VARIANTS:
        assert G.theoretical_macs(G.GSCConfig(variant=v)) == \
            JG.theoretical_macs(JG.GSCConfig(variant=v))
    macs = G.theoretical_macs(G.GSCConfig())
    assert macs["speedup_ss"] > 30 and macs["speedup_ss"] > \
        2 * macs["speedup_sd"]

    def nbytes(variant):
        params = G.init_model(G.GSCConfig(variant=variant), device="cpu")
        return sum(t.numel() * t.element_size() for _, t in flatten(params)
                   if t.is_floating_point())

    assert nbytes("dense") / nbytes("sparse_sparse") > 8


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
def test_conv_layers_match_reference(padding):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 11, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        L.im2col(torch.from_numpy(x), 3, 5, padding=padding).numpy(),
        np.asarray(JL.im2col(jnp.asarray(x), 3, 5, padding=padding)))
    jp, _ = JL.conv2d_init(jax.random.PRNGKey(1), 3, 5, 3, 4)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    np.testing.assert_allclose(
        L.conv2d_apply(tp, torch.from_numpy(x), padding=padding).numpy(),
        np.asarray(JL.conv2d_apply(jp, jnp.asarray(x), padding=padding)),
        atol=1e-5)
    np.testing.assert_array_equal(
        L.maxpool2d(torch.from_numpy(x)).numpy(),
        np.asarray(JL.maxpool2d(jnp.asarray(x))))


def test_sparse_sparse_activation_sparsity():
    cfg = G.GSCConfig()
    params = G.init_model(cfg, device="cpu")
    _, tb = _batch(0)
    assert torch.isfinite(G.forward(params, tb["x"], cfg)).all()
    h = torch.from_numpy(np.random.default_rng(2).normal(
        size=(8, 10, 10, 64)).astype(np.float32))
    hk = kwta_channel(torch.relu(h), cfg.conv_k)
    assert float((hk == 0).float().mean()) > 0.85


def test_batches_bit_identical_to_reference():
    for step in (0, 7):
        got, want = gsc_batch(3, step, 16), j_gsc_batch(3, step, 16)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def _train(variant, steps, batch=32):
    """The reference test's loop (tests/test_gsc_e2e.py): AdamW lr 2e-3,
    wd 0.01, batch 32 of ``gsc_batch``."""
    cfg = G.GSCConfig(variant=variant)
    params = G.init_model(cfg, device="cpu")
    acfg = AdamWConfig(lr=2e-3, weight_decay=0.01)
    opt = init_state(params, acfg)
    losses = []
    for s in range(steps):
        _, tb = _batch(s, batch)
        (loss, _), grads = value_and_grad(
            lambda p: G.loss_fn(p, tb, cfg), params)
        apply_updates(params, grads, opt, acfg)
        losses.append(float(loss))
    return losses


def test_sparse_sparse_trains_20_steps():
    losses = _train("sparse_sparse", 20)
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < losses[0], losses


@pytest.mark.slow
@pytest.mark.parametrize("variant", VARIANTS)
def test_gsc_trains(variant):
    losses = _train(variant, 60)
    assert losses[-1] < losses[0] * 0.7, (variant, losses[0], losses[-1])
