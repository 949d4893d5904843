"""The port's LM training path against the JAX package on the CPU, on
smollm-360m reduced as tests/test_train_loop.py cuts it, in float32 on
the reference's ``init_model`` weights bridged into the training layout,
with the ``bisect`` k-WTA (the shipped config's) and with exact top-k:
``loss_fn`` within 1e-5, every leaf's gradient within 1e-5·(1+max|g|) of
``jax.value_and_grad``, the params after one ``make_train_step`` step
within 1e-6 of the reference's jitted step.  Then the training layout
(float32 masters, no ``packed_p``) and the serving params made from it,
the fault-tolerant ``Trainer`` (the four tests of
tests/test_train_loop.py), and the CLI."""

import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.launch import steps as JSt
from repro.models import transformer as JT
from repro.models.common import cross_entropy as j_cross_entropy
from repro.optim import init_state as j_init_state
from repro_torch import checkpoint as ckpt
from repro_torch.bridge import params_from_jax, train_params_from_jax
from repro_torch.configs import TrainConfig, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.layers import partition_major
from repro_torch.data import batch_for, canonical, lm_batch
from repro_torch.launch import steps as St
from repro_torch.launch.train import Trainer, main as train_main
from repro_torch.models import transformer as T
from repro_torch.models.common import cross_entropy
from repro_torch.optim import AdamWConfig, init_state
from repro_torch.tree import flatten

REDUCED = dict(d_model=64, d_ff=128, vocab_size=128, n_heads=4,
               n_kv_heads=2, head_pad=0, n_layers=2)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module: with torch's default (one a
    core) the suite's parallel workers oversubscribe the CPU, and these
    convolution- and scatter-heavy steps then run ten times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(kwta_impl, **kw):
    def cut(c):
        c = c.reduced(**REDUCED, **kw)
        return dataclasses.replace(c, ffn_sparsity=dataclasses.replace(
            c.ffn_sparsity, kwta_impl=kwta_impl))
    return cut(jget_config("smollm-360m")), cut(get_config("smollm-360m"))


def _np(tree):
    """A JAX tree as numpy; float0 (an int leaf's gradient) as int8 0s."""
    return jax.tree.map(lambda a: np.zeros(a.shape, np.int8)
                        if a.dtype == jax.dtypes.float0 else np.asarray(a),
                        tree)


@pytest.fixture(scope="module", params=["bisect", "topk"])
def bridged(request):
    """Both packages' loss and gradients on one batch: the reference's
    jitted, as its training step takes them."""
    jcfg, cfg = _cfgs(request.param, compute_dtype="float32")
    assert cfg.ffn_sparsity.n == 4 and cfg.ffn_sparsity.activation_sparse
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    params = train_params_from_jax(_np(jparams), cfg, device="cpu")
    b = lm_batch(0, 0, 4, 32, cfg.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(canonical(v)) for k, v in b.items()}
    jout = jax.jit(jax.value_and_grad(lambda p: JT.loss_fn(p, jb, jcfg),
                                      has_aux=True, allow_int=True))(jparams)
    out = St.value_and_grad(lambda p: T.loss_fn(p, tb, cfg), params)
    return jcfg, cfg, jparams, params, (jb, tb), jout, out


def test_loss_and_grads_match_reference(bridged):
    jcfg, cfg, jparams, params, _, ((jloss, jm), jgrads), out = bridged
    (loss, m), grads = out
    assert abs(float(loss) - float(jloss)) <= 1e-5
    assert abs(float(m["lm_loss"]) - float(jm["lm_loss"])) <= 1e-5
    assert float(m["aux_loss"]) == float(jm["aux_loss"]) == 0.0
    want = flatten(train_params_from_jax(_np(jgrads), cfg, device="cpu"))
    got = flatten(params)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, p), g, (_, w) in zip(got, grads, want):
        if not p.is_floating_point():
            assert g is None, k
            continue
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, err_msg=k,
                                   atol=1e-5 * (1 + np.abs(w).max()))


def test_one_train_step_matches_reference_jit(bridged):
    """Params after one step within 1e-6 of the reference's jitted step,
    beyond what the measured gradient difference moves Adam's first
    update g/(|g| + eps): where |g| is near eps (1e-8) a gradient that
    agrees to 1e-10 still moves that update by up to 1e-2 (the head's
    tiny-gradient entries)."""
    jcfg, cfg, jparams, params, (jb, tb), (_, jgrads), (_, grads) = bridged
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    jstep, jacfg = JSt.make_train_step(jcfg, JTrainConfig(**kw))
    jp, _, jm = jax.jit(jstep)(jparams, j_init_state(jparams, jacfg), jb)
    step, acfg = St.make_train_step(cfg, TrainConfig(**kw))
    tp = train_params_from_jax(_np(jparams), cfg, device="cpu")
    opt = init_state(tp, acfg)
    _, _, m = step(tp, opt, tb)
    assert int(opt["step"]) == 1
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
        1e-5 * float(jm["grad_norm"])
    lr = kw["lr"] * float(St.warmup_cosine(0, 2, 20))
    clip = min(1.0, 1.0 / float(jm["grad_norm"]))
    want = flatten(train_params_from_jax(_np(jp), cfg, device="cpu"))
    wgrads = flatten(train_params_from_jax(_np(jgrads), cfg, device="cpu"))

    def first_update(g):
        g = g.double() * clip
        return g / (g.abs() + acfg.eps)

    for (k, t), (_, w), g, (_, gw) in zip(flatten(tp), want, grads, wgrads):
        if not t.is_floating_point():
            assert torch.equal(t, w), k
            continue
        moved = lr * (first_update(g) - first_update(gw)).abs()
        excess = (t - w).abs().double() - moved
        assert float(excess.max()) <= 1e-6, (k, float(excess.max()))


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(3, 5, 11)) * 4).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5))
    mask = rng.random((3, 5)) < 0.6
    for m in (None, mask, np.zeros_like(mask)):
        got = cross_entropy(torch.from_numpy(logits).to(torch.bfloat16),
                            torch.from_numpy(labels),
                            None if m is None else torch.from_numpy(m))
        want = j_cross_entropy(jnp.asarray(logits, jnp.bfloat16),
                               jnp.asarray(labels),
                               None if m is None else jnp.asarray(m))
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 1e-5


def test_serve_prefill_and_opt_steps():
    """``make_prefill_step`` gives the forward's last logits,
    ``make_serve_step`` the decode step's, ``make_opt_step`` AdamW with
    the default hyper-parameters and the run's moment dtype, in place."""
    cfg = get_config("smollm-360m").reduced(**REDUCED,
                                            compute_dtype="float32")
    params = T.init_model(cfg, seed=2, device="cpu")
    tokens = torch.from_numpy(canonical(lm_batch(1, 0, 2, 8,
                                                 cfg.vocab_size)["tokens"]))
    with torch.no_grad():
        last = St.make_prefill_step(cfg)(params, {"tokens": tokens})
        logits, cache = T.prefill(params, {"tokens": tokens}, cfg, 12)
        assert torch.equal(last, T.forward(params, {"tokens": tokens},
                                           cfg)[0][:, -1])
        np.testing.assert_allclose(last.numpy(), logits[:, -1].numpy(),
                                   atol=1e-5)
        nxt = torch.argmax(logits[:, -1:], -1)
        # the decode step writes row 8 in place: both calls write the same
        want, _ = T.serve_step(params, cache, {"tokens": nxt}, 8, cfg)
        got, _ = St.make_serve_step(cfg)(params, cache, {"tokens": nxt}, 8)
    assert torch.equal(got, want)
    tcfg = TrainConfig(moment_dtype="bfloat16")
    train = T.init_train_params(cfg, seed=2, device="cpu")
    grads = [torch.ones_like(t) if t.is_floating_point() else None
             for _, t in flatten(train)]
    opt = init_state(train, AdamWConfig(moment_dtype=torch.bfloat16))
    before = {k: t.clone() for k, t in flatten(train)}
    St.make_opt_step(cfg, tcfg)(train, grads, opt)
    assert int(opt["step"]) == 1
    assert opt["mu"]["final_norm"]["scale"].dtype == torch.bfloat16
    for k, t in flatten(train):
        if t.is_floating_point():
            assert not torch.equal(t, before[k]), k
        else:
            assert torch.equal(t, before[k]), k


def test_training_layout_and_serving_params():
    cfg = get_config("smollm-360m").reduced(**REDUCED)
    params = T.init_train_params(cfg, seed=3, device="cpu")
    flat = flatten(params)
    assert not any("packed_p" in k for k, _ in flat)
    assert all(t.dtype == torch.float32 for _, t in flat
               if t.is_floating_point())
    serving = T.serving_params(params, cfg)
    want = T.init_model(cfg, seed=3, device="cpu")
    assert [k for k, _ in flatten(serving)] == [k for k, _ in flatten(want)]
    for (k, a), (_, b) in zip(flatten(serving), flatten(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    # serving is a copy: an update in place of the masters does not reach it
    up = params["layers"][0]["ffn"]["down"]["packed"]
    before = serving["layers"][0]["ffn"]["down"]["packed_p"].clone()
    up.add_(1.0)
    assert torch.equal(serving["layers"][0]["ffn"]["down"]["packed_p"],
                       before)
    fresh = T.serving_params(params, cfg)["layers"][0]["ffn"]["down"]
    assert torch.equal(fresh["packed_p"], partition_major(fresh["packed"]))
    # the bridge's serving params equal serving params from its training ones
    jcfg, cfg2 = _cfgs("bisect")
    jparams, _ = JT.init_model(jax.random.PRNGKey(1), jcfg)
    a = params_from_jax(_np(jparams), cfg2, device="cpu")
    b = T.serving_params(train_params_from_jax(_np(jparams), cfg2,
                                               device="cpu"), cfg2)
    for (k, x), (_, y) in zip(flatten(a), flatten(b), strict=True):
        assert torch.equal(x, y), k


# ---------------------------------------------------------------------------
# the Trainer (tests/test_train_loop.py's four tests)
# ---------------------------------------------------------------------------

def _mk_trainer(tmp_path, total=20, seed=0, log_every=100):
    cfg = get_config("smollm-360m").reduced(**REDUCED)
    shape = ShapeConfig("t", 32, 4, "train")
    tcfg = TrainConfig(lr=1e-3, total_steps=total, ckpt_dir=str(tmp_path),
                       checkpoint_every=5, log_every=log_every, seed=seed)
    trainer = Trainer(cfg, tcfg, (1, 1), shape, device="cpu")
    batch_fn = lambda step: batch_for(cfg, shape, step, seed=seed)  # noqa
    return trainer, batch_fn, cfg, shape


def test_train_loss_decreases(tmp_path):
    trainer, batch_fn, *_ = _mk_trainer(tmp_path, total=30)
    logs = []
    trainer.run(30, batch_fn, log=logs.append)
    assert trainer.step == 30
    assert trainer.guard.ema is not None
    ev = trainer.monitor.events
    assert len(ev) == 30 and trainer.monitor.summary()["steps"] == 30
    assert ckpt.latest_step(str(tmp_path)) == 30


def test_resume_is_deterministic(tmp_path):
    """Train 10 straight vs train 5 + crash + resume 5: identical
    parameters (stateless data + exact checkpoint restore)."""
    t1, batch_fn, *_ = _mk_trainer(tmp_path / "a", total=10)
    t1.run(10, batch_fn)
    ref = [t.float() for _, t in flatten(t1.params) if t.is_floating_point()]

    t2, batch_fn2, *_ = _mk_trainer(tmp_path / "b", total=10)
    t2.run(5, batch_fn2)
    assert t2.step == 5
    # new trainer = simulated restart
    t3, batch_fn3, *_ = _mk_trainer(tmp_path / "b", total=10)
    assert t3.try_resume(), "no checkpoint found after phase 1"
    assert t3.step == 5
    t3.run(10, batch_fn3)
    got = [t.float() for _, t in flatten(t3.params) if t.is_floating_point()]
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_rollback_on_nan(tmp_path):
    trainer, batch_fn, *_ = _mk_trainer(tmp_path, total=10)
    trainer.run(6, batch_fn)  # writes a checkpoint at step 5
    # poison the guard as if a NaN appeared
    assert not trainer.guard.check(float("nan"))
    assert trainer.rollback()
    # run(6) checkpoints its final step; rollback restores it and skips one
    assert trainer.step == 7
    trainer.run(10, batch_fn)
    assert trainer.step == 10


def test_preemption_checkpoint(tmp_path):
    trainer, batch_fn, *_ = _mk_trainer(tmp_path, total=100, log_every=1)
    old = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    trainer.install_preemption_handler()
    count = {"n": 0}

    def log(*a):
        count["n"] += 1
        if count["n"] == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    try:
        final = trainer.run(100, batch_fn, log=log)
    finally:
        for s, h in old.items():
            signal.signal(s, h)
    assert final < 100, "preemption did not stop the loop"
    assert ckpt.latest_step(trainer.tcfg.ckpt_dir) == final
    # the reference's checkpoint reader lists the port's directory
    assert jckpt.latest_step(trainer.tcfg.ckpt_dir) == final


def test_cli_trains_on_cpu_and_resumes(tmp_path, capsys):
    args = ["--arch", "smollm-360m", "--steps", "3", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    train_main(args)
    out = capsys.readouterr().out
    assert "finished at step 3" in out and "on cpu" in out
    train_main(args[:3] + ["5"] + args[4:] + ["--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "finished at step 5" in out
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        train_main(args + ["--mesh", "2x2"])
