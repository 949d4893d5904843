"""The port's Trainer and training step on a (data, model) mesh over gloo
on the CPU (spawned ranks), against the JAX package.

* One sharded step on mesh (2, 2) for smollm-360m (4 heads, 2 kv heads),
  deepseek-v2-lite-16b (MoE + MLA: the aux loss's expert loads are summed
  over the DP group) and yi-6b, reduced, against the reference's jitted
  single-device step (the setup of tests/test_distributed.py:33-68): loss
  within 1e-6 relative, params within tests/test_torch_train.py's
  first-step bound; every rank's param and (float) moment bytes against
  the reference's per-device shards.  In float32 (with bf16 compute the DP
  mean of bf16-rounded gradients differs from the whole batch's by up to
  a bf16 ulp) and with the exact top-k k-WTA: on this batch the shipped
  ``bisect`` threshold of one unit sits within an ulp of a tie, and the
  port's single-device loss already parts from the reference's by 2.2e-6
  through that one selection (the reference's own jitted and eager losses
  part by 2.6e-7).
* The Trainer on (1, 1) for 4 steps, checkpointed, resumed on (2, 2) and
  run to 8: the losses of an uninterrupted (1, 1) run within 1e-5
  relative (tests/test_train_loop.py:96); ``ckpt.restore(..., shardings=)``
  onto other specs (tests/test_substrates.py:114).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks
from _zero1_reference import zero1_shardings
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.data import batch_for as j_batch_for
from repro.launch import mesh as jmesh_mod
from repro.launch import steps as JSt
from repro.models import transformer as JT
from repro.optim import init_state as j_init_state
from repro.sharding import make_rules as j_make_rules
from repro.sharding import param_sharding as j_param_sharding
from repro_torch.bridge import train_params_from_jax
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data import batch_for
from repro_torch.launch.ranks import run_ranks
from repro_torch.launch.train import Trainer
from repro_torch.optim import AdamWConfig
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.tree import flatten

needs_devices = pytest.mark.skipif(jax.device_count() < 8,
                                   reason="needs 8 fake CPU devices")

CASES = {"smollm-360m": dict(n_heads=4, n_kv_heads=2),
         "deepseek-v2-lite-16b": {}, "yi-6b": {}}
F32 = dict(compute_dtype="float32", head_pad=0)


def _topk(cfg):
    return dataclasses.replace(cfg, ffn_sparsity=dataclasses.replace(
        cfg.ffn_sparsity, kwta_impl="topk"))


TKW = dict(lr=1e-3, warmup_steps=2, total_steps=20, zero1=True)
REDUCED = dict(d_model=64, d_ff=128, vocab_size=128, n_heads=4,
               n_kv_heads=2, head_pad=0, n_layers=2,
               compute_dtype="float32")


class _Shape:
    seq_len = 32
    global_batch = 4


def _np(tree):
    return jax.tree.map(lambda a: np.zeros(a.shape, np.int8)
                        if a.dtype == jax.dtypes.float0 else np.asarray(a),
                        tree)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The reference's jitted step on one device and the port's sharded
    step on four gloo ranks, for every case."""
    ref, cases = {}, []
    for arch, kw in CASES.items():
        jcfg = _topk(jget_config(arch).reduced(**kw, **F32))
        jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
        batch = j_batch_for(jcfg, _Shape, step=0)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jstep, jacfg = JSt.make_train_step(jcfg, JTrainConfig(**TKW))
        jp, _, jm = jax.jit(jstep)(jparams, j_init_state(jparams, jacfg), jb)
        _, jgrads = jax.jit(jax.value_and_grad(
            lambda p: JT.loss_fn(p, jb, jcfg), has_aux=True,
            allow_int=True))(jparams)
        ref[arch] = (jcfg, jparams, jp, jm, jgrads)
        cases.append((arch, dict(kw, **F32), TKW, _np(jparams), batch))
    out = run_ranks(ranks.sharded_step, 4, tmp_path_factory.mktemp("ranks"),
                    args=(cases, "topk"))
    return ref, {arch: [r[i] for r in out] for i, arch in enumerate(CASES)}


@needs_devices
@pytest.mark.parametrize("arch", list(CASES))
def test_sharded_step_matches_reference_single_device(sharded, arch):
    ref, got = sharded
    jcfg, jparams, jp, jm, jgrads = ref[arch]
    cfg = _topk(get_config(arch).reduced(**CASES[arch], **F32))
    r0 = got[arch][0]
    assert all(r["step"] == 1 for r in got[arch])
    assert r0["rows"] == {"tokens": (2, 32), "labels": (2, 32)}
    for r in got[arch]:
        assert abs(r["loss"] - float(jm["loss"])) <= 1e-6 * abs(
            float(jm["loss"]))
        assert r["loss"] == r0["loss"] and r["aux"] == r0["aux"]
    if cfg.is_moe:
        assert r0["aux"] > 0
    assert abs(r0["grad_norm"] - float(jm["grad_norm"])) <= \
        1e-5 * float(jm["grad_norm"])
    lr = TKW["lr"] * float(warmup_cosine(0, TKW["warmup_steps"],
                                         TKW["total_steps"]))
    clip = min(1.0, 1.0 / float(jm["grad_norm"]))
    eps = AdamWConfig().eps
    want = flatten(train_params_from_jax(_np(jp), cfg, device="cpu"))
    wgrads = dict(flatten(train_params_from_jax(_np(jgrads), cfg,
                                                device="cpu")))

    def first_update(g):
        g = torch.from_numpy(g).double() * clip
        return g / (g.abs() + eps)

    for k, w in want:
        t = torch.from_numpy(r0["params"][k])
        if not w.is_floating_point():
            assert torch.equal(t, w), k
            continue
        moved = lr * (first_update(r0["grads"][k])
                      - first_update(wgrads[k].numpy())).abs()
        excess = (t - w).abs().double() - moved
        assert float(excess.max()) <= 1e-6, (k, float(excess.max()))

    # each rank's bytes: the reference's per-device shards on (2, 2)
    jmesh = jmesh_mod.make_mesh((2, 2), ("data", "model"))
    rules = j_make_rules(jmesh, "train")
    _, jspecs = JT.init_model(jax.random.PRNGKey(0), jcfg)
    zspecs = JSt.zero1_specs(jspecs, jparams, rules)
    mu = j_init_state(jparams, JSt.AdamWConfig())["mu"]
    count = {}
    for name, shardings, tree in (
            ("params", j_param_sharding(jspecs, jparams, rules), jparams),
            ("mu", zero1_shardings(zspecs, mu, rules), mu)):
        count[name] = sum(
            math.prod(s.shard_shape(a.shape)) for s, a, p in zip(
                jax.tree.leaves(shardings), jax.tree.leaves(tree),
                jax.tree.leaves(jparams))
            if name == "params" or jnp.issubdtype(p.dtype, jnp.floating))
    assert count["mu"] < count["params"]
    for r in got[arch]:
        for name in ("params", "mu"):
            assert sum(math.prod(s) for s in r["local"][name].values()) \
                == count[name], (name, r["local"][name])


@needs_devices
def test_trainer_resumes_a_single_device_run_on_a_mesh(tmp_path):
    from repro_torch.configs.base import ShapeConfig
    cfg = get_config("smollm-360m").reduced(**REDUCED)
    shape = ShapeConfig("t", 32, 4, "train")
    tkw = dict(lr=1e-3, total_steps=8, checkpoint_every=4, log_every=100)

    def trainer(d):
        return Trainer(cfg, TrainConfig(ckpt_dir=str(d), **tkw), (1, 1),
                       shape, device="cpu")

    def batch_fn(step):
        return batch_for(cfg, shape, step, seed=0)

    straight, losses = trainer(tmp_path / "a"), []
    check = straight.guard.check
    straight.guard.check = lambda loss: losses.append(loss) or check(loss)
    straight.run(8, batch_fn, log=lambda *a: None)
    first = trainer(tmp_path / "b")
    first.run(4, batch_fn, log=lambda *a: None)
    res = run_ranks(ranks.resume_on_mesh, 4, tmp_path / "ranks",
                    args=(str(tmp_path / "b"), REDUCED, tkw, 8))
    for r in res:
        assert r["resumed"] == 4 and r["step"] == 8
        assert len(r["losses"]) == 4
        for a, b in zip(r["losses"], losses[4:]):
            assert abs(a - b) <= 1e-5 * abs(b), (r["losses"], losses[4:])
    for k, t in flatten(straight.params):
        np.testing.assert_allclose(res[0]["params"][k], t.numpy(), rtol=0,
                                   atol=5e-3, err_msg=k)


@needs_devices
def test_restore_with_shardings_onto_other_specs(tmp_path):
    res = run_ranks(ranks.reshard_restore, 4, tmp_path / "ranks",
                    args=(str(tmp_path / "ckpt"),))
    seen = set()
    for coords, out, x in res:
        for spec, (block, sl) in out.items():
            np.testing.assert_array_equal(block, x[sl])
        d, m = coords["data"], coords["model"]
        np.testing.assert_array_equal(out[(None, "model")][0],
                                      x[:, 4 * m:4 * m + 4])
        np.testing.assert_array_equal(out[("data", "model")][0],
                                      x[4 * d:4 * d + 4, 4 * m:4 * m + 4])
        seen.add((d, m))
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}
