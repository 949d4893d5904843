"""The checks of the training step on the rank's blocks
(``repro_torch.launch.steps.make_sharded_train_step``), shared by
tests/test_torch_tp_train*.py: each file runs its archs on one mesh over
gloo on the CPU (spawned ranks, ``_torch_dist_ranks.tp_train``) and holds
every rank against the reference's ``jax.value_and_grad`` of its
``loss_fn`` on the same numpy weights and batch, in float32 with the
exact top-k k-WTA and remat as shipped:

* the loss within 1e-6 relative;
* every rank's DP-mean gradient block of every leaf within
  1e-5·(1+max|g|) of the reference's gradient cut to that rank's
  per-device block (the bound of tests/test_torch_archs.py);
* the step's ``grad_norm`` within 1e-5 relative of the reference's global
  norm;
* every block that a mesh axis splits has a gradient that is not zero;
* the gradients of the whole leaves, and those leaves after two steps,
  bit-equal across the ``model`` ranks;
* no collective of the loss, its backward or the steps is handed a
  tensor sharing storage with a param block, and ``gather_leaves`` is
  never called inside the steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

import _torch_dist_ranks as ranks
from _torch_serve_ranks import config_of
from repro.configs import get_config as jget_config
from repro.data import batch_for as j_batch_for
from repro.models import transformer as JT
from repro_torch.bridge import train_params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch.ranks import run_ranks
from repro_torch.tree import flatten

F32 = dict(compute_dtype="float32", head_pad=0)
#: smollm with 2 kv heads: k and v whole on (1, 4), blocks on (2, 2)
KW = {"smollm-360m": dict(n_heads=4, n_kv_heads=2)}
TIMEOUT_S = 300.0


class _Shape:
    seq_len = 32
    global_batch = 4


def _topk(cfg):
    return dataclasses.replace(cfg, ffn_sparsity=dataclasses.replace(
        cfg.ffn_sparsity, kwta_impl="topk"))


def _np(tree):
    return jax.tree.map(lambda a: np.zeros(a.shape, np.int8)
                        if a.dtype == jax.dtypes.float0 else np.asarray(a),
                        tree)


def cfg_kw(arch):
    return dict(KW.get(arch, {}), **F32)


def reference(arch, kw=None):
    """The reference's loss, gradients (the port's layout, path -> numpy)
    and global gradient norm, with the numpy weights and batch the ranks
    take; the config ``reduced(**kw)`` (:func:`_torch_serve_ranks.
    config_of`), by default the arch's :func:`cfg_kw`."""
    kw = cfg_kw(arch) if kw is None else kw
    jcfg = _topk(config_of(jget_config, arch, kw))
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    batch = j_batch_for(jcfg, _Shape, step=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, jb, jcfg), has_aux=True,
        allow_int=True))(jparams)
    cfg = _topk(config_of(get_config, arch, kw))
    grads = {k: t.numpy() for k, t in flatten(train_params_from_jax(
        _np(jgrads), cfg, device="cpu")) if t.is_floating_point()}
    norm = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                             for g in grads.values())))
    return {"loss": float(loss), "grads": grads, "norm": norm,
            "case": (arch, kw, _np(jparams), batch)}


def run(archs, dims, workdir, remat_check=False):
    """The references and every rank's results: arch -> (reference, the
    ranks' records in rank order)."""
    refs = {a: reference(a) for a in archs}
    world = int(np.prod(dims))
    out = run_ranks(ranks.tp_train, world, workdir, timeout_s=TIMEOUT_S,
                    threads=2, args=(dims, [refs[a]["case"] for a in archs],
                                     remat_check))
    return {a: (refs[a], [r[i] for r in out]) for i, a in enumerate(archs)}


def check_loss_and_norm(ref, recs):
    for r in recs:
        assert abs(r["loss"] - ref["loss"]) <= 1e-6 * abs(ref["loss"]), (
            r["coords"], r["loss"], ref["loss"])
        assert r["step"] == 2
        assert abs(r["norms"][0] - ref["norm"]) <= 1e-5 * ref["norm"], (
            r["norms"][0], ref["norm"])
        assert r["norms"] == recs[0]["norms"]


def check_grads(ref, recs):
    for r in recs:
        assert set(r["grads"]) <= set(ref["grads"])
        for k in set(ref["grads"]) - set(r["grads"]):
            # a leaf the loss does not reach (the table under embeds)
            assert not np.any(ref["grads"][k]), k
        for k, g in r["grads"].items():
            want = ref["grads"][k][r["blocks"][k]]
            assert g.shape == want.shape, (k, g.shape, want.shape)
            err = float(np.abs(g - want).max())
            assert err <= 1e-5 * (1 + float(np.abs(want).max())), (
                r["coords"], k, err)
            if r["split"][k]:
                assert np.abs(g).max() > 0, (r["coords"], k)


def _model_peers(recs):
    """Pairs of ranks that differ on ``model`` alone."""
    def key(r):
        return tuple(v for a, v in r["coords"].items() if a != "model")
    return [(a, b) for a in recs for b in recs
            if key(a) == key(b) and a["coords"]["model"] <
            b["coords"]["model"]]


def check_whole_leaves(recs):
    pairs = _model_peers(recs)
    assert pairs
    for a, b in pairs:
        assert set(a["local_whole"]) == set(b["local_whole"])
        for k in a["local_whole"]:
            np.testing.assert_array_equal(a["local_whole"][k],
                                          b["local_whole"][k], err_msg=k)
            np.testing.assert_array_equal(a["params_whole"][k],
                                          b["params_whole"][k], err_msg=k)


def check_no_param_handed(recs):
    for r in recs:
        assert r["handed"] == [], (r["coords"], r["handed"][:5])
        assert r["gathers"] == 0


def check_all(ref, recs):
    check_loss_and_norm(ref, recs)
    check_grads(ref, recs)
    check_whole_leaves(recs)
    check_no_param_handed(recs)
