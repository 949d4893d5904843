"""Block remat in the training forward (``ModelConfig.remat``, the
reference's ``jax.checkpoint`` around each block's apply,
``repro/models/transformer.py:235-238``), on the CPU in float32:

* smollm-360m and zamba2-1.2b reduced (zamba2's blocks nest
  ``ssd_scan``'s chunk checkpoints inside the block's), with the exact
  top-k k-WTA (on this batch smollm's shipped ``bisect`` threshold of one
  unit sits within an ulp of a tie, as tests/test_torch_distributed_train.py
  found: the port's loss parts from the reference's by 1.4e-5 through
  that one selection, with remat or without): the loss and every
  gradient leaf with remat bit-equal to those without, and both within
  1e-5·(1+max|g|) of the reference's ``jax.value_and_grad`` (the bound
  of tests/test_torch_archs.py);
* the census of one loss and backward: the storages' peak with remat
  strictly below the peak without it;
* the backward's recompute runs quiet: a support capture and the Select
  counters see each block once, as without remat;
* one sharded step on mesh (2, 2) over gloo with remat gives the step
  without it, params bit-equal.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks
from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro_torch.bridge import train_params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.instrument import count_selects
from repro_torch.data import canonical, lm_batch
from repro_torch.launch import steps as St
from repro_torch.launch.hlo import census
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import transformer as T
from repro_torch.obs.sparsity import capture_supports
from repro_torch.tree import flatten

BASE = dict(compute_dtype="float32", head_pad=0)


def _topk(cfg):
    return dataclasses.replace(cfg, ffn_sparsity=dataclasses.replace(
        cfg.ffn_sparsity, kwta_impl="topk"))
ARCHS = ["smollm-360m", "zamba2-1.2b"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(lambda a: np.zeros(a.shape, np.int8)
                        if a.dtype == jax.dtypes.float0 else np.asarray(a),
                        tree)


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    arch = request.param
    jcfg = _topk(jget_config(arch).reduced(**BASE))
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    return arch, jcfg, _np(jparams), _batch(jcfg)


def _batch(cfg):
    """tests/test_torch_train.py's batch: 4 sequences of 32 tokens."""
    return lm_batch(0, 0, 4, 32, cfg.vocab_size)


def _torch(batch):
    return {k: torch.from_numpy(canonical(v)) for k, v in batch.items()}


def _cfg(arch, remat):
    return _topk(get_config(arch).reduced(**BASE, remat=remat))


def _grads(arch, npp, batch, remat):
    cfg = _cfg(arch, remat)
    train = train_params_from_jax(npp, cfg, device="cpu")
    (loss, _), grads = St.value_and_grad(
        lambda p: T.loss_fn(p, _torch(batch), cfg), train)
    return train, loss, grads


def test_remat_gradients_equal_the_plain_ones_and_the_reference(bridged):
    arch, jcfg, npp, batch = bridged
    assert jcfg.remat
    train, loss, grads = _grads(arch, npp, batch, True)
    _, loss0, grads0 = _grads(arch, npp, batch, False)
    assert torch.equal(loss, loss0)
    for (k, _), g, g0 in zip(flatten(train), grads, grads0):
        assert (g is None) == (g0 is None), k
        assert g is None or torch.equal(g, g0), k
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, batch, jcfg), has_aux=True,
        allow_int=True))(jax.tree.map(jax.numpy.asarray, npp))
    assert abs(float(loss) - float(jloss)) <= 1e-5
    cfg = _cfg(arch, True)
    want = flatten(train_params_from_jax(_np(jgrads), cfg, device="cpu"))
    for (k, p), g, (_, w) in zip(flatten(train), grads, want):
        if not p.is_floating_point():
            continue
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, err_msg=k,
                                   atol=1e-5 * (1 + np.abs(w.numpy()).max()))


def test_remat_lowers_the_census_peak(bridged):
    arch, _, npp, batch = bridged
    peaks = {}
    for remat in (False, True):
        cfg = _cfg(arch, remat)
        train = train_params_from_jax(npp, cfg, device="cpu")
        rec = census(lambda p: St.value_and_grad(
            lambda q: T.loss_fn(q, _torch(batch), cfg), p)[0][0], train)
        peaks[remat] = rec["memory"]["peak_bytes_est"]
    print(f"{arch}: census peak with remat / without "
          f"{peaks[True]} / {peaks[False]} = {peaks[True] / peaks[False]:.3f}")
    assert peaks[True] < peaks[False]


def test_the_recompute_counts_nothing_twice(bridged):
    """A support capture and the Select counters over one loss and
    backward see the same sites, each once, with remat as without."""
    arch, _, npp, batch = bridged
    seen = {}
    for remat in (False, True):
        cfg = _cfg(arch, remat)
        train = train_params_from_jax(npp, cfg, device="cpu")
        with capture_supports() as cap, count_selects() as sel:
            St.value_and_grad(lambda p: T.loss_fn(p, _torch(batch), cfg),
                              train)
        seen[remat] = ({k: sorted(v) for k, v in cap.entries.items()},
                       sel.top_k)
    assert seen[True] == seen[False]
    assert seen[True][0]


def test_sharded_step_with_remat_is_the_plain_step(tmp_path):
    """smollm reduced on mesh (2, 2): one step from the same state with
    and without remat, the loss and the params after it bit-equal."""
    jcfg = jget_config("smollm-360m").reduced(**BASE)
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    batch = _batch(jcfg)
    out = run_ranks(ranks.sharded_remat, math.prod((2, 2)), tmp_path,
                    args=("smollm-360m", BASE, _np(jparams), batch),
                    threads=1)
    for r in out:
        assert r[True]["loss"] == r[False]["loss"]
    plain, remat = out[0][False]["params"], out[0][True]["params"]
    assert plain.keys() == remat.keys()
    for k in plain:
        assert np.array_equal(plain[k], remat[k]), k


def test_the_recompute_runs_under_the_rules_of_the_forward(tmp_path):
    """qwen3-moe reduced on mesh (2, 1), each rank's rows under the
    training rules, the backward on a thread of its own (autograd's
    device thread on the card holds none of the forward's thread-locals):
    with remat the recompute still sums the MoE load-balancing loss over
    the DP group, so the loss and every gradient leaf equal those without
    remat, bit for bit."""
    arch = "qwen3-moe-235b-a22b"
    batch = _batch(get_config(arch).reduced(**BASE))
    out = run_ranks(ranks.remat_other_thread, 2, tmp_path,
                    args=(arch, BASE, batch), threads=1)
    for r in out:
        assert r[True]["loss"] == r[False]["loss"]
        assert len(r[True]["grads"]) == len(r[False]["grads"])
        for i, (g, g0) in enumerate(zip(r[True]["grads"], r[False]["grads"])):
            assert np.array_equal(g, g0), i
