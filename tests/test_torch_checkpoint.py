"""The port's checkpoints and training monitors on the CPU: round trip of
float32, bfloat16 (stored as its 2-byte view) and int leaves, atomicity,
corruption, pruning, leaf-path checks, ``save_async`` while the tree is
updated in place; the reference's ``repro.checkpoint`` lists the port's
directory (the on-disk layout is shared); ``StepMonitor`` and
``LossGuard`` as tests/test_substrates.py and tests/test_obs.py hold the
reference's, and against the reference's on the same event stream."""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.obs.metrics import Registry as JRegistry
from repro.runtime import LossGuard as JLossGuard
from repro.runtime import StepMonitor as JStepMonitor
from repro_torch import checkpoint as ckpt
from repro_torch.obs.metrics import Registry
from repro_torch.runtime import LossGuard, StepMonitor
from repro_torch.tree import flatten


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int8),
                  "m": torch.randn((4, 3), generator=g).to(torch.bfloat16)},
            "layers": [{"w": torch.randn((2, 2), generator=g)}
                       for _ in range(2)],
            "step": torch.tensor(3, dtype=torch.int32)}


def _assert_equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), k


def test_checkpoint_roundtrip_is_exact(tmp_path):
    d = str(tmp_path)
    tree = _tree()
    path = ckpt.save(d, 10, tree, extra={"note": "x"})
    step, restored, extra = ckpt.restore_latest(d, _tree(seed=1))
    assert step == 10 and extra["note"] == "x"
    _assert_equal(restored, tree)
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["treedef"] == [k for k, _ in flatten(tree)]
    dtypes = {m["dtype"] for m in manifest["leaves"].values()}
    assert dtypes == {"float32", "int8", "bfloat16", "int32"}
    # the reference reads the layout: steps, the marker, the npz's leaves
    assert jckpt.list_steps(d) == [10] and jckpt.latest_step(d) == 10
    with np.load(os.path.join(path, "shard_p0.npz")) as data:
        assert sorted(data.files) == sorted(manifest["leaves"])


def test_checkpoint_atomic_ignores_uncommitted(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 5, _tree())
    # a crash mid-write: a step dir without the .done marker, a tmp dir
    os.makedirs(os.path.join(d, "step_00000009"))
    os.makedirs(os.path.join(d, "step_00000011.tmp.1.2"))
    assert ckpt.latest_step(d) == 5
    assert jckpt.latest_step(d) == 5


def test_checkpoint_detects_corruption_and_structure(tmp_path):
    d = str(tmp_path)
    tree = _tree()
    path = ckpt.save(d, 3, tree)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(d, 3, {"a": tree["a"]})
    shard = os.path.join(path, "shard_p0.npz")
    data = dict(np.load(shard))
    data["leaf_00000"] = data["leaf_00000"] + 1.0  # corrupt
    np.savez(shard, **data)
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore(d, 3, tree)


def test_checkpoint_prune(tmp_path):
    d = str(tmp_path)
    for s in [1, 2, 3, 4, 5]:
        ckpt.save(d, s, _tree())
    ckpt.prune(d, keep=2)
    assert ckpt.list_steps(d) == [4, 5]
    assert not os.path.exists(os.path.join(d, "step_00000003.done"))


def test_save_async_is_a_snapshot_under_in_place_updates(tmp_path):
    d = str(tmp_path)
    tree = _tree()
    want = {"a": tree["a"].clone(), "b": {k: v.clone() for k, v in
                                          tree["b"].items()},
            "layers": [{"w": x["w"].clone()} for x in tree["layers"]],
            "step": tree["step"].clone()}
    t = ckpt.save_async(d, 7, tree)
    # the trainer goes on updating its tensors in place at once
    for _ in range(50):
        tree["a"].add_(1.0)
        tree["b"]["m"].mul_(2)
        tree["layers"][1]["w"].zero_()
    t.join(timeout=30)
    assert not t.is_alive()
    _, restored, _ = ckpt.restore_latest(d, tree)
    _assert_equal(restored, want)


def test_concurrent_saves_of_one_step(tmp_path):
    """Async saves racing a sync save of one step (the Trainer's last
    periodic save and its final one): every writer returns, one commit
    stands, no tmp dir is left.  A short switch interval makes the
    threads interleave inside the commit."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    errors = []
    hook = threading.excepthook
    threading.excepthook = lambda args: errors.append(args.exc_value)
    try:
        for i in range(10):
            d = str(tmp_path / str(i))
            threads = [ckpt.save_async(d, 4, _tree()) for _ in range(4)]
            ckpt.save(d, 4, _tree())
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
            assert errors == [] and ckpt.list_steps(d) == [4]
            assert not [n for n in os.listdir(d) if ".tmp." in n]
            _assert_equal(ckpt.restore(d, 4, _tree())[0], _tree())
    finally:
        threading.excepthook = hook
        sys.setswitchinterval(old)


# ---------------------------------------------------------------------------
# monitors
# ---------------------------------------------------------------------------

def test_step_monitor_flags_stragglers():
    m = StepMonitor(straggler_factor=2.0, warmup_steps=2, trip_after=3)
    for i in range(10):
        m.record(i, 0.1)
    assert not m.should_reshard
    evs = [m.record(10 + i, 1.0) for i in range(3)]
    assert all(e.flagged for e in evs)
    assert m.should_reshard
    assert m.summary()["flagged"] == 3


def test_step_monitor_feeds_registry():
    reg = Registry()
    m = StepMonitor(straggler_factor=2.0, warmup_steps=1, trip_after=2,
                    registry=reg)
    for i, dur in enumerate((0.1, 0.1, 1.0, 1.0)):
        m.record(i, dur)
    s = m.summary()
    assert s["steps"] == 4 and s["flagged"] == 2
    assert s["max_s"] == pytest.approx(1.0)
    assert s["ema_s"] == pytest.approx(m.ema)
    assert reg.snapshot()["histograms"]["monitor.step_s"]["count"] == 4
    assert m.should_reshard


def test_loss_guard():
    g = LossGuard(spike_factor=5.0)
    assert g.check(2.0)
    assert g.check(1.9)
    assert not g.check(float("nan"))
    assert not g.check(100.0)
    assert g.check(1.8)
    reg = Registry()
    g = LossGuard(spike_factor=2.0, registry=reg)
    assert g.check(1.0)
    assert not g.check(float("nan"))
    assert not g.check(10.0)
    assert reg.snapshot()["counters"]["monitor.loss_rollbacks"] == 2


def test_monitors_match_reference_on_one_stream():
    rng = np.random.default_rng(0)
    durs = np.concatenate([rng.uniform(0.09, 0.11, 20), [0.5, 0.6, 0.7],
                           rng.uniform(0.09, 0.11, 5), [0.9] * 6])
    losses = np.concatenate([np.linspace(4, 2, 20), [np.nan, 80.0, 1.9,
                                                     np.inf, 1.8]])
    reg, jreg = Registry(), JRegistry()
    m = StepMonitor(registry=reg)
    jm = JStepMonitor(registry=jreg)
    g, jg = LossGuard(registry=reg), JLossGuard(registry=jreg)
    for i, d in enumerate(durs):
        ev, jev = m.record(i, float(d)), jm.record(i, float(d))
        assert (ev.flagged, m.should_reshard, m.ema) == \
            (jev.flagged, jm.should_reshard, jm.ema)
    for x in losses:
        assert g.check(float(x)) == jg.check(float(x))
        assert g.ema == jg.ema
    assert m.summary() == jm.summary()
    assert reg.snapshot() == jreg.snapshot()
