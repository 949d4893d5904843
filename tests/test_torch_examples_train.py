"""The port's training examples against the JAX package's, on the CPU in
float32, from the reference's own weights bridged into the port:
``examples/sparse_sparse_lm_torch.py`` against the reference's ``run``
(``examples/sparse_sparse_lm.py``, loaded without its ``__main__``
block) and ``examples/train_gsc_torch.py`` against its ``train``.

Each reference function runs as written; its config is cut to float32
compute (the examples compute in bf16) and the values it prints are read
where it converts them (its module's ``float``).

Tolerances: sparse_sparse_lm's final losses after 3 steps 1e-4 relative;
the sparse-sparse/dense ratio of the census's FLOPs a step
(``counted_flops``) within 12% of the reference's ``compiled_flops``
ratio, the bound of the decode census (tests/_census_decode_cases.py);
train_gsc's loss of each of 2 steps (batch 8) 1e-4, its held-out accuracy
equal."""

import builtins
import concurrent.futures
import dataclasses
import importlib.util
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.api import DENSE as JDENSE, SparsityConfig as JSparsity
from repro.models import gsc_cnn as JG
from repro.models import init_model as j_init_model
from repro_torch.bridge import gsc_params_from_jax, train_params_from_jax

ROOT = Path(__file__).resolve().parents[1]
LM_STEPS = 3
GSC_STEPS, GSC_BATCH = 2, 8


def load(path, name):
    """A script as a module (its ``__main__`` block not run)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Floats:
    """Stands for ``float`` in a reference module: records every value
    the module converts, in order."""

    def __init__(self):
        self.seen = []

    def __call__(self, v):
        self.seen.append(builtins.float(v))
        return self.seen[-1]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def f32_configs(get_config):
    """A reference module's ``get_config`` whose ``reduced()`` computes
    in float32."""
    def get(arch):
        cfg = get_config(arch)
        return types.SimpleNamespace(reduced=lambda **kw: cfg.reduced(
            compute_dtype="float32", **kw))
    return get


def test_sparse_sparse_lm_against_the_reference():
    """The reference's two runs go on in a thread of their own while the
    port's run beside them (XLA and torch release the GIL as they work)."""
    ref = load("examples/sparse_sparse_lm.py", "ref_sparse_sparse_lm")
    port = load("examples/sparse_sparse_lm_torch.py", "sparse_sparse_lm")
    ref.get_config = f32_configs(ref.get_config)
    ref.float = Floats()
    runs = (("dense", JDENSE, port.DENSE),
            ("sparse-sparse", JSparsity(n=4, k_frac=0.125,
                                        kwta_impl="bisect"), port.SPARSE))

    def reference():
        # each run's FLOPs, and its final loss: the last value it converts
        return [(ref.run(tag, jsp, LM_STEPS), ref.float.seen[-1])
                for tag, jsp, _ in runs]

    got = {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        want = pool.submit(reference)
        for tag, jsp, sp in runs:
            cfg = dataclasses.replace(port.config(sp),
                                      compute_dtype="float32")
            jcfg = ref.get_config("smollm-360m").reduced(
                d_model=128, d_ff=512, vocab_size=512, n_heads=4,
                n_kv_heads=2, head_pad=0, ffn_sparsity=jsp)
            jparams, _ = j_init_model(jax.random.PRNGKey(0), jcfg)
            params = train_params_from_jax(
                jax.tree.map(np.asarray, jparams), cfg, device="cpu")
            got[tag] = port.run(tag, sp, LM_STEPS, params=params,
                                device="cpu", cfg=cfg)
        want = dict(zip((tag for tag, _, _ in runs), want.result()))
    for tag, (_, jloss) in want.items():
        assert abs(got[tag]["loss"] / jloss - 1) <= 1e-4, (
            tag, got[tag]["loss"], jloss)
    flops = {tag: (got[tag]["flops"], want[tag][0]) for tag in got}
    ratio = flops["dense"][0] / flops["sparse-sparse"][0]
    jratio = flops["dense"][1] / flops["sparse-sparse"][1]
    print(f"FLOPs a step (census, XLA): {flops}; ratios {ratio}, {jratio}")
    assert abs(ratio / jratio - 1) <= 0.12, (ratio, jratio, flops)


@pytest.mark.parametrize("variant", ["dense", "sparse_dense",
                                     "sparse_sparse"])
def test_train_gsc_against_the_reference(variant):
    ref = load("examples/train_gsc.py", "ref_train_gsc")
    port = load("examples/train_gsc_torch.py", "train_gsc")
    ref.float = Floats()
    jheld = ref.train(variant, GSC_STEPS, GSC_BATCH)
    # each printed step's loss and accuracy, then the 5 held-out batches'
    seen = ref.float.seen
    jparams, _ = JG.init_model(jax.random.PRNGKey(0),
                               JG.GSCConfig(variant=variant))
    got = port.train(variant, GSC_STEPS, GSC_BATCH,
                     params=gsc_params_from_jax(
                         jax.tree.map(np.asarray, jparams), device="cpu"),
                     device="cpu")
    assert sorted(got["printed"]) == list(range(GSC_STEPS))
    for s, (loss, _) in got["printed"].items():
        assert abs(loss - seen[2 * s]) <= 1e-4, (s, loss, seen[2 * s])
    assert got["heldout"] == pytest.approx(float(jheld), abs=1e-9)
