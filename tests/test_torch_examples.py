"""The port's examples against the JAX package's, on the CPU in float32:
``examples/quickstart_torch.py`` against ``repro.core`` and the reference
quickstart's MLP loop, and ``examples/serve_lm_torch.py`` against
``repro.launch.serve.Engine`` on the example's workload.

Tolerances: the packing dict and FLOP counts exact; both max errors of
the quickstart's products 1e-5; the MLP's losses after each of 6 SGD
steps 1e-5 of the reference's on its weights; the served greedy tokens
equal; each layer's realized k/N 1e-6 of the JAX engine's."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import (CSLayout as JLayout, SparsityConfig as JSparsity,
                        flops_cs_matmul, flops_cs_topk, flops_dense,
                        packed_bytes)
from repro.core.layers import (apply_kwta as j_apply_kwta,
                               packed_linear_apply as j_packed_linear_apply,
                               packed_linear_init as j_packed_linear_init)
from repro.launch.mesh import make_mesh
from repro.launch.serve import Engine as JEngine
from repro.obs import Telemetry as JTelemetry
from repro.runtime.scheduler import Request as JRequest
from repro.runtime.scheduler import SamplingParams as JSamplingParams
from repro_torch.bridge import packed_params_from_jax, params_from_jax
from repro_torch.configs import get_config

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
MLP_STEPS = 6


def load_example(name):
    """An example script as a module (its ``__main__`` block not run)."""
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def reference_mlp():
    """The reference quickstart's MLP, its batch and the losses after
    each of ``MLP_STEPS`` SGD steps, in its own lines."""
    cfg = JSparsity(n=4, k_frac=0.125)
    key = jax.random.PRNGKey(0)
    p1, _ = j_packed_linear_init(key, 64, 256, cfg, seed=1)
    p2, _ = j_packed_linear_init(key, 256, 10, JSparsity(n=2), seed=2)
    params = {"l1": p1, "l2": p2}
    xb = jax.random.normal(jax.random.PRNGKey(1), (256, 64))
    yb = (xb[:, 0] > 0).astype(jnp.int32) + 2 * (xb[:, 1] > 0).astype(
        jnp.int32)

    def loss_fn(params):
        h = j_packed_linear_apply(params["l1"], xb, cfg)
        h = j_apply_kwta(jax.nn.relu(h), cfg)
        logits = j_packed_linear_apply(params["l2"], h,
                                       JSparsity(n=2))[:, :4]
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(256), yb])

    step = jax.jit(lambda p: jax.tree.map(
        lambda a, g: a - 0.5 * g if a.dtype.kind == "f" else a,
        p, jax.grad(loss_fn, allow_int=True)(p)))
    init, losses = params, []
    for _ in range(MLP_STEPS):
        params = step(params)
        losses.append(float(loss_fn(params)))
    return init, xb, losses


def test_quickstart_against_the_reference():
    qs = load_example("quickstart_torch")
    init, xb, want = reference_mlp()
    got = qs.main(["--device", "cpu"],
                  params=packed_params_from_jax(
                      jax.tree.map(np.asarray, init), device="cpu"),
                  xb=torch.from_numpy(np.array(xb)), steps=MLP_STEPS)
    assert got["packing"] == packed_bytes(JLayout(512, 512, 8))
    assert got["packing"]["dense_bytes"] == 524288
    assert got["flops"] == {"dense": flops_dense(4, 512, 512),
                            "sparse_dense": flops_cs_matmul(4, 512, 512, 8),
                            "sparse_sparse": flops_cs_topk(4, 64, 512)}
    assert got["sparse_dense_err"] <= 1e-5
    assert got["sparse_sparse_err"] <= 1e-5
    np.testing.assert_allclose(got["losses"], want, rtol=0, atol=1e-5)
    assert want[-1] < want[0]


def test_quickstart_seeded_run_trains():
    """The example as a user runs it (its own seeded draws), cut to 26
    steps: the loss falls, as the reference's does."""
    got = load_example("quickstart_torch").main(["--device", "cpu"],
                                                steps=26)
    assert len(got["losses"]) == 26
    assert got["losses"][25] < got["losses"][0]


def test_serve_lm_against_the_jax_engine():
    sl = load_example("serve_lm_torch")
    jcfg = jget_config("smollm-360m").reduced(compute_dtype="float32")
    cfg = get_config("smollm-360m").reduced(compute_dtype="float32")
    argv = ["--device", "cpu"]
    args = sl.build_parser().parse_args(argv)
    reqs = sl.build_requests(cfg.vocab_size, args.requests, args.gen)
    jtel = JTelemetry.on(sparsity_every=4)
    jeng = JEngine(jcfg, make_mesh((1, 1), ("data", "model")),
                   max_seq=sl.MAX_SEQ, n_slots=args.slots, telemetry=jtel)
    jout, jstats = jeng.serve([JRequest(
        uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
        sampling=JSamplingParams(temperature=r.sampling.temperature,
                                 top_k=r.sampling.top_k,
                                 seed=r.sampling.seed)) for r in reqs])
    jlayers = jeng.metrics_snapshot()["sparsity"]["layers"]
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg,
                             device="cpu")
    got = sl.main(argv, params=params, cfg=cfg)
    assert [r.prompt for r in got["requests"]] == [r.prompt for r in reqs]
    assert got["out"] == {u: [int(t) for t in v] for u, v in jout.items()}
    assert got["stats"]["decode_steps"] == jstats["decode_steps"]
    assert got["stats"]["prefill_calls"] == len(reqs) == 8
    layers = got["telemetry"]["layers"]
    assert set(layers) == set(jlayers) and len(layers) == cfg.n_layers
    for name, frac in layers.items():
        assert abs(frac - jlayers[name]["realized_k_frac"]) <= 1e-6, name
