"""The port's ``Engine`` on a multi-pod mesh (pod, data, model) = (2, 1,
2) over gloo on the CPU against the JAX ``Engine`` on the same mesh: a
batch's slots shard over the DP axes (``pod`` and ``data``), the cache's
slots and the decode step's rows alike.  Reduced smollm-360m in float32,
the greedy tokens of tests/_mesh_serve_cases.py's six requests on 4
slots, contiguous layout."""

import jax
import numpy as np
import pytest

import _torch_serve_ranks as ranks
from _mesh_serve_cases import CFG_KW, _jrequests, _spec
from repro.configs import get_config as jget_config
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.launch.serve import Engine as JEngine
from repro.models import transformer as JT
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch.ranks import run_ranks
from repro_torch.launch.serve import Engine

DIMS = (2, 1, 2)


@pytest.mark.skipif(jax.device_count() < 4, reason="needs 4 fake CPU devices")
def test_slots_shard_over_every_dp_axis(tmp_path):
    jcfg = jget_config("smollm-360m").reduced(**CFG_KW)
    cfg = get_config("smollm-360m").reduced(**CFG_KW)
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    spec = _spec(cfg.vocab_size)
    port = run_ranks(ranks.pod_serve, 4, tmp_path,
                     args=(DIMS, np_params, CFG_KW, spec), threads=1)
    jmesh = jmake_mesh(DIMS, ("pod", "data", "model"))
    jout, _ = JEngine(jcfg, jmesh, max_seq=32, n_slots=4).serve(
        _jrequests(spec, False))
    want = {u: [int(t) for t in v] for u, v in jout.items()}
    single, _ = Engine(cfg, max_seq=32, n_slots=4, device="cpu",
                       params=params_from_jax(np_params, cfg, device="cpu")
                       ).serve(ranks.requests(spec, False))
    assert {u: list(v) for u, v in single.items()} == want
    for r in port:
        assert r["greedy"] == want, r["coords"]
        # 2 of 4 slots a rank (over pod), 16 of 32 rows (over model)
        assert {shape[:2] for shape in r["cache"]} == {(2, 16)}
