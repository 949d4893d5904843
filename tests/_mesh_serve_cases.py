"""The checks of the port's ``Engine`` on a (data, model) mesh over gloo
on the CPU (spawned ranks, one torch thread each) against the JAX
``Engine`` on the same mesh (8 fake CPU devices, tests/conftest.py) and
the port's own single-device engine, shared by the test modules
tests/test_torch_mesh_serve*.py, each of which names its mesh in a
``dims`` fixture (one module a mesh: xdist's ``loadfile`` runs them side
by side).

Reduced smollm-360m in float32 (4 heads padded to 16, 2 kv heads), 6
requests on 4 slots, ``max_seq`` 32, contiguous and paged, greedy and
sampled (temperature 0.8, top_k 5, seed = uid):

* tokens equal the JAX engine's on the same mesh and the single-device
  port's, on every rank;
* every rank's param blocks and fresh cache blocks equal, bit for bit,
  the reference's addressable shard on the device at the rank's
  coordinates; after four prefills, their inserts and one decode step
  the contiguous cache blocks and the logits are within 1e-5;
* no collective of a serve is handed a param or cache block (by
  storage), and the largest a decode step moves is the (B, vocab)
  logits;
* ``generate_static`` against both.
"""

import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_serve_ranks as ranks
from repro.configs import get_config as jget_config
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.launch.serve import Engine as JEngine
from repro.models import transformer as JT
from repro.runtime.scheduler import Request as JRequest
from repro.runtime.scheduler import SamplingParams as JSampling
from repro.sharding import use_rules as juse_rules
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch.ranks import run_ranks
from repro_torch.launch.serve import Engine

needs_devices = pytest.mark.skipif(jax.device_count() < 8,
                                   reason="needs 8 fake CPU devices")

CFG_KW = dict(compute_dtype="float32")
LAYOUTS = {"contiguous": {},
           "paged": dict(kv_layout="paged", page_size=8, prefill_chunk=8)}
MODES = ("greedy", "sampled")
STATIC_GEN = 6


def _spec(vocab):
    rng = np.random.default_rng(7)
    return [(rng.integers(0, vocab, n).tolist(), g)
            for n, g in zip([9, 12, 5, 16, 10, 7], [8, 3, 8, 6, 8, 4])]


def _jrequests(spec, sampled):
    return [JRequest(uid=i, prompt=p, max_new_tokens=g,
                     sampling=JSampling(**ranks.SAMPLED, seed=i) if sampled
                     else JSampling())
            for i, (p, g) in enumerate(spec)]


def _static_prompts(vocab):
    return np.random.default_rng(8).integers(0, vocab, (4, 9))


def _shard(arr, device, unit=None):
    """The reference's addressable shard of ``arr`` on ``device`` (the
    port's unit ``unit`` of a stacked leaf)."""
    (shard,) = [s for s in arr.addressable_shards if s.device == device]
    data = np.asarray(shard.data)
    return data if unit is None else data[unit]


def _ref_param(jparams, key, n):
    parts = key.split("/")
    node, unit = jparams, None
    if parts[0] == "layers":
        j = int(parts[1])
        node, unit, parts = jparams["units"][f"b{j % n}"], j // n, parts[2:]
    for p in parts:
        node = node[p]
    return node, unit


def _ref_cache(jcache, key, n):
    j, name = key.split("/")
    return jcache[f"b{int(j) % n}"][name], int(j) // n


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config("smollm-360m").reduced(**CFG_KW)
    cfg = get_config("smollm-360m").reduced(**CFG_KW)
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    spec = _spec(cfg.vocab_size)
    single = {}
    for layout, kw in LAYOUTS.items():
        eng = Engine(cfg, max_seq=32, n_slots=4, device="cpu",
                     params=params_from_jax(np_params, cfg, device="cpu"),
                     **kw)
        for mode in MODES:
            out, _ = eng.serve(ranks.requests(spec, mode == "sampled"))
            single[layout, mode] = out
    static = Engine(cfg, max_seq=32, n_slots=4, device="cpu",
                    params=params_from_jax(np_params, cfg, device="cpu")
                    ).generate_static(_static_prompts(cfg.vocab_size),
                                      STATIC_GEN)
    return jcfg, cfg, np_params, spec, single, static


@pytest.fixture(scope="module")
def runs(dims, model, tmp_path_factory):
    """The JAX engine on the mesh ``dims`` (the test module's) and the
    port's ranks on it, started first: they run beside the JAX engine."""
    jcfg, cfg, np_params, spec, _, _ = model
    static = (_static_prompts(cfg.vocab_size), STATIC_GEN)
    port = {}

    def ranks_run():
        try:
            port["out"] = run_ranks(
                ranks.mesh_serve, math.prod(dims),
                tmp_path_factory.mktemp("serve_ranks"),
                args=(dims, np_params, CFG_KW, spec, LAYOUTS, static),
                threads=1)
        except BaseException as e:      # raised again below
            port["error"] = e

    thread = threading.Thread(target=ranks_run)
    thread.start()
    jmesh = jmake_mesh(dims, ("data", "model"))
    ref = {}
    for layout, kw in LAYOUTS.items():
        jeng = JEngine(jcfg, jmesh, max_seq=32, n_slots=4, **kw)
        res = {m: jeng.serve(_jrequests(spec, m == "sampled"))[0]
               for m in MODES}
        res["engine"] = jeng
        res["cache"] = (jeng.new_paged_cache() if layout == "paged"
                        else jeng.new_cache(4))
        if layout == "contiguous":
            cache = jeng.new_cache(4)
            with juse_rules(jeng.rules):
                for slot, (prompt, _) in enumerate(spec[:4]):
                    _, frag = jeng._prefill(prompt)
                    cache = jeng._insert(cache, frag, slot)
                toks = jnp.asarray([[p[-1]] for p, _ in spec[:4]], jnp.int32)
                pos = jnp.asarray([len(p) for p, _ in spec[:4]], jnp.int32)
                logits, cache = jeng._step(jeng.params, cache,
                                           {"tokens": toks}, pos)
            res["written"], res["step_logits"] = cache, np.asarray(logits)
            res["static"] = jeng.generate_static(*static)
        ref[layout] = res
    thread.join()
    if "error" in port:
        raise port["error"]
    return dims, jmesh, ref, port["out"]


@needs_devices
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tokens_match_the_jax_engine_on_the_mesh(runs, model, layout, mode):
    dims, _, ref, port = runs
    single = model[4][layout, mode]
    want = {u: [int(t) for t in v] for u, v in ref[layout][mode].items()}
    assert {u: list(v) for u, v in single.items()} == want
    for r in port:
        assert r[layout][mode] == want, (dims, r["coords"])


@needs_devices
def test_param_blocks_equal_the_reference_shards(runs, model):
    dims, jmesh, ref, port = runs
    n = len(model[1].block_pattern)
    jparams = ref["contiguous"]["engine"].params
    for r in port:
        dev = jmesh.devices[r["coords"]["data"], r["coords"]["model"]]
        for layout in LAYOUTS:
            got = r[layout]["params"]
            assert r[layout]["packed_p"]
            for key, block in got.items():
                arr, unit = _ref_param(jparams, key, n)
                want = _shard(arr, dev, unit)
                assert block.dtype == want.dtype and block.shape == \
                    want.shape, (dims, key)
                assert np.array_equal(block, want), (dims, key)


@needs_devices
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cache_blocks_equal_the_reference_shards(runs, model, layout):
    dims, jmesh, ref, port = runs
    n = len(model[1].block_pattern)
    for r in port:
        dev = jmesh.devices[r["coords"]["data"], r["coords"]["model"]]
        for key, block in r[layout]["cache"].items():
            arr, unit = _ref_cache(ref[layout]["cache"], key, n)
            want = _shard(arr, dev, unit)
            assert block.dtype == want.dtype and block.shape == want.shape
            assert np.array_equal(block, want), (dims, key)
        if layout == "contiguous":
            for key, block in r[layout]["written"].items():
                arr, unit = _ref_cache(ref[layout]["written"], key, n)
                np.testing.assert_allclose(block, _shard(arr, dev, unit),
                                           atol=1e-5, err_msg=key)
            np.testing.assert_allclose(r[layout]["step_logits"],
                                       ref[layout]["step_logits"], atol=1e-5)


@needs_devices
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_decode_collectives_move_no_weight(runs, model, layout):
    dims, _, _, port = runs
    cfg = model[1]
    for r in port:
        c = r[layout]["collectives"]
        assert c["weights_moved"] == 0, (dims, layout)
        # the logits' gather: (B, vocab) received, the largest moved
        assert c["largest"] == (4 * cfg.padded_vocab, "all_gather")
        assert c["per_step"] > 0
        assert set(c["ops"]) <= {"all_gather", "all_reduce_sum",
                                 "all_reduce_max"}


@needs_devices
def test_generate_static_matches_the_jax_engine_on_the_mesh(runs, model):
    _, _, ref, port = runs
    want = ref["contiguous"]["static"]
    assert np.array_equal(model[5], want)
    for r in port:
        assert np.array_equal(r["contiguous"]["static"], want)
