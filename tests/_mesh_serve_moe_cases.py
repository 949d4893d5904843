"""The checks of the port's ``Engine`` on a (data, model) mesh over gloo
on the CPU for the MoE + MLA family, against the JAX ``Engine`` on the
same mesh (8 fake CPU devices, tests/conftest.py), shared by
tests/test_torch_mesh_serve_moe*.py, each of which names its mesh in a
``dims`` fixture (one module a mesh: xdist's ``loadfile`` runs them side
by side).

deepseek-v2-lite reduced (MLA, MoE of 4 experts top-2 and one shared
expert) and qwen3-moe reduced (GQA, MoE of 4 experts top-2) in float32,
6 requests on 4 slots, greedy, ``max_seq`` 32, contiguous and paged:

* tokens equal the JAX engine's on the same mesh, on every rank (the
  reference's paged tokens differ from its contiguous ones on the MoE
  configs: each layout is held to its own);
* every rank's param blocks and fresh cache blocks equal, bit for bit,
  the reference's addressable shard on the device at the rank's
  coordinates: routed experts over ``model`` with their groups whole,
  MLA's ``o`` by rows;
* no collective of a serve is handed a param or cache block (by
  storage), and the largest a decode step moves is the (B, vocab)
  logits (at these widths MLA's sharded softmax on the contiguous layout
  gathers more).

With ``int8_too`` (the module's fixture) the same for smollm reduced with
the int8 KV cache on the paged layout.
"""

import math
import threading

import jax
import numpy as np
import pytest

import _torch_serve_ranks as ranks
from _torch_serve_ranks import config_of
from repro.configs import get_config as jget_config
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.launch.serve import Engine as JEngine
from repro.models import transformer as JT
from repro.runtime.scheduler import Request as JRequest
from repro_torch.launch.ranks import run_ranks

needs_devices = pytest.mark.skipif(jax.device_count() < 8,
                                   reason="needs 8 fake CPU devices")

CFG_KW = dict(compute_dtype="float32", param_dtype="float32", head_pad=0)
INT8_KW = dict(compute_dtype="float32", kv_cache_dtype="int8")
ARCHS = ("deepseek-v2-lite-16b", "qwen3-moe-235b-a22b")
LAYOUTS = {"contiguous": {},
           "paged": dict(kv_layout="paged", page_size=8, prefill_chunk=8)}
PAGED = {"paged": LAYOUTS["paged"]}


def spec_of(vocab):
    rng = np.random.default_rng(7)
    return [(rng.integers(0, vocab, n).tolist(), g)
            for n, g in zip([9, 12, 5, 16, 10, 7], [8, 3, 8, 6, 8, 4])]


def _shard(arr, device, unit=None):
    """The reference's addressable shard of ``arr`` on ``device`` (the
    port's unit ``unit`` of a stacked leaf)."""
    (shard,) = [s for s in arr.addressable_shards if s.device == device]
    data = np.asarray(shard.data)
    return data if unit is None else data[unit]


def ref_param(jparams, key, n):
    parts = key.split("/")
    node, unit = jparams, None
    if parts[0] == "layers":
        j = int(parts[1])
        node, unit, parts = jparams["units"][f"b{j % n}"], j // n, parts[2:]
    for p in parts:
        node = node[p]
    return node, unit


def ref_cache(jcache, key, n):
    j, name = key.split("/")
    return jcache[f"b{int(j) % n}"][name], int(j) // n


def _serve_both(jobs, dims, workdir, spawn=None):
    """The port's ranks (started first, in a thread, every job in one
    spawn) and the JAX engine on mesh ``dims``, for each job ``(name,
    arch, cfg_kw, layouts)`` and each of its layouts.  Returns {name:
    (jmesh, the JAX results by layout, the ranks' results)}.  ``spawn``
    (the jobs' ``mesh_serve_family`` arguments -> the ranks' results)
    runs the ranks another way."""
    made = []
    for name, arch, kw, layouts in jobs:
        jcfg = config_of(jget_config, arch, kw)
        jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
        made.append((name, arch, jax.tree.map(np.asarray, jparams), kw,
                     spec_of(jcfg.vocab_size), layouts))
    port = {}

    def ranks_run():
        try:
            port["out"] = spawn(made) if spawn else run_ranks(
                ranks.mesh_serve_family, math.prod(dims), workdir,
                args=(dims, made), threads=1)
        except BaseException as e:      # raised again below
            port["error"] = e

    thread = threading.Thread(target=ranks_run)
    thread.start()
    jmesh = jmake_mesh(dims, ("data", "model"))
    ref = {}
    for name, arch, _, kw, spec, layouts in made:
        jcfg = config_of(jget_config, arch, kw)
        ref[name] = {}
        for layout, lkw in layouts.items():
            jeng = JEngine(jcfg, jmesh, max_seq=32, n_slots=4, **lkw)
            toks, _ = jeng.serve([JRequest(uid=i, prompt=p,
                                           max_new_tokens=g)
                                  for i, (p, g) in enumerate(spec)])
            ref[name][layout] = {
                "greedy": {u: [int(t) for t in v] for u, v in toks.items()},
                "params": jeng.params,
                "cache": (jeng.new_paged_cache() if layout == "paged"
                          else jeng.new_cache(4))}
    thread.join()
    if "error" in port:
        raise port["error"]
    return {name: (jmesh, ref[name],
                   [dict(r[name], coords=r["coords"]) for r in port["out"]])
            for name, *_ in jobs}


@pytest.fixture(scope="module")
def runs(dims, int8_too, tmp_path_factory):
    """The MoE archs (and, where the module's ``int8_too`` says, smollm
    with the int8 cache on the paged layout, under "int8") on the
    module's mesh."""
    jobs = [(arch, arch, CFG_KW, LAYOUTS) for arch in ARCHS]
    if int8_too:
        jobs.append(("int8", "smollm-360m", INT8_KW, PAGED))
    return _serve_both(jobs, dims, tmp_path_factory.mktemp("moe_ranks"))


def check_tokens(jmesh_ref_port, layout, dims):
    _, ref, port = jmesh_ref_port
    want = ref[layout]["greedy"]
    for r in port:
        assert r[layout]["greedy"] == want, (dims, r["coords"])


def check_params(jmesh_ref_port, arch, layout, dims):
    jmesh, ref, port = jmesh_ref_port
    n = len(jget_config(arch).block_pattern)
    for r in port:
        dev = jmesh.devices[r["coords"]["data"], r["coords"]["model"]]
        assert r[layout]["packed_p"]
        for key, block in r[layout]["params"].items():
            arr, unit = ref_param(ref[layout]["params"], key, n)
            want = _shard(arr, dev, unit)
            assert block.dtype == want.dtype and block.shape == \
                want.shape, (dims, key)
            assert np.array_equal(block, want), (dims, key)


def check_cache(jmesh_ref_port, arch, layout, dims):
    jmesh, ref, port = jmesh_ref_port
    n = len(jget_config(arch).block_pattern)
    for r in port:
        dev = jmesh.devices[r["coords"]["data"], r["coords"]["model"]]
        for key, block in r[layout]["cache"].items():
            arr, unit = ref_cache(ref[layout]["cache"], key, n)
            want = _shard(arr, dev, unit)
            assert block.dtype == want.dtype and block.shape == \
                want.shape, (dims, key)
            assert np.array_equal(block, want), (dims, key)


def check_collectives(jmesh_ref_port, arch, layout, dims, kw=CFG_KW):
    cfg = config_of(jget_config, arch, kw)
    largest = 4 * cfg.padded_vocab          # the (B, vocab) logits' gather
    if cfg.use_mla and layout == "contiguous" and dims[1] > 1:
        # MLA's sharded softmax over the rows: every rank's maximum, sum
        # and weighted latent rows, (B, H, 1, 2 + r) each (at full width
        # below the logits)
        largest = max(largest, dims[1] * 4 // dims[0] * cfg.n_heads
                      * (2 + cfg.kv_lora_rank))
    for r in jmesh_ref_port[2]:
        c = r[layout]["collectives"]
        assert c["weights_moved"] == 0, (dims, layout)
        assert c["largest"] == (largest, "all_gather")
        assert c["per_step"] > 0
        assert set(c["ops"]) <= {"all_gather", "all_reduce_sum",
                                 "all_reduce_max"}


@needs_devices
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_tokens_match_the_jax_engine_on_the_mesh(runs, dims, arch,
                                                     layout):
    check_tokens(runs[arch], layout, dims)


@needs_devices
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_param_blocks_equal_the_reference_shards(runs, dims, arch):
    for layout in LAYOUTS:
        check_params(runs[arch], arch, layout, dims)


@needs_devices
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_cache_blocks_equal_the_reference_shards(runs, dims, arch,
                                                     layout):
    check_cache(runs[arch], arch, layout, dims)


@needs_devices
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_collectives_move_no_weight(runs, dims, arch, layout):
    check_collectives(runs[arch], arch, layout, dims)


@needs_devices
def test_int8_paged_cache_matches_the_jax_engine_on_the_mesh(runs, dims):
    """smollm reduced with the int8 KV cache, paged: tokens, the rank's
    param and pool blocks (int8 rows and f32 scales), no weight moved."""
    run = runs["int8"]
    check_tokens(run, "paged", dims)
    check_params(run, "smollm-360m", "paged", dims)
    check_cache(run, "smollm-360m", "paged", dims)
    check_collectives(run, "smollm-360m", "paged", dims, INT8_KW)
