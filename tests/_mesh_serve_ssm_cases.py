"""The checks of the port's ``Engine`` on a (data, model) mesh over gloo
on the CPU for the SSM/hybrid patterns, against the JAX ``Engine`` on the
same mesh (8 fake CPU devices, tests/conftest.py) and the port's own
single-device engine, shared by tests/test_torch_mesh_serve_ssm*.py, each
of which names its mesh in a ``dims`` fixture (one module a mesh:
xdist's ``loadfile`` runs them side by side).

zamba2-1.2b reduced (18 Mamba2 blocks and the weight-shared attention
block with its sparse FFN, two units) and xlstm-350m reduced (seven
mLSTM blocks and one sLSTM block, two units) in float32, served through
``generate_static`` (4 prompts of 6 tokens, 5 new tokens):

* tokens equal the JAX engine's on the same mesh and the single-device
  port's, on every rank;
* every rank's param blocks and fresh cache blocks equal, bit for bit,
  the reference's addressable shard on the device at the rank's
  coordinates (Mamba2's ``in_proj``/conv columns and heads, mLSTM's and
  sLSTM's blocks over ``heads``); after stepping through the prompts the
  ``S`` / ``conv`` / ``h, c, n`` and K/V blocks and the logits are
  within 1e-5 of the reference's;
* no collective is handed a param or cache block (by storage);
* ``Engine.serve`` raises the reference's "no fused prefill" on the mesh.

With ``long_too`` (the module's fixture) two more jobs: zamba2 reduced
and deepseek-v2-lite reduced (MLA's latent cache) stepped through a
prompt of one row under the ``decode_long`` rules, whose attention cache
rows shard over ``data`` and ``model`` together: the logits within 1e-5
of the single device's.
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
from repro.sharding import use_rules as juse_rules
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch.ranks import run_ranks
from repro_torch.launch.serve import Engine

needs_devices = pytest.mark.skipif(jax.device_count() < 8,
                                   reason="needs 8 fake CPU devices")

CFG_KW = dict(compute_dtype="float32", head_pad=0)
ARCHS = ("zamba2-1.2b", "xlstm-350m")
#: the MLA model of the ``decode_long`` jobs
LONG_MLA = "deepseek-v2-lite-16b"
GEN = 5


def prompts(vocab):
    return np.random.default_rng(9).integers(0, vocab, (4, 6))


def _shard(arr, device, unit=None):
    (shard,) = [s for s in arr.addressable_shards if s.device == device]
    data = np.asarray(shard.data)
    return data if unit is None else data[unit]


def _block(fresh, arr, device, unit):
    """``arr``'s block at ``device`` under ``fresh``'s sharding (a jitted
    step's output is laid out as the compiler chose)."""
    idx = fresh.sharding.devices_indices_map(fresh.shape)[device]
    return np.asarray(arr)[idx][unit]


def _ref_leaf(jtree, key, n, cache=False):
    """The reference's leaf (and the port's unit of it) of a port key:
    ``layers/<j>/...`` of the params, ``<j>/<name>`` of the cache."""
    parts = key.split("/")
    if cache:
        j, parts, node = int(parts[0]), parts[1:], jtree
        node, unit = node[f"b{j % n}"], j // n
    elif parts[0] == "layers":
        j = int(parts[1])
        node, unit, parts = jtree["units"][f"b{j % n}"], j // n, parts[2:]
    else:
        node, unit = jtree, None
    for p in parts:
        node = node[p]
    return node, unit


def _jax_stepped(jeng, toks):
    """The reference's cache and logits after stepping ``toks`` (B, P)."""
    cache = jeng.new_cache(toks.shape[0])
    with juse_rules(jeng.rules):
        for pos in range(toks.shape[1]):
            logits, cache = jeng._step(
                jeng.params, cache,
                {"tokens": jnp.asarray(toks[:, pos:pos + 1], jnp.int32)},
                jnp.int32(pos))
    return cache, np.asarray(logits)


@pytest.fixture(scope="module")
def models():
    """Per arch: the reference's weights as numpy, the prompts and the
    single-device port's ``generate_static`` tokens."""
    out = {}
    for arch in ARCHS:
        jcfg = jget_config(arch).reduced(**CFG_KW)
        cfg = get_config(arch).reduced(**CFG_KW)
        jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
        np_params = jax.tree.map(np.asarray, jparams)
        toks = prompts(cfg.vocab_size)
        single = Engine(cfg, max_seq=32, n_slots=4, device="cpu",
                        params=params_from_jax(np_params, cfg, device="cpu")
                        ).generate_static(toks, GEN)
        out[arch] = (jcfg, cfg, np_params, toks, single)
    return out


@pytest.fixture(scope="module")
def runs(dims, long_too, models, tmp_path_factory):
    """The port's ranks (started first, in a thread, every job in one
    spawn) and the JAX engine on the module's mesh."""
    jobs = [(arch, models[arch][2], CFG_KW) for arch in ARCHS]
    toks = models[ARCHS[0]][3]
    long = []
    if long_too:
        jcfg = jget_config(LONG_MLA).reduced(**CFG_KW)
        mla = jax.tree.map(np.asarray,
                           JT.init_model(jax.random.PRNGKey(0), jcfg)[0])
        long = [("zamba2-1.2b", models["zamba2-1.2b"][2], CFG_KW, toks[:1]),
                (LONG_MLA, mla, CFG_KW, toks[:1])]
    port = {}

    def ranks_run():
        try:
            port["out"] = run_ranks(
                ranks.mesh_serve_ssm, math.prod(dims),
                tmp_path_factory.mktemp("ssm_ranks"),
                args=(dims, jobs, (toks, GEN), long), threads=1)
        except BaseException as e:      # raised again below
            port["error"] = e

    thread = threading.Thread(target=ranks_run)
    thread.start()
    jmesh = jmake_mesh(dims, ("data", "model"))
    ref = {}
    for arch in ARCHS:
        jcfg, _, _, toks_a, _ = models[arch]
        assert np.array_equal(toks_a, toks)
        jeng = JEngine(jcfg, jmesh, max_seq=32, n_slots=4)
        written, logits = _jax_stepped(jeng, toks)
        ref[arch] = {"static": jeng.generate_static(toks, GEN),
                     "params": jeng.params, "cache": jeng.new_cache(4),
                     "written": written, "step_logits": logits}
    ref["long"] = {}
    for arch, *_ in long:
        jone = JEngine(jget_config(arch).reduced(**CFG_KW),
                       jmake_mesh((1, 1), ("data", "model")), max_seq=32,
                       n_slots=1)
        ref["long"][arch] = _jax_stepped(jone, toks[:1])[1]
    thread.join()
    if "error" in port:
        raise port["error"]
    return dims, jmesh, ref, port["out"]


def _device(jmesh, r):
    return jmesh.devices[r["coords"]["data"], r["coords"]["model"]]


@needs_devices
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_static_tokens_match_the_jax_engine_on_the_mesh(runs, models,
                                                            arch):
    dims, _, ref, port = runs
    want = ref[arch]["static"]
    assert np.array_equal(models[arch][4], want)
    for r in port:
        assert np.array_equal(r[arch]["static"], want), (dims, r["coords"])


@needs_devices
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_param_blocks_equal_the_reference_shards(runs, models, arch):
    dims, jmesh, ref, port = runs
    n = len(models[arch][1].block_pattern)
    for r in port:
        dev = _device(jmesh, r)
        for key, block in r[arch]["params"].items():
            arr, unit = _ref_leaf(ref[arch]["params"], key, n)
            want = _shard(arr, dev, unit)
            assert block.dtype == want.dtype and block.shape == \
                want.shape, (dims, key)
            assert np.array_equal(block, want), (dims, key)


@needs_devices
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_cache_blocks_equal_the_reference_shards(runs, models, arch):
    """Fresh blocks bit for bit; after the prompts' steps within 1e-5."""
    dims, jmesh, ref, port = runs
    n = len(models[arch][1].block_pattern)
    for r in port:
        dev = _device(jmesh, r)
        for key, block in r[arch]["cache"].items():
            arr, unit = _ref_leaf(ref[arch]["cache"], key, n, cache=True)
            want = _shard(arr, dev, unit)
            assert block.dtype == want.dtype and block.shape == \
                want.shape, (dims, key)
            assert np.array_equal(block, want), (dims, key)
        for key, block in r[arch]["written"].items():
            arr, unit = _ref_leaf(ref[arch]["written"], key, n, cache=True)
            fresh, _ = _ref_leaf(ref[arch]["cache"], key, n, cache=True)
            np.testing.assert_allclose(block, _block(fresh, arr, dev, unit),
                                       atol=1e-5, err_msg=f"{dims} {key}")
        np.testing.assert_allclose(r[arch]["step_logits"],
                                   ref[arch]["step_logits"], atol=1e-5)


@needs_devices
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_collectives_move_no_block(runs, arch):
    dims, _, _, port = runs
    for r in port:
        c = r[arch]["collectives"]
        assert c["weights_moved"] == 0, (dims, arch)
        assert c["per_step"] > 0
        assert set(c["ops"]) <= {"all_gather", "all_reduce_sum",
                                 "all_reduce_max"}


@needs_devices
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_serve_raises_as_the_reference_on_the_mesh(runs, arch):
    for r in runs[3]:
        assert "has no fused prefill; serve with generate_static" in \
            r[arch]["serve_error"]


def check_decode_long(runs, arch="zamba2-1.2b"):
    """zamba2 (or deepseek-v2-lite) under ``decode_long``: the shared
    attention's cache rows (MLA's latent rows) over both axes (a block of
    max_seq / ranks rows), the logits within 1e-5 of the single
    device's."""
    dims, _, ref, port = runs
    cfg = get_config(arch).reduced(**CFG_KW)
    leaf = "ckv" if cfg.use_mla else "k"
    layer = 0 if cfg.use_mla else cfg.block_pattern.index("shared_attn")
    for r in port:
        long = r["long"][arch]
        shape = long["cache"][f"{layer}/{leaf}"]
        assert shape[:2] == (1, 32 // math.prod(dims)), (dims, shape)
        np.testing.assert_allclose(long["logits"], ref["long"][arch],
                                   atol=1e-5)
