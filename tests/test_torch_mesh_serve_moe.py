"""The port's ``Engine`` on the MoE + MLA family on mesh (1, 2) over gloo
on the CPU against the JAX ``Engine`` on the same mesh: the checks of
tests/_mesh_serve_moe_cases.py.  tests/test_torch_mesh_serve_moe_2x2.py
and tests/test_torch_mesh_serve_moe_1x4.py run them on (2, 2) and (1, 4),
with the int8 KV cache's.

And, with no process ranks: ``moe_apply`` on blocks of experts and MLA on
blocks of heads (the contiguous latent cache split by rows: the absorbed
queries and the sharded softmax), each block a thread whose collectives
meet at a barrier, against the whole functions; MLA's row-parallel ``o``
over a list of partials against the whole product; the rank's blocks of
the specs (routed experts over ``model`` whole, ``o`` by rows, the routes
whole).  And the frontends (musicgen's ``embeds``, internvl2's
``patch_embeds``) through ``prefill`` and ``serve_step`` on the rank's
blocks against the reference's under ``use_rules`` on (1, 2)."""

import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_serve_ranks as ranks
from _mesh_serve_moe_cases import (  # noqa: F401  (fixtures and tests)
    runs, test_moe_cache_blocks_equal_the_reference_shards,
    test_moe_decode_collectives_move_no_weight,
    test_moe_param_blocks_equal_the_reference_shards,
    test_moe_tokens_match_the_jax_engine_on_the_mesh)
from _mesh_serve_moe_cases import CFG_KW, needs_devices
from repro.configs import get_config as jget_config
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.models import transformer as JT
from repro.sharding import use_rules as juse_rules
from repro.sharding.axes import make_rules as jmake_rules
from repro.sharding.context import param_sharding as jparam_sharding
from repro_torch.configs import get_config
from repro_torch.core.layers import add_partition_major, drop_partition_major
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.models.moe import moe_apply
from repro_torch.sharding import make_rules
from repro_torch.sharding.context import param_sharding
from repro_torch.sharding.serving import use_serving
from repro_torch.tree import flatten, map_tree


@pytest.fixture(scope="module")
def dims():
    return (1, 2)


@pytest.fixture(scope="module")
def int8_too():
    return False


# ---------------------------------------------------------------------------
# the pieces, with no process ranks
# ---------------------------------------------------------------------------

class _ThreadShards:
    """Rank ``i`` of a ``model`` axis of ``m`` threads: the blocks and the
    collectives :mod:`repro_torch.sharding.serving` gives the model code,
    the collectives meeting at a barrier."""

    def __init__(self, i, m, board, barrier, max_seq):
        self.i, self.m, self.max_seq = i, m, max_seq
        self.board, self.barrier = board, barrier

    def size(self, axis):
        return self.m if axis in ("model", ("model",)) else 1

    def block(self, axis, n):
        k = n // self.size(axis)
        lo = (self.i if self.size(axis) > 1 else 0) * k
        return lo, lo + k

    def kv_split(self, paged, n_kv_heads):
        return None if paged else "rows"

    def rows_axes(self, paged, n_kv_heads):
        return ("model",)

    def _exchange(self, x):
        self.board[self.i] = x
        self.barrier.wait()
        got = list(self.board)
        self.barrier.wait()
        return got

    def reduce_model(self, x, op="sum"):
        parts = torch.stack(self._exchange(x.clone()))
        x.copy_(parts.sum(0) if op == "sum" else parts.amax(0))
        return x

    def gather(self, x, dims):
        (d,) = dims
        return torch.cat(self._exchange(x), dim=d)

    def gather_last(self, *xs):
        parts = self._exchange(xs)
        return [torch.cat([p[j] for p in parts], dim=-1)
                for j in range(len(xs))]


def _on_threads(m, fn, max_seq=0):
    """``fn(i)`` on m threads, each under its own ``_ThreadShards``."""
    board, barrier = [None] * m, threading.Barrier(m, timeout=60)
    out, errors = [None] * m, []

    def run(i):
        try:
            with use_serving(_ThreadShards(i, m, board, barrier, max_seq)):
                out[i] = fn(i)
        except BaseException as e:     # raised again below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(m)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return out


def _blocks(cfg, tree, specs, m, i):
    """Rank (0, i)'s blocks of ``tree`` on mesh (1, m) under the decode
    rules, as :func:`repro_torch.models.transformer.param_blocks` cuts
    them."""
    rules = make_rules(Mesh((1, m), ("data", "model"), torch.device("cpu")),
                       "decode")
    whole = drop_partition_major(tree)
    coords = {"data": 0, "model": i}
    return add_partition_major(map_tree(
        lambda sh, t: t[sh.block(t.shape, coords)] if sh.axes else t,
        param_sharding(specs, whole, rules), whole))


def _layer(cfg):
    params = T.init_model(cfg, seed=3, device="cpu")
    specs = T.layer_specs(T.param_specs(cfg), cfg)
    return params["layers"][0], specs["layers"][0]


@pytest.mark.parametrize("m", [2, 4])
def test_moe_on_blocks_of_experts_sums_to_the_whole(m):
    """deepseek-v2-lite reduced: each block of experts (router columns,
    routed weights whole per expert, the shared experts' up/gate groups)
    gathers the logits and the shared hidden in one collective, combines
    its experts' terms, and the partial outputs summed over the blocks
    give the whole ``moe_apply``."""
    cfg = get_config("deepseek-v2-lite-16b").reduced(**CFG_KW)
    layer, specs = _layer(cfg)
    x = torch.randn((3, 5, cfg.d_model),
                    generator=torch.Generator().manual_seed(4))
    want, _ = moe_apply(layer["moe"], x, cfg, cfg.ffn_sparsity)
    blocks = [_blocks(cfg, layer["moe"], specs["moe"], m, i)
              for i in range(m)]
    assert blocks[0]["up"]["packed"].shape[0] == cfg.n_experts // m
    assert blocks[0]["up"]["packed"].shape[1:] == \
        layer["moe"]["up"]["packed"].shape[1:]
    assert blocks[0]["router"].shape[1] == cfg.n_experts // m
    got = _on_threads(m, lambda i: moe_apply(blocks[i], x, cfg,
                                             cfg.ffn_sparsity)[0])
    for y in got:
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)


def test_mla_row_parallel_o_over_partials_equals_the_product():
    """Each block of heads' outputs through its rows of ``o`` is a
    partial product; their sum is the whole ``out @ o``."""
    cfg = get_config("deepseek-v2-lite-16b").reduced(**CFG_KW)
    layer, specs = _layer(cfg)
    gen = torch.Generator().manual_seed(5)
    out = torch.randn((2, 3, cfg.n_heads, cfg.head_dim), generator=gen)
    want = out.reshape(2, 3, -1) @ layer["mixer"]["o"]
    partials = []

    class Record:
        def reduce_model(self, y, op="sum"):
            partials.append(y.clone())
            return y

    for m in (2, 4):
        partials.clear()
        hl = cfg.n_heads // m
        with use_serving(Record()):
            for i in range(m):
                blk = _blocks(cfg, layer["mixer"], specs["mixer"], m, i)
                assert blk["o"].shape == (hl * cfg.head_dim, cfg.d_model)
                A._mla_o(blk, out[..., i * hl:(i + 1) * hl, :], cfg)
        torch.testing.assert_close(sum(partials), want, rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("m", [2, 4])
def test_mla_on_blocks_of_heads_and_rows_equals_the_whole(m):
    """MLA on blocks of heads: a prefill (the rank's heads over the whole
    prompt, ``o`` summed), then two decode steps over a contiguous latent
    cache split by rows (the absorbed queries gathered, the sharded
    softmax over the rank's rows) give the whole function's outputs."""
    cfg = get_config("deepseek-v2-lite-16b").reduced(**CFG_KW)
    layer, specs = _layer(cfg)
    gen = torch.Generator().manual_seed(6)
    b, s, max_seq = 3, 5, 16
    x = torch.randn((b, s, cfg.d_model), generator=gen)
    steps = [torch.randn((b, 1, cfg.d_model), generator=gen)
             for _ in range(2)]
    pos = torch.tensor([5, 2, 4])
    positions = torch.arange(s).expand(b, s)

    def run(params):
        y, cache = A.mla_prefill(params, x, cfg, positions, max_seq)
        out = [y]
        for i, xs in enumerate(steps):
            y, cache = A.mla_decode(params, xs, cfg, cache, pos + i)
            out.append(y)
        return out

    want = run(layer["mixer"])
    blocks = [_blocks(cfg, layer["mixer"], specs["mixer"], m, i)
              for i in range(m)]
    assert blocks[0]["q"].shape[1] * m == layer["mixer"]["q"].shape[1]
    assert blocks[0]["dkv"].shape == layer["mixer"]["dkv"].shape
    k = max_seq // m

    def rank(i):
        # mla_prefill cuts the cache to the rank's rows through the rules,
        # which the thread stand-in has not: the rows are cut here
        y, cache = _prefill_whole_cache(blocks[i], x, cfg, positions,
                                        max_seq)
        cache = {n: t[:, i * k:(i + 1) * k].clone() for n, t in cache.items()}
        out = [y]
        for j, xs in enumerate(steps):
            y, cache = A.mla_decode(blocks[i], xs, cfg, cache, pos + j)
            out.append(y)
        return out

    for got in _on_threads(m, rank, max_seq):
        for g, w in zip(got, want, strict=True):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def _prefill_whole_cache(params, x, cfg, positions, max_seq):
    """:func:`A.mla_prefill`'s output with the whole latent cache."""
    y, c_kv, k_pe = A._mla_forward(params, x, cfg, positions)
    return y, {"ckv": A._pad_seq(c_kv, max_seq),
               "kpe": A._pad_seq(k_pe, max_seq)}


def test_moe_and_mla_specs_put_experts_and_heads_over_model():
    """The rank's blocks the specs give on (1, 4): routed experts over
    ``model`` with their groups whole (a mesh axis appears once in a
    spec), their route (first dimension 1) whole; the router's columns;
    MLA's q/uk/uv columns, ``o``'s rows, ``dkv``/``kpe`` whole; the
    shared experts' up/gate groups, down whole."""
    cfg = get_config("deepseek-v2-lite-16b").reduced(**CFG_KW)
    layer, specs = _layer(cfg)
    blk = _blocks(cfg, layer, specs, 4, 1)
    moe, mix = layer["moe"], layer["mixer"]
    for name in ("up", "gate", "down"):
        e = moe[name]["packed"].shape[0]
        assert blk["moe"][name]["packed"].shape == \
            (e // 4, *moe[name]["packed"].shape[1:])
        assert torch.equal(blk["moe"][name]["packed"],
                           moe[name]["packed"][e // 4:e // 2])
        assert moe[name]["route"].shape[0] == 1
        assert torch.equal(blk["moe"][name]["route"], moe[name]["route"])
    assert torch.equal(blk["moe"]["router"],
                       moe["router"][:, 1:2])
    g = moe["shared"]["up"]["packed"].shape[0]
    assert blk["moe"]["shared"]["up"]["packed"].shape[0] == g // 4
    assert torch.equal(blk["moe"]["shared"]["down"]["packed"],
                       moe["shared"]["down"]["packed"])
    hd = cfg.n_heads // 4 * cfg.head_dim
    assert torch.equal(blk["mixer"]["o"], mix["o"][hd:2 * hd])
    assert torch.equal(blk["mixer"]["uk"], mix["uk"][:, hd:2 * hd])
    assert torch.equal(blk["mixer"]["dkv"], mix["dkv"])


def test_blockwise_init_equals_the_blocks_of_the_whole():
    """``init_model(rules=)`` draws each layer and keeps its block: bit
    for bit ``param_blocks`` of the whole tree."""
    cfg = get_config("deepseek-v2-lite-16b").reduced(**CFG_KW)

    class OneRank(Mesh):
        @property
        def coords(self):
            return {"data": 0, "model": 1}

    rules = make_rules(OneRank((1, 2), ("data", "model"),
                               torch.device("cpu")), "decode")
    want = T.param_blocks(T.init_model(cfg, seed=2, device="cpu"), cfg,
                          rules)
    got = flatten(T.init_model(cfg, seed=2, device="cpu", rules=rules))
    assert [k for k, _ in got] == [k for k, _ in flatten(want)]
    for (key, a), (_, b) in zip(got, flatten(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), key


# ---------------------------------------------------------------------------
# the frontends on (1, 2)
# ---------------------------------------------------------------------------

FRONTENDS = ("musicgen-large", "internvl2-2b")
FRONT_SEQ = 16


def _frontend_inputs(cfg, b=2, s=6):
    """The stub inputs: ``embeds`` (musicgen) or ``patch_embeds`` before
    tokens (internvl2), then two decode steps' batches and positions."""
    rng = np.random.default_rng(9)
    if cfg.frontend == "embed":
        prompt = {"embeds": rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)}
        n = s
        steps = [{"embeds": rng.standard_normal(
            (b, 1, cfg.d_model)).astype(np.float32)} for _ in range(2)]
    else:
        prompt = {"patch_embeds": rng.standard_normal(
            (b, cfg.n_prefix, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (b, s))}
        n = cfg.n_prefix + s
        steps = [{"tokens": rng.integers(0, cfg.vocab_size, (b, 1))}
                 for _ in range(2)]
    return prompt, [(n + i, st) for i, st in enumerate(steps)]


@needs_devices
@pytest.mark.parametrize("arch", FRONTENDS)
def test_frontends_prefill_and_step_match_the_reference_on_the_mesh(
        arch, dims, tmp_path):
    """``prefill`` and two ``serve_step`` calls of the frontend's stub
    inputs on each rank's blocks (vocab-parallel head; the inputs whole
    on every rank) against the reference's on its sharded params under
    ``use_rules`` on the same mesh (the reference's ``Engine.serve`` takes
    tokens only)."""
    kw = dict(compute_dtype="float32")
    jcfg = jget_config(arch).reduced(**kw)
    jparams, specs = JT.init_model(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    prompt, steps = _frontend_inputs(jcfg)
    port = {}

    def ranks_run():
        try:
            port["out"] = run_ranks(
                ranks.frontend_steps, math.prod(dims), tmp_path,
                args=(dims, arch, np_params, kw, FRONT_SEQ, prompt, steps),
                threads=1)
        except BaseException as e:      # raised again below
            port["error"] = e

    thread = threading.Thread(target=ranks_run)
    thread.start()
    jmesh = jmake_mesh(dims, ("data", "model"))
    rules = jmake_rules(jmesh, "decode")
    with juse_rules(rules):
        params = jax.device_put(jparams,
                                jparam_sharding(specs, jparams, rules))
        logits, cache = jax.jit(lambda p, b: JT.prefill(
            p, b, jcfg, FRONT_SEQ))(params, jax.tree.map(jnp.asarray, prompt))
        want = [np.asarray(logits)]
        step = jax.jit(lambda p, c, b, pos: JT.serve_step(p, c, b, pos, jcfg))
        for pos, batch in steps:
            logits, cache = step(params, cache,
                                 jax.tree.map(jnp.asarray, batch), pos)
            want.append(np.asarray(logits))
    thread.join()
    if "error" in port:
        raise port["error"]
    assert len(port["out"]) == math.prod(dims)
    for rows in port["out"]:
        for got, w in zip(rows, want, strict=True):
            assert got.shape == w.shape
            np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_cli_serves_deepseek_on_a_mesh(layout, tmp_path):
    """``--arch deepseek-v2-lite-16b --mesh 1x2 --backend gloo`` (reduced,
    on two ranks whose process group is up): rank 0 prints the served
    line, the other rank nothing."""
    argv = ["--arch", "deepseek-v2-lite-16b", "--mesh", "1x2", "--backend",
            "gloo", "--device", "cpu", "--requests", "3", "--gen", "4",
            "--prompt-len", "6"]
    if layout == "paged":
        argv += ["--kv-layout", "paged", "--page-size", "8"]
    printed = run_ranks(ranks.serve_cli, 2, tmp_path, args=(argv,),
                        threads=1)
    assert "served 3 requests on cpu mesh 1x2" in printed[0]
    assert printed[1] == ""
