"""The port's ``Engine`` on mesh (1, 2) over gloo on the CPU against the
JAX ``Engine`` on the same mesh: the checks of tests/_mesh_serve_cases.py
(on (1, 2) the contiguous cache shards its rows and the page pools their
kv heads).  tests/test_torch_mesh_serve_2x2.py and
tests/test_torch_mesh_serve_1x4.py run them on (2, 2) and (1, 4).

And, with no ranks: the sharded softmax's combine and the vocab-parallel
lookup against their unsharded functions over a list of per-rank
partials; a packed layer on a block of output groups against the whole
layer's columns (a route of one table kept whole, a route of G tables cut
with the groups, a route of 2 tables kept whole beside the block's own
``block_route``, a bias cut with them); deepseek-v2-lite's blocks under
``decode_long`` on (2, 2) against the reference's shards; a one-rank
mesh's engine bit for bit the engine without one; a mesh of more than one
rank with no process group refused."""

import numpy as np
import pytest
import torch

import _torch_serve_ranks as ranks
from _mesh_serve_cases import (  # noqa: F401  (fixtures and tests)
    model, needs_devices, runs,
    test_cache_blocks_equal_the_reference_shards,
    test_decode_collectives_move_no_weight,
    test_generate_static_matches_the_jax_engine_on_the_mesh,
    test_param_blocks_equal_the_reference_shards,
    test_tokens_match_the_jax_engine_on_the_mesh)
from _mesh_serve_cases import CFG_KW, MODES, _spec
from repro_torch.configs import get_config
from repro_torch.core import SparsityConfig
from repro_torch.core import functional as F
from repro_torch.bridge import params_from_jax
from repro_torch.core.layers import (apply_kwta, block_route,
                                     drop_partition_major,
                                     packed_linear_apply, packed_linear_init)
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.launch.serve import Engine
from repro_torch.models import attention as A
from repro_torch.models.common import embedding_apply, embedding_block_apply
from repro_torch.runtime.scheduler import Request


@pytest.fixture(scope="module")
def dims():
    return (1, 2)


# ---------------------------------------------------------------------------
# the pieces, with no ranks
# ---------------------------------------------------------------------------

def test_sharded_softmax_combine_equals_softmax():
    gen = torch.Generator().manual_seed(0)
    b, h, q, k, d, m = 3, 4, 2, 24, 8, 4
    scores = torch.randn((b, h, q, k), generator=gen) * 4
    valid = torch.rand((b, 1, k), generator=gen) > 0.3
    valid[..., 0] = True
    scores = torch.where(valid[:, None], scores, -1e30)
    v = torch.randn((b, k, h, d), generator=gen)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)
    blocks = list(zip(scores.chunk(m, -1), v.chunk(m, 1)))
    mx = torch.stack([A.softmax_max(s) for s, _ in blocks]).amax(0)
    terms = [A.softmax_terms(s, vb, mx) for s, vb in blocks]
    got = A.softmax_finish(sum(t[0] for t in terms), sum(t[1] for t in terms))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_vocab_parallel_lookup_equals_the_lookup():
    gen = torch.Generator().manual_seed(1)
    table = torch.randn((256, 16), generator=gen)
    tokens = torch.randint(0, 256, (3, 5), generator=gen)
    want = embedding_apply({"table": table}, tokens, torch.float32)
    for m in (2, 4):
        w = 256 // m
        parts = [embedding_block_apply(table[i * w:(i + 1) * w], tokens,
                                       torch.float32, i * w)
                 for i in range(m)]
        assert torch.equal(sum(parts), want)


@pytest.mark.parametrize("route_share", [0, 1, 8])
def test_packed_layer_on_a_block_of_groups(route_share):
    """A block of groups [g0, g1) computes columns [g0·N, g1·N) of the
    whole layer (``decompress`` puts group g, slot s at column g·N + s),
    on the Hadamard path and on the sparse-sparse path of a k-sparse
    input: a route of one table stays whole, a route whose tables divide
    over the blocks is cut with the groups, and a route of several tables
    that does not divide (R = 8 of 16 groups over 4 blocks: 2 tables) is
    kept whole beside the block's ``block_route``, as the reference's
    rules place them; the bias is cut with the groups."""
    sp = SparsityConfig(n=4, route_share=route_share, kwta_impl="topk")
    gen = torch.Generator().manual_seed(2)
    p = packed_linear_init(gen, 32, 64, sp, bias=True, seed=3)
    p["b"] = torch.randn(64, generator=gen)
    x = torch.randn((5, 32), generator=gen)
    xs = apply_kwta(x, sp)
    g, n = p["packed"].shape[0], p["packed"].shape[2]
    gr = p["route"].shape[0]
    whole = packed_linear_apply(p, x, sp)
    whole_s = packed_linear_apply(p, xs, sp, x_is_sparse=True)
    dense = x @ F.decompress(p["packed"], p["route"]) + p["b"]
    torch.testing.assert_close(whole, dense)
    for m in (2, 4):
        w = g // m
        for i in range(m):
            sl = slice(i * w, (i + 1) * w)
            blk = {"packed": p["packed"][sl], "b": p["b"][sl.start * n:
                                                          sl.stop * n],
                   "route": p["route"][i * gr // m:(i + 1) * gr // m]
                   if gr % m == 0 else p["route"]}
            if gr > 1 and gr % m:
                blk["block_route"] = block_route(p["route"], g, sl.start,
                                                 sl.stop)
            blk["packed_p"] = blk["packed"].transpose(0, 1).contiguous()
            cols = slice(sl.start * n, sl.stop * n)
            torch.testing.assert_close(packed_linear_apply(blk, x, sp),
                                       whole[:, cols])
            torch.testing.assert_close(
                packed_linear_apply(blk, xs, sp, x_is_sparse=True),
                whole_s[:, cols])


@needs_devices
def test_mla_blocks_under_decode_long_are_the_reference_shards(monkeypatch):
    """Under ``decode_long`` on (2, 2) deepseek-v2-lite reduced's param
    blocks and its contiguous latent cache blocks (``T.param_blocks`` and
    ``T.init_cache`` with the rules) are the reference's shards, bit for
    bit: the latent rows split over ``data`` and ``model`` together, a
    block of max_seq / 4 rows a rank."""
    import jax
    from jax.sharding import NamedSharding as JNamedSharding
    from _mesh_serve_moe_cases import _shard, ref_cache, ref_param
    from repro.configs import get_config as jget_config
    from repro.launch.mesh import make_mesh as jmake_mesh
    from repro.models import transformer as JT
    from repro.sharding import make_rules as jmake_rules
    from repro.sharding.context import is_spec
    from repro_torch.models import transformer as T
    from repro_torch.sharding import make_rules
    from repro_torch.tree import flatten
    kw = dict(compute_dtype="float32", param_dtype="float32")
    jcfg = jget_config("deepseek-v2-lite-16b").reduced(**kw)
    cfg = get_config("deepseek-v2-lite-16b").reduced(**kw)
    jmesh = jmake_mesh((2, 2), ("data", "model"))
    jrules = jmake_rules(jmesh, "decode_long")

    def placed(tree, specs):
        return jax.tree.map(lambda sp, a: jax.device_put(a, JNamedSharding(
            jmesh, jrules.spec_for(sp, a.shape))), specs, tree,
            is_leaf=is_spec)

    jparams = placed(*JT.init_model(jax.random.PRNGKey(0), jcfg))
    jcache = placed(*JT.init_cache(jcfg, 1, 32))
    whole = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    n = len(cfg.block_pattern)
    for rank in range(4):
        monkeypatch.setattr(torch.distributed, "get_rank", lambda *a: rank)
        mesh = Mesh((2, 2), ("data", "model"), torch.device("cpu"),
                    groups={("model",): None})
        rules = make_rules(mesh, "decode_long")
        dev = jmesh.devices[mesh.coords["data"], mesh.coords["model"]]
        blocks = T.param_blocks(whole, cfg, rules)
        for key, block in flatten(drop_partition_major(blocks)):
            arr, unit = ref_param(jparams, key, n)
            assert np.array_equal(block.numpy(), _shard(arr, dev, unit)), \
                (rank, key)
        cache = T.init_cache(cfg, 1, 32, "cpu", rules)
        for key, block in flatten(cache):
            assert block.shape[1] == 32 // 4, (rank, key, block.shape)
            arr, unit = ref_cache(jcache, key, n)
            assert np.array_equal(block.numpy(), _shard(arr, dev, unit))


def test_one_rank_mesh_is_the_engine_bit_for_bit():
    cfg = get_config("smollm-360m").reduced(**CFG_KW)
    plain = Engine(cfg, max_seq=32, n_slots=4, device="cpu")
    one = Engine(cfg, max_seq=32, n_slots=4, device="cpu",
                 mesh=make_mesh((1, 1), ("data", "model"), "cpu"))
    spec = _spec(cfg.vocab_size)
    for mode in MODES:
        assert one.serve(ranks.requests(spec, mode == "sampled"))[0] == \
            plain.serve(ranks.requests(spec, mode == "sampled"))[0]
    rows = []
    for eng in (plain, one):
        cache = eng.new_cache(4)
        with eng.on_mesh():
            for slot, (prompt, _) in enumerate(spec[:4]):
                row, frag = eng._prefill(prompt)
                eng._insert(cache, frag, slot)
                rows.append(row)
            logits, _ = eng._decode_step(
                cache, np.array([[p[-1]] for p, _ in spec[:4]]),
                np.array([len(p) for p, _ in spec[:4]]))
        rows.append(logits)
    half = len(rows) // 2
    assert all(np.array_equal(a, b) for a, b in zip(rows[:half],
                                                    rows[half:]))


def test_a_mesh_without_a_process_group_is_refused():
    cfg = get_config("smollm-360m").reduced(**CFG_KW)
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((1, 2), ("data", "model"), "cpu")
    lone = Mesh((1, 2), ("data", "model"), torch.device("cpu"))
    with pytest.raises(RuntimeError, match="process group"):
        Engine(cfg, max_seq=32, n_slots=4, device="cpu", mesh=lone)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "zamba2-1.2b",
                                  "musicgen-large", "xlstm-350m"])
def test_other_families_raise_on_a_mesh(arch, monkeypatch):
    """Every family builds on a mesh of more than one rank (a mesh whose
    groups are stand-ins), rank 0 holding its blocks: MLA and MoE
    (deepseek-v2-lite), the frontends (musicgen) and the SSM/hybrid
    patterns (zamba2, xLSTM), whose ``Engine.serve`` raises the
    reference's "no fused prefill" there as on one device, before any
    collective (they serve through ``generate_static``)."""
    monkeypatch.setattr(torch.distributed, "get_rank", lambda *a: 0)
    cfg = get_config(arch).reduced()
    mesh = Mesh((1, 2), ("data", "model"), torch.device("cpu"),
                groups={("model",): None})
    eng = Engine(cfg, max_seq=32, n_slots=4, device="cpu", mesh=mesh)
    table = eng.params["embed"]["table"]
    assert table.shape[0] == cfg.padded_vocab // 2
    if any(k != "attn" for k in cfg.block_pattern):
        with pytest.raises(NotImplementedError, match="no fused prefill"):
            eng.serve([Request(uid=0, prompt=[1, 2], max_new_tokens=2)])
