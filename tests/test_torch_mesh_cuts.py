"""Training and serving on mesh (1, 4) where the blocks cut what the
reference's divisibility fallback lets GSPMD cut
(``repro/sharding/context.py:54-62``: an axis that does not divide a dim
replicates it, and the rest of the partitioning goes through it), over
gloo on the CPU against the reference, in one spawn of four ranks:

* ``mla_heads``: deepseek-v2-lite reduced with 2 heads, whose q, uk and
  uv columns and o rows split into four blocks that cut each head;
* ``expert_groups``: qwen3-moe reduced with 2 experts top-1, whole on
  every rank, each expert's groups split into four blocks;
* ``shared_route``: smollm reduced with ``route_share`` 16 (32 groups, 2
  route tables): the route is kept whole beside each block of 8 groups.

Training, in float32 with the exact top-k k-WTA
(tests/_tp_train_cases.py's checks): the loss within 1e-6 relative of
the reference's ``jax.value_and_grad`` on the same numpy weights, every
rank's DP-mean gradient block within 1e-5·(1+max|g|) of the reference's
gradient cut to that block, whole leaves bit-equal across the ranks, no
param block handed to a collective.  Serving, f32 greedy, contiguous and
paged (tests/_mesh_serve_moe_cases.py's checks): tokens equal to the JAX
``Engine``'s on the same mesh, every rank's param blocks and fresh cache
blocks bit-equal to the reference's shards, no param or cache block
handed to a collective.  A Trainer on the shared route's blocks saves,
resumes and steps on.

And, with no ranks: the training state and the engine refuse alike
(``shard_train_state`` runs serving's block checks)."""

import math

import numpy as np
import pytest
import torch

import _mesh_serve_moe_cases as MC
import _tp_train_cases as TP
import _torch_dist_ranks as ranks
from repro_torch.configs import TrainConfig, get_config
from repro_torch.launch import steps as St
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.launch.serve import Engine
from repro_torch.models import transformer as T
from repro_torch.sharding import make_rules

DIMS = (1, 4)
#: name -> (arch, the cut's ``reduced`` kwargs)
CASES = {
    "mla_heads": ("deepseek-v2-lite-16b", dict(n_heads=2)),
    "expert_groups": ("qwen3-moe-235b-a22b",
                      dict(n_experts=2, experts_per_token=1)),
    "shared_route": ("smollm-360m", dict(route_share=16)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's losses and gradients, then the ranks (training and
    serving, in a thread) beside the JAX engine on the mesh.  Returns
    (train: name -> (reference, the ranks' records), serve: name ->
    :func:`_mesh_serve_moe_cases._serve_both`'s triple)."""
    refs = {n: TP.reference(arch, dict(kw, **TP.F32))
            for n, (arch, kw) in CASES.items()}
    train, resume = {}, []
    ckpt = str(tmp_path_factory.mktemp("cut_ckpt"))

    def spawn(made):
        out = run_ranks(ranks.mesh_cuts, math.prod(DIMS),
                        tmp_path_factory.mktemp("cut_ranks"), threads=1,
                        timeout_s=TP.TIMEOUT_S,
                        args=(DIMS, [refs[n]["case"] for n in CASES], made,
                              (dict(CASES["shared_route"][1], **TP.F32),
                               ckpt)))
        for i, n in enumerate(CASES):
            train[n] = (refs[n], [r["train"][i] for r in out])
        resume.extend(r["resume"] for r in out)
        return [r["serve"] for r in out]

    serve = MC._serve_both(
        [(n, arch, dict(kw, **MC.CFG_KW), MC.LAYOUTS)
         for n, (arch, kw) in CASES.items()], DIMS, None, spawn)
    return train, serve, resume


@MC.needs_devices
@pytest.mark.parametrize("name", list(CASES))
def test_training_on_cut_blocks_matches_the_reference(runs, name):
    TP.check_all(*runs[0][name])


@MC.needs_devices
@pytest.mark.parametrize("layout", list(MC.LAYOUTS))
@pytest.mark.parametrize("name", list(CASES))
def test_tokens_match_the_jax_engine_on_the_mesh(runs, name, layout):
    MC.check_tokens(runs[1][name], layout, DIMS)


@MC.needs_devices
@pytest.mark.parametrize("name", list(CASES))
def test_param_blocks_equal_the_reference_shards(runs, name):
    for layout in MC.LAYOUTS:
        MC.check_params(runs[1][name], CASES[name][0], layout, DIMS)


@MC.needs_devices
@pytest.mark.parametrize("layout", list(MC.LAYOUTS))
@pytest.mark.parametrize("name", list(CASES))
def test_cache_blocks_equal_the_reference_shards(runs, name, layout):
    MC.check_cache(runs[1][name], CASES[name][0], layout, DIMS)


@MC.needs_devices
@pytest.mark.parametrize("layout", list(MC.LAYOUTS))
@pytest.mark.parametrize("name", list(CASES))
def test_serving_hands_no_block_to_a_collective(runs, name, layout):
    for r in runs[1][name][2]:
        c = r[layout]["collectives"]
        assert c["weights_moved"] == 0, (name, layout)
        assert c["per_step"] > 0
        assert set(c["ops"]) <= {"all_gather", "all_reduce_sum",
                                 "all_reduce_max"}


@MC.needs_devices
def test_a_trainer_resumes_blocks_with_their_own_routes(runs):
    """A Trainer on the shared route's blocks saves the training layout
    (no ``block_route`` in the checkpoint), resumes it bit for bit with
    each rank's ``block_route`` kept, and steps on."""
    for r in runs[2]:
        assert r["resumed"] and r["equal"]
        assert r["routes"] and not any("block_route" in k
                                       for k in r["saved"])
        assert np.isfinite(r["loss"])


def test_training_and_serving_refuse_alike(monkeypatch):
    """``shard_train_state`` and ``Engine(mesh=)`` run the same block
    checks on the same blocks: what one refuses, the other does."""
    def refuse(blocks, whole):
        raise NotImplementedError("refused")

    monkeypatch.setattr(T, "check_blocks", refuse)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda *a: 0)
    arch, kw = CASES["shared_route"]
    cfg = TP.config_of(get_config, arch, dict(kw, **TP.F32))
    mesh = Mesh(DIMS, ("data", "model"), torch.device("cpu"),
                groups={("model",): None})
    with pytest.raises(NotImplementedError, match="refused"):
        St.shard_train_state(T.init_train_params(cfg, device="cpu"), cfg,
                             TrainConfig(), make_rules(mesh, "train"))
    with pytest.raises(NotImplementedError, match="refused"):
        Engine(cfg, max_seq=32, n_slots=4, device="cpu", mesh=mesh)


def test_a_padded_packed_bias_cut_beside_its_groups_is_refused():
    """The one cut left refused: a packed layer whose padded groups hold
    more columns than its bias (d_out 30 in 8 groups of 4), both cut over
    two blocks, would add the bias at other columns than the groups'."""
    whole = {"packed": torch.zeros(8, 4, 4), "route": torch.zeros(
        1, 4, 4, dtype=torch.int8), "b": torch.zeros(30)}
    block = {"packed": whole["packed"][:4], "route": whole["route"],
             "b": whole["b"][:15]}
    with pytest.raises(NotImplementedError, match="bias"):
        T.check_blocks(block, whole)
    T.check_blocks(dict(block, b=torch.zeros(16)),
                   dict(whole, b=torch.zeros(32)))


def test_block_routes_read_each_groups_own_table():
    """A block of groups that starts inside a table reads, group by
    group, the table the whole layer's group reads."""
    from repro_torch.core.layers import block_route
    route = torch.arange(5, dtype=torch.int8)[:, None, None].expand(
        5, 3, 4).contiguous()
    for g0, g1 in ((0, 160), (160, 320), (480, 640)):
        got = block_route(route, 640, g0, g1)
        assert got.shape == (g1 - g0, 3, 4)
        assert np.array_equal(got[:, 0, 0].numpy(),
                              np.arange(g0, g1) // 128)
