"""The port's dry run (``repro_torch.launch.dryrun``, the abstract helpers
of ``launch/steps.py``) against the reference's sharding on the
production meshes: each rank's parameter bytes of every shipped arch on
16x16 and 2x16x16 under the train and decode rules, the reference's side
from ``param_sharding`` on ``jax.sharding.AbstractMesh`` (no devices).

The cells' breakdown is in ``tests/test_torch_dryrun_cells.py``, a 235B
cell and the CLI in ``tests/test_torch_dryrun_cli.py``, the census
against XLA's count in ``tests/test_torch_census_decode.py``."""

import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch import steps as RSt
from repro.sharding import make_rules as ref_rules
from repro.sharding import param_sharding as ref_param_sharding
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import steps as St
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding import make_rules, param_sharding
from repro_torch.tree import leaves

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ref_rank_bytes(arch):
    """{(multi_pod, kind): bytes of one device's shards} of the
    reference's ``abstract_params`` tree."""
    params_s, specs = RSt.abstract_params(ref_config(arch))
    out = {}
    for mp, (dims, axes) in MESHES.items():
        mesh = jax.sharding.AbstractMesh(dims, axes)
        for kind in ("train", "decode"):
            sh = ref_param_sharding(specs, params_s, ref_rules(mesh, kind))
            out[mp, kind] = sum(
                int(np.prod(s.shard_shape(p.shape))) * p.dtype.itemsize
                for s, p in zip(jax.tree.leaves(sh),
                                jax.tree.leaves(params_s)))
    return out


def _block_bytes(blocks) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(blocks))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rank_param_bytes_equal_the_reference_sharding(arch):
    """Each rank's blocks as ``abstract_params(cfg, rules)`` draws them on
    16x16 under the decode rules, and as the whole tree's shardings cut
    them for every mesh and kind."""
    want = _ref_rank_bytes(arch)
    cfg = get_config(arch)
    whole, specs = St.abstract_params(cfg, device="cpu")
    assert all(type(t).__name__ == "FakeTensor" and t.device.type == "cpu"
               for t in leaves(whole))
    for (mp, kind), ref_bytes in want.items():
        rules = make_rules(make_production_mesh(multi_pod=mp, device="cpu"),
                           kind)
        shapes = [sh.local_shape(t.shape) for sh, t in zip(
            leaves(param_sharding(specs, whole, rules)), leaves(whole))]
        got = sum(math.prod(s) * t.element_size() for s, t in zip(
            shapes, leaves(whole)) if s != (0,))
        assert got == ref_bytes, (mp, kind)
    rules = make_rules(make_production_mesh(device="cpu"), "decode")
    blocks, _ = St.abstract_params(cfg, rules, device="cpu")
    assert _block_bytes(blocks) == want[False, "decode"]
