"""The census of a decode step (``repro_torch.launch.hlo``) against XLA's
count of the reference's, on one device in float32 at one unit (so the
reference's layer scan has one trip, counted once): the port's FLOPs are
within 12% of the reference's ``compiled_flops`` of ``make_serve_step``
(measured: 0.89 to 1.04 of it over the ten archs).  Products agree; XLA
also counts every convert and its masked rewrite of the cache rows, where
the port writes a row in place.  Shared by tests/test_torch_census_decode.py
and tests/test_torch_census_steps.py, each holding half of the archs."""

import dataclasses

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as ref_config
from repro.launch import steps as RSt
from repro.launch.hlo import compiled_flops
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.launch.hlo import census
from repro_torch.models import transformer as T


def check_decode_flops(arch):
    """The census of ``arch``'s decode step (reduced, float32, one unit)
    against the reference's ``compiled_flops`` of ``make_serve_step``."""
    def one_unit(cfg):
        return dataclasses.replace(cfg, n_layers=len(cfg.block_pattern),
                                   compute_dtype="float32")

    jcfg = one_unit(ref_config(arch).reduced())
    params, _ = RT.init_model(jax.random.PRNGKey(0), jcfg)
    cache, _ = RT.init_cache(jcfg, 4, 64)
    embed = jcfg.frontend == "embed"
    batch = ({"embeds": jnp.zeros((4, 1, jcfg.d_model))} if embed
             else {"tokens": jnp.zeros((4, 1), jnp.int32)})
    ref = compiled_flops(jax.jit(RSt.make_serve_step(jcfg)).lower(
        params, cache, batch, jnp.full((4,), 5, jnp.int32)).compile())

    cfg = one_unit(get_config(arch).reduced())
    pbatch = ({"embeds": torch.zeros((4, 1, cfg.d_model))} if embed
              else {"tokens": torch.zeros((4, 1), dtype=torch.int64)})
    rec = census(lambda p, c, b, q: T.serve_step(p, c, b, q, cfg)[0],
                 T.init_model(cfg, seed=0, device="cpu"),
                 T.init_cache(cfg, 4, 64, "cpu"), pbatch,
                 torch.full((4,), 5))
    assert abs(rec["cost"]["flops"] / ref - 1) <= 0.12, (rec["cost"], ref)
    assert rec["host_transfers"] == []
