"""The port's ``Engine`` on the MoE + MLA family and with the int8 KV
cache on mesh (1, 4) over gloo on the CPU against the JAX ``Engine`` on
the same mesh: the checks of tests/_mesh_serve_moe_cases.py."""

import pytest

from _mesh_serve_moe_cases import (  # noqa: F401  (fixtures and tests)
    runs, test_int8_paged_cache_matches_the_jax_engine_on_the_mesh,
    test_moe_cache_blocks_equal_the_reference_shards,
    test_moe_decode_collectives_move_no_weight,
    test_moe_param_blocks_equal_the_reference_shards,
    test_moe_tokens_match_the_jax_engine_on_the_mesh)


@pytest.fixture(scope="module")
def dims():
    return (1, 4)


@pytest.fixture(scope="module")
def int8_too():
    return True
