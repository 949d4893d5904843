"""The port's ``Engine`` on the SSM/hybrid patterns (zamba2, xLSTM) on
mesh (1, 2) over gloo on the CPU against the JAX ``Engine`` on the same
mesh: the checks of tests/_mesh_serve_ssm_cases.py."""

import pytest

from _mesh_serve_ssm_cases import (  # noqa: F401  (fixtures and tests)
    models, runs,
    test_ssm_cache_blocks_equal_the_reference_shards,
    test_ssm_collectives_move_no_block,
    test_ssm_param_blocks_equal_the_reference_shards,
    test_ssm_serve_raises_as_the_reference_on_the_mesh,
    test_ssm_static_tokens_match_the_jax_engine_on_the_mesh)


@pytest.fixture(scope="module")
def dims():
    return (1, 2)


@pytest.fixture(scope="module")
def long_too():
    return False

