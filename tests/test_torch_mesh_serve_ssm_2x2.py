"""The port's ``Engine`` on the SSM/hybrid patterns (zamba2, xLSTM) on
mesh (2, 2) over gloo on the CPU against the JAX ``Engine`` on the same
mesh: the checks of tests/_mesh_serve_ssm_cases.py. With the
decode_long jobs: zamba2's shared attention cache rows and
deepseek-v2-lite's latent cache rows over data and model together."""

import pytest

from _mesh_serve_ssm_cases import (  # noqa: F401  (fixtures and tests)
    check_decode_long, models, needs_devices, runs,
    test_ssm_cache_blocks_equal_the_reference_shards,
    test_ssm_collectives_move_no_block,
    test_ssm_param_blocks_equal_the_reference_shards,
    test_ssm_serve_raises_as_the_reference_on_the_mesh,
    test_ssm_static_tokens_match_the_jax_engine_on_the_mesh)


@pytest.fixture(scope="module")
def dims():
    return (2, 2)


@pytest.fixture(scope="module")
def long_too():
    return True


@needs_devices
def test_zamba2_decode_long_splits_the_shared_rows_over_both_axes(runs):
    check_decode_long(runs)


@needs_devices
def test_mla_decode_long_splits_the_latent_rows_over_both_axes(runs):
    check_decode_long(runs, "deepseek-v2-lite-16b")
