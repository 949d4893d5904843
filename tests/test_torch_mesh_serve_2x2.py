"""The port's ``Engine`` on mesh (2, 2) over gloo on the CPU against the
JAX ``Engine`` on the same mesh: the checks of tests/_mesh_serve_cases.py
(slots shard over ``data``, the contiguous cache's rows over
``model``)."""

import pytest

from _mesh_serve_cases import (  # noqa: F401  (fixtures and tests)
    model, runs, test_cache_blocks_equal_the_reference_shards,
    test_decode_collectives_move_no_weight,
    test_generate_static_matches_the_jax_engine_on_the_mesh,
    test_param_blocks_equal_the_reference_shards,
    test_tokens_match_the_jax_engine_on_the_mesh)


@pytest.fixture(scope="module")
def dims():
    return (2, 2)
