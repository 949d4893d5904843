"""The training step on the rank's blocks on mesh (1, 4) (data x model,
no DP) over four gloo ranks on the CPU: smollm-360m (2 kv heads: k and v
whole beside q's column block), deepseek-v2-lite-16b, zamba2-1.2b and
xlstm-350m, reduced, against the reference's ``jax.value_and_grad`` (the
checks of tests/_tp_train_cases.py)."""

import pytest

import _tp_train_cases as cases

ARCHS = ["smollm-360m", "deepseek-v2-lite-16b", "zamba2-1.2b", "xlstm-350m"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return cases.run(ARCHS, (1, 4), tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("arch", ARCHS)
def test_the_step_on_blocks_matches_the_reference(runs, arch):
    cases.check_all(*runs[arch])
