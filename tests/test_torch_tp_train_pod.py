"""The training step on the rank's blocks on mesh (2, 1, 2) (pod x data x
model: the batch's rows over both DP axes) over four gloo ranks on the
CPU: smollm-360m, deepseek-v2-lite-16b, zamba2-1.2b and xlstm-350m,
reduced, against the reference's ``jax.value_and_grad`` (the checks of
tests/_tp_train_cases.py)."""

import pytest

import _tp_train_cases as cases

ARCHS = ["smollm-360m", "deepseek-v2-lite-16b", "zamba2-1.2b", "xlstm-350m"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return cases.run(ARCHS, (2, 1, 2), tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("arch", ARCHS)
def test_the_step_on_blocks_matches_the_reference_on_a_pod_mesh(runs, arch):
    cases.check_all(*runs[arch])
