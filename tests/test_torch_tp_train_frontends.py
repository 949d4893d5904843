"""One training step on the rank's blocks on mesh (2, 2) over four gloo
ranks on the CPU for each frontend, musicgen-large (``embeds`` in place
of tokens) and internvl2-2b (a vision prefix before the tokens), reduced,
against the reference's ``jax.value_and_grad`` (the checks of
tests/_tp_train_cases.py)."""

import pytest

import _tp_train_cases as cases

ARCHS = ["musicgen-large", "internvl2-2b"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return cases.run(ARCHS, (2, 2), tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("arch", ARCHS)
def test_the_frontends_step_on_blocks(runs, arch):
    cases.check_all(*runs[arch])
