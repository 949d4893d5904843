"""The accounting steps of ``launch/steps.py`` against the reference's on
its weights (float32: 1e-5 forward, 1e-4 the unit's input gradient, 1e-6
the head's), and the census of a decode step against the reference's
``compiled_flops`` (tests/_census_decode_cases.py) for the last five of
the reference's archs."""

import jax
import numpy as np
import pytest
import torch

from _census_decode_cases import check_decode_flops
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_config
from repro.models import transformer as RT
from repro_torch.configs import get_config


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", REF_ARCH_IDS[5:])
def test_decode_flops_are_the_reference_compiled_flops(arch):
    check_decode_flops(arch)


def test_the_accounting_steps_equal_the_reference():
    """One unit's forward and forward+backward, and the embedding + head +
    loss step, on the reference's weights (reduced smollm, float32)."""
    from repro.launch import steps as JSt
    from repro_torch.bridge import train_params_from_jax
    from repro_torch.launch import steps as St
    from repro_torch.tree import leaves
    jcfg = ref_config("smollm-360m").reduced(compute_dtype="float32")
    cfg = get_config("smollm-360m").reduced(compute_dtype="float32")
    jparams, _ = RT.init_model(jax.random.PRNGKey(0), jcfg)
    params = train_params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    junit = jax.tree.map(lambda x: x[0], jparams["units"])
    unit = {f"b{i}": params["layers"][i]
            for i in range(len(cfg.block_pattern))}
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(8), (2, 8))
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos.copy())

    want = JSt.make_unit_fwd_step(jcfg)(junit, None, x, pos)
    got = St.make_unit_fwd_step(cfg)(unit, None, tx, tpos)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)

    jg, jgx = JSt.make_unit_train_step(jcfg)(junit, None, x, pos)
    grads = St.make_unit_train_step(cfg)(unit, None, tx, tpos)
    np.testing.assert_allclose(grads[-1].numpy(), jgx, rtol=1e-4, atol=1e-4)
    assert len(grads) == len(leaves(unit)) + 1

    tokens = rng.integers(0, cfg.vocab_size, (2, 8))
    table = jparams["embed"]["table"]
    jdt, jdx = JSt.make_head_train_step(jcfg)(table, tokens, tokens, x)
    dt, dx = St.make_head_train_step(cfg)(
        params["embed"]["table"], torch.from_numpy(tokens),
        torch.from_numpy(tokens), tx)
    np.testing.assert_allclose(dt.numpy(), jdt, atol=1e-6)
    np.testing.assert_allclose(dx.numpy(), jdx, atol=1e-6)
