"""The training step on the rank's blocks on mesh (2, 2) (data x model)
over four gloo ranks on the CPU: smollm-360m (4 heads, 2 kv heads: q, k
and v column blocks), deepseek-v2-lite-16b (MLA heads, MoE experts over
``model``), zamba2-1.2b (Mamba2 and the shared attention block) and
xlstm-350m (mLSTM and sLSTM), reduced, against the reference's
``jax.value_and_grad`` (the checks of tests/_tp_train_cases.py); remat on
against off bit-equal; and the vocab-parallel ``cross_entropy`` against
the reference's on a padded vocabulary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _tp_train_cases as cases
import _torch_dist_ranks as ranks
from repro.models.common import cross_entropy as j_cross_entropy
from repro_torch.launch.ranks import run_ranks

ARCHS = ["smollm-360m", "deepseek-v2-lite-16b", "zamba2-1.2b", "xlstm-350m"]
DIMS = (2, 2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return cases.run(ARCHS, DIMS, tmp_path_factory.mktemp("ranks"),
                     remat_check=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grad_norm_match_the_reference(runs, arch):
    cases.check_loss_and_norm(*runs[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_every_gradient_block_matches_the_reference(runs, arch):
    cases.check_grads(*runs[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_whole_leaves_stay_bit_equal_across_model_ranks(runs, arch):
    cases.check_whole_leaves(runs[arch][1])


@pytest.mark.parametrize("arch", ARCHS)
def test_no_param_block_is_handed_to_a_collective(runs, arch):
    cases.check_no_param_handed(runs[arch][1])


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_are_bit_equal(runs, arch):
    assert all(r["remat_equal"] for r in runs[arch][1])


def test_vocab_parallel_cross_entropy_matches_the_reference(tmp_path):
    """Padded vocabulary: 250 labels' worth of rows, 256 columns (the
    padded ones take part), 4 rows over the DP axis."""
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (4, 6, 256)).astype(np.float32)
    labels = rng.integers(0, 250, (4, 6)).astype(np.int64)
    mask = (rng.random((4, 6)) < 0.7).astype(np.float32)
    want, want_g = {}, {}
    for name, m in (("mean", None), ("masked", mask)):
        f = (lambda x, m=m: j_cross_entropy(
            x, jnp.asarray(labels), None if m is None else jnp.asarray(m)))
        v, g = jax.value_and_grad(f)(jnp.asarray(logits))
        want[name], want_g[name] = float(v), np.asarray(g)
    got = run_ranks(ranks.vocab_parallel_ce, 4, tmp_path,
                    timeout_s=cases.TIMEOUT_S,
                    args=(DIMS, logits, labels, mask))
    for r in got:
        blk = r["block"]
        assert blk[2].stop - blk[2].start == 128
        for name in want:
            assert abs(r[name] - want[name]) <= 1e-6 * abs(want[name])
            # batch_sum's backward scales each DP rank's by the group size
            g = r[f"{name}_grad"] / DIMS[0]
            np.testing.assert_allclose(g, want_g[name][blk], rtol=0,
                                       atol=1e-6 * np.abs(want_g[name]).max())
