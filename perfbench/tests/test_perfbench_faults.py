"""Runs with the timed path broken underneath: a served token altered where
it is produced reads far from the reference, and a cell that BENCHMARK.json
lists comes out not correct.  (One card: no exchange between chips to leave
out; serving keeps no state that a step could return unchanged.)"""

import numpy as np
import pytest

from _perfbench_util import run_small


@pytest.mark.parametrize("name", ["smollm-360m.chat4",
                                  "deepseek-v2-lite-16b.chat4",
                                  "smollm-360m.batch32"])
def test_altered_token_fails(name, monkeypatch):
    import repro_torch.launch.serve as S
    real = S.sample_token
    calls = {"n": 0}

    def altered(logits, params, rng):
        calls["n"] += 1
        if calls["n"] % 7 == 3:         # now and then the least likely
            return int(np.argmin(logits))
        return real(logits, params, rng)

    monkeypatch.setattr(S, "sample_token", altered)
    cell, out = run_small(name)
    assert out["check_detail"]["logit_gap"] > 1e-2
    if cell.limits:
        assert out["correct"] is False
