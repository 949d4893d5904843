"""The one traffic generator: each mix repeats exactly for a seed; the
seed draws the ids and never the sizes; every call asks for the same
work; the warm-up covers every prefill bucket the mix can
use; the output check's sample holds the longest request."""

import json

import numpy as np
import pytest

from _perfbench_util import BENCH
from harness import traffic as TR

SERVE = ["chat4", "chat32"]


def mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", SERVE)
def test_serve_stream_repeats_for_a_seed(name):
    m = mix(name)
    a = TR.ServeStream(m, 49152, 2**31 + 11)
    b = TR.ServeStream(m, 49152, 2**31 + 11)
    for i in range(3):
        for x, y in zip(a.call(i), b.call(i)):
            assert x.uid == y.uid and x.max_new_tokens == y.max_new_tokens
            np.testing.assert_array_equal(x.prompt, y.prompt)


@pytest.mark.parametrize("name", SERVE)
def test_seed_draws_ids_not_sizes(name):
    m = mix(name)
    a = TR.ServeStream(m, 49152, 1).call(1)
    b = TR.ServeStream(m, 49152, 2**33 + 5).call(1)
    assert [len(r.prompt) for r in a] == [len(r.prompt) for r in b]
    assert [r.max_new_tokens for r in a] == [r.max_new_tokens for r in b]
    assert any((x.prompt != y.prompt).any() for x, y in zip(a, b))
    for r in a:
        assert m["prompt_len"]["min"] <= len(r.prompt) <= m["prompt_len"]["max"]
        assert m["output_len"]["min"] <= r.max_new_tokens \
            <= m["output_len"]["max"]
        assert len(r.prompt) + r.max_new_tokens <= m["max_seq"]
        assert r.prompt.min() >= 0 and r.prompt.max() < 49152
    assert len(a) == m["requests_per_call"] == 2 * m["slots"]


@pytest.mark.parametrize("name", SERVE)
def test_every_call_asks_for_the_same_work(name):
    m = mix(name)
    stream = TR.ServeStream(m, 49152, 2**31 + 5)
    calls = [stream.call(i) for i in range(4)]
    for key in (lambda r: len(r.prompt), lambda r: r.max_new_tokens):
        sizes = [sorted(map(key, c)) for c in calls]
        assert all(x == sizes[0] for x in sizes)
        assert len({tuple(map(key, c)) for c in calls}) > 1


def test_check_sample_holds_the_longest():
    from harness.serve import check_sample
    stream = TR.ServeStream(mix("chat4"), 49152, 7)
    done = [(r, [0] * r.max_new_tokens) for i in range(3)
            for r in stream.call(i)]
    a = check_sample(done, 2**31 + 9, 5)
    assert [r.uid for r, _ in a] == [r.uid for r, _ in
                                     check_sample(done, 2**31 + 9, 5)]
    assert len(a) == 5 and [r.uid for r, _ in a] == sorted(
        r.uid for r, _ in a)
    longest = max(len(t) for _, t in done)
    assert max(len(t) for _, t in a) == longest
    assert check_sample(done, 1, len(done)) == done


@pytest.mark.parametrize("name", SERVE)
def test_warmup_covers_every_bucket(name):
    m = mix(name)
    stream = TR.ServeStream(m, 49152, 3)
    used = {TR.prefill_bucket(len(r.prompt), m["max_seq"])
            for i in range(3) for r in stream.call(i)}
    warm = [TR.prefill_bucket(n, m["max_seq"])
            for n in TR.warmup_prompt_lengths(m)]
    assert sorted(warm) == sorted(used) == [128, 256, 512, 1024]
