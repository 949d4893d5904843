"""Differential fuzz harness for the port's grow-on-demand paged KV cache,
mirroring tests/test_kvcache_fuzz.py.

Random serving schedules — mixed prompt lengths, duplicated and extended
prompts (forcing prefix sharing + copy-on-write), small page pools
(forcing lazy growth and preemption) — run through BOTH of the port's
engines:

* the paged engine under ``kv_policy="grow"`` (chains admitted on the
  prompt footprint, extended lazily, preempted under pressure, prefix
  pages shared copy-on-write), and
* the contiguous engine, the token-exact greedy oracle (itself pinned to
  the JAX engine by tests/test_torch_serve.py).

Every schedule must produce IDENTICAL tokens for every request, with
``BlockAllocator.check()`` asserting pool invariants after every
admit/preempt/retire and every serve-loop iteration (``REPRO_KV_CHECK=1``
for every test of this module).  A failing schedule is printed as a
replayable ``run_schedule(Schedule(...))`` literal, and hypothesis
shrinks it to a minimal reproducer.

Profiles (select with ``HYPOTHESIS_PROFILE``): ``dev`` (default, 20
examples), ``ci`` (200, derandomized) and ``nightly`` (1000).  Without
hypothesis installed the ``@given`` test skips and the seeded
``test_fuzz_seeded_schedules`` twin still runs the same harness.
"""

import dataclasses
import os
from typing import Tuple

import numpy as np
import pytest

from _hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st
from repro_torch.configs import get_config
from repro_torch.launch.serve import Engine
from repro_torch.runtime.scheduler import Request, SamplingParams

if HAVE_HYPOTHESIS:
    settings.register_profile("dev", max_examples=20, deadline=None)
    settings.register_profile("ci", max_examples=200, deadline=None,
                              derandomize=True, print_blob=True)
    settings.register_profile("nightly", max_examples=1000, deadline=None)
    settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "dev"))

# fixed geometry: the reference harness's
PAGE_SIZE = 4
N_SLOTS = 3
MAX_SEQ = 24          # blocks_per_slot = 6, so pools >= 7 pages work
PREFILL_CHUNK = 8
POOL_CHOICES = (8, 11, 16)   # usable capacity 7 / 10 / 15 (<= 16 pages)
MAX_PROMPT = 12
MAX_GEN = 6           # worst case ceil(18/4) = 5 pages <= every pool
VOCAB_DRAW = 256


@pytest.fixture(autouse=True, scope="module")
def paranoid():
    """Allocator invariants checked every serve-loop iteration and at
    every page change, not only on drain (module-scoped: hypothesis runs
    every example inside one call of its test)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_KV_CHECK", "1")
        yield


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One replayable fuzz case: a pool size and the request batch
    (``(prompt_tokens, max_new_tokens)`` per request, submitted FIFO)."""
    n_pages: int
    requests: Tuple[Tuple[Tuple[int, ...], int], ...]


_ENGINES = {}


def _engines(n_pages):
    """(contiguous oracle, paged grow engine) for one pool size — cached
    so every example reuses the same weights."""
    if "oracle" not in _ENGINES:
        cfg = get_config("smollm-360m").reduced(
            d_model=128, d_ff=512, vocab_size=512, n_heads=4,
            n_kv_heads=2, head_pad=0, compute_dtype="float32",
            param_dtype="float32")
        _ENGINES["oracle"] = Engine(cfg, max_seq=MAX_SEQ, n_slots=N_SLOTS,
                                    device="cpu")
    oracle = _ENGINES["oracle"]
    if n_pages not in _ENGINES:
        _ENGINES[n_pages] = Engine(
            oracle.cfg, max_seq=MAX_SEQ, n_slots=N_SLOTS,
            kv_layout="paged", page_size=PAGE_SIZE, n_pages=n_pages,
            prefill_chunk=PREFILL_CHUNK, params=oracle.params,
            kv_policy="grow", device="cpu")
    return oracle, _ENGINES[n_pages]


def _requests(sched: Schedule):
    return [Request(uid=i, prompt=list(p), max_new_tokens=g,
                    sampling=SamplingParams(seed=i))
            for i, (p, g) in enumerate(sched.requests)]


def run_schedule(sched: Schedule):
    """Run one schedule through oracle and grow engine; assert token
    parity and per-request budget.  Returns the paged stats so callers
    can accumulate coverage (preemptions / CoW / prefix hits)."""
    oracle, paged = _engines(sched.n_pages)
    out_c, _ = oracle.serve(_requests(sched))
    out_p, stats = paged.serve(_requests(sched))
    trace = f"run_schedule({sched!r})"
    assert out_p == out_c, (
        f"paged grow engine diverged from the contiguous oracle\n"
        f"  oracle: {out_c}\n  paged:  {out_p}\n  replay: {trace}")
    for i, (_, g) in enumerate(sched.requests):
        # greedy + no eos: every request spends exactly its full budget
        assert len(out_p[i]) == g, f"budget missed on uid {i}: {trace}"
    return stats


def _np_schedule(rng: np.random.Generator) -> Schedule:
    """The strategy, mirrored for the seeded no-hypothesis twin: a few
    base prompts, each request either fresh, an exact duplicate (CoW
    pressure) or a base+suffix extension (prefix-sharing pressure)."""
    n_pages = int(rng.choice(POOL_CHOICES))
    bases = [tuple(int(t) for t in
                   rng.integers(0, VOCAB_DRAW, int(rng.integers(1, 13))))
             for _ in range(int(rng.integers(1, 4)))]
    reqs = []
    for _ in range(int(rng.integers(1, 9))):
        mode = rng.choice(("fresh", "dup", "extend"))
        if mode == "fresh":
            prompt = tuple(int(t) for t in rng.integers(
                0, VOCAB_DRAW, int(rng.integers(1, 13))))
        elif mode == "dup":
            prompt = bases[int(rng.integers(0, len(bases)))]
        else:
            base = bases[int(rng.integers(0, len(bases)))]
            ext = tuple(int(t) for t in rng.integers(
                0, VOCAB_DRAW, int(rng.integers(1, 5))))
            prompt = (base + ext)[:MAX_PROMPT]
        reqs.append((prompt, int(rng.integers(1, MAX_GEN + 1))))
    return Schedule(n_pages=n_pages, requests=tuple(reqs))


if HAVE_HYPOTHESIS:
    @st.composite
    def schedules(draw):
        n_pages = draw(st.sampled_from(POOL_CHOICES))
        tokens = st.integers(0, VOCAB_DRAW - 1)
        prompts = st.lists(tokens, min_size=1,
                           max_size=MAX_PROMPT).map(tuple)
        bases = draw(st.lists(prompts, min_size=1, max_size=3))
        reqs = []
        for _ in range(draw(st.integers(1, 8))):
            mode = draw(st.sampled_from(("fresh", "dup", "extend")))
            if mode == "fresh":
                prompt = draw(prompts)
            elif mode == "dup":
                prompt = draw(st.sampled_from(bases))
            else:
                base = draw(st.sampled_from(bases))
                ext = draw(st.lists(tokens, min_size=1,
                                    max_size=4).map(tuple))
                prompt = (base + ext)[:MAX_PROMPT]
            reqs.append((prompt, draw(st.integers(1, MAX_GEN))))
        return Schedule(n_pages=n_pages, requests=tuple(reqs))
else:  # pragma: no cover - strategy stub; the @given test is skipped
    def schedules():
        return st


@given(schedules())
def test_fuzz_grow_engine_matches_oracle(sched):
    run_schedule(sched)


def test_fuzz_seeded_schedules():
    """Hypothesis-free twin: 25 seeded random schedules through the same
    differential harness.  The corpus must cover the interesting
    transitions at least once — growth, preemption, prefix adoption and a
    CoW break."""
    rng = np.random.default_rng(0)
    totals = {"preemptions": 0, "cow_copies": 0, "prefix_hit_pages": 0,
              "grown_pages": 0}
    for _ in range(25):
        stats = run_schedule(_np_schedule(rng))
        for k in totals:
            totals[k] += stats[k]
    assert totals["grown_pages"] > 0, totals
    assert totals["preemptions"] > 0, totals
    assert totals["prefix_hit_pages"] > 0, totals
    assert totals["cow_copies"] > 0, totals


def test_schedule_literal_replays():
    """A printed ``run_schedule(Schedule(...))`` literal is a reproducer:
    its repr evaluates back to an equal schedule, which runs again."""
    sched = _np_schedule(np.random.default_rng(11))
    replay = eval(repr(sched), {"Schedule": Schedule})
    assert replay == sched
    assert run_schedule(replay)["pages_capacity"] == sched.n_pages - 1


def test_fuzz_forced_preemption_parity():
    """A pool of 7 usable pages under six 15..22-row requests MUST
    preempt (recompute-on-resume) and still match the oracle token for
    token."""
    sched = Schedule(n_pages=8, requests=tuple(
        (tuple(int(t) for t in
               np.random.default_rng(i).integers(0, VOCAB_DRAW, p)), g)
        for i, (p, g) in enumerate(
            [(9, 6), (12, 6), (6, 6), (11, 5), (7, 6), (10, 5)])))
    stats = run_schedule(sched)
    assert stats["preemptions"] >= 1, stats
    assert stats["grown_pages"] >= 1, stats


def test_fuzz_forced_cow_in_place_parity():
    """With the pool EXACTLY full (parent 3 pages + filler 4 = 7 usable),
    the exact duplicate admits by pure adoption (0 fresh pages), so when
    the parent's first decode write hits the shared tail page, ``_cow``
    finds no free page and ``_ensure_free`` preempts the duplicate — the
    page's only co-holder — before ``cow_page`` runs.  ``cow_page`` then
    returns ``None`` (uniquely held again); the engine writes in place
    and token parity still holds."""
    rng = np.random.default_rng(3)
    parent = tuple(int(t) for t in rng.integers(0, VOCAB_DRAW, 10))
    filler = tuple(int(t) for t in rng.integers(0, VOCAB_DRAW, 16))
    sched = Schedule(n_pages=8, requests=(
        # 3 pages; gen 3 keeps the parent decoding into its tail page
        # for one iteration AFTER the duplicate adopts
        (parent, 3),
        (filler, 1),      # 4 pages: fills the pool, prefills 2 chunks
        (parent, 2),      # admitted by adoption once the parent registers
    ))
    stats = run_schedule(sched)
    assert stats["prefix_hit_pages"] >= 3, stats
    assert stats["cow_in_place"] >= 1, stats
    assert stats["preemptions"] >= 2, stats   # duplicate, then filler


def test_fuzz_forced_cow_fork_parity():
    """A duplicate admitted after its parent's prefill has registered
    adopts the parent's pages (prefix hit) and breaks the shared last page
    with a copy-on-write fork before rewriting its final prompt token."""
    base = tuple(int(t) for t in
                 np.random.default_rng(7).integers(0, VOCAB_DRAW, 12))
    sched = Schedule(n_pages=16, requests=(
        # parent decodes long enough to stay alive while the dups land
        (base, 6),
        # two budget-1 fillers occupy the other slots and retire at
        # their own prefill, so the duplicate is admitted only AFTER
        # the parent's last chunk has registered its pages
        ((5, 6, 7), 1),
        ((8, 9, 10), 1),
        (base, 6),                       # exact duplicate -> CoW
        (base + (3, 1, 4), 5),           # extension -> pure prefix hits
    ))
    stats = run_schedule(sched)
    assert stats["prefix_hit_pages"] >= 3, stats
    assert stats["cow_copies"] >= 1, stats
