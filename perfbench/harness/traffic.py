"""The one general traffic generator: it reads a mix's data file.

Serving mixes (``"kind": "serve"``) give the slots, the requests of one
``Engine.serve`` call and the distributions of prompt and output lengths.
The lengths come from the mix's own ``lengths_seed``, so every ``--seed``
serves the same sizes in the same order and a run's work does not move with
the seed; ``--seed`` draws the token ids, request by request (and through
them the k-WTA winners and the MoE routing).  Every call holds the same
lengths (the distribution's quantiles at (j + 1/2) / R for its R
requests), prompts and outputs each in an order of the call's own, so that
every call asks for the same work and a window of more calls or fewer
reads the same rate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List

import numpy as np


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    uid: int
    prompt: np.ndarray        # int64 token ids
    max_new_tokens: int


def _quantiles(spec: Dict, n: int) -> np.ndarray:
    """The ``n`` lengths at the distribution's quantiles (j + 1/2) / n."""
    if spec["dist"] != "log_uniform":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    lo, hi = int(spec["min"]), int(spec["max"])
    u = (np.arange(n) + 0.5) / n
    x = np.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo)))
    return np.clip(np.floor(x).astype(np.int64), lo, hi)


def _ids(seed: int, index: int, n: int, vocab: int) -> np.ndarray:
    """``n`` ids uniform over the vocabulary, from (seed, index) alone."""
    rng = np.random.default_rng([int(seed) & (2**64 - 1), index])
    return rng.integers(0, vocab, size=n, dtype=np.int64)


class ServeStream:
    """The mix's stream of ``Engine.serve`` calls: call ``i`` holds
    requests ``i·R .. i·R + R - 1`` (R = ``requests_per_call``)."""

    def __init__(self, mix: Dict, vocab: int, seed: int):
        if mix["kind"] != "serve":
            raise ValueError(f"not a serving mix: {mix['kind']!r}")
        if mix.get("token_ids") != "uniform_vocab":
            raise ValueError(f"token ids {mix.get('token_ids')!r} unknown")
        self.mix = mix
        self.vocab = vocab
        self.seed = seed
        self.per_call = int(mix["requests_per_call"])
        self._len_rng = np.random.default_rng(int(mix["lengths_seed"]))
        self._lengths: List = []

    def _length(self, uid: int):
        while len(self._lengths) <= uid:
            n = self.per_call
            p = self._len_rng.permutation(
                _quantiles(self.mix["prompt_len"], n))
            o = self._len_rng.permutation(
                _quantiles(self.mix["output_len"], n))
            self._lengths.extend(zip(p.tolist(), o.tolist()))
        return self._lengths[uid]

    def request(self, uid: int) -> ServeRequest:
        p_len, out = self._length(uid)
        if p_len + out > int(self.mix["max_seq"]):
            raise ValueError(f"request {uid}: {p_len} + {out} exceeds "
                             f"max_seq {self.mix['max_seq']}")
        return ServeRequest(uid, _ids(self.seed, uid, p_len, self.vocab),
                            int(out))

    def call(self, i: int) -> List[ServeRequest]:
        return [self.request(i * self.per_call + j)
                for j in range(self.per_call)]

    def calls(self) -> Iterator[List[ServeRequest]]:
        i = 0
        while True:
            yield self.call(i)
            i += 1


def prefill_bucket(n: int, max_seq: int) -> int:
    """The engine's prefill bucket of a prompt of ``n`` tokens: the next
    power of two, at least 8, at most ``max_seq``."""
    b = 8
    while b < n:
        b *= 2
    return min(b, max_seq)


def warmup_prompt_lengths(mix: Dict) -> List[int]:
    """One prompt length for every prefill bucket the mix's prompts fall
    into, and none for the others."""
    lengths = _quantiles(mix["prompt_len"], int(mix["requests_per_call"]))
    by_bucket = {prefill_bucket(int(n), int(mix["max_seq"])): int(n)
                 for n in lengths}
    return sorted(by_bucket.values())

