"""Call-time instrumentation for the sparse execution paths.

The paper's Fig. 8a pipeline runs ONE Select (top-k / k-WTA) per sparse
layer; re-deriving the support downstream silently doubles the Select
cost.  Every Select call site in this package goes through
:func:`counted_top_k`, so tests can run a layer and assert exactly one
``torch.topk`` per sparse layer:

    with count_selects() as c:
        ffn_apply(params, x, cfg_sp)
    assert c.top_k == 1

PyTorch runs eagerly, so the counters tick once per call (the reference's
tick once per trace).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

import torch


class SelectCounter:
    """Per-``with``-block Select counts (see :func:`count_selects`)."""

    def __init__(self) -> None:
        self.counts = {"top_k": 0}

    @property
    def top_k(self) -> int:
        return self.counts["top_k"]

    def reset(self) -> None:
        for k in self.counts:
            self.counts[k] = 0


class _State(threading.local):
    def __init__(self) -> None:
        self.stack: list[SelectCounter] = []


_STATE = _State()


@contextlib.contextmanager
def count_selects() -> Iterator[SelectCounter]:
    """Count Select (top_k) calls made while the block is active.

    Scoped and re-entrant: each ``with`` block gets its own
    :class:`SelectCounter`, nested blocks all tick, and counters on other
    threads are untouched."""
    c = SelectCounter()
    _STATE.stack.append(c)
    try:
        yield c
    finally:
        _STATE.stack.remove(c)


def counted_top_k(x: torch.Tensor, k: int):
    """``torch.topk`` over the last axis (largest first, sorted, like
    ``lax.top_k``) that ticks every active Select counter."""
    for c in _STATE.stack:
        c.counts["top_k"] += 1
    return torch.topk(x, k, dim=-1)
