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

:func:`named_scope` is the counterpart of ``jax.named_scope``: the model
code opens the reference's scopes (``b{i}_{kind}``, ``ffn_down``,
``cs_topk``, ``select``...), and while the linter traces
(:func:`tracing_scopes`, :mod:`repro_torch.analysis.graph_walk`) every
graph node made inside one carries its path, e.g.
``u0/b0_attn/ffn_down/cs_topk/select``, in ``node.meta["custom"]["scope"]``.
Outside a trace it returns a shared null context: eager serving pays a
call and a flag read for it, and no device work.
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
        self.tracing = False           # set by tracing_scopes()
        self.scopes: list[str] = []    # open named_scope segments


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


@contextlib.contextmanager
def pause_selects() -> Iterator[None]:
    """No Select counter of this thread ticks while the block runs (a
    block's recompute in the backward: the step counted it once)."""
    saved, _STATE.stack = _STATE.stack, []
    try:
        yield
    finally:
        _STATE.stack = saved


def counted_top_k(x: torch.Tensor, k: int):
    """``torch.topk`` over the last axis (largest first, sorted, like
    ``lax.top_k``) that ticks every active Select counter.  Traced under
    a ``select`` scope, as the reference stages it."""
    for c in _STATE.stack:
        c.counts["top_k"] += 1
    with named_scope("select"):
        return torch.topk(x, k, dim=-1)


_NULL_SCOPE = contextlib.nullcontext()


@contextlib.contextmanager
def _scope(name: str) -> Iterator[None]:
    import torch.fx.traceback as fx_traceback
    _STATE.scopes.append(name)
    try:
        with fx_traceback.annotate({"scope": "/".join(_STATE.scopes)}):
            yield
    finally:
        _STATE.scopes.pop()


def named_scope(name: str):
    """Open scope ``name`` (nested under the open ones) for the graph
    nodes traced inside it; a null context unless the linter traces."""
    return _scope(name) if _STATE.tracing else _NULL_SCOPE


@contextlib.contextmanager
def tracing_scopes() -> Iterator[None]:
    """Make :func:`named_scope` annotate graph nodes while the block runs
    (on this thread), starting from an empty path."""
    saved = _STATE.tracing, _STATE.scopes
    _STATE.tracing, _STATE.scopes = True, []
    try:
        yield
    finally:
        _STATE.tracing, _STATE.scopes = saved
