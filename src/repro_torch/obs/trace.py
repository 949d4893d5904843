"""Span tracer: nested wall-clock spans with a thread-local stack.

``Tracer.span("decode.step")`` times a ``with`` block and records one
event per exit: name, start time (relative to the tracer's epoch),
duration, nesting depth, parent span name, plus any keyword attributes.
Events accumulate in an in-memory ring (``max_events``) and, when a sink
is attached (:class:`repro_torch.obs.export.JsonlWriter`), stream out as JSON
lines in the schema :mod:`repro_torch.obs.export` validates.

Spans read the host clock.  Launches on the card are asynchronous, so a
span that closes before a host sync (a copy to the host) measures the
work's dispatch, not its device time.

The stack is thread-local, so spans opened on different threads nest
independently; per-stage totals (``totals()``) aggregate across threads.

Disabled tracers are zero-cost: ``span()`` returns one shared re-entrant
null context manager — no allocation, no clock read, no event.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

__all__ = ["SpanEvent", "Tracer", "NULL_TRACER"]


class SpanEvent:
    __slots__ = ("name", "t_start", "dur_s", "depth", "parent", "attrs")

    def __init__(self, name: str, t_start: float, dur_s: float, depth: int,
                 parent: Optional[str], attrs: Optional[dict]):
        self.name = name
        self.t_start = t_start
        self.dur_s = dur_s
        self.depth = depth
        self.parent = parent
        self.attrs = attrs

    def to_dict(self) -> dict:
        d = {"kind": "span", "name": self.name,
             "ts": round(self.t_start, 6), "dur_s": round(self.dur_s, 6),
             "depth": self.depth, "parent": self.parent}
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class _NullSpan:
    """Shared no-op context manager for disabled tracers (re-entrant)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._tracer._push(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        self._tracer._pop(self, dur)
        return False


class _Stack(threading.local):
    def __init__(self):
        self.names: List[str] = []


class Tracer:
    """Collects :class:`SpanEvent` records; see module docstring.

    ``sink`` is any object with a ``write(dict)`` method (duck-typed to
    :class:`repro_torch.obs.export.JsonlWriter`); writes happen at span exit on
    the span's thread.
    """

    def __init__(self, enabled: bool = True, sink=None,
                 max_events: int = 100_000):
        self.enabled = enabled
        self.sink = sink
        self.events: Deque[SpanEvent] = deque(maxlen=max_events)
        self._epoch = time.perf_counter()
        self._stack = _Stack()
        self._lock = threading.Lock()
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    def span(self, name: str, **attrs):
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs or None)

    # -- internals used by _Span --------------------------------------------
    def _push(self, name: str) -> None:
        self._stack.names.append(name)

    def _pop(self, span: _Span, dur: float) -> None:
        stack = self._stack.names
        stack.pop()
        ev = SpanEvent(span.name, time.perf_counter() - self._epoch - dur,
                       dur, len(stack), stack[-1] if stack else None,
                       span.attrs)
        with self._lock:
            self.events.append(ev)
            self._totals[ev.name] = self._totals.get(ev.name, 0.0) + dur
            self._counts[ev.name] = self._counts.get(ev.name, 0) + 1
        if self.sink is not None:
            self.sink.write(ev.to_dict())

    # -- read side ----------------------------------------------------------
    def totals(self) -> Dict[str, Dict[str, float]]:
        """Per-span-name aggregate: total seconds + completed-span count."""
        with self._lock:
            return {name: {"total_s": t, "count": self._counts[name]}
                    for name, t in sorted(self._totals.items())}


#: Process-wide disabled tracer.
NULL_TRACER = Tracer(enabled=False)
