"""Metrics registry: counters, gauges, fixed-bucket latency histograms.

The runtime-observability counterpart of the *static* sparsity linter
(:mod:`repro_torch.analysis`): the linter proves the traced program has
the right structure, this registry measures what the structure *does* at
runtime — request latencies, stage times, queue depths, realized
activation sparsity.  A copy of the reference's ``repro.obs.metrics``
(the port imports nothing of the reference).  Design constraints:

* **Thread-safe** — one lock per registry guards both the name table and
  every update; metric objects are cheap enough that serving-loop call
  sites (a handful of updates per decode step) cost microseconds.
* **Zero-cost when disabled** — a disabled registry hands out shared
  null singletons whose ``inc``/``set``/``observe`` are empty methods, so
  instrumented code needs no ``if telemetry:`` branches and the disabled
  path allocates nothing per call.
* **Snapshot-oriented** — no background threads, no push model:
  ``Registry.snapshot()`` returns a plain nested dict (JSON-ready), the
  thing ``Engine.metrics_snapshot()`` embeds.

Histograms use fixed bucket edges (default: log-spaced seconds, 100 µs to
~178 s) so that merging/exporting never re-bins; percentiles are
estimated by linear interpolation inside the hit bucket, with the
observed min/max clamping the first/last buckets (exact for the common
"all mass in one bucket" smoke-test case).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "RollingHistogram", "Registry",
           "NULL_REGISTRY", "DEFAULT_LATENCY_EDGES_S"]


def _log_edges(lo: float, hi: float, per_decade: int) -> Tuple[float, ...]:
    n = int(math.ceil(per_decade * math.log10(hi / lo))) + 1
    return tuple(lo * 10.0 ** (i / per_decade) for i in range(n))


#: Default latency bucket edges (seconds): 4 buckets per decade from
#: 100 µs to ~178 s — spans a fast CPU decode step to a stuck request.
DEFAULT_LATENCY_EDGES_S = _log_edges(1e-4, 100.0, 4)


def _bucket_index(edges: Sequence[float], v: float) -> int:
    """First bucket with ``v <= edge`` (binary search), else overflow."""
    lo, hi = 0, len(edges)
    while lo < hi:
        mid = (lo + hi) // 2
        if v <= edges[mid]:
            hi = mid
        else:
            lo = mid + 1
    return lo


class Counter:
    """Monotonic counter (e.g. tokens generated, prefill calls)."""

    __slots__ = ("name", "unit", "_lock", "_value")

    def __init__(self, name: str, unit: str, lock: threading.Lock):
        self.name = name
        self.unit = unit
        self._lock = lock
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self):
        return self._value


class Gauge:
    """Last-write-wins sample (e.g. queue depth, EMA state)."""

    __slots__ = ("name", "unit", "_lock", "_value")

    def __init__(self, name: str, unit: str, lock: threading.Lock):
        self.name = name
        self.unit = unit
        self._lock = lock
        self._value: Optional[float] = None

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def reset(self) -> None:
        with self._lock:
            self._value = None

    @property
    def value(self) -> Optional[float]:
        return self._value

    def snapshot(self):
        return self._value


class Histogram:
    """Fixed-bucket histogram with interpolated percentile snapshots.

    ``edges`` are the bucket upper bounds (ascending); observation ``v``
    lands in the first bucket with ``v <= edge``, or the overflow bucket
    past the last edge.  ``percentile(q)`` linearly interpolates within
    the hit bucket (clamped by observed min/max), which is exact when a
    bucket holds uniform mass and never off by more than one bucket
    width otherwise.
    """

    __slots__ = ("name", "unit", "edges", "_lock", "_counts", "_count",
                 "_sum", "_min", "_max")

    def __init__(self, name: str, unit: str, lock: threading.Lock,
                 edges: Sequence[float] = DEFAULT_LATENCY_EDGES_S):
        if not edges or list(edges) != sorted(edges):
            raise ValueError(f"histogram {name}: edges must be ascending "
                             f"and non-empty, got {edges!r}")
        self.name = name
        self.unit = unit
        self.edges = tuple(float(e) for e in edges)
        self._lock = lock
        self._counts = [0] * (len(self.edges) + 1)  # +1 overflow
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._counts[self._bucket(v)] += 1
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.edges) + 1)
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf

    def _bucket(self, v: float) -> int:
        return _bucket_index(self.edges, v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> Optional[float]:
        return self._sum / self._count if self._count else None

    def percentile(self, q: float) -> Optional[float]:
        """Interpolated q-th percentile (q in [0, 100])."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile q={q} outside [0, 100]")
        if self._count == 0:
            return None
        target = q / 100.0 * self._count
        cum = 0
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.edges[i - 1] if i > 0 else 0.0
                hi = self.edges[i] if i < len(self.edges) else self._max
                # clamp by observed extrema (exact one-bucket case)
                lo = max(lo, self._min)
                hi = min(hi, self._max)
                if hi <= lo:
                    return lo
                frac = (target - cum) / c
                return lo + frac * (hi - lo)
            cum += c
        return self._max

    def snapshot(self) -> Dict:
        with self._lock:
            if self._count == 0:
                return {"count": 0}
            return {
                "count": self._count,
                "sum": self._sum,
                "mean": self._sum / self._count,
                "min": self._min,
                "max": self._max,
                "p50": self.percentile(50.0),
                "p95": self.percentile(95.0),
                "p99": self.percentile(99.0),
            }


class RollingHistogram:
    """Windowed percentiles: a ring of time-sliced sub-histograms.

    A run-lifetime :class:`Histogram` answers "how has latency been since
    start"; long-lived serving wants "how is latency NOW".  The window
    ``[now - window_s, now)`` is covered by ``n_slices`` sub-histograms
    of ``window_s / n_slices`` seconds each: ``observe`` lands in the
    slice owning the current instant (lazily zeroing a slice whose old
    epoch has expired — O(1) per observation, no background thread), and
    ``percentile``/``snapshot`` merge only the slices still inside the
    window.  Old mass thus ages out with slice granularity instead of
    accumulating forever, at a fixed memory cost of
    ``n_slices × len(edges)`` ints.

    ``clock`` is injectable (tests drive a fake clock; default
    ``time.monotonic``).
    """

    __slots__ = ("name", "unit", "edges", "window_s", "n_slices", "_lock",
                 "_clock", "_slice_s", "_ids", "_counts", "_n", "_sum",
                 "_min", "_max")

    def __init__(self, name: str, unit: str, lock: threading.Lock,
                 edges: Sequence[float] = DEFAULT_LATENCY_EDGES_S,
                 window_s: float = 60.0, n_slices: int = 6, clock=None):
        if not edges or list(edges) != sorted(edges):
            raise ValueError(f"rolling histogram {name}: edges must be "
                             f"ascending and non-empty, got {edges!r}")
        if window_s <= 0 or n_slices < 1:
            raise ValueError(f"rolling histogram {name}: need window_s > 0 "
                             f"and n_slices >= 1, got {window_s}/{n_slices}")
        self.name = name
        self.unit = unit
        self.edges = tuple(float(e) for e in edges)
        self.window_s = float(window_s)
        self.n_slices = int(n_slices)
        self._lock = lock
        self._clock = clock if clock is not None else time.monotonic
        self._slice_s = self.window_s / self.n_slices
        n = self.n_slices
        self._ids = [-1] * n           # epoch owning each ring position
        self._counts = [[0] * (len(self.edges) + 1) for _ in range(n)]
        self._n = [0] * n
        self._sum = [0.0] * n
        self._min = [math.inf] * n
        self._max = [-math.inf] * n

    def _clear(self, i: int, sid: int) -> None:
        self._ids[i] = sid
        self._counts[i] = [0] * (len(self.edges) + 1)
        self._n[i] = 0
        self._sum[i] = 0.0
        self._min[i] = math.inf
        self._max[i] = -math.inf

    def _slot(self, sid: int) -> int:
        """Ring position for epoch ``sid``, zeroed if a stale epoch
        still occupies it."""
        i = sid % self.n_slices
        if self._ids[i] != sid:
            self._clear(i, sid)
        return i

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            i = self._slot(int(self._clock() / self._slice_s))
            self._counts[i][_bucket_index(self.edges, v)] += 1
            self._n[i] += 1
            self._sum[i] += v
            self._min[i] = min(self._min[i], v)
            self._max[i] = max(self._max[i], v)

    def reset(self) -> None:
        with self._lock:
            for i in range(self.n_slices):
                # -1 can sit inside the live window while sid < n_slices
                # (start of a run), so the slice state must be zeroed too
                self._clear(i, -1)

    def _merged(self):
        """(counts, count, sum, min, max) over the live window."""
        sid = int(self._clock() / self._slice_s)
        counts = [0] * (len(self.edges) + 1)
        n, s, mn, mx = 0, 0.0, math.inf, -math.inf
        for i in range(self.n_slices):
            if not (sid - self.n_slices < self._ids[i] <= sid):
                continue  # expired (or never-written) slice
            for b, c in enumerate(self._counts[i]):
                counts[b] += c
            n += self._n[i]
            s += self._sum[i]
            mn = min(mn, self._min[i])
            mx = max(mx, self._max[i])
        return counts, n, s, mn, mx

    @property
    def count(self) -> int:
        with self._lock:
            return self._merged()[1]

    def _pct(self, counts, n, mn, mx, q: float) -> Optional[float]:
        if n == 0:
            return None
        target = q / 100.0 * n
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.edges[i - 1] if i > 0 else 0.0
                hi = self.edges[i] if i < len(self.edges) else mx
                lo = max(lo, mn)
                hi = min(hi, mx)
                if hi <= lo:
                    return lo
                frac = (target - cum) / c
                return lo + frac * (hi - lo)
            cum += c
        return mx

    def percentile(self, q: float) -> Optional[float]:
        """Interpolated q-th percentile over the live window only."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile q={q} outside [0, 100]")
        with self._lock:
            counts, n, _, mn, mx = self._merged()
        return self._pct(counts, n, mn, mx, q)

    def snapshot(self) -> Dict:
        with self._lock:
            counts, n, s, mn, mx = self._merged()
        if n == 0:
            return {"count": 0, "window_s": self.window_s}
        return {"count": n, "window_s": self.window_s, "sum": s,
                "mean": s / n, "min": mn, "max": mx,
                "p50": self._pct(counts, n, mn, mx, 50.0),
                "p95": self._pct(counts, n, mn, mx, 95.0),
                "p99": self._pct(counts, n, mn, mx, 99.0)}


class _NullMetric:
    """Shared do-nothing metric: the disabled-registry hand-out.

    All three update verbs are empty methods on one singleton, so
    instrumented code pays one attribute call and nothing else when
    telemetry is off.
    """

    __slots__ = ()
    name = ""
    unit = ""
    value = None
    count = 0
    sum = 0.0
    mean = None

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def reset(self) -> None:
        pass

    def percentile(self, q: float) -> Optional[float]:
        return None

    def snapshot(self):
        return None


_NULL_METRIC = _NullMetric()


class Registry:
    """Named metrics table: ``counter``/``gauge``/``histogram`` create or
    return (idempotent per name; kind mismatches raise), ``snapshot()``
    serializes everything.  A disabled registry returns the shared null
    metric from every accessor and snapshots empty."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, kind, **kw):
        if not self.enabled:
            return _NULL_METRIC
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = kind(name, lock=self._lock, **kw)
                self._metrics[name] = m
            elif not isinstance(m, kind):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {kind.__name__}")
            return m

    def counter(self, name: str, unit: str = "") -> Counter:
        return self._get(name, Counter, unit=unit)

    def gauge(self, name: str, unit: str = "") -> Gauge:
        return self._get(name, Gauge, unit=unit)

    def histogram(self, name: str, unit: str = "s",
                  edges: Sequence[float] = DEFAULT_LATENCY_EDGES_S
                  ) -> Histogram:
        return self._get(name, Histogram, unit=unit, edges=edges)

    def rolling_histogram(self, name: str, unit: str = "s",
                          edges: Sequence[float] = DEFAULT_LATENCY_EDGES_S,
                          window_s: float = 60.0, n_slices: int = 6,
                          clock=None) -> RollingHistogram:
        """Windowed-percentile histogram (see :class:`RollingHistogram`).
        Construction kwargs apply on first registration only (idempotent
        per name, like every accessor)."""
        return self._get(name, RollingHistogram, unit=unit, edges=edges,
                         window_s=window_s, n_slices=n_slices, clock=clock)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def reset(self) -> None:
        """Zero every registered metric, keeping registrations (handles
        stay valid).  Benchmarks use this between warm-up and the timed
        run so compile-laden warm-up requests don't pollute percentiles."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.reset()

    def snapshot(self) -> Dict[str, Dict]:
        """``{"counters": {...}, "gauges": {...}, "histograms": {...}}``."""
        out: Dict[str, Dict] = {"counters": {}, "gauges": {},
                                "histograms": {}}
        if not self.enabled:
            return out
        with self._lock:
            items = list(self._metrics.items())
        for name, m in items:
            if isinstance(m, Counter):
                out["counters"][name] = m.snapshot()
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.snapshot()
            else:
                # Histogram and RollingHistogram both serve percentile
                # snapshots (the rolling one over its live window only).
                out["histograms"][name] = m.snapshot()
        return out


#: Process-wide disabled registry: the default for un-telemetered code.
NULL_REGISTRY = Registry(enabled=False)
