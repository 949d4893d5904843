"""Step-time monitoring and straggler/anomaly detection.

At multi-pod scale the common failure modes are (a) a straggling host
slowing every synchronous step, (b) a hung collective, (c) loss spikes
from data or hardware corruption.  ``StepMonitor`` tracks a step-time EMA
and flags steps above ``straggler_factor`` x EMA; a sustained run of flags
trips ``should_reshard`` (the elastic-restart signal consumed by the
trainer).  ``LossGuard`` flags NaN/exploding losses so the trainer can roll
back to the last checkpoint instead of corrupting the run.

Both ride the :mod:`repro_torch.obs` metrics registry: step durations
land in the ``monitor.step_s`` histogram, flags/rollbacks in counters, the
EMA in a gauge, so a train run and a serve run export through the same
``Registry.snapshot()`` shape.  Pass a shared registry to pool them with
engine telemetry; by default each monitor owns a private one, which keeps
``summary()`` self-contained and the trip/flag semantics unchanged.

A copy of the reference's ``repro.runtime.monitor`` (host logic; the port
imports nothing of the reference).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

from repro_torch.obs.metrics import Registry


@dataclasses.dataclass
class StepEvent:
    step: int
    duration: float
    flagged: bool


class StepMonitor:
    def __init__(self, straggler_factor: float = 2.5, ema_decay: float = 0.9,
                 warmup_steps: int = 3, trip_after: int = 5,
                 registry: Optional[Registry] = None):
        self.factor = straggler_factor
        self.decay = ema_decay
        self.warmup = warmup_steps
        self.trip_after = trip_after
        self.registry = registry if registry is not None else Registry()
        self._h_step = self.registry.histogram("monitor.step_s")
        self._c_flagged = self.registry.counter("monitor.steps_flagged")
        self._g_ema = self.registry.gauge("monitor.step_ema_s")
        self.ema: Optional[float] = None
        self.events: List[StepEvent] = []
        self._consecutive = 0
        self._n = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self, step: int) -> StepEvent:
        assert self._t0 is not None, "stop() without start()"
        dur = time.monotonic() - self._t0
        self._t0 = None
        return self.record(step, dur)

    def record(self, step: int, duration: float) -> StepEvent:
        self._n += 1
        flagged = False
        if self.ema is None:
            self.ema = duration
        else:
            if self._n > self.warmup and duration > self.factor * self.ema:
                flagged = True
                self._consecutive += 1
            else:
                self._consecutive = 0
            # EMA excludes flagged outliers so one straggler doesn't poison
            # the baseline
            if not flagged:
                self.ema = self.decay * self.ema + (1 - self.decay) * duration
        self._h_step.observe(duration)
        if flagged:
            self._c_flagged.inc()
        self._g_ema.set(self.ema)
        ev = StepEvent(step, duration, flagged)
        self.events.append(ev)
        return ev

    @property
    def should_reshard(self) -> bool:
        """Sustained stragglers -> the trainer should checkpoint and rebuild
        the mesh from live devices (elastic restart)."""
        return self._consecutive >= self.trip_after

    def summary(self) -> dict:
        """Same keys as ever (steps/mean_s/ema_s/flagged/p50_s/max_s), now
        read back out of the registry snapshot instead of a private list.
        ``p50_s`` is the histogram's interpolated estimate (exact when all
        mass shares a bucket, off by at most one bucket width otherwise)."""
        snap = self.registry.snapshot()
        hist = snap["histograms"].get("monitor.step_s", {"count": 0})
        if not hist.get("count"):
            return {}
        return {
            "steps": hist["count"],
            "mean_s": hist["mean"],
            "ema_s": snap["gauges"].get("monitor.step_ema_s"),
            "flagged": int(snap["counters"].get("monitor.steps_flagged", 0)),
            "p50_s": hist["p50"],
            "max_s": hist["max"],
        }


class LossGuard:
    """Rolls back on NaN/inf or explosive loss (> spike_factor x EMA)."""

    def __init__(self, spike_factor: float = 10.0, ema_decay: float = 0.95,
                 registry: Optional[Registry] = None):
        self.factor = spike_factor
        self.decay = ema_decay
        self.registry = registry if registry is not None else Registry()
        self._g_ema = self.registry.gauge("monitor.loss_ema")
        self._c_rollbacks = self.registry.counter("monitor.loss_rollbacks")
        self.ema: Optional[float] = None

    def check(self, loss: float) -> bool:
        """Returns True if the step is healthy; False -> roll back."""
        import math
        if not math.isfinite(loss):
            self._c_rollbacks.inc()
            return False
        if self.ema is None:
            self.ema = loss
            self._g_ema.set(self.ema)
            return True
        if loss > self.factor * max(self.ema, 1e-6) and self.ema > 0:
            self._c_rollbacks.inc()
            return False
        self.ema = self.decay * self.ema + (1 - self.decay) * loss
        self._g_ema.set(self.ema)
        return True
