"""Runtime observability: metrics registry, span tracer, realized-sparsity
telemetry, exporters (the port of the reference's ``repro.obs``).

:class:`Telemetry` bundles the three runtime surfaces of the serving
engine:

* ``registry`` — counters / gauges / latency histograms
  (:mod:`repro_torch.obs.metrics`),
* ``tracer`` — nested host-clock spans with optional JSONL streaming
  (:mod:`repro_torch.obs.trace`),
* ``sparsity`` / ``dispatch`` — realized activation sparsity per layer
  and execution-path attribution (:mod:`repro_torch.obs.sparsity`).

``Telemetry.off()`` (the default everywhere) hands out the null registry
and tracer: every instrumented call site degrades to a no-op attribute
call.  The decode step then issues the same device work as without any
telemetry and syncs nothing more; an unprobed step with telemetry on does
the same.  Only a probed step adds device work (``observe_activation``'s
nnz reduction and the one packing copy of the captured tensors).

See ``src/repro_torch/obs/README.md`` for the metrics catalogue.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from .export import JsonlWriter, latency_columns, sparsity_columns
from .metrics import (DEFAULT_LATENCY_EDGES_S, NULL_REGISTRY, Counter,
                      Gauge, Histogram, Registry, RollingHistogram)
from .sparsity import DispatchStats, SparsityStats
from .trace import NULL_TRACER, Tracer

__all__ = ["Telemetry", "Registry", "Counter", "Gauge", "Histogram",
           "RollingHistogram", "Tracer", "JsonlWriter", "SparsityStats",
           "DispatchStats", "NULL_REGISTRY", "NULL_TRACER",
           "DEFAULT_LATENCY_EDGES_S", "latency_columns",
           "sparsity_columns"]


@dataclasses.dataclass
class Telemetry:
    """One run's observability bundle (engine- or test-owned).

    ``sparsity_every`` — probe the decode batch's realized sparsity every
    N decode steps (0 disables the probed step entirely; 1 probes every
    step).  The probed step is the same eager step run under a support
    capture, so an unprobed step is untouched.
    """

    registry: Registry
    tracer: Tracer
    enabled: bool = True
    sparsity_every: int = 1
    sink: Optional[JsonlWriter] = None

    @classmethod
    def on(cls, jsonl_path: Optional[str] = None,
           sparsity_every: int = 1) -> "Telemetry":
        sink = JsonlWriter(jsonl_path) if jsonl_path else None
        return cls(registry=Registry(enabled=True),
                   tracer=Tracer(enabled=True, sink=sink),
                   enabled=True, sparsity_every=sparsity_every, sink=sink)

    @classmethod
    def off(cls) -> "Telemetry":
        return cls(registry=NULL_REGISTRY, tracer=NULL_TRACER,
                   enabled=False, sparsity_every=0, sink=None)

    def emit(self, event: Dict) -> None:
        """Write one non-span event (request lifecycle, final snapshot)
        to the JSONL sink, if any."""
        if self.sink is not None:
            self.sink.write(event)

    def close(self) -> None:
        if self.sink is not None:
            self.sink.close()
