"""Telemetry for the serving stack: a metrics registry and span tracing.

* :mod:`repro_torch.obs.metrics` — counters / gauges / bounded-reservoir
  histograms with labeled series that the executor, cache and scheduler
  report into;
* :mod:`repro_torch.obs.tracing` — sampling-controlled per-query span
  tracing with a Chrome ``trace_event`` exporter.

:class:`Observability` bundles one registry + one tracer; a service owns
one instance created from its config. Counters are default-on (cheap),
tracing is opt-in via ``trace_sample_rate``.
"""
from __future__ import annotations

from .metrics import NULL_REGISTRY, MetricsRegistry
from .tracing import Tracer

__all__ = ["NULL_OBS", "Observability"]


class Observability:
    """One registry + one tracer: the telemetry context of one stack.

    ``enabled=False`` swaps in the null registry and a zero-rate tracer
    so every instrumented call site stays branch-free and near-free.
    """

    def __init__(self, enabled: bool = True,
                 trace_sample_rate: float = 0.0,
                 reservoir_cap: int = 2048,
                 max_trace_events: int = 50_000):
        self.enabled = bool(enabled)
        if self.enabled:
            self.registry = MetricsRegistry(reservoir_cap=reservoir_cap)
            self.tracer = Tracer(sample_rate=trace_sample_rate,
                                 max_events=max_trace_events)
        else:
            self.registry = NULL_REGISTRY
            self.tracer = Tracer(sample_rate=0.0, max_events=0)

    def build_observer(self):
        """Per-phase build observer; none exists in the port yet, so build
        loops skip the per-phase timing."""
        return None


#: shared inert instance for call sites constructed without telemetry
NULL_OBS = Observability(enabled=False)
