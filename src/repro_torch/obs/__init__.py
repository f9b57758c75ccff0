"""Telemetry and correctness observability for the serving and build stack.

* :mod:`repro_torch.obs.metrics` — counters / gauges / bounded-reservoir
  histograms with labeled series that every serving and build layer
  reports into;
* :mod:`repro_torch.obs.tracing` — sampling-controlled per-query span
  tracing with a Chrome ``trace_event`` exporter;
* :mod:`repro_torch.obs.export` — the versioned ``repro.obs/1`` JSON
  snapshot and a Prometheus text-format dump;
* :mod:`repro_torch.obs.build_obs` — per-(hub, direction) phase timings
  and pruning-counter deltas for the Algorithm 2 backends (the ``cuda``
  backend's device waves included) and the delta engine;
* :mod:`repro_torch.obs.explain` — witness-mode query derivations
  (``repro.obs.witness/1``) with oracle replay and entry re-verification;
* :mod:`repro_torch.obs.audit` — the index-health auditor
  (``repro.obs.audit/1`` reports, drift fingerprints);
* :mod:`repro_torch.obs.shadow` — sampled re-execution of served answers
  against the BiBFS oracle.

The schema identifiers are wire formats shared with the JAX package, so
either package's validators accept the other's documents.

:class:`Observability` bundles one registry + one tracer; a service owns
one instance created from its config. Counters are default-on (cheap),
tracing is opt-in via ``trace_sample_rate``.
"""
from __future__ import annotations

from typing import Optional

from .audit import (AUDIT_SCHEMA, audit_index, bank_audit_metrics,
                    fingerprint, validate_audit_report)
from .build_obs import BuildPhaseObserver
from .explain import (WITNESS_SCHEMA, build_witness, explain_rows,
                      replay_witness, verify_witness_entries)
from .export import (SCHEMA, snapshot, snapshot_to_prometheus,
                     to_prometheus, validate_snapshot)
from .metrics import (NULL_REGISTRY, Counter, Gauge, Histogram, Metric,
                      MetricsRegistry, NullRegistry, Reservoir)
from .shadow import ShadowVerifier, attach_shadow
from .tracing import SpanEvent, Trace, Tracer, span_tree

__all__ = [
    "AUDIT_SCHEMA", "SCHEMA", "WITNESS_SCHEMA", "BuildPhaseObserver",
    "Counter", "Gauge", "Histogram", "Metric", "MetricsRegistry",
    "NullRegistry", "NULL_REGISTRY", "Observability", "NULL_OBS",
    "Reservoir", "ShadowVerifier", "SpanEvent", "Trace", "Tracer",
    "attach_shadow", "audit_index", "bank_audit_metrics",
    "build_witness", "explain_rows", "fingerprint", "replay_witness",
    "snapshot", "snapshot_to_prometheus", "span_tree", "to_prometheus",
    "validate_snapshot", "validate_audit_report",
    "verify_witness_entries",
]


class Observability:
    """One registry + one tracer: the telemetry context of one stack.

    ``enabled=False`` swaps in the null registry and a zero-rate tracer
    so every instrumented call site stays branch-free and near-free.
    Counters/histograms are default-on; span tracing only activates at
    ``trace_sample_rate > 0``.
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
        self._build_observer: Optional[BuildPhaseObserver] = None

    # ------------------------------------------------------------------ #
    def build_observer(self, context: str = "full") -> \
            Optional[BuildPhaseObserver]:
        """A :class:`BuildPhaseObserver` bound to this registry (None in
        disabled mode — build loops skip the per-phase timing entirely
        rather than timing into a null sink)."""
        if not self.enabled:
            return None
        if context == "full":
            if self._build_observer is None:
                self._build_observer = BuildPhaseObserver(
                    self.registry, context=context)
            return self._build_observer
        return BuildPhaseObserver(self.registry, context=context)

    # -- exporters ------------------------------------------------------ #
    def snapshot(self, extra: Optional[dict] = None) -> dict:
        ex = dict(extra) if extra else {}
        if self._build_observer is not None:
            ex.setdefault("slowest_build_phases",
                          self._build_observer.slowest_phases())
        return snapshot(self.registry, tracer=self.tracer,
                        extra=ex or None)

    def prometheus(self) -> str:
        return to_prometheus(self.registry)

    def chrome_trace(self, process_name: str = "rlc-service") -> dict:
        return self.tracer.chrome_trace(process_name)


#: shared inert instance for call sites constructed without telemetry
NULL_OBS = Observability(enabled=False)
