"""Build/delta instrumentation: per-(hub, direction) phase accounting.

Algorithm 2 runs one phase per ``(hub, direction)``; the existing
:class:`repro_torch.build.base.PhaseProbe` records each phase's traversal
*footprint* — this module adds the missing *cost* axis: wall time and
pruning-counter deltas per phase, aggregated into registry series (raw
per-phase lists would be O(2V) memory) plus an exact top-N of the
slowest phases, which is where "why did this build take 40s" answers
live.

The observer attaches to any :class:`repro_torch.build.base.BuildBackend` via
``set_observer`` (or ``build_rlc_index_with_stats(..., observer=...)``);
the batched backends call it from :meth:`PhaseRunner.run`, the python
reference from its own hub loop, and the delta engine from both its
traced full builds and its dirty-phase re-runs — so delta re-run phases
land in the same series as full-build phases, labeled apart.

:class:`BuildCounters` holds the condensed device build's counters
(``build_condensed_device``): its runs, the entries and ``(vertex, hub)``
keys it hands to the ``RLCIndex`` and its host copies, each bound once.
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

__all__ = ["BuildCounters", "BuildPhaseObserver"]

#: order must match repro_torch.build.base.BuildStats._COUNTERS
_COUNTER_NAMES = ("kernel_search_states", "kernel_bfs_states", "inserted",
                  "pruned_pr1", "pruned_pr2", "pr3_cuts")


class BuildPhaseObserver:
    """Sink for per-phase build telemetry.

    ``context`` labels where the phases came from: ``"full"`` for a
    from-scratch build, ``"delta"`` for dirty-phase re-runs inside an
    incremental apply. Memory is bounded: aggregates + a ``top_n`` heap.
    """

    def __init__(self, registry, context: str = "full", top_n: int = 8):
        self.registry = registry
        self.context = context
        self.top_n = int(top_n)
        self._slowest: List[Tuple[float, int, str]] = []   # min-heap
        hist = registry.histogram(
            "rlc_build_phase_seconds",
            desc="wall time of one (hub, direction) Algorithm 2 phase",
            unit="s", labelnames=("context", "direction"))
        self._phase_s = {True: hist.labels(context=context, direction="in"),
                         False: hist.labels(context=context,
                                            direction="out")}
        phases = registry.counter(
            "rlc_build_phases", desc="Algorithm 2 phases executed",
            labelnames=("context", "direction"))
        self._phases = {True: phases.labels(context=context, direction="in"),
                        False: phases.labels(context=context,
                                             direction="out")}
        ctr = registry.counter(
            "rlc_build_counter_deltas",
            desc="per-phase BuildStats counter shares",
            labelnames=("context", "counter"))
        self._counters = [ctr.labels(context=context, counter=n)
                          for n in _COUNTER_NAMES]
        self._builds = registry.counter(
            "rlc_build_runs", desc="completed index builds",
            labelnames=("context", "backend"))
        self._build_s = registry.histogram(
            "rlc_build_seconds", desc="end-to-end index build wall time",
            unit="s", labelnames=("context", "backend"))

    # -- called per phase (hot during builds, never during serving) ----- #
    def phase(self, hub: int, backward: bool, seconds: float,
              counter_delta: Optional[Tuple[int, ...]] = None) -> None:
        self._phase_s[backward].observe(seconds)
        self._phases[backward].inc()
        if counter_delta is not None:
            for cell, d in zip(self._counters, counter_delta):
                if d:
                    cell.inc(d)
        direction = "in" if backward else "out"
        item = (seconds, int(hub), direction)
        if len(self._slowest) < self.top_n:
            heapq.heappush(self._slowest, item)
        elif item > self._slowest[0]:
            heapq.heapreplace(self._slowest, item)

    # -- parallel-build series (created lazily: they only exist when the
    # -- parallel backend actually ran, so sequential snapshots stay
    # -- unchanged) ------------------------------------------------------ #
    def _parallel_cells(self):
        cells = getattr(self, "_par", None)
        if cells is None:
            r, ctx = self.registry, self.context
            cells = self._par = dict(
                epochs=r.counter(
                    "rlc_build_epochs",
                    desc="parallel build epoch/merge rounds",
                    labelnames=("context",)).labels(context=ctx),
                stale=r.counter(
                    "rlc_build_stale_reruns",
                    desc="phases re-run after a stale snapshot "
                         "fingerprint",
                    labelnames=("context",)).labels(context=ctx),
                epoch_s=r.histogram(
                    "rlc_build_epoch_seconds",
                    desc="wall time of one dispatch+merge epoch",
                    unit="s", labelnames=("context",)).labels(
                        context=ctx),
                worker_s=r.histogram(
                    "rlc_build_worker_phase_seconds",
                    desc="committed phase wall time, by the worker "
                         "that ran it (parent = stale re-run)",
                    unit="s", labelnames=("context", "worker")),
                worker_cells={})
        return cells

    def epoch(self, seconds: float, phases: int = 0,
              stale_reruns: int = 0) -> None:
        """One parallel-build epoch boundary: the merged-in view of the
        per-worker registries (workers report raw phase data; this
        parent registry is the single snapshot surface)."""
        cells = self._parallel_cells()
        cells["epochs"].inc()
        cells["epoch_s"].observe(seconds)
        if stale_reruns:
            cells["stale"].inc(stale_reruns)

    def worker_phase(self, worker: str, seconds: float) -> None:
        """A committed phase's wall time attributed to the worker that
        produced it (``"parent"`` for coordinator stale re-runs)."""
        cells = self._parallel_cells()
        cell = cells["worker_cells"].get(worker)
        if cell is None:
            cell = cells["worker_cells"][worker] = cells[
                "worker_s"].labels(context=self.context, worker=worker)
        cell.observe(seconds)

    # -- called once per completed build -------------------------------- #
    def build_done(self, backend: str, wall_time_s: float) -> None:
        self._builds.inc(1, context=self.context, backend=backend)
        self._build_s.observe(wall_time_s, context=self.context,
                              backend=backend)

    def slowest_phases(self) -> List[dict]:
        """The top-N slowest phases, slowest first (snapshot ``extra``)."""
        return [dict(hub=h, direction=d, seconds=round(s, 6))
                for s, h, d in sorted(self._slowest, reverse=True)]


class BuildCounters:
    """A dense device build's counters for one ``backend``
    (``device_condensed``), bound once so a build pays one ``+=`` a
    counter:

    * ``rlc_build_runs{context="full"}``: builds completed (the series
      :meth:`BuildPhaseObserver.build_done` counts other backends in);
    * ``rlc_build_entries{side}``: entries handed to the ``RLCIndex``;
    * ``rlc_build_pairs{side}``: the ``(vertex, hub)`` keys of the rows
      filled, so entries over pairs is the MRs a key holds;
    * ``rlc_build_host_bytes{direction}``: bytes copied between host and
      device, ``up`` the reach handed over as a host array, ``down`` the
      entries (on the card one MR mask per pair, on the CPU one coordinate
      triple per entry).

    ``entries`` and ``pairs`` are keyed by side, ``"out"`` and ``"in"``.
    """

    __slots__ = ("runs", "entries", "pairs", "host_bytes_up",
                 "host_bytes_down")

    def __init__(self, registry, backend: str):
        self.runs = registry.counter(
            "rlc_build_runs", desc="completed index builds",
            labelnames=("context", "backend")).labels(context="full",
                                                      backend=backend)
        entries = registry.counter(
            "rlc_build_entries",
            desc="index entries a device build handed to the RLCIndex",
            labelnames=("backend", "side"))
        pairs = registry.counter(
            "rlc_build_pairs",
            desc="(vertex, hub) keys of the rows a device build filled",
            labelnames=("backend", "side"))
        self.entries = {side: entries.labels(backend=backend, side=side)
                        for side in ("out", "in")}
        self.pairs = {side: pairs.labels(backend=backend, side=side)
                      for side in ("out", "in")}
        host = registry.counter(
            "rlc_build_host_bytes",
            desc="bytes a device build copied between host and device",
            unit="By", labelnames=("backend", "direction"))
        self.host_bytes_up = host.labels(backend=backend, direction="up")
        self.host_bytes_down = host.labels(backend=backend,
                                           direction="down")
