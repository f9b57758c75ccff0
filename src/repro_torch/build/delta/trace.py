"""Build traces: the per-phase memory a delta build replays from.

A full (traced) build records one :class:`PhaseTrace` per
``(hub, direction)`` phase — the traversal footprint captured by
:class:`repro_torch.build.base.PhaseProbe` plus the phase's share of the
:class:`repro_torch.build.BuildStats` counters. The delta engine consults the
footprint to decide whether a graph delta can touch the phase, replays
the counters (and the old entries) when it cannot, and refreshes the
trace for phases it re-runs — so traces chain across any number of
``apply`` calls.

All masks are packed python-int bitsets over the vertex space (the same
representation as the bits build tier), so a phase's storage cost is
proportional to the vertices it actually touched.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

ZERO_COUNTERS: Tuple[int, ...] = (0, 0, 0, 0, 0, 0)


@dataclass
class PhaseTrace:
    """Footprint + counters of one ``(hub, direction)`` phase.

    ``visited``/``near``/``lab`` follow the
    :class:`repro_torch.build.base.PhaseProbe` contract; ``counters`` is the
    phase's delta of ``BuildStats.counters()``. The all-empty instance
    doubles as the trace of a skipped (degree-0) phase.
    """

    visited: int = 0
    near: int = 0
    lab: Tuple[int, ...] = ()
    counters: Tuple[int, ...] = ZERO_COUNTERS
    _work: int = -1

    @property
    def work(self) -> int:
        """Cached ``popcount(visited)`` (phases replay across traces, so
        memoizing on the instance pays)."""
        if self._work < 0:
            self._work = self.visited.bit_count()
        return self._work


_EMPTY = PhaseTrace()


class BuildTrace:
    """All phase traces of one build, keyed by ``(hub, backward)``."""

    def __init__(self, num_vertices: int, num_labels: int):
        self.num_vertices = num_vertices
        self.num_labels = num_labels
        self._phases: Dict[Tuple[int, bool], PhaseTrace] = {}
        #: sum of visited popcounts — the delta engine's work denominator
        self.total_work = 0

    def get(self, v: int, backward: bool) -> PhaseTrace:
        return self._phases.get((v, backward), _EMPTY)

    def put(self, v: int, backward: bool, pt: PhaseTrace) -> None:
        old = self._phases.get((v, backward))
        if old is not None:
            self.total_work -= old.work
        self._phases[(v, backward)] = pt
        self.total_work += pt.work

    def __len__(self) -> int:
        return len(self._phases)

    def nbytes(self) -> int:
        """Approximate footprint of the stored masks (diagnostics)."""
        total = 0
        for pt in self._phases.values():
            total += (pt.visited.bit_length() + pt.near.bit_length()
                      + sum(m.bit_length() for m in pt.lab)) // 8 + 8
        return total
