"""Incremental (delta) index construction for mutable graphs.

Public surface::

    from repro_torch.build.delta import DeltaBuilder, GraphDelta

    db = DeltaBuilder(graph, k=2)            # backend="numpy" by default
    index, stats = db.full()                 # traced full build
    delta = GraphDelta.of(inserts=[(0, 1, 7)], deletes=[(3, 0, 4)])
    res = db.apply(delta)                    # incremental re-derivation
    db.index                                 # == full rebuild on db.graph

``apply`` produces an index (and :class:`repro_torch.build.BuildStats`
counters) **bit-identical** to a from-scratch build of the mutated
graph, re-running only the ``(hub, direction)`` phases the delta can
touch and replaying every other phase from the previous build's trace.
See "Incremental delta builds" in the JAX package's
``src/repro/build/README.md`` for the affected-hub analysis and the
correctness argument; ``tests/test_torch_delta.py`` holds the port's
delta builds against the JAX package's and against full rebuilds.
"""
from __future__ import annotations

from repro_torch.core.graph import GraphDelta

from .engine import DeltaBuilder, DeltaResult
from .trace import BuildTrace, PhaseTrace

__all__ = ["BuildTrace", "DeltaBuilder", "DeltaResult", "GraphDelta",
           "PhaseTrace"]
