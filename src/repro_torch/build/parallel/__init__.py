"""Parallel hub-partitioned index construction (the JAX package's
``repro/build/parallel``, ported as it is: the workers are host numpy).

Partitions Algorithm 2's ``(hub, direction)`` phases across N worker
engines, scheduled over a dependency DAG instead of the fixed access
order, with an epoch/merge protocol that keeps the result bit-identical
(entries *and* pruning counters) to the sequential reference. See
the JAX package's ``src/repro/build/README.md`` ("Parallel
construction") and the module docstrings:

- :mod:`.dag` — which phases are actually independent;
- :mod:`.scheduler` — cost-modeled, frontier-windowed list scheduling
  of per-worker batches (no global epoch barrier);
- :mod:`.worker` — prefix-snapshot engines + inline/process executors;
- :mod:`.mirror` — hub-sliced ``BitMirror`` replacement (the memory
  bound lifter);
- :mod:`.backend` — the coordinator and the registered ``parallel``
  backend.
"""
from .backend import ParallelBackend
from .dag import PhaseDAG
from .mirror import HubSliceMirror
from .scheduler import ListScheduler, PhaseCostModel
from .worker import BuildWorker, LocalEngine

__all__ = ["BuildWorker", "HubSliceMirror", "ListScheduler",
           "LocalEngine", "ParallelBackend", "PhaseCostModel", "PhaseDAG"]
