"""Stage decomposition of Algorithm 2 and the pluggable backend protocol.

See ``src/repro/build/README.md`` for the full design. The paper's RLC
indexing algorithm decomposes into four stages shared by every backend:

1. **access-order scheduling** — vertices sorted by the IN-OUT score,
   defining both the hub processing order and the PR2 access ids;
2. **kernel-search** — exhaustive BFS over (vertex, label-sequence)
   states up to depth ``k``, producing tentative entries and the eager
   kernel candidates that seed stage 3;
3. **kernel-BFS** — per kernel ``L``, a product-automaton expansion over
   ``V x {0..|L|-1}`` guided by ``L``-cyclic transitions;
4. **pruned insertion** — PR1/PR2 gating of every tentative entry, with
   PR3 feeding failures back into stage 3 as subtree cuts.

Backends differ only in *how* stages 2-3 traverse the graph (scalar
python, numpy bitset waves, or CUDA frontier-kernel batches); the
pruning semantics and therefore the produced index are bit-identical.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, fields
from typing import Callable, Dict, Tuple

import numpy as np

from repro_torch.core.graph import LabeledGraph
from repro_torch.core.rlc_index import RLCIndex


@dataclass
class BuildStats:
    """Construction counters (bit-identical across backends) plus
    per-build metadata (``backend``, ``wall_time_s``) that is not part of
    counter equality."""

    kernel_search_states: int = 0
    kernel_bfs_states: int = 0
    inserted: int = 0
    pruned_pr1: int = 0
    pruned_pr2: int = 0
    pr3_cuts: int = 0
    backend: str = ""
    wall_time_s: float = 0.0
    #: peak bytes of PR1 coverage mirror(s) held by any one process during
    #: the build (0 = no mirror: the scalar reference). Metadata, not part
    #: of counter equality — backends with different mirror layouts are
    #: still bit-identical in entries/counters.
    peak_mirror_bytes: int = 0

    _COUNTERS = ("kernel_search_states", "kernel_bfs_states", "inserted",
                 "pruned_pr1", "pruned_pr2", "pr3_cuts")

    def counters(self) -> Tuple[int, ...]:
        """The backend-invariant portion (used by equivalence tests)."""
        return tuple(getattr(self, f) for f in self._COUNTERS)

    def as_dict(self) -> dict:
        d = {f.name: getattr(self, f.name) for f in fields(self)}
        d["wall_time_s"] = round(d["wall_time_s"], 6)
        return d


def access_schedule(graph: LabeledGraph) -> Tuple[np.ndarray, np.ndarray]:
    """Stage 1: the IN-OUT access order and the 1-based access ids
    (``aid[order[i]] == i + 1``); PR2 compares these ids."""
    return graph.access_order(), graph.access_ids()


def vertex_mask(ys, num_vertices: int) -> int:
    """Vertex ids -> packed little-endian bitmask (a python int, the same
    representation the bits build tier and the delta engine use)."""
    if not len(ys):
        return 0
    row = np.zeros(num_vertices, np.uint8)
    row[np.asarray(ys)] = 1
    return int.from_bytes(
        np.packbits(row, bitorder="little").tobytes(), "little")


def mask_vertices(mask: int):
    """Iterate the set vertex ids of a packed mask (ascending)."""
    while mask:
        b = mask & -mask
        yield b.bit_length() - 1
        mask ^= b


class PhaseProbe:
    """Traversal-footprint recorder for one ``(hub, direction)`` phase.

    Filled by the stage 2-3 implementations (all tiers record the same
    sets, so a trace is tier-independent) and consumed by the delta
    engine's affected-hub analysis:

    * ``visited`` — every vertex holding a discovered state (superset of
      the vertices whose entries the phase attempts / whose rows PR1
      reads);
    * ``near`` — vertices whose states expand with *full label fanout*
      (kernel-search states at depth < k, plus the hub itself): any edge
      mutation at these tails changes the traversal;
    * ``lab[l]`` — vertices whose states expand *along label l only*
      (kernel-BFS product states): an edge mutation with label ``l`` at
      these tails changes the traversal, other labels cannot.

    All masks are packed python-int bitsets over the vertex space.
    """

    __slots__ = ("visited", "near", "lab")

    def __init__(self, num_labels: int):
        self.visited = 0
        self.near = 0
        self.lab = [0] * num_labels


class PrunedInserter:
    """Stage 4: PR1/PR2-gated insertion into an :class:`RLCIndex`.

    One instance per build; every backend funnels its tentative entries
    through :meth:`insert` (scalar) or the batched equivalents in
    :mod:`repro_torch.build.batched`, so the pruning semantics live in exactly
    one place. ``insert`` returning False is the PR3 signal.
    """

    def __init__(self, index: RLCIndex, stats: BuildStats,
                 use_pr1: bool = True, use_pr2: bool = True):
        self.index = index
        self.stats = stats
        self.use_pr1 = use_pr1
        self.use_pr2 = use_pr2

    def insert(self, y: int, v: int, L, backward: bool) -> bool:
        """Try to record hub ``v`` at visited vertex ``y`` (paper
        Algorithm 2, lines 19-24). True iff the entry was added."""
        idx = self.index
        if self.use_pr2 and idx.aid[v] > idx.aid[y]:
            self.stats.pruned_pr2 += 1
            return False
        s, t = (y, v) if backward else (v, y)
        if self.use_pr1 and idx.query(s, t, L):
            self.stats.pruned_pr1 += 1
            return False
        if backward:
            idx.add_out(y, v, L)
        else:
            idx.add_in(y, v, L)
        self.stats.inserted += 1
        return True


class BuildBackend:
    """Protocol for index-construction backends.

    Concrete backends implement :meth:`_build` and set :attr:`name`;
    :meth:`build` wraps it with timing + stats metadata. All backends
    must produce bit-identical index entries *and* pruning counters for
    the same ``(graph, k, flags)`` — the property suite in
    ``tests/test_build_backends.py`` enforces this against the python
    reference.
    """

    name: str = "?"

    def __init__(self, use_pr1: bool = True, use_pr2: bool = True,
                 use_pr3: bool = True):
        self.use_pr1 = use_pr1
        self.use_pr2 = use_pr2
        self.use_pr3 = use_pr3
        #: optional :class:`repro_torch.obs.BuildPhaseObserver` — when set, the
        #: per-(hub, direction) phase loops report timings and pruning
        #: counter deltas into its registry (None = zero overhead)
        self.observer = None

    def set_observer(self, observer) -> "BuildBackend":
        self.observer = observer
        return self

    # -- subclass hook --------------------------------------------------- #
    def _build(self, graph: LabeledGraph, k: int, stats: BuildStats
               ) -> RLCIndex:
        raise NotImplementedError

    # -- public API ------------------------------------------------------- #
    def build(self, graph: LabeledGraph, k: int
              ) -> Tuple[RLCIndex, BuildStats]:
        stats = BuildStats(backend=self.name)
        t0 = time.perf_counter()
        index = self._build(graph, int(k), stats)
        stats.wall_time_s = time.perf_counter() - t0
        if self.observer is not None:
            self.observer.build_done(self.name, stats.wall_time_s)
        return index, stats


# --------------------------------------------------------------------- #
# Backend registry
# --------------------------------------------------------------------- #
_REGISTRY: Dict[str, Callable[..., BuildBackend]] = {}

#: resolution order for ``backend="auto"`` — first constructible wins.
AUTO_ORDER = ("numpy", "python")


def register_backend(name: str, factory: Callable[..., BuildBackend]
                     ) -> None:
    _REGISTRY[name] = factory


def list_backends() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def get_backend(name: str = "auto", **kw) -> BuildBackend:
    """Instantiate a build backend. ``auto`` resolves to the first
    registered name in :data:`AUTO_ORDER` (numpy; the cuda backend
    must be requested explicitly).
    Constructor errors (bad kwargs etc.) propagate."""
    if name == "auto":
        name = next((c for c in AUTO_ORDER if c in _REGISTRY), "python")
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown build backend {name!r}; choose from "
            f"{('auto',) + list_backends()}")
    return _REGISTRY[name](**kw)
