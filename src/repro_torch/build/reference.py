"""The python reference backend — faithful, sequential Algorithm 2.

This is the paper's reference semantics and the oracle every batched
backend is property-tested against; it deliberately stays the plain
pseudocode transcription (per-state CSR slicing, direct
``minimum_repeat`` calls) rather than chasing constants — speed is the
batched backends' job.

The scalar stage implementations are module-level and parameterized by a
neighbor accessor, so the hybrid batched builders reuse them verbatim
(with pre-materialized adjacency lists and a memoized MR table) for
low-degree hubs: running the identical code path is what makes the
hybrid dispatch trivially bit-identical.

Semantics notes (Algorithm 2 deviations and readings) live in
``src/repro/build/README.md``.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional, Set, Tuple

from repro_torch.core.graph import LabeledGraph
from repro_torch.core.minimum_repeat import LabelSeq, minimum_repeat
from repro_torch.core.rlc_index import RLCIndex

from .base import (BuildBackend, BuildStats, PrunedInserter, access_schedule,
                   register_backend)

#: ``neighbors(x, backward)`` -> iterable of (neighbor, label) pairs
NeighborFn = Callable[[int, bool], list]


class _GraphNeighbors:
    """Seed-faithful accessor: slice the CSR per visited state."""

    def __init__(self, graph: LabeledGraph):
        self.g = graph

    def __call__(self, x: int, backward: bool):
        nbrs, labs = (self.g.in_edges(x) if backward
                      else self.g.out_edges(x))
        return zip(nbrs.tolist(), labs.tolist())


class _NeighborLists:
    """Pre-materialized ``[(nbr, lab), ...]`` lists in CSR order — the
    hybrid backends' scalar-tier accessor (one conversion per build
    instead of one numpy slice + ``tolist`` per visited state)."""

    def __init__(self, graph: LabeledGraph):
        self._dir = (self._mk(graph, backward=False),
                     self._mk(graph, backward=True))

    @staticmethod
    def _mk(graph: LabeledGraph, backward: bool) -> List[list]:
        indptr, other, lab = graph.bwd if backward else graph.fwd
        other = other.tolist()
        lab = lab.tolist()
        bounds = indptr.tolist()
        return [list(zip(other[bounds[v]:bounds[v + 1]],
                         lab[bounds[v]:bounds[v + 1]]))
                for v in range(graph.num_vertices)]

    def __call__(self, x: int, backward: bool) -> list:
        return self._dir[backward][x]


class _MemoMR:
    """Memoized ``minimum_repeat`` over the (tiny) depth-<=k seq space."""

    def __init__(self):
        self._memo: Dict[LabelSeq, LabelSeq] = {}

    def __call__(self, seq: LabelSeq) -> LabelSeq:
        mr = self._memo.get(seq)
        if mr is None:
            mr = self._memo[seq] = minimum_repeat(seq)
        return mr


def kernel_search_scalar(neighbors: NeighborFn, inserter: PrunedInserter,
                         stats: BuildStats, mr_fn, v: int, k: int,
                         backward: bool, probe=None
                         ) -> Dict[LabelSeq, Set[int]]:
    """Stage 2 (scalar): exhaustive BFS to depth ``k`` over (vertex, seq)
    states. Inserts entries for every state whose MR has length <= k (PR3
    does not apply here, paper §V-B) and returns the eager kernel
    candidates ``{L: frontier vertices whose path-so-far equals L^h}``.
    ``probe`` (a :class:`repro_torch.build.base.PhaseProbe`) records the
    traversal footprint for the delta engine.
    """
    seen: Set[Tuple[int, LabelSeq]] = {(v, ())}
    frontier: deque = deque([(v, ())])
    kernels: Dict[LabelSeq, Set[int]] = {}
    if probe is not None:
        probe.visited |= 1 << v
        probe.near |= 1 << v
    while frontier:
        x, seq = frontier.popleft()
        for y, lab in neighbors(x, backward):
            seq2 = ((lab,) + seq) if backward else (seq + (lab,))
            state = (y, seq2)
            if state in seen:
                continue
            seen.add(state)
            stats.kernel_search_states += 1
            if probe is not None:
                probe.visited |= 1 << y
            L = mr_fn(seq2)
            if len(L) <= k:
                # |MR| <= k  =>  seq2 == L^h: a genuine entry AND an
                # eager kernel candidate seeded at y (repeat boundary).
                inserter.insert(y, v, L, backward)
                kernels.setdefault(L, set()).add(y)
            if len(seq2) < k:
                frontier.append((y, seq2))
                if probe is not None:
                    probe.near |= 1 << y
    return kernels


def kernel_bfs_scalar(neighbors: NeighborFn, inserter: PrunedInserter,
                      stats: BuildStats, use_pr3: bool,
                      v: int, L: LabelSeq, seeds: Set[int],
                      backward: bool, probe=None) -> None:
    """Stage 3 (scalar): product-automaton BFS guided by ``L^+``.

    State ``(y, p)``: ``p`` labels consumed since the last full-repeat
    boundary. Backward search prepends labels, so from state ``p`` the
    expected edge label is ``L[m-1-p]``; forward appends, expecting
    ``L[p]``. Stage-4 insertion fires when ``p`` wraps to 0; a pruned
    insertion (PR1/PR2 fired) triggers the PR3 subtree cut. ``probe``
    records expansion tails per label (PR3-cut states are never popped,
    so they stay out of the label masks — exactly the states that do
    not expand).
    """
    m = len(L)
    visited: Set[Tuple[int, int]] = {(x, 0) for x in seeds}
    q: deque = deque(visited)
    while q:
        x, p = q.popleft()
        want = L[m - 1 - p] if backward else L[p]
        if probe is not None:
            probe.lab[want] |= 1 << x
        for y, lab in neighbors(x, backward):
            if lab != want:
                continue
            p2 = (p + 1) % m
            if (y, p2) in visited:
                continue
            stats.kernel_bfs_states += 1
            if probe is not None:
                probe.visited |= 1 << y
            if p2 == 0:
                if not inserter.insert(y, v, L, backward):
                    if use_pr3:
                        # PR3: cut the subtree behind y (do not expand).
                        stats.pr3_cuts += 1
                        visited.add((y, p2))
                        continue
            visited.add((y, p2))
            q.append((y, p2))


class PythonBackend(BuildBackend):
    """Sequential Algorithm 2 — the reference oracle."""

    name = "python"

    def _build(self, graph: LabeledGraph, k: int, stats: BuildStats
               ) -> RLCIndex:
        order, aid = access_schedule(graph)
        index = RLCIndex(graph.num_vertices, k, aid)
        inserter = PrunedInserter(index, stats, self.use_pr1, self.use_pr2)
        neighbors = _GraphNeighbors(graph)
        obs = self.observer
        for v in order:
            v = int(v)
            for backward in (True, False):
                if obs is not None:
                    before = stats.counters()
                    t0 = time.perf_counter()
                self._phase(neighbors, inserter, stats, v, k, backward)
                if obs is not None:
                    obs.phase(v, backward, time.perf_counter() - t0,
                              counter_delta=tuple(
                                  a - b for a, b in zip(stats.counters(),
                                                        before)))
        return index

    def _phase(self, neighbors, inserter, stats, v: int, k: int,
               backward: bool) -> None:
        kernels = kernel_search_scalar(
            neighbors, inserter, stats, minimum_repeat, v, k, backward)
        for L, seeds in kernels.items():
            kernel_bfs_scalar(neighbors, inserter, stats,
                              self.use_pr3, v, L, seeds, backward)


register_backend("python", PythonBackend)


# --------------------------------------------------------------------- #
# Back-compat surface (the pre-refactor ``core.index_builder`` API)
# --------------------------------------------------------------------- #
class IndexBuilder:
    """Drop-in for the historical ``core.index_builder.IndexBuilder``."""

    def __init__(self, graph: LabeledGraph, k: int,
                 use_pr1: bool = True, use_pr2: bool = True,
                 use_pr3: bool = True):
        self.g = graph
        self.k = int(k)
        self._backend = PythonBackend(use_pr1, use_pr2, use_pr3)
        self.stats = BuildStats(backend=self._backend.name)
        self.index: Optional[RLCIndex] = None

    def build(self) -> RLCIndex:
        self.index, self.stats = self._backend.build(self.g, self.k)
        return self.index
