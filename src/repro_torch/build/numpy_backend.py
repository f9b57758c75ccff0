"""Numpy build backend: kernel-BFS waves as label-partitioned CSR gathers.

One wave expands *every* frontier pair of a hub's phase in a single
vectorized pass (BitPath-style frontier batching): the per-(vertex,
label) neighbor slices are located in the shared
:meth:`LabeledGraph.label_csr` layout and gathered as one concatenated
segment array; dedup/visited/pruning happen in
:mod:`repro_torch.build.batched` as packed-bitset arithmetic. No per-state
python executes on the hot path.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.graph import LabeledGraph

from .base import register_backend
from .batched import BatchedBackend, FrontierEngine

_EMPTY = np.empty(0, dtype=np.int64)


def _gather_concat(starts: np.ndarray, counts: np.ndarray, total: int
                   ) -> np.ndarray:
    """Indices covering ``[starts[i], starts[i]+counts[i])`` back-to-back
    (the standard repeat/cumsum slice-concatenation trick)."""
    ends = np.cumsum(counts)
    return np.arange(total, dtype=np.int64) + np.repeat(
        starts - ends + counts, counts)


class NumpyEngine(FrontierEngine):
    def __init__(self, graph: LabeledGraph):
        self.V = graph.num_vertices
        self.nl = graph.num_labels
        self._lab_csr = (graph.label_csr(backward=False),
                         graph.label_csr(backward=True))
        self._csr = (graph.fwd, graph.bwd)

    def expand(self, rows: np.ndarray, ys: np.ndarray, rowlab: np.ndarray,
               dstrow: np.ndarray, backward: bool
               ) -> Tuple[np.ndarray, np.ndarray]:
        lptr, lnbr = self._lab_csr[backward]
        keys = ys * self.nl + rowlab[rows]
        starts = lptr[keys]
        counts = lptr[keys + 1] - starts
        total = int(counts.sum())
        if not total:
            return _EMPTY, _EMPTY
        seg = np.repeat(dstrow[rows], counts)
        return seg, lnbr[_gather_concat(starts, counts, total)].astype(
            np.int64)

    def expand_fanout(self, rows: np.ndarray, ys: np.ndarray,
                      backward: bool) -> Tuple[np.ndarray, np.ndarray]:
        indptr, other, lab = self._csr[backward]
        starts = indptr[ys]
        counts = indptr[ys + 1] - starts
        total = int(counts.sum())
        if not total:
            return _EMPTY, _EMPTY
        ptr = _gather_concat(starts, counts, total)
        child = np.repeat(rows, counts) * self.nl + lab[ptr]
        return child, other[ptr].astype(np.int64)


class NumpyBackend(BatchedBackend):
    """Hybrid scalar/vectorized build over the numpy wave engine."""

    name = "numpy"

    def _make_engine(self, graph: LabeledGraph) -> FrontierEngine:
        return NumpyEngine(graph)


register_backend("numpy", NumpyBackend)
