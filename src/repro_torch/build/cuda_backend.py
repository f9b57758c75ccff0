"""CUDA build backend: hub waves through the frontier kernel.

The wave contract is the same as the numpy engine's — expand a batch of
``(row, vertex)`` frontier pairs one label step — but every expansion
runs as one :func:`repro_torch.kernels.label_frontier.frontier_step_many`
launch against the label-sliced adjacency, which lives on the device
bit-packed (32 vertices per int32 word, built once per engine). The
kernel returns the next frontier in the same words; the host unpacks
them with numpy for the pruned-insert loop.

Hub batching stops at one hub: PR1 reads the entries every earlier hub
completed, so cross-hub waves cannot stay bit-identical (see
:mod:`repro_torch.build.batched`). The default ``hybrid`` mode sends the
widest hubs through the device; ``mode="vector"`` sends every hub, as the
equivalence tests do. ``device="cpu"`` runs the kernel's plain version.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.devices import resolve_device
from repro_torch.core.graph import LabeledGraph
from repro_torch.kernels.bitpack import pack_adjacency, unpack_rows
from repro_torch.kernels.label_frontier import frontier_step_many

from .base import register_backend
from .batched import BatchedBackend, FrontierEngine

_EMPTY = np.empty(0, dtype=np.int64)


def _pad128(n: int) -> int:
    return max(128, -(-n // 128) * 128)


class CudaEngine(FrontierEngine):
    def __init__(self, graph: LabeledGraph, device="cuda"):
        self.device = resolve_device(device)
        self.V = graph.num_vertices
        self.nl = graph.num_labels
        self.Vp = _pad128(self.V)
        e = graph.edges
        self._A = (  # forward: u -> v, backward: v -> u
            pack_adjacency(e[:, 0], e[:, 1], e[:, 2], self.nl, self.Vp,
                           self.device),
            pack_adjacency(e[:, 2], e[:, 1], e[:, 0], self.nl, self.Vp,
                           self.device))

    # ------------------------------------------------------------------ #
    def _step(self, F: np.ndarray, labels: np.ndarray, backward: bool
              ) -> np.ndarray:
        """One device wave: returns the (R, V) boolean next frontier."""
        words = frontier_step_many(torch.from_numpy(F).to(self.device),
                                   self._A[backward], labels)
        return unpack_rows(words.cpu().numpy(), self.V)

    def expand(self, rows: np.ndarray, ys: np.ndarray, rowlab: np.ndarray,
               dstrow: np.ndarray, backward: bool
               ) -> Tuple[np.ndarray, np.ndarray]:
        R = len(rowlab)
        F = np.zeros((R, self.Vp), dtype=np.float32)
        F[rows, ys] = 1.0
        dense = self._step(F, rowlab, backward)
        nr, ny = np.nonzero(dense)
        if not nr.size:
            return _EMPTY, _EMPTY
        return dstrow[nr], ny.astype(np.int64)

    def expand_fanout(self, rows: np.ndarray, ys: np.ndarray,
                      backward: bool) -> Tuple[np.ndarray, np.ndarray]:
        # duplicate each active parent row once per label; the multi-label
        # kernel then expands all (parent, label) fans in one launch
        parents = np.unique(rows)
        P, nl = len(parents), self.nl
        F = np.zeros((P * nl, self.Vp), dtype=np.float32)
        loc = np.searchsorted(parents, rows)
        for lab in range(nl):
            F[loc * nl + lab, ys] = 1.0
        labels = np.tile(np.arange(nl, dtype=np.int32), P)
        dense = self._step(F, labels, backward)
        nr, ny = np.nonzero(dense)
        if not nr.size:
            return _EMPTY, _EMPTY
        child = parents[nr // nl] * nl + (nr % nl)
        return child, ny.astype(np.int64)


class CudaBackend(BatchedBackend):
    """Hybrid build whose wide-hub waves run on the frontier kernel."""

    name = "cuda"

    def __init__(self, *args, device="cuda", **kw):
        super().__init__(*args, **kw)
        self.device = resolve_device(device)

    def _make_engine(self, graph: LabeledGraph) -> FrontierEngine:
        return CudaEngine(graph, device=self.device)


register_backend("cuda", CudaBackend)
