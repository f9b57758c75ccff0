"""Edge-labeled directed graph G = (V, E, L) (paper §III).

Storage: an int32 edge table plus CSR adjacency in both directions, grouped
so that per-(vertex, label) neighbor slices are O(1) to locate. A dense
per-label boolean adjacency view is available for dense engines on graphs
where |V|^2 * |L| is affordable.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def _edge_keys(edges: np.ndarray, num_vertices: int, num_labels: int
               ) -> np.ndarray:
    """Collision-free int64 key per (src, label, dst) row."""
    e = edges.astype(np.int64)
    return (e[:, 0] * num_labels + e[:, 1]) * num_vertices + e[:, 2]


@dataclass(frozen=True)
class GraphDelta:
    """A batch of edge mutations: ``inserts``/``deletes`` are (m, 3) int32
    rows of ``(src, label, dst)``, deduplicated and disjoint.

    The unit the incremental build engine (:mod:`repro_torch.build.delta`)
    consumes: :meth:`LabeledGraph.apply_delta` turns ``graph + delta``
    into the mutated graph, and the delta builder re-derives only the
    ``(hub, direction)`` phases the delta can touch.
    """

    inserts: np.ndarray
    deletes: np.ndarray

    @staticmethod
    def of(inserts: Sequence = (), deletes: Sequence = ()) -> "GraphDelta":
        def norm(rows):
            a = np.asarray(rows, dtype=np.int32).reshape(-1, 3)
            return np.unique(a, axis=0) if a.size else a
        return GraphDelta(norm(inserts), norm(deletes))

    @property
    def num_changes(self) -> int:
        return int(self.inserts.shape[0] + self.deletes.shape[0])

    def endpoints(self) -> np.ndarray:
        """Sorted unique vertex ids whose degree the delta changes."""
        cols = [self.inserts[:, 0], self.inserts[:, 2],
                self.deletes[:, 0], self.deletes[:, 2]]
        return np.unique(np.concatenate(cols)).astype(np.int64)

    def validate(self, graph: "LabeledGraph") -> None:
        """Raise ``ValueError`` unless the delta is applicable to
        ``graph``: ids in range, deletes present, inserts absent, and no
        row both inserted and deleted."""
        for name, rows in (("inserts", self.inserts),
                           ("deletes", self.deletes)):
            if not rows.size:
                continue
            if (rows[:, [0, 2]].min() < 0
                    or rows[:, [0, 2]].max() >= graph.num_vertices):
                raise ValueError(f"{name}: vertex id out of range "
                                 f"[0, {graph.num_vertices})")
            if rows[:, 1].min() < 0 or rows[:, 1].max() >= graph.num_labels:
                raise ValueError(f"{name}: label id out of range "
                                 f"[0, {graph.num_labels})")
        V, L = graph.num_vertices, graph.num_labels
        have = _edge_keys(graph.edges, V, L)
        ins = _edge_keys(self.inserts, V, L)
        dels = _edge_keys(self.deletes, V, L)
        if np.isin(ins, have).any():
            raise ValueError("inserts contain edges already in the graph")
        if not np.isin(dels, have).all():
            raise ValueError("deletes contain edges not in the graph")
        if np.isin(ins, dels).any():
            raise ValueError("an edge appears in both inserts and deletes")


@dataclass
class LabeledGraph:
    num_vertices: int
    num_labels: int
    # (m, 3) int32 rows of (src, label, dst), deduplicated.
    edges: np.ndarray

    # --- derived CSR structures (built lazily) ---
    _fwd: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = field(
        default=None, repr=False)
    _bwd: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = field(
        default=None, repr=False)
    _label_adj: Optional[np.ndarray] = field(default=None, repr=False)
    _fwd_label_csr: Optional[Tuple[np.ndarray, np.ndarray]] = field(
        default=None, repr=False)
    _bwd_label_csr: Optional[Tuple[np.ndarray, np.ndarray]] = field(
        default=None, repr=False)

    # ------------------------------------------------------------------ #
    @staticmethod
    def from_edges(num_vertices: int, num_labels: int,
                   edges: np.ndarray) -> "LabeledGraph":
        edges = np.asarray(edges, dtype=np.int32).reshape(-1, 3)
        if edges.size:
            edges = np.unique(edges, axis=0)
        return LabeledGraph(num_vertices, num_labels, edges)

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])

    def apply_delta(self, delta: GraphDelta,
                    validate: bool = True) -> "LabeledGraph":
        """The mutated graph ``(E \\ deletes) ∪ inserts`` as a fresh
        :class:`LabeledGraph` (same vertex/label space; derived CSR caches
        are rebuilt lazily on the new object — the receiver is untouched,
        so index builds against the old snapshot stay valid)."""
        if validate:
            delta.validate(self)
        keys = _edge_keys(self.edges, self.num_vertices, self.num_labels)
        dels = _edge_keys(delta.deletes, self.num_vertices, self.num_labels)
        kept = self.edges[~np.isin(keys, dels)]
        edges = (np.concatenate([kept, delta.inserts.astype(np.int32)])
                 if delta.inserts.size else kept)
        return LabeledGraph.from_edges(self.num_vertices, self.num_labels,
                                       edges)

    # ------------------------------------------------------------------ #
    def _build_csr(self, key_col: int, val_col: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """CSR keyed on ``key_col`` vertex; values are (other_vertex, label)
        sorted by (key, label) so per-label slices are contiguous."""
        e = self.edges
        order = np.lexsort((e[:, val_col], e[:, 1], e[:, key_col]))
        e = e[order]
        indptr = np.zeros(self.num_vertices + 1, dtype=np.int64)
        np.add.at(indptr, e[:, key_col] + 1, 1)
        np.cumsum(indptr, out=indptr)
        return indptr, e[:, val_col].copy(), e[:, 1].copy()

    @property
    def fwd(self):
        """(indptr, dst, label): out-edges of each vertex, label-sorted."""
        if self._fwd is None:
            self._fwd = self._build_csr(key_col=0, val_col=2)
        return self._fwd

    @property
    def bwd(self):
        """(indptr, src, label): in-edges of each vertex, label-sorted."""
        if self._bwd is None:
            self._bwd = self._build_csr(key_col=2, val_col=0)
        return self._bwd

    # -- neighbor iteration -------------------------------------------- #
    def out_edges(self, v: int) -> Tuple[np.ndarray, np.ndarray]:
        indptr, other, lab = self.fwd
        s, t = indptr[v], indptr[v + 1]
        return other[s:t], lab[s:t]

    def in_edges(self, v: int) -> Tuple[np.ndarray, np.ndarray]:
        indptr, other, lab = self.bwd
        s, t = indptr[v], indptr[v + 1]
        return other[s:t], lab[s:t]

    # -- label-partitioned CSR (shared by batched builders, baselines,
    #    the dense engine, and per-label neighbor slicing) --------------- #
    def _build_label_csr(self, backward: bool
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """CSR keyed on the composite ``vertex * |L| + label``.

        The base CSRs are already (vertex, label)-sorted, so the neighbor
        array is shared (no copy); only the (V*|L| + 1) indptr is new.
        ``nbrs[indptr[v*L + l] : indptr[v*L + l + 1]]`` are v's neighbors
        via label ``l``, in the direction's base-CSR order.
        """
        indptr, other, lab = self.bwd if backward else self.fwd
        nl = self.num_labels
        keys = np.zeros(self.num_vertices * nl + 1, dtype=np.int64)
        # edge e sits at row (key_vertex[e], lab[e]); count per composite key
        vert = np.repeat(np.arange(self.num_vertices), np.diff(indptr))
        np.add.at(keys, vert * nl + lab + 1, 1)
        np.cumsum(keys, out=keys)
        return keys, other

    def label_csr(self, backward: bool = False
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Cached ``(indptr, nbrs)`` label-partitioned adjacency; see
        :meth:`_build_label_csr` for the layout contract."""
        if backward:
            if self._bwd_label_csr is None:
                self._bwd_label_csr = self._build_label_csr(True)
            return self._bwd_label_csr
        if self._fwd_label_csr is None:
            self._fwd_label_csr = self._build_label_csr(False)
        return self._fwd_label_csr

    def out_neighbors_with_label(self, v: int, label: int) -> np.ndarray:
        indptr, nbrs = self.label_csr(backward=False)
        key = v * self.num_labels + label
        return nbrs[indptr[key]:indptr[key + 1]]

    def in_neighbors_with_label(self, v: int, label: int) -> np.ndarray:
        indptr, nbrs = self.label_csr(backward=True)
        key = v * self.num_labels + label
        return nbrs[indptr[key]:indptr[key + 1]]

    # -- degrees & the IN-OUT vertex ordering (paper §V-B) -------------- #
    def out_degree(self) -> np.ndarray:
        indptr, _, _ = self.fwd
        return np.diff(indptr)

    def in_degree(self) -> np.ndarray:
        indptr, _, _ = self.bwd
        return np.diff(indptr)

    def access_order(self) -> np.ndarray:
        """Vertices sorted by (|out(v)|+1)*(|in(v)|+1) descending; ties by
        vertex id for determinism. ``order[aid-1] = vertex``."""
        score = (self.out_degree() + 1).astype(np.int64) * \
                (self.in_degree() + 1).astype(np.int64)
        return np.lexsort((np.arange(self.num_vertices), -score))

    def access_ids(self) -> np.ndarray:
        """``aid[v]`` = 1-based access id of vertex v."""
        order = self.access_order()
        aid = np.empty(self.num_vertices, dtype=np.int64)
        aid[order] = np.arange(1, self.num_vertices + 1)
        return aid

    # -- dense per-label adjacency for the semiring engine -------------- #
    def label_adjacency(self, dtype=np.float32) -> np.ndarray:
        """Dense (|L|, n, n) boolean-as-``dtype`` adjacency stack.
        ``A[l, u, v] = 1`` iff edge (u, l, v).

        Derived from :meth:`label_csr` so the dense engine, the baselines,
        and the batched builders all share one adjacency source.
        """
        if self._label_adj is None or self._label_adj.dtype != dtype:
            n, nl = self.num_vertices, self.num_labels
            indptr, nbrs = self.label_csr(backward=False)
            keys = np.repeat(np.arange(n * nl), np.diff(indptr))
            A = np.zeros((nl, n, n), dtype=dtype)
            A[keys % nl, keys // nl, nbrs] = 1
            self._label_adj = A
        return self._label_adj

    # -- stats used in benchmarks (paper Table III) ---------------------- #
    def loop_count(self) -> int:
        return int(np.sum(self.edges[:, 0] == self.edges[:, 2]))

    def summary(self) -> Dict[str, int]:
        return dict(V=self.num_vertices, E=self.num_edges,
                    L=self.num_labels, loops=self.loop_count())
