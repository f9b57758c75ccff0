"""Phase dependency DAG over Algorithm 2's ``(hub, direction)`` phases.

Algorithm 2 runs ``2V`` phases in a fixed total order (IN-OUT access
order, backward before forward per hub — the "line 36" constraint
documented in the JAX package's ``src/repro/build/README.md``). The
only *true* cross-phase data flow runs through the entries at the hub's
own vertex: phase ``(v, bwd)`` reads ``L_in(v)`` items plus the
out-side mirror rows of the hubs appearing in them, ``(v, fwd)``
symmetrically via ``L_out(v)``
— everything else a phase touches is static graph structure. A hub
``x`` can only have written at ``v`` if ``v`` is reachable from ``x``
(forward writes) or reaches ``x`` (backward writes), so most phase
pairs on real graphs are independent and the true DAG is far wider
than the sequential chain.

The exact write set is unknowable before building (PR1/PR3 prune most
candidate entries), so this DAG is a *scheduling heuristic*, not a
correctness device — the epoch/merge protocol in
:mod:`repro_torch.build.parallel.backend` validates every phase's actual
read fingerprint and re-runs conflicts exactly. Edges come from three
over-approximations of "x may write at v" (for ``rank(x) < rank(v)``):

* **intra-hub**: ``(v, bwd) -> (v, fwd)`` always (fwd reads L_out(v),
  which bwd writes);
* **hot prefix**: for the first ``hot_prefix`` hubs in access order —
  the ones whose entries blanket the graph — the *single-label*
  reachability cone: a phase's only writes beyond its ``k``-hop ball
  come from kernel-BFS walks, and the long-range mass of those is the
  ``m = 1`` kernels (paths spelling ``a^j``), whose write set is
  exactly the per-label closure. ``v`` in any label closure of ``x``
  adds ``(x, *) -> (v, bwd)`` edges; symmetric backward closures add
  ``(x, *) -> (v, fwd)``. (Full reachability would chain nearly every
  phase behind every hot hub on a connected graph — measured on the
  bench stand-ins it pushes the critical-path share past 0.4 for no
  stale-re-run savings.)
* **locality**: kernel-search writes land within ``k`` hops of the
  hub, so ``x`` within ``locality`` (default ``k``) backward hops of
  ``v`` adds ``(x, *) -> (v, bwd)``, within forward hops
  ``(x, *) -> (v, fwd)``.

Multi-label cyclic kernels (``m >= 2``) beyond the ball are the one
write family deliberately left out — they are rare, and a missed edge
costs one exact re-run, not correctness.

Beyond these the scheduler is optimistic: a long-range kernel-BFS
write from a cold hub surfaces as a stale fingerprint and an exact
re-run, never as a wrong bit.

Positions: phase ``(order[r], bwd)`` is node ``2r``, ``(order[r],
fwd)`` is ``2r + 1`` — ascending position *is* the sequential total
order, so every edge points forward and one ascending pass computes
levels.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.graph import LabeledGraph

__all__ = ["PhaseDAG"]

#: above this vertex count the packed-int reachability/ball passes are
#: skipped (hot + locality edges off; the protocol still re-runs any
#: conflict exactly, the schedule is just more optimistic).
_EDGE_ANALYSIS_MAX_V = 20_000


def _adj_bits(graph: LabeledGraph
              ) -> Tuple[List[int], List[int], List[List[int]],
                         List[List[int]]]:
    """Packed adjacency: label-blind ``fwd[v]`` / ``bwd[v]`` neighbor
    bitsets plus the per-label views (one shifted-OR per edge)."""
    V, L = graph.num_vertices, graph.num_labels
    fwd = [0] * V
    bwd = [0] * V
    fwd_l = [[0] * V for _ in range(L)]
    bwd_l = [[0] * V for _ in range(L)]
    for s, lab, d in graph.edges.tolist():
        db, sb = 1 << d, 1 << s
        fwd[s] |= db
        bwd[d] |= sb
        fwd_l[lab][s] |= db
        bwd_l[lab][d] |= sb
    return fwd, bwd, fwd_l, bwd_l


def _closure(src: int, adj: List[int]) -> int:
    """Packed-int BFS closure from ``src`` (excluding ``src`` unless on
    a cycle)."""
    vis = 0
    fr = adj[src]
    while fr:
        vis |= fr
        nxt = 0
        while fr:
            b = fr & -fr
            fr ^= b
            nxt |= adj[b.bit_length() - 1]
        fr = nxt & ~vis
    return vis


def _ball(src: int, adj: List[int], hops: int) -> int:
    """Vertices within ``hops`` steps of ``src`` along ``adj``."""
    vis = 0
    fr = adj[src]
    for _ in range(hops):
        if not fr:
            break
        vis |= fr
        nxt = 0
        while fr:
            b = fr & -fr
            fr ^= b
            nxt |= adj[b.bit_length() - 1]
        fr = nxt & ~vis
    return vis


class PhaseDAG:
    """Dependency DAG + static stats over the ``2V`` phase positions."""

    def __init__(self, graph: LabeledGraph, k: int, order: np.ndarray,
                 hot_prefix: int = 16, locality: int | None = None):
        V = graph.num_vertices
        self.npos = 2 * V
        self.order = np.asarray(order, dtype=np.int64)
        self.rank = np.empty(V, dtype=np.int64)
        self.rank[self.order] = np.arange(V)
        out_deg, in_deg = graph.out_degree(), graph.in_degree()
        self.active = np.zeros(self.npos, dtype=bool)
        self.active[0::2] = in_deg[self.order] > 0    # (v, bwd)
        self.active[1::2] = out_deg[self.order] > 0   # (v, fwd)
        preds: List[set] = [set() for _ in range(self.npos)]
        for r in range(V):
            if self.active[2 * r] and self.active[2 * r + 1]:
                preds[2 * r + 1].add(2 * r)
        hops = int(k if locality is None else locality)
        if V and V <= _EDGE_ANALYSIS_MAX_V and graph.num_edges:
            fwd, bwd, fwd_l, bwd_l = _adj_bits(graph)
            self._hot_edges(preds, fwd_l, bwd_l, min(int(hot_prefix), V))
            if hops > 0:
                self._local_edges(preds, fwd, bwd, hops)
        self.preds: List[Tuple[int, ...]] = [
            tuple(sorted(p)) for p in preds]
        self.num_edges = sum(len(p) for p in self.preds)

    # -- edge passes ---------------------------------------------------- #
    def _add_hub_edges(self, preds: List[set], i: int, pos: int) -> None:
        """Both phases of the rank-``i`` hub become preds of ``pos``."""
        if self.active[2 * i]:
            preds[pos].add(2 * i)
        if self.active[2 * i + 1]:
            preds[pos].add(2 * i + 1)

    def _hot_edges(self, preds, fwd_l, bwd_l, hot: int) -> None:
        for i in range(hot):
            x = int(self.order[i])
            if not (self.active[2 * i] or self.active[2 * i + 1]):
                continue
            reach = coreach = 0
            for adj_f, adj_b in zip(fwd_l, bwd_l):
                reach |= _closure(x, adj_f)
                coreach |= _closure(x, adj_b)
            for j in range(i + 1, len(self.order)):
                v = int(self.order[j])
                vb = 1 << v
                if reach & vb and self.active[2 * j]:
                    self._add_hub_edges(preds, i, 2 * j)
                if coreach & vb and self.active[2 * j + 1]:
                    self._add_hub_edges(preds, i, 2 * j + 1)

    def _local_edges(self, preds, fwd, bwd, hops: int) -> None:
        rank = self.rank
        for j in range(len(self.order)):
            v = int(self.order[j])
            for pos, ball in ((2 * j, _ball(v, bwd, hops)),
                              (2 * j + 1, _ball(v, fwd, hops))):
                if not self.active[pos]:
                    continue
                f = ball
                while f:
                    b = f & -f
                    f ^= b
                    i = int(rank[b.bit_length() - 1])
                    if i < j:
                        self._add_hub_edges(preds, i, pos)

    # -- static structure stats ----------------------------------------- #
    def levels(self) -> np.ndarray:
        """ASAP level per position (0 for inactive); one ascending pass
        (edges always point to higher positions)."""
        lv = np.zeros(self.npos, dtype=np.int64)
        for p in range(self.npos):
            if not self.active[p]:
                continue
            lv[p] = 1 + max((lv[q] for q in self.preds[p]), default=0)
        return lv

    def stats(self, cost: np.ndarray | None = None) -> Dict:
        """Width/depth + (when per-position ``cost`` estimates are
        given) the critical-path share of total work — the sequential-
        fallback signal and the bench's DAG-width artifact fields."""
        lv = self.levels()
        act = lv[self.active]
        depth = int(act.max()) if act.size else 0
        widths = (np.bincount(act, minlength=depth + 1)[1:]
                  if depth else np.zeros(0, np.int64))
        out = dict(
            phases=int(self.active.sum()), edges=self.num_edges,
            depth=depth,
            max_width=int(widths.max()) if widths.size else 0,
            mean_width=round(float(widths.mean()), 2) if widths.size
            else 0.0)
        if cost is not None:
            cpl = np.zeros(self.npos)
            for p in range(self.npos):
                if self.active[p]:
                    cpl[p] = cost[p] + max(
                        (cpl[q] for q in self.preds[p]), default=0.0)
            total = float(cost[self.active].sum())
            out["serial_fraction"] = round(
                float(cpl.max()) / total, 4) if total > 0 else 1.0
        return out
