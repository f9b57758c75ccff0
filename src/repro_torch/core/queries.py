"""Query-workload generation (paper §VI-c).

Uniformly sample (s, t, L^+) triples, classify each with a bidirectional
product-automaton BFS, and collect 1000 true- and 1000 false-queries.
Constraints L are drawn from the realizable minimum repeats of the graph
(uniform over MR space, as in the paper), biased to length <= k.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .baselines import bibfs_rlc
from .graph import LabeledGraph
from .minimum_repeat import LabelSeq, enumerate_mrs, minimum_repeat


@dataclass
class QuerySet:
    true_queries: List[Tuple[int, int, LabelSeq]]
    false_queries: List[Tuple[int, int, LabelSeq]]

    def all(self) -> List[Tuple[int, int, LabelSeq, bool]]:
        return ([(s, t, L, True) for s, t, L in self.true_queries]
                + [(s, t, L, False) for s, t, L in self.false_queries])


def generate_queries(g: LabeledGraph, k: int, n_true: int = 1000,
                     n_false: int = 1000, seed: int = 0,
                     max_attempts: Optional[int] = None) -> QuerySet:
    rng = np.random.default_rng(seed)
    mrs = enumerate_mrs(g.num_labels, k)
    # restrict to labels that actually occur (otherwise false-queries are
    # trivially false and true-queries unreachable)
    present = np.unique(g.edges[:, 1]) if g.num_edges else np.array([0])
    mrs = [m for m in mrs if all(l in present for l in m)] or list(mrs)
    tq: List[Tuple[int, int, LabelSeq]] = []
    fq: List[Tuple[int, int, LabelSeq]] = []
    attempts = 0
    cap = max_attempts or (n_true + n_false) * 200
    while (len(tq) < n_true or len(fq) < n_false) and attempts < cap:
        attempts += 1
        s = int(rng.integers(g.num_vertices))
        t = int(rng.integers(g.num_vertices))
        L = mrs[int(rng.integers(len(mrs)))]
        ans = bibfs_rlc(g, s, t, L)
        if ans and len(tq) < n_true:
            tq.append((s, t, L))
        elif not ans and len(fq) < n_false:
            fq.append((s, t, L))
    return QuerySet(tq, fq)


def sample_index_queries(frozen, id_to_mr, n: int = 64, seed: int = 0
                         ) -> List[Tuple[int, int, LabelSeq]]:
    """Sample ``(s, t, L)`` queries straight from a frozen index's entries.

    Every entry is a reachability fact — ``(h, c)`` at out-row ``v``
    witnesses ``v ~~mr_c^+~~> h``, and symmetrically on the in side — so
    each sampled entry yields a query the index *must* answer ``True``.
    The index-health auditor (:mod:`repro_torch.obs.audit`) replays these
    against the BiBFS oracle as soundness probes, and they double as a
    hot-row-biased warm set (entry-dense rows are sampled more often),
    the shape the ROADMAP item-5 cache warmers want.
    """
    rng = np.random.default_rng(seed)
    out_n, in_n = len(frozen.out_hub), len(frozen.in_hub)
    total = out_n + in_n
    if total == 0:
        return []
    out: List[Tuple[int, int, LabelSeq]] = []
    for e in rng.integers(total, size=n).tolist():
        if e < out_n:
            v = int(np.searchsorted(frozen.out_indptr, e, "right")) - 1
            hub = int(frozen.out_hub[e])
            L = tuple(id_to_mr[int(frozen.out_mr[e])])
            out.append((v, hub, L))
        else:
            e -= out_n
            v = int(np.searchsorted(frozen.in_indptr, e, "right")) - 1
            hub = int(frozen.in_hub[e])
            L = tuple(id_to_mr[int(frozen.in_mr[e])])
            out.append((hub, v, L))
    return out


def biased_true_queries(g: LabeledGraph, k: int, n: int, seed: int = 0,
                        n_false: Optional[int] = None) -> QuerySet:
    """Seed true queries from short random walks so dense true sets exist
    even on very sparse graphs (used by benchmarks to hit the n_true quota
    quickly without the oracle).

    A walk ``s -> ... -> t`` of length ``<= k`` spelling ``seq`` witnesses
    ``s ~~MR(seq)^+~~> t`` (``seq`` is always a power of its own minimum
    repeat), so every sampled walk yields a true query with an MR of length
    up to ``k`` — not just single-label constraints. False queries are
    uniform ``(s, t, L)`` triples over the walk-observed MR pool, verified
    negative with the BiBFS oracle.
    """
    rng = np.random.default_rng(seed)
    n_false = n if n_false is None else n_false
    tq: List[Tuple[int, int, LabelSeq]] = []
    fq: List[Tuple[int, int, LabelSeq]] = []
    m = g.num_edges
    if m == 0:
        return QuerySet(tq, fq)
    seen_mrs: List[LabelSeq] = []
    attempts = 0
    while len(tq) < n and attempts < n * 100:
        attempts += 1
        # random walk of target length 1..k from a random edge's source
        e = g.edges[int(rng.integers(m))]
        s = int(e[0])
        length = int(rng.integers(1, k + 1))
        x, labels = s, []
        for _ in range(length):
            nbrs, labs = g.out_edges(x)
            if len(nbrs) == 0:
                break
            j = int(rng.integers(len(nbrs)))
            labels.append(int(labs[j]))
            x = int(nbrs[j])
        if not labels:
            continue
        L = minimum_repeat(tuple(labels))
        if len(L) > k:          # unreachable (|walk| <= k) — belt and braces
            continue
        tq.append((s, x, L))
        if L not in seen_mrs:
            seen_mrs.append(L)
    attempts = 0
    while len(fq) < n_false and attempts < n_false * 200 and seen_mrs:
        attempts += 1
        s = int(rng.integers(g.num_vertices))
        t = int(rng.integers(g.num_vertices))
        L = seen_mrs[int(rng.integers(len(seen_mrs)))]
        if not bibfs_rlc(g, s, t, L):
            fq.append((s, t, L))
    return QuerySet(tq, fq)
