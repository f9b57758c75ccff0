"""Synthetic graph generation (paper §VI-b).

ER (Erdős–Rényi) and BA (Barabási–Albert) digraphs with Zipfian edge-label
assignment (exponent 2, matching the paper / gMark), plus the paper's two
illustration graphs (Fig. 1 and Fig. 2) for examples and tests.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.core.graph import LabeledGraph


def zipf_labels(num_edges: int, num_labels: int, rng: np.random.Generator,
                exponent: float = 2.0) -> np.ndarray:
    """Zipfian label ids (exponent 2 per the paper) in ``[0, num_labels)``."""
    ranks = np.arange(1, num_labels + 1, dtype=np.float64)
    p = ranks ** (-exponent)
    p /= p.sum()
    return rng.choice(num_labels, size=num_edges, p=p).astype(np.int32)


def erdos_renyi(num_vertices: int, avg_degree: float, num_labels: int,
                seed: int = 0, allow_loops: bool = True) -> LabeledGraph:
    """Directed ER graph: ``n * avg_degree`` edges drawn uniformly."""
    rng = np.random.default_rng(seed)
    m = int(round(num_vertices * avg_degree))
    src = rng.integers(0, num_vertices, size=m, dtype=np.int64)
    dst = rng.integers(0, num_vertices, size=m, dtype=np.int64)
    if not allow_loops:
        loops = src == dst
        dst[loops] = (dst[loops] + 1) % num_vertices
    lab = zipf_labels(m, num_labels, rng)
    edges = np.stack([src, lab, dst], axis=1)
    return LabeledGraph.from_edges(num_vertices, num_labels, edges)


def barabasi_albert(num_vertices: int, m_attach: int, num_labels: int,
                    seed: int = 0) -> LabeledGraph:
    """Directed BA graph: start from a complete core of ``m_attach + 1``
    vertices; each new vertex attaches ``m_attach`` out-edges preferentially
    (classic BA; direction new -> target, plus a reverse edge with p=0.5 to
    mimic the cyclic character of the paper's datasets)."""
    rng = np.random.default_rng(seed)
    core = m_attach + 1
    src_l, dst_l = [], []
    # complete directed core (both directions, no self loops)
    for u in range(core):
        for v in range(core):
            if u != v:
                src_l.append(u)
                dst_l.append(v)
    degree = np.zeros(num_vertices, dtype=np.float64)
    degree[:core] = 2 * (core - 1)
    total = degree.sum()
    for v in range(core, num_vertices):
        p = degree[:v] / total
        targets = rng.choice(v, size=min(m_attach, v), replace=False, p=p)
        for t in targets:
            src_l.append(v)
            dst_l.append(int(t))
            if rng.random() < 0.5:
                src_l.append(int(t))
                dst_l.append(v)
            degree[t] += 1
            degree[v] += 1
            total += 2
    m = len(src_l)
    lab = zipf_labels(m, num_labels, rng)
    edges = np.stack([np.asarray(src_l), lab, np.asarray(dst_l)], axis=1)
    return LabeledGraph.from_edges(num_vertices, num_labels, edges)


def random_labeled_graph(num_vertices: int, num_edges: int, num_labels: int,
                         seed: int = 0, self_loop_frac: float = 0.05
                         ) -> LabeledGraph:
    """Uniform random graph with a controlled fraction of self loops —
    the stress shape for RLC indexing (cycles of length 1, paper §II)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_vertices, size=num_edges, dtype=np.int64)
    dst = rng.integers(0, num_vertices, size=num_edges, dtype=np.int64)
    n_loop = int(num_edges * self_loop_frac)
    if n_loop:
        which = rng.choice(num_edges, size=n_loop, replace=False)
        dst[which] = src[which]
    lab = rng.integers(0, num_labels, size=num_edges, dtype=np.int64)
    edges = np.stack([src, lab, dst], axis=1)
    return LabeledGraph.from_edges(num_vertices, num_labels, edges)


def random_delta(graph: LabeledGraph, n_ins: int, n_del: int,
                 rng: np.random.Generator, max_tries: int = 1000):
    """A random :class:`repro_torch.core.graph.GraphDelta` for ``graph``:
    ``n_del`` uniformly drawn existing edges deleted plus up to
    ``n_ins`` fresh (absent) edges inserted. The insert search is
    bounded by ``max_tries`` rejection samples so a near-complete
    (src, label, dst) space degrades to a smaller insert batch instead
    of spinning — the shared workload generator for the delta tests,
    benchmarks and examples."""
    from repro_torch.core.graph import GraphDelta
    keys = set(map(tuple, graph.edges.tolist()))
    n_del = min(n_del, graph.num_edges)
    dels = [graph.edges[i].tolist()
            for i in rng.choice(graph.num_edges, size=n_del,
                                replace=False)] if n_del else []
    ins: list = []
    seen = set()
    for _ in range(max_tries):
        if len(ins) >= n_ins:
            break
        e = (int(rng.integers(graph.num_vertices)),
             int(rng.integers(graph.num_labels)),
             int(rng.integers(graph.num_vertices)))
        if e not in keys and e not in seen:
            seen.add(e)
            ins.append(list(e))
    return GraphDelta.of(ins, dels)


# ------------------------------------------------------------------ #
# Paper illustration graphs
# ------------------------------------------------------------------ #
def fig2_graph() -> Tuple[LabeledGraph, Dict[str, int]]:
    """The running-example graph of paper Fig. 2 (reconstructed from the
    example text + Table II). Labels: l1=0, l2=1, l3=2; vertices v1..v6."""
    names = {f"v{i}": i - 1 for i in range(1, 7)}
    l1, l2, l3 = 0, 1, 2
    E = [
        ("v1", l2, "v3"), ("v3", l1, "v2"), ("v3", l1, "v6"),
        ("v3", l2, "v4"), ("v4", l1, "v1"), ("v2", l2, "v5"),
        ("v5", l1, "v1"), ("v4", l3, "v6"), ("v3", l2, "v1"),
        ("v2", l1, "v1"),
    ]
    edges = np.array([[names[s], l, names[t]] for s, l, t in E])
    return LabeledGraph.from_edges(6, 3, edges), names


def fig1_graph() -> Tuple[LabeledGraph, Dict[str, int], Dict[str, int]]:
    """The social/professional/financial network of paper Fig. 1 (Example 1).

    Vertices: persons P10..P13, P16; accounts A14, A17, A19; employers
    E15, E18 (account-like transfer hops). Labels: knows, worksFor, debits,
    credits, holds. Encodes the two example queries:
      Q1(A14, A19, (debits, credits)+) = true
      Q2(P10, P13, (knows, knows, worksFor)+) = false
    """
    labels = {"knows": 0, "worksFor": 1, "debits": 2, "credits": 3,
              "holds": 4}
    names = {}
    for i, nm in enumerate(["P10", "P11", "P12", "P13", "P16",
                            "A14", "E15", "A17", "E18", "A19"]):
        names[nm] = i
    K, W, D, C, H = (labels[x] for x in
                     ("knows", "worksFor", "debits", "credits", "holds"))
    E = [
        # social / professional
        ("P10", K, "P11"), ("P11", W, "P12"), ("P12", K, "P13"),
        ("P13", W, "P16"), ("P11", K, "P12"), ("P12", K, "P16"),
        ("P16", K, "P10"),
        # account holdings
        ("P10", H, "A14"), ("P12", H, "A17"), ("P13", H, "A19"),
        # money movement: A14 -debits-> E15 -credits-> A17 -debits-> E18
        #                 -credits-> A19
        ("A14", D, "E15"), ("E15", C, "A17"), ("A17", D, "E18"),
        ("E18", C, "A19"),
    ]
    edges = np.array([[names[s], l, names[t]] for s, l, t in E])
    return LabeledGraph.from_edges(10, 5, edges), names, labels
