"""The benchmark's graph generator, frozen so that the workload does not
move with the program.

A copy of the directed Barabasi-Albert recipe with Zipfian edge labels
(exponent 2, as the RLC index paper assigns labels, section VI-b), as
``repro_torch.graphgen.generators`` had it when the benchmark was written.
It returns a plain ``(m, 3)`` int32 array of ``(src, label, dst)`` rows;
the harness hands it to the program through ``LabeledGraph.from_edges``
and to the reference as it is.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np


def zipf_labels(num_edges: int, num_labels: int, rng: np.random.Generator,
                exponent: float = 2.0) -> np.ndarray:
    """Zipfian label ids in ``[0, num_labels)``: label ``i`` with weight
    ``(i + 1) ** -exponent``."""
    ranks = np.arange(1, num_labels + 1, dtype=np.float64)
    p = ranks ** (-exponent)
    p /= p.sum()
    return rng.choice(num_labels, size=num_edges, p=p).astype(np.int32)


def barabasi_albert(num_vertices: int, m_attach: int, num_labels: int,
                    seed: int, label_zipf_exponent: float = 2.0,
                    reverse_edge_p: float = 0.5) -> np.ndarray:
    """Directed BA graph: a complete directed core of ``m_attach + 1``
    vertices, then each new vertex sends ``m_attach`` edges to distinct
    older vertices drawn by degree, each answered by a reverse edge with
    probability ``reverse_edge_p``. No self loops, no duplicate rows."""
    rng = np.random.default_rng(seed)
    core = m_attach + 1
    src_l, dst_l = [], []
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
            if rng.random() < reverse_edge_p:
                src_l.append(int(t))
                dst_l.append(v)
            degree[t] += 1
            degree[v] += 1
            total += 2
    lab = zipf_labels(len(src_l), num_labels, rng, label_zipf_exponent)
    return np.stack([np.asarray(src_l, np.int32), lab,
                     np.asarray(dst_l, np.int32)], axis=1)


GENERATORS = {"barabasi_albert": barabasi_albert}


def make_edges(graph_cfg: Mapping, seed: int) -> np.ndarray:
    """The edge rows of a configuration's ``graph`` recipe for ``seed``
    (any whole number; folded into numpy's unsigned 64-bit seed)."""
    cfg = dict(graph_cfg)
    gen = GENERATORS[cfg.pop("generator")]
    return gen(seed=int(seed) % 2 ** 64, **cfg)
