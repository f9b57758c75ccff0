"""Carry index state across from the JAX package (plain numpy in, port out).

Both packages keep their host-side index state in numpy arrays and python
dicts, so an index built by one can be served by the other: pass the
fields of a ``repro`` index (``FrozenRLCIndex`` arrays, or ``RLCIndex``
entry maps) and get the port's object holding the same entries. Tests use
this to put the *same* index behind both packages' device layouts and
services, and the *same* dense reachability stack behind both packages'
condensed builds.
"""
from __future__ import annotations

from typing import Dict, List, Set

import numpy as np

from repro_torch.core.dense import DenseEngine
from repro_torch.core.graph import LabeledGraph
from repro_torch.core.minimum_repeat import (LabelSeq, enumerate_mrs,
                                             mr_id_space)
from repro_torch.core.rlc_index import FrozenRLCIndex, RLCIndex


def frozen_from_arrays(num_vertices: int, k: int, aid, out_indptr,
                       out_hub, out_mr, in_indptr, in_hub, in_mr
                       ) -> FrozenRLCIndex:
    """The port's :class:`FrozenRLCIndex` over copies of the given CSR
    arrays (indptr int64, hub/mr int32, as :meth:`FrozenRLCIndex.
    from_index` lays them out)."""
    n = int(num_vertices)
    ii = np.array(out_indptr, dtype=np.int64), np.array(in_indptr,
                                                         dtype=np.int64)
    for name, ptr, hub, mr in (("out", ii[0], out_hub, out_mr),
                               ("in", ii[1], in_hub, in_mr)):
        if ptr.shape != (n + 1,) or ptr[0] != 0 \
                or ptr[-1] != len(hub) or len(hub) != len(mr):
            raise ValueError(f"inconsistent {name} CSR arrays")
    return FrozenRLCIndex(n, int(k), np.array(aid), ii[0],
                          np.array(out_hub, dtype=np.int32),
                          np.array(out_mr, dtype=np.int32), ii[1],
                          np.array(in_hub, dtype=np.int32),
                          np.array(in_mr, dtype=np.int32))


def index_from_entries(num_vertices: int, k: int, aid,
                       l_out: List[Dict[int, Set[LabelSeq]]],
                       l_in: List[Dict[int, Set[LabelSeq]]]) -> RLCIndex:
    """The port's :class:`RLCIndex` holding copies of the given per-vertex
    entry maps (``hub -> set of MR tuples``)."""
    if len(l_out) != num_vertices or len(l_in) != num_vertices:
        raise ValueError("one entry map per vertex and direction")
    copy = lambda maps: [{int(h): {tuple(m) for m in ms}  # noqa: E731
                          for h, ms in d.items()} for d in maps]
    return RLCIndex(int(num_vertices), int(k), np.array(aid),
                    l_in=copy(l_in), l_out=copy(l_out))


def dense_engine_from_arrays(graph: LabeledGraph, k: int, reach
                             ) -> DenseEngine:
    """The port's :class:`DenseEngine` over a copy of a ``(C, n, n)``
    reachability stack (a ``repro`` ``DenseEngine.reach``), for the
    port's ``graph`` and ``k``."""
    mrs = enumerate_mrs(graph.num_labels, int(k))
    n = graph.num_vertices
    reach = np.array(reach, dtype=bool)
    if reach.shape != (len(mrs), n, n):
        raise ValueError(f"reach must be ({len(mrs)}, {n}, {n}), not "
                         f"{reach.shape}")
    return DenseEngine(graph, int(k), mrs,
                       mr_id_space(graph.num_labels, int(k)), reach)
