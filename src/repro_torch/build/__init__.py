"""Batched index-construction engine (Algorithm 2 as a staged pipeline).

Public surface::

    from repro_torch.build import build_rlc_index, build_rlc_index_with_stats
    idx = build_rlc_index(g, k=2)                       # auto -> numpy
    idx, st = build_rlc_index_with_stats(g, 2, backend="cuda")
    get_backend("numpy", mode="vector").build(g, 2)     # explicit control

Backends:

============  ==========================================================
``python``    faithful sequential Algorithm 2 — the reference oracle
``numpy``     hybrid scalar / vectorized bitset waves on label CSR
``cuda``      hybrid with waves run by the CUDA frontier kernel
              (``device=``, default ``"cuda"``; request explicitly)
============  ==========================================================

Incremental builds of a mutated graph: :mod:`repro_torch.build.delta`
(``DeltaBuilder``, over the ``numpy`` or ``cuda`` backend).

All backends produce bit-identical index entries and pruning counters.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.core.graph import LabeledGraph
from repro_torch.core.rlc_index import RLCIndex

from .base import (AUTO_ORDER, BuildBackend, BuildStats, PrunedInserter,
                   access_schedule, get_backend, list_backends,
                   register_backend)
from .cuda_backend import CudaBackend
from .delta import DeltaBuilder, DeltaResult, GraphDelta
from .numpy_backend import NumpyBackend
from .reference import PythonBackend

__all__ = [
    "AUTO_ORDER", "BuildBackend", "BuildStats", "CudaBackend",
    "DeltaBuilder", "DeltaResult", "GraphDelta", "NumpyBackend",
    "PrunedInserter", "PythonBackend",
    "access_schedule", "build_rlc_index", "build_rlc_index_with_stats",
    "get_backend", "list_backends", "register_backend",
]


def build_rlc_index_with_stats(graph: LabeledGraph, k: int,
                               backend: str = "auto", observer=None, **kw
                               ) -> Tuple[RLCIndex, BuildStats]:
    """Build the RLC index with the chosen backend; returns (index, stats).

    ``**kw`` reaches the backend constructor (``use_pr1/2/3`` everywhere;
    ``mode``/``scalar_threshold`` on the batched backends; ``device`` on
    cuda). ``observer``: optional per-phase observer receiving
    per-(hub, direction) phase timings and counter deltas.
    """
    return get_backend(backend, **kw).set_observer(observer).build(graph, k)


def build_rlc_index(graph: LabeledGraph, k: int, backend: str = "auto",
                    **kw) -> RLCIndex:
    return build_rlc_index_with_stats(graph, k, backend=backend, **kw)[0]
