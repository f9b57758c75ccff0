"""Carry index state across from the JAX package (plain numpy in, port out).

Both packages keep their host-side index state in numpy arrays and python
dicts, so an index built by one can be served by the other: pass the
fields of a ``repro`` index (``FrozenRLCIndex`` arrays, or ``RLCIndex``
entry maps) and get the port's object holding the same entries. Tests use
this to put the *same* index behind both packages' device layouts and
services, and the *same* dense reachability stack behind both packages'
condensed builds.

For the model substrate, :func:`lm_params_from_jax` takes ``repro``'s
parameter tree (as numpy arrays) and gives the port's, so both packages
compute with the same weights; :func:`train_state_from_jax` carries a
whole ``repro`` ``TrainState`` (params, both moments, step), so both
start training from one state.
"""
from __future__ import annotations

from typing import Any, Dict, List, Set

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.dense import DenseEngine
from repro_torch.core.devices import resolve_device
from repro_torch.core.graph import LabeledGraph
from repro_torch.core.minimum_repeat import (LabelSeq, enumerate_mrs,
                                             mr_id_space)
from repro_torch.core.rlc_index import FrozenRLCIndex, RLCIndex
from repro_torch.models import init_model
from repro_torch.models.builder import tree_from_leaves, tree_leaves
from repro_torch.train.train_loop import TrainState


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


def _leaf_tensor(arr, device: torch.device) -> torch.Tensor:
    """One leaf (numpy or JAX), bit for bit and in its own dtype. numpy has
    no bfloat16: such leaves arrive as ``ml_dtypes.bfloat16`` and cross
    as uint16."""
    arr = np.array(arr, order="C")     # a copy; keeps a 0-d leaf 0-d
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def lm_params_from_jax(tree: Any, cfg: ArchConfig, device="cuda") -> Dict:
    """The port's parameter tree for ``cfg`` holding ``repro``'s values.

    ``tree`` is ``repro.models.init_model``'s params with numpy (or JAX)
    leaves. Its paths and shapes must be
    the port's (``init_model(cfg, abstract=True)``), else ``ValueError``;
    each leaf keeps its dtype."""
    want = dict(tree_leaves(init_model(cfg, abstract=True)[0]))
    got = dict(tree_leaves(tree))
    if set(got) != set(want):
        fmt = lambda ps: sorted("/".join(p) for p in ps)  # noqa: E731
        raise ValueError(f"tree paths differ: missing "
                         f"{fmt(set(want) - set(got))}, extra "
                         f"{fmt(set(got) - set(want))}")
    dev = resolve_device(device)
    for path, arr in got.items():
        if tuple(np.shape(arr)) != tuple(want[path].shape):
            raise ValueError(f"{'/'.join(path)}: shape {np.shape(arr)}, "
                             f"the port has {tuple(want[path].shape)}")
    return tree_from_leaves((path, _leaf_tensor(arr, dev))
                            for path, arr in got.items())


def train_state_from_jax(state: Any, cfg: ArchConfig, device="cuda"
                         ) -> TrainState:
    """The port's :class:`~repro_torch.train.TrainState` holding a
    ``repro`` ``TrainState``'s values bit for bit: its params and both
    moments (each leaf in its own dtype, bfloat16 included) and its two
    step counters. Leaves may be JAX or numpy arrays."""
    dev = resolve_device(device)
    opt = state.opt
    return TrainState(
        lm_params_from_jax(state.params, cfg, dev),
        {"m": lm_params_from_jax(opt["m"], cfg, dev),
         "v": lm_params_from_jax(opt["v"], cfg, dev),
         "step": _leaf_tensor(opt["step"], dev)},
        _leaf_tensor(state.step, dev))
