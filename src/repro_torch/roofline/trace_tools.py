"""Op-trace profiling tools for the dry run (the counterpart of
``repro.roofline.hlo_tools``: where the reference reads XLA's optimized
per-device HLO, the port records the ops one rank runs).

:class:`StepTrace` is a ``TorchDispatchMode`` that records every op a
step issues on THIS rank's tensors: its local output shapes and dtypes,
its flops (``torch.utils.flop_counter``'s formulas, so a step traced on
one rank counts what ``FlopCounterMode`` counts there), the bytes it
reads and writes, the Python function it came from (``module``), and the
live bytes it leaves behind. A DTensor op is not recorded itself: the
mode hands it to DTensor (``NotImplemented``), and records the local ops
and the collectives (``_c10d_functional`` ops, ``_dtensor``'s
all-to-all) that DTensor issues for it. ``FlopCounterMode`` over
DTensors counts the logical op instead — a ``(4096, 4096) @ (4096,
16384)`` product on a ``(16, 16)`` mesh counts its global 2*M*K*N, not
one device's share.

Ops that DTensor runs to propagate global shapes (the global op on fake
tensors, once a signature) are skipped.

The port loops over its layers, so every op is seen once and
:func:`trace_totals` multiplies nothing (the reference's
``scan_aware_totals`` multiplies while-loop bodies by their trip
counts). The recompute under ``torch.utils.checkpoint`` runs in the
backward and is counted, as the reference's HLO counts it.
"""
from __future__ import annotations

import functools
import os
import sys
import weakref
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from .analysis import HW, KINDS

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_HERE = os.path.dirname(os.path.abspath(__file__))
_PROPAGATION = os.path.join("distributed", "tensor", "_sharding_prop.py")

# funcol op name -> the reference's collective kind
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}
# ops that read only the addressed region of their source
_GATHERS = {"index", "gather", "index_select", "embedding", "take_along_dim"}
# ops that write only the addressed region of their destination
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "scatter",
             "scatter_", "scatter_add", "scatter_add_", "index_add",
             "index_add_"}
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "wait_tensor",
               "detach", "lift_fresh", "alias"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class OpRecord:
    op: str                          # e.g. "aten.mm.default"
    module: str                      # "models/attention.py:_attend_mha"
    outs: List[Tuple[str, Tuple[int, ...]]]
    flops: float
    bytes: int                       # HBM read + write estimate
    out_bytes: int
    coll: Optional[Tuple[str, int, int, bool]] = None


class StepTrace(TorchDispatchMode):
    """Records the ops of one step on this rank. ``peak_bytes`` is the
    most bytes that outputs of recorded ops held at once (storages, each
    counted once, freed when the last tensor over it dies); tensors made
    before the trace (the state, the batch) are not in it. A group over
    ranks of more than one node (``HW.gpus_per_node`` ranks each) is
    priced at the network's rate."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._refs: Dict[int, int] = {}
        self._sizes: Dict[int, int] = {}
        self._groups: Dict[str, Tuple[int, bool]] = {}

    # -------------------------------------------------------------- #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented          # DTensor issues the local ops
        tensors = [a for a in flat if isinstance(a, torch.Tensor)]
        module = _module()
        if module is None:                 # DTensor's shape propagation
            return func(*args, **kwargs)
        if func.namespace == "aten" and \
                func._overloadpacket not in flop_registry:
            with self:                     # as FlopCounterMode does
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self._record(func, args, kwargs, tensors, out, module)
        return out

    def _record(self, func, args, kwargs, ins, out, module):
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        if not outs:
            return
        packet = func._overloadpacket
        name = packet.__name__
        fn = flop_registry.get(packet)
        flops = float(fn(*args, **kwargs, out_val=out)) if fn else 0.0
        out_bytes = sum(_nbytes(o) for o in outs)
        coll = None
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d_functional", "_dtensor") and \
                name in _COLLECTIVES:
            g, spans = self._group(args, kwargs)
            coll = (_COLLECTIVES[name], out_bytes, g, spans)
        if func.is_view or name in _NO_TRAFFIC:
            traffic = 0
        elif name in _GATHERS:
            traffic = 2 * out_bytes
        elif name in _SCATTERS:
            src = [t for t in ins[1:] if t.is_floating_point()] or ins[1:]
            traffic = 2 * max((_nbytes(t) for t in src), default=0)
        else:
            traffic = sum(_nbytes(t) for t in ins) + out_bytes
        self.ops.append(OpRecord(
            f"{ns}.{name}.{func._overloadname}", module,
            [(str(o.dtype).replace("torch.", ""), tuple(o.shape))
             for o in outs], flops, traffic, out_bytes, coll))
        self._track(ins, outs, coll is not None)

    def _group(self, args, kwargs) -> Tuple[int, bool]:
        """(size, spans nodes) of the group named in a funcol op."""
        names = [a for a in tree_flatten((args, kwargs))[0]
                 if isinstance(a, str)]
        key = names[-1] if names else ""
        if key not in self._groups:
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            ranks = dist.get_process_group_ranks(
                _resolve_process_group(key))
            nodes = {r // HW.gpus_per_node for r in ranks}
            self._groups[key] = (len(ranks), len(nodes) > 1)
        return self._groups[key]

    # -------------------------------------------------------------- #
    def _track(self, ins, outs, collective=False):
        known_in = {t.untyped_storage()._cdata for t in ins}
        for o in outs:
            key = o.untyped_storage()._cdata
            if key not in self._refs:
                if key in known_in:       # an input from before the trace
                    continue
                # a collective's fake kernel may narrow a gathered
                # buffer; the real one allocates its output alone
                size = (_nbytes(o) if collective
                        else o.untyped_storage().nbytes())
                self._refs[key], self._sizes[key] = 0, size
                self.live_bytes += size
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            self._refs[key] += 1
            weakref.finalize(o, self._release, key)

    def _release(self, key):
        self._refs[key] -= 1
        if self._refs[key] == 0:
            del self._refs[key]
            self.live_bytes -= self._sizes.pop(key)

    @property
    def collectives(self) -> List[Tuple[str, int, int, bool]]:
        return [r.coll for r in self.ops if r.coll is not None]


@functools.lru_cache(maxsize=None)
def _rel(path: str) -> str:
    return os.path.relpath(path, _PKG)


def _module() -> Optional[str]:
    """The innermost function of the package that issued the op
    (``models/attention.py:_attend_mha``); ``backward:<node>`` for a
    backward op outside any of them; None inside DTensor's propagation of
    global shapes, which runs the global op on fake tensors once a
    signature and is no work of this rank."""
    f = sys._getframe(1)
    while f is not None:
        path = f.f_code.co_filename
        if path.endswith(_PROPAGATION):
            return None
        if path.startswith(_PKG) and not path.startswith(_HERE):
            return f"{_rel(path)}:{f.f_code.co_name}"
        f = f.f_back
    node = torch._C._current_autograd_node()
    return f"backward:{node.name()}" if node is not None else "<top>"


# ------------------------------------------------------------------ #
# Views of a trace (the reference's histograms over HLO text)
# ------------------------------------------------------------------ #
def dot_flops_histogram(trace: StepTrace, top: int = 25
                        ) -> List[Tuple[str, float, int]]:
    """[(module, flops, count)] for ops with flops, descending."""
    hist: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for r in trace.ops:
        if r.flops:
            hist[r.module][0] += r.flops
            hist[r.module][1] += 1
    rows = [(k, v[0], int(v[1])) for k, v in hist.items()]
    rows.sort(key=lambda r: -r[1])
    return rows[:top]


def buffer_histogram(trace: StepTrace, top: int = 25,
                     min_bytes: int = 1 << 20
                     ) -> List[Tuple[str, int, str]]:
    """Largest op outputs: [(module xcount, bytes, 'dtype[shape]')]."""
    agg: Dict[Tuple[str, str], List[int]] = defaultdict(lambda: [0, 0])
    for r in trace.ops:
        if r.out_bytes < min_bytes:
            continue
        desc = ", ".join(f"{d}[{','.join(map(str, s))}]"
                         for d, s in r.outs[:2])
        agg[(r.module, desc)][0] += r.out_bytes
        agg[(r.module, desc)][1] += 1
    out = [(f"{k} x{c[1]}", c[0], d) for (k, d), c in agg.items()]
    out.sort(key=lambda r: -r[1])
    return out[:top]


def op_bytes_by_kind(trace: StepTrace) -> Dict[str, int]:
    """Total output bytes per op (coarse memory-traffic view)."""
    out: Dict[str, int] = defaultdict(int)
    for r in trace.ops:
        out[r.op] += r.out_bytes
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def trace_totals(trace: StepTrace) -> Dict[str, float]:
    """{"flops", "coll_<kind>", "coll_total", "coll_network",
    "hbm_bytes_est", "hbm_bytes_upper"} of one traced step, per device.

    ``hbm_bytes_est``: eager torch runs each op as its own kernel, so
    every op that is not a view reads its inputs and writes its outputs
    once (gathers and scatters only the addressed rows);
    ``hbm_bytes_upper`` is twice the output bytes, as the reference's.
    ``coll_*`` are ring wire bytes (:func:`.analysis.ring_wire_bytes`)."""
    from .analysis import collective_bytes_from_trace
    coll = collective_bytes_from_trace(trace.collectives)
    out = {"flops": sum(r.flops for r in trace.ops),
           "hbm_bytes_est": float(sum(r.bytes for r in trace.ops)),
           "hbm_bytes_upper": 2.0 * sum(r.out_bytes for r in trace.ops)}
    for k in KINDS:
        if k in coll:
            out[f"coll_{k}"] = coll[k]
    out["coll_total"] = coll["total"]
    out["coll_network"] = coll["network"]
    return out
