"""Dense boolean-semiring engine on the card (the JAX package's
``repro/core/dense.py``, DESIGN.md §3).

The paper's kernel-BFS guided by ``L^+`` is a BFS over the product
automaton ``V x {0..m-1}``; batching all sources turns the whole index
computation into boolean matrix-matrix products. This module provides:

* ``mr_step_matrix``   — ``M_L = A[l1] (x) ... (x) A[lm]`` (OR-AND chain);
* ``plus_closure``     — ``M^+`` by log-doubling (``h <= |V|`` repeats);
* ``DenseEngine``      — ETC-equivalent all-pairs ``S^k`` oracle on device;
* ``device_reach``     — the same all-MR reach kept on the device;
* ``build_condensed_device`` — hub-batched pruned 2-hop labeling: the
  paper's Algorithm 2 re-derived as masked matmuls (PR2 is the aid mask,
  PR1 a vectorized coverage query, one matmul per hub batch; batch size 1
  reproduces the sequential pruning schedule).

Boolean values ride as 0/1. With no ``matmul`` given, the engine keeps
its adjacency and each MR's closure in bf16 (exact for 0/1, half the bytes of
float32, and the operand type the semiring kernels read without a
staging pass), and the products run through the hand-written kernels of
:mod:`repro_torch.kernels.bool_semiring` on a CUDA device (the plain
versions on the CPU): the step chain through ``bool_matmul`` and each
doubling step through the fused ``closure_step``, which computes the
reference's ``max(R, matmul(R, R))`` in one launch. A caller-given
``matmul`` keeps float32 and the reference's form. The engine pads the
adjacency once to a multiple of the kernel tile (zero rows and columns
add no paths) and takes the doubling count from the unpadded ``n``, as
the reference does. The condensed build's hub loop splits by device. On
a CUDA device its entry stacks are bit-packed ``(C, n, W)`` int32 words
and each hub batch is two launches of the hand-written coverage kernel
of :mod:`repro_torch.kernels.hub_cover` (products, PR1/PR2 masks and new
bits in one pass over a stack, one bit an entry), with the reach kept as
uploaded bytes beside a transposed copy. On the CPU the stacks stay
float32 and :func:`_hub_batch_step` runs the coverage products as
``torch.bmm``, the form the JAX package leaves to XLA, and the plain
ground truth of the kernel's path. All float products sum 0/1 values in
float32, exact whether or not TF32 is on; PyTorch's default (TF32 off)
is assumed and not changed here.

Both reaches come from one loop, :func:`_all_mr_reach`: it writes each
MR's closure, cropped and thresholded, into its plane of one ``(C, n,
n)`` bool stack on the device and frees it before the next MR starts, so
the device holds the stack, the adjacency and one MR's buffers at a
time. :meth:`DenseEngine.build` downloads that stack as its numpy
``reach``, as in the JAX package; :func:`device_reach` leaves it on the
device, and ``build_condensed_device`` takes it there with no copy
through the host.

Entry points take ``device="cuda"`` by default and raise where no card
is present.

Both builds name their phases on ``torch.profiler``'s timeline while it
records (:func:`repro_torch.obs.region`: ``repro_torch.dense.adjacency``,
``.reach``, ``.download``; ``repro_torch.condensed.prepare``,
``.hub_loop``, then per side ``.download`` and ``.index_fill``);
:func:`device_reach` opens the first two. The condensed build counts its
runs, the entries and ``(vertex, hub)`` keys it hands to the ``RLCIndex``
and the bytes it copies between host and device in
:func:`repro_torch.obs.process_obs`'s registry
(:class:`~repro_torch.obs.BuildCounters`, backend ``device_condensed``).
Neither adds a wait or a device allocation.
"""
from __future__ import annotations

import gc
import math
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.devices import resolve_device
from repro_torch.core.graph import LabeledGraph
from repro_torch.core.minimum_repeat import (LabelSeq, enumerate_mrs,
                                             mr_id_space)
from repro_torch.core.rlc_index import RLCIndex
from repro_torch.kernels import bool_semiring, hub_cover
from repro_torch.kernels.ref import bool_matmul_ref
from repro_torch.obs import process_obs, region

MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


#: OR-AND semiring product for 0/1 float arrays (reference path)
bool_matmul = bool_matmul_ref


def _n_iters(n: int) -> int:
    return max(1, math.ceil(math.log2(max(n, 2))))


def mr_step_matrix(A: torch.Tensor, mr: Sequence[int],
                   matmul: Optional[MatMul] = None) -> torch.Tensor:
    """``M_L[u, v] = 1`` iff a path u->v spells exactly ``L``. ``A`` is the
    (|L|, n, n) label-sliced adjacency stack; ``matmul`` defaults to the
    ``bool_matmul`` kernel."""
    matmul = matmul or bool_semiring.bool_matmul
    M = A[mr[0]]
    for lab in mr[1:]:
        M = matmul(M, A[lab])
    return M


def plus_closure(M: torch.Tensor, n_iters: Optional[int] = None,
                 matmul: Optional[MatMul] = None) -> torch.Tensor:
    """``M^+ = M | M^2 | ...`` via log-doubling: R_{i+1} = R_i | R_i R_i
    covers powers 1..2^(i+1); minimal repeat count is <= |V|.

    With no ``matmul``, each step is one fused ``closure_step`` launch
    into the other of two buffers (never into ``M``, which may be a view
    of the adjacency)."""
    iters = n_iters if n_iters is not None else _n_iters(M.shape[-1])
    R = M
    if matmul is not None:
        for _ in range(iters):
            R = torch.maximum(R, matmul(R, R))
        return R
    bufs = (torch.empty_like(M), torch.empty_like(M))
    for i in range(iters):
        R = bool_semiring.closure_step(R, out=bufs[i % 2])
    return R


def _all_mr_reach(A: torch.Tensor, mrs: Tuple[LabelSeq, ...], n: int,
                  matmul: Optional[MatMul] = None) -> torch.Tensor:
    """Contiguous ``(C, n, n)`` bool stack of ``R_L`` for every MR, on
    ``A``'s device, over the padded adjacency ``A`` with the doubling
    count of the unpadded ``n``. Each MR's closure is cropped and
    thresholded into its plane, then freed before the next MR starts."""
    R = torch.empty((len(mrs), n, n), dtype=torch.bool, device=A.device)
    for c, mr in enumerate(mrs):
        closure = plus_closure(mr_step_matrix(A, mr, matmul),
                               n_iters=_n_iters(n), matmul=matmul)
        torch.gt(closure[:n, :n], 0, out=R[c])
        del closure
    return R


def label_adjacency(graph: LabeledGraph, device,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dense (|L|, n_pad, n_pad) 0/1 stack of ``dtype``: ``graph.
    label_adjacency`` padded with zero rows and columns to a multiple of
    the kernel tile, built on ``device`` from the edge list (no host copy
    of the |L| n^2 values)."""
    n = graph.num_vertices
    n_pad = -(-max(n, 1) // bool_semiring.TILE) * bool_semiring.TILE
    A = torch.zeros((graph.num_labels, n_pad, n_pad), dtype=dtype,
                    device=device)
    e = torch.from_numpy(np.asarray(graph.edges, np.int64)).to(device)
    if len(e):
        A[e[:, 1], e[:, 0], e[:, 2]] = 1
    return A


@dataclass
class DenseEngine:
    """All-pairs ``S^k`` on device — the analog of the paper's ETC."""

    graph: LabeledGraph
    k: int
    mrs: Tuple[LabelSeq, ...]
    mr_ids: Dict[LabelSeq, int]
    #: (C, n, n) bool, reach[c, u, v] = u ~~mr_c^+~~> v: the numpy array
    #: of :meth:`build`, or the tensor handed to ``build_condensed_device``
    reach: Union[np.ndarray, torch.Tensor]

    @staticmethod
    def build(graph: LabeledGraph, k: int,
              matmul: Optional[MatMul] = None,
              device="cuda") -> "DenseEngine":
        dev = resolve_device(device)
        n = graph.num_vertices
        mrs = enumerate_mrs(graph.num_labels, k)
        dtype = torch.float32 if matmul is not None else torch.bfloat16
        with region("dense.adjacency"):
            A = label_adjacency(graph, dev, dtype)
        with region("dense.reach"):
            R = _all_mr_reach(A, mrs, n, matmul)
        del A
        with region("dense.download"):
            reach = R.cpu().numpy()
        return DenseEngine(graph, k, mrs, mr_id_space(graph.num_labels, k),
                           reach)

    def query(self, s: int, t: int, L: Sequence[int]) -> bool:
        c = self.mr_ids.get(tuple(L))
        if c is None:
            return False
        return bool(self.reach[c, s, t])

    def s_k(self, u: int, v: int) -> set:
        return {self.mrs[c] for c in range(len(self.mrs))
                if self.reach[c, u, v]}

    def num_true_pairs(self) -> int:
        return int(self.reach.sum())


def device_reach(graph: LabeledGraph, k: int, device="cuda"
                 ) -> Tuple[Tuple[LabelSeq, ...], torch.Tensor]:
    """``(mrs, R)``: the reach of :meth:`DenseEngine.build` as the
    contiguous ``(C, n, n)`` bool tensor of :func:`_all_mr_reach`, left on
    ``device``."""
    dev = resolve_device(device)
    mrs = enumerate_mrs(graph.num_labels, k)
    with region("dense.adjacency"):
        A = label_adjacency(graph, dev, torch.bfloat16)
    with region("dense.reach"):
        R = _all_mr_reach(A, mrs, graph.num_vertices)
    return mrs, R


# ------------------------------------------------------------------ #
# Hub-batched condensed 2-hop build (device Algorithm 2)
# ------------------------------------------------------------------ #
def _hub_batch_step(OUT: torch.Tensor, IN: torch.Tensor, R: torch.Tensor,
                    aid: torch.Tensor, hubs: torch.Tensor) -> None:
    """Add entries for one batch of hubs with PR1/PR2 masks, updating
    ``OUT`` and ``IN`` in place (the reference donates them to jit).

    OUT[c, y, x] = 1 iff (x, mr_c) in L_out(y);  IN[c, y, x] similarly.
    For hub h (column/row slices of R):
      backward (L_out additions at every y reaching h):
        cand = R[c, :, h] & aid(h) <= aid(y) & ~Query(y, h, mr_c)
      forward (L_in additions at every y reached from h): symmetric.
    Query(s, t, c) = OUT[c,s,t] | IN[c,t,s] | OR_x OUT[c,s,x] & IN[c,t,x].
    """
    dtypef = OUT.dtype
    aid_h = aid[hubs]                                    # (B,)
    pr2 = (aid_h[None, :] <= aid[:, None]).to(dtypef)    # (n, B) keep-mask

    # ---- backward: entries (h, c) at L_out(y) ----
    reach_to_h = R[:, :, hubs]                           # (C, n, B)
    IN_h = IN[:, hubs, :]                                # (C, B, n)
    # Case-1 coverage: OR_x OUT[c,y,x] & IN[c,h,x]
    cov1 = torch.bmm(OUT, IN_h.transpose(1, 2)) > 0
    cov2 = OUT[:, :, hubs] > 0                           # direct (h,c) there
    cov3 = IN_h.transpose(1, 2) > 0                      # (y, c) in L_in(h)?
    covered = cov1 | cov2 | cov3
    cand_out = reach_to_h * pr2[None] * (~covered).to(dtypef)
    OUT[:, :, hubs] = torch.maximum(OUT[:, :, hubs], cand_out)

    # ---- forward: entries (h, c) at L_in(y) ----
    reach_from_h = R[:, hubs, :].transpose(1, 2)         # (C, n, B)
    OUT_h = OUT[:, hubs, :]                              # (C, B, n) updated!
    cov1f = torch.bmm(IN, OUT_h.transpose(1, 2)) > 0
    cov2f = IN[:, :, hubs] > 0
    cov3f = OUT_h.transpose(1, 2) > 0                    # (t, c) in L_out(h)
    coveredf = cov1f | cov2f | cov3f
    cand_in = reach_from_h * pr2[None] * (~coveredf).to(dtypef)
    IN[:, :, hubs] = torch.maximum(IN[:, :, hubs], cand_in)


@contextmanager
def _collector_paused():
    """Python's cyclic garbage collector off inside the block, and on again
    after it where it was on before. The index fill makes a set or dict
    for nearly every entry, millions at a time, and no reference cycle;
    with the collector on, its passes over the growing index can take
    longer than the fill itself."""
    was_on = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_on:
            gc.enable()


def _entry_pairs(words: torch.Tensor
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The ``(vertex, hub)`` cells of a packed entry stack that hold an
    entry, on the host: int32 vertices and hubs ``(P,)`` in row-major order
    (by vertex, hubs ascending) and their int64 MR masks ``(P, M)``
    (:func:`repro_torch.kernels.hub_cover.entry_masks`). Only those cells
    leave the device, ``8 + 8 M`` bytes each."""
    masks = hub_cover.entry_masks(words)
    ys, xs = torch.nonzero(masks.ne(0).any(-1), as_tuple=True)
    return (ys.int().cpu().numpy(), xs.int().cpu().numpy(),
            masks[ys, xs].cpu().numpy())


def build_condensed_device(graph: LabeledGraph, k: int,
                           hub_batch: int = 1,
                           matmul: Optional[MatMul] = None,
                           reach: Optional[Union[np.ndarray,
                                                 torch.Tensor]] = None,
                           device="cuda") -> Tuple[RLCIndex, DenseEngine]:
    """Device-side condensed RLC index build (see module docstring).

    ``reach`` skips the engine build: a :attr:`DenseEngine.reach`, which
    the build copies to the device, or the bool tensor of
    :func:`device_reach` on the build's device, which it reads where it
    lies (the returned engine then holds that tensor). Only the entries
    leave the device: on the card the ``(vertex, hub)`` cells that hold
    one, each with its MRs as one mask (:func:`_entry_pairs`), and each
    side's rows are filled by :meth:`RLCIndex.fill_rows`; on the CPU the
    non-zero ``(c, y, x)`` triples, one ``add_out`` / ``add_in`` each, the
    plain ground truth of the card's fill."""
    dev = resolve_device(device)
    if hub_batch < 1:
        raise ValueError(f"hub_batch must be >= 1, not {hub_batch}")
    eng = (DenseEngine(graph, k, enumerate_mrs(graph.num_labels, k),
                       mr_id_space(graph.num_labels, k), reach)
           if reach is not None
           else DenseEngine.build(graph, k, matmul, device=dev))
    n, C = graph.num_vertices, len(eng.mrs)
    if tuple(eng.reach.shape) != (C, n, n):
        raise ValueError(f"reach must be ({C}, {n}, {n})")
    on_device = isinstance(eng.reach, torch.Tensor)
    if on_device and (eng.reach.dtype != torch.bool
                      or not eng.reach.is_contiguous()
                      or eng.reach.device.type != dev.type
                      or dev.index not in (None, eng.reach.device.index)):
        raise ValueError(f"a reach tensor must be a contiguous bool tensor "
                         f"on {dev}")
    ctr = process_obs().build_counters("device_condensed")
    packed = dev.type != "cpu"
    with region("condensed.prepare"):
        aid = graph.access_ids()
        if on_device:
            R = eng.reach
        else:
            R = torch.from_numpy(np.ascontiguousarray(eng.reach)).to(dev)
            ctr.host_bytes_up.inc(R.nbytes)
        aid_t = torch.from_numpy(aid.astype(np.int64)).to(dev)
        order = torch.from_numpy(graph.access_order().astype(np.int64)).to(
            dev)
        if packed:
            OUT, IN = (hub_cover.zero_stack(C, n, dev) for _ in range(2))
            RT = R.transpose(1, 2).contiguous()
        else:
            R = R.float()
            OUT = torch.zeros((C, n, n), dtype=torch.float32, device=dev)
            IN = torch.zeros((C, n, n), dtype=torch.float32, device=dev)
    with region("condensed.hub_loop"):
        if packed:
            hub_cover.hub_loop(OUT, IN, R, RT, aid_t, order, hub_batch)
            del RT
        else:
            for i in range(0, n, hub_batch):
                _hub_batch_step(OUT, IN, R, aid_t, order[i:i + hub_batch])
    del R
    with region("condensed.index_fill"):
        idx = RLCIndex(n, k, aid)
    with _collector_paused():
        for side, entries, maps, add in (("out", OUT, idx.l_out, idx.add_out),
                                         ("in", IN, idx.l_in, idx.add_in)):
            with region("condensed.download"):
                got = _entry_pairs(entries) if packed else tuple(
                    t.cpu().numpy() for t in torch.nonzero(entries > 0,
                                                           as_tuple=True))
            ctr.host_bytes_down.inc(sum(a.nbytes for a in got))
            with region("condensed.index_fill"):
                if packed:
                    added, pairs = idx.fill_rows(side, *got, eng.mrs)
                else:
                    cs, ys, xs = got
                    for c, y, x in zip(cs.tolist(), ys.tolist(),
                                       xs.tolist()):
                        add(y, x, eng.mrs[c])
                    added, pairs = len(cs), sum(map(len, maps))
            ctr.entries[side].inc(added)
            ctr.pairs[side].inc(pairs)
    ctr.runs.inc()
    return idx, eng
