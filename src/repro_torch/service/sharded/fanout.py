"""Scatter/gather batch executor over shard replica sets.

Takes one admitted micro-batch (:class:`repro_torch.service.scheduler.Batch`),
regroups its requests into per-``(shard_s, shard_t)`` sub-batches, runs
each sub-batch on the owning shard's replicas, and gathers the answers
back into admission order:

* **same-shard** ``(i, i)`` — the :class:`BatchExecutor` of one replica
  of shard *i*, exactly the single-host path but over the shard's slice:
  on a CUDA layout the merge-join kernel over the shard's row window
  (``row_base = lo``);
* **cross-shard** ``(i, j)`` — the *scatter* hop: a replica of shard *i*
  gathers the padded out-row digests of the batch's source vertices and
  ships them to shard *j*'s device (``Tensor.to`` when the shards are
  pinned to different devices), where
  :func:`repro_torch.core.device_index.join_rows` joins digests against
  *j*'s local in-rows. Shards without a device layout run the same join
  row by row through :func:`repro_torch.core.rlc_index.merge_join_rows`.

Sub-batches carry only their real requests: torch runs eagerly, so no
shape needs bounding.

**One generation a batch.** A batch runs wholly under the read side of
:class:`GenerationGate`; a hot swap or delta builds every shard's new
state first and publishes it under the write side. So no batch, and no
cross-shard join inside it, ever sees one shard's new rows beside
another's old ones, and no sub-batch needs to be answered off the index
while a swap is under way.

No failure is hidden on a card: where a shard serves from a CUDA layout,
a failed launch, device join or digest copy raises to the caller. On
CPU layouts a failed device join falls back to the numpy join and a
failed sub-batch to the online BiBFS oracle, as the reference does;
under the RPC transport only a lost worker (:class:`WorkerLost`,
:class:`WorkerGone`) takes the BiBFS path.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.device_index import join_rows
from repro_torch.core.rlc_index import merge_join_rows
from repro_torch.obs import NULL_OBS

from ..metrics import LatencyRecorder
from ..scheduler import Batch
from .replica import ShardReplica, ShardReplicaSet
from .router import TwoSidedRouter


class GenerationGate:
    """A readers-writer lock between batches (readers) and the publish
    of a new generation (the writer). A publish waits for the batches in
    flight and holds new ones back until every shard serves the new
    state; a waiting publish goes first, so a steady stream cannot
    starve it. Reads do not nest: a thread that holds the read side
    must not take it again."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writing = False
        self._writers_waiting = 0

    @contextmanager
    def read(self):
        with self._cond:
            while self._writing or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if not self._readers:
                    self._cond.notify_all()

    @contextmanager
    def write(self):
        with self._cond:
            self._writers_waiting += 1
            while self._writing or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writing = True
        try:
            yield
        finally:
            with self._cond:
                self._writing = False
                self._cond.notify_all()


class ScatterGatherExecutor:
    def __init__(self, shards: List[ShardReplicaSet],
                 router: TwoSidedRouter, batch_size: int, obs=None,
                 graph=None, id_to_mr=None):
        self.shards = shards
        self.router = router
        self.batch_size = batch_size
        self.graph = graph          # live graph for the BiBFS degrade path
        self.id_to_mr = id_to_mr
        #: batches read, a hot swap or delta publishes (see the module)
        self.gate = GenerationGate()
        self.recorders = dict(local=LatencyRecorder("local"),
                              remote=LatencyRecorder("remote"))
        self.sub_batches: Dict[Tuple[int, int], int] = {}
        self.remote_joins_device = 0
        self.remote_joins_numpy = 0
        self.degraded = 0       # sub-batches answered by BiBFS
        self.digest_bytes = 0   # cross-shard digest traffic
        self.obs = obs or NULL_OBS
        reg = self.obs.registry
        sub = reg.histogram(
            "rlc_fanout_subbatch_seconds",
            desc="wall time of one per-(shard_s, shard_t) sub-batch",
            unit="s", labelnames=("path",))
        self._m_sub = {p: sub.labels(path=p) for p in ("local", "remote")}
        self._m_digest = reg.counter(
            "rlc_fanout_digest_bytes",
            desc="cross-shard digest traffic", unit="By").labels()
        joins = reg.counter("rlc_fanout_remote_joins",
                            desc="cross-shard digest joins by path",
                            labelnames=("path",))
        self._m_join = {p: joins.labels(path=p)
                        for p in ("device", "numpy")}
        self._m_degraded = reg.counter(
            "rlc_fanout_degraded",
            desc="sub-batches answered by online BiBFS: a failed "
                 "sub-batch off the card, or a lost RPC worker").labels()

    def _degrade_bibfs(self, reqs, idxs) -> np.ndarray:
        """Answer one sub-batch by online bidirectional BFS on the live
        graph. Exact (BiBFS is the oracle), so answers stay bit-identical
        to the index path."""
        from repro_torch.core.baselines import bibfs_rlc
        out = np.zeros(len(idxs), dtype=bool)
        for j, q in enumerate(idxs):
            r = reqs[q]
            out[j] = bibfs_rlc(self.graph, r.s, r.t,
                               self.id_to_mr[r.mr_id])
        self.degraded += 1
        self._m_degraded.inc()
        return out

    # -- transport hooks (overridden by the RPC executor) --------------- #
    def _may_degrade(self, err: Exception, ss: int, st: int) -> bool:
        """Whether a sub-batch that raised ``err`` may be answered by
        BiBFS: never where either shard serves from a CUDA layout."""
        return not (self.shards[ss].on_cuda or self.shards[st].on_cuda)

    def _run_sub(self, ss: int, st: int, s: np.ndarray, t: np.ndarray,
                 mr: np.ndarray, trace=None) -> Tuple[np.ndarray, str]:
        """Execute one ``(shard_s, shard_t)`` sub-batch; returns
        ``(answers, backend_label)``. The in-process transport acquires
        replicas directly; :class:`RpcScatterGatherExecutor` sends the
        same sub-batch to worker processes."""
        if ss == st:
            rep = self.shards[st].acquire()
            ans, backend = rep.executor.execute(s, t, mr, trace=trace)
            return np.asarray(ans, dtype=bool), backend
        return self._cross_shard(ss, st, s, t, mr, trace=trace), "digest"

    # ------------------------------------------------------------------ #
    def execute(self, batch: Batch,
                trace=None) -> Tuple[np.ndarray, List[str]]:
        """Answer every real request of ``batch``, in admission order,
        on one generation of every shard. Returns ``(answers,
        backends)``: the bool answers plus one backend-attribution label
        per request (same order) for the typed
        :class:`~repro_torch.service.answer.Answer` results. ``trace``:
        optional sampled :class:`repro_torch.obs.Trace` — the shard route,
        each sub-batch, and the digest hand-off get spans."""
        reqs = batch.requests
        t_route = time.perf_counter()
        groups: Dict[Tuple[int, int], List[int]] = {}
        for q, r in enumerate(reqs):
            route = self.router.route(r.s, r.t)
            groups.setdefault((route.shard_s, route.home), []).append(q)
        if trace is not None:
            dt = time.perf_counter() - t_route
            trace.add("route", trace.tracer._now() - dt, dt, cat="fanout",
                      n=len(reqs), sub_batches=len(groups))
        answers = np.zeros(len(reqs), dtype=bool)
        backends: List[str] = [""] * len(reqs)
        can_degrade = self.graph is not None and self.id_to_mr is not None
        with self.gate.read():
            for (ss, st), idxs in sorted(groups.items()):
                self.sub_batches[(ss, st)] = \
                    self.sub_batches.get((ss, st), 0) + 1
                s, t, mr = (np.array([getattr(reqs[q], f) for q in idxs],
                                     dtype=np.int32)
                            for f in ("s", "t", "mr_id"))
                t0 = time.perf_counter()
                try:
                    ans, backend = self._run_sub(ss, st, s, t, mr,
                                                 trace=trace)
                except Exception as e:  # noqa: BLE001 — see below
                    # a lost host (or, off the card, a failed sub-batch):
                    # the degrade path still answers exactly
                    if not (can_degrade and self._may_degrade(e, ss, st)):
                        raise
                    ans, backend = self._degrade_bibfs(reqs, idxs), "bibfs"
                path = "local" if ss == st else "remote"
                dt = time.perf_counter() - t0
                self.recorders[path].record(dt, len(idxs))
                self._m_sub[path].observe(dt)
                if trace is not None:
                    trace.add(f"sub[{ss}->{st}]", trace.tracer._now() - dt,
                              dt, cat="fanout", n=len(idxs), path=path)
                answers[np.asarray(idxs)] = ans
                for q in idxs:
                    backends[q] = backend
        return answers, backends

    # ------------------------------------------------------------------ #
    def _cross_shard(self, ss: int, st: int, s: np.ndarray, t: np.ndarray,
                     mr: np.ndarray, trace=None) -> np.ndarray:
        """Digest scatter from shard ``ss`` + merge-join at shard ``st``.

        On CUDA layouts a failed device join raises; on CPU layouts it
        falls back to the numpy join, as the reference does.
        """
        src = self.shards[ss].acquire()
        dst = self.shards[st].acquire()
        if src.device_index is not None and dst.device_index is not None:
            try:
                ans = self._join_device(src, dst, s, t, mr)
                self.remote_joins_device += 1
                self._m_join["device"].inc()
                return ans
            except Exception:  # noqa: BLE001 — re-raised on a card
                if src.executor.on_cuda or dst.executor.on_cuda:
                    raise
        self.remote_joins_numpy += 1
        self._m_join["numpy"].inc()
        return self._join_numpy(src, dst, s, t, mr)

    def _join_device(self, src: ShardReplica, dst: ShardReplica,
                     s, t, mr) -> np.ndarray:
        oh, om = src.device_index.gather_out_rows(s)
        dev = dst.device_index.device
        if oh.device != dev:
            # the one-hop digest ship (a real copy when pinned apart)
            oh, om = oh.to(dev), om.to(dev)
        ih, im = dst.device_index.gather_in_rows(t)
        q = (torch.as_tensor(np.asarray(a, np.int32), device=dev)
             for a in (s, t, mr))
        ans = join_rows(oh, om, ih, im, *q).cpu().numpy()
        # traffic accounting only after the join succeeded (a CPU layout
        # that fails falls back to the numpy join, which counts its own)
        nbytes = 2 * len(s) * int(oh.shape[1]) * 4
        self.digest_bytes += nbytes
        self._m_digest.inc(nbytes)
        return ans

    def _join_numpy(self, src: ShardReplica, dst: ShardReplica,
                    s, t, mr) -> np.ndarray:
        out = np.zeros(len(s), dtype=bool)
        aid = src.frozen.aid
        for q in range(len(s)):
            oh, om = src.frozen.row_out(int(s[q]))     # the digest
            ih, im = dst.frozen.row_in(int(t[q]))
            self.digest_bytes += (oh.nbytes + om.nbytes)
            self._m_digest.inc(oh.nbytes + om.nbytes)
            out[q] = merge_join_rows(oh, om, ih, im, aid,
                                     int(s[q]), int(t[q]), int(mr[q]))
        return out

    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        return dict(
            local=self.recorders["local"].summary(),
            remote=self.recorders["remote"].summary(),
            sub_batches={f"{a}->{b}": c
                         for (a, b), c in sorted(self.sub_batches.items())},
            remote_joins_device=self.remote_joins_device,
            remote_joins_numpy=self.remote_joins_numpy,
            degraded=self.degraded,
            digest_bytes=self.digest_bytes,
        )


class RpcScatterGatherExecutor(ScatterGatherExecutor):
    """The same scatter/gather, but every sub-batch crosses a process
    boundary: same-shard work goes to a shard-host worker over RPC
    (``transport="rpc"``), and the cross-shard digest hand-off gathers
    out-row digests from shard *i*'s worker and ships the *bytes* to
    shard *j*'s worker for the merge join — the wire replacing the
    device copy. Workers answer from the host (numpy).

    Inherits routing, accounting, tracing, the generation gate and the
    BiBFS degrade path; only the transport hooks differ. A
    :class:`WorkerLost` or :class:`WorkerGone` escaping a sub-batch is
    answered by BiBFS — exact answers survive total shard loss; a
    :class:`RemoteError` (the worker's own failure) raises.
    """

    def __init__(self, cluster, router: TwoSidedRouter, batch_size: int,
                 obs=None, graph=None, id_to_mr=None):
        # the base class wants replica sets; the cluster stands in for
        # them — shards=[] keeps every inherited in-process path unused
        super().__init__([], router, batch_size, obs=obs, graph=graph,
                         id_to_mr=id_to_mr)
        self.cluster = cluster
        self.remote_joins_rpc = 0

    def _may_degrade(self, err: Exception, ss: int, st: int) -> bool:
        from ..rpc import WorkerGone, WorkerLost
        return isinstance(err, (WorkerLost, WorkerGone))

    def _run_sub(self, ss: int, st: int, s: np.ndarray, t: np.ndarray,
                 mr: np.ndarray, trace=None) -> Tuple[np.ndarray, str]:
        if ss == st:
            ans, backend = self.cluster.execute(st, s, t, mr)
            return np.asarray(ans, dtype=bool), f"rpc:{backend}"
        # scatter: shard ss's worker gathers out-row digests ...
        digest = self.cluster.gather_digest(ss, s)
        nbytes = int(digest["hub"].nbytes + digest["mr"].nbytes)
        # ... which cross the wire (real bytes) ...
        self.digest_bytes += nbytes
        self._m_digest.inc(nbytes)
        if trace is not None:
            trace.add(f"digest[{ss}->{st}]", trace.tracer._now(), 0.0,
                      cat="fanout", bytes=nbytes)
        # ... and shard st's worker merge-joins them against its in-rows
        ans = self.cluster.join_digest(st, s, t, mr, digest)
        self.remote_joins_rpc += 1
        self._m_join["numpy"].inc()
        return np.asarray(ans, dtype=bool), "rpc:digest"

    def stats(self) -> dict:
        st = super().stats()
        st["remote_joins_rpc"] = self.remote_joins_rpc
        st["rpc"] = self.cluster.stats()
        return st
