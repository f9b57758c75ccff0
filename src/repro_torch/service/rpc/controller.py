"""The controller side of multi-process shard serving: elastic worker
membership, staged swaps, and the RPC call plane.

:class:`RpcShardCluster` owns one worker *process* per (shard, replica)
— spawned with the ``spawn`` start method, so the topology works under
any interpreter/platform and no worker inherits this process's CUDA
context — and a loopback listener the workers dial back to. Each worker
is shipped only its shard's frozen slice and answers from the host
(:mod:`repro_torch.service.rpc.worker`); the cluster keeps the per-shard
slice payloads so a worker that *rejoins* after leaving (crash, drain,
scale-up) can be re-initialized at the current generation without
touching the serving path.

Membership is elastic in the :mod:`repro_torch.ft.elastic` sense: workers
join/leave at any time, each change bumps a membership epoch, routing
simply skips dead members, and the per-worker
``StragglerMonitor`` from that module watches round-trip times so a
slow host is visible before it is gone. ``hot_swap`` / ``apply_delta``
are **staged, then committed**: every worker of every touched shard
builds the new generation beside the one it serves (:meth:`stage`), and
:meth:`commit` then switches them all while the fan-out's generation
gate holds batches back, so a digest gathered on one shard is never
joined against another shard's rows of a different generation.

Every call is accounted in the ``rlc_rpc_*`` metric family: bytes on
the wire by direction/method, round-trip latency, outcomes, retries
after a worker died mid-call, and membership events.
"""
from __future__ import annotations

import itertools
import multiprocessing
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.rlc_index import FrozenRLCIndex
from repro_torch.ft.elastic import StragglerMonitor
from repro_torch.obs import NULL_OBS

from .transport import (RemoteError, RpcEndpoint, RpcError, RpcListener,
                        WorkerGone)
from .worker import worker_main

__all__ = ["RpcShardCluster", "RpcWorkerHandle", "WorkerLost"]

RPC_METHODS = ("init", "execute", "gather_digest", "join_digest", "swap",
               "commit", "stats", "ping", "shutdown")


class WorkerLost(RpcError):
    """No live worker can serve the shard (every replica is gone and the
    caller has no degrade path)."""


class RpcWorkerHandle:
    """One worker process + its connection, as the cluster sees it."""

    def __init__(self, shard_id: int, replica_id: int, worker_id: str,
                 proc, ep: RpcEndpoint):
        self.shard_id = shard_id
        self.replica_id = replica_id
        self.worker_id = worker_id
        self.proc = proc
        self.ep = ep
        self.generation = -1
        self.alive = True
        self.pid = proc.pid if proc is not None else None
        self.straggler = None       # ft.elastic.StragglerMonitor
        self.calls = 0

    def __repr__(self) -> str:
        state = "alive" if self.alive else "gone"
        return (f"RpcWorkerHandle({self.worker_id}, gen={self.generation}, "
                f"{state})")


def _slice_payload(frozen_slice: FrozenRLCIndex, lo: int, hi: int,
                   generation: int, id_to_mr) -> dict:
    """The wire form of one shard's serving state. ``aid``/``indptr``
    are global-length (the slice keeps global vertex ids) — O(n) per
    worker, the price of id-stable routing; entry arrays are the
    shard's span only."""
    return dict(
        generation=int(generation), lo=int(lo), hi=int(hi),
        num_vertices=int(frozen_slice.num_vertices),
        k=int(frozen_slice.k),
        aid=np.asarray(frozen_slice.aid, dtype=np.int64),
        out_indptr=np.asarray(frozen_slice.out_indptr, dtype=np.int64),
        out_hub=np.asarray(frozen_slice.out_hub, dtype=np.int32),
        out_mr=np.asarray(frozen_slice.out_mr, dtype=np.int32),
        in_indptr=np.asarray(frozen_slice.in_indptr, dtype=np.int64),
        in_hub=np.asarray(frozen_slice.in_hub, dtype=np.int32),
        in_mr=np.asarray(frozen_slice.in_mr, dtype=np.int32),
        id_to_mr=[list(mr) for mr in id_to_mr])


class RpcShardCluster:
    def __init__(self, ranges: List[Tuple[int, int]], num_replicas: int,
                 id_to_mr, obs=None, start_timeout_s: float = 60.0,
                 call_timeout_s: Optional[float] = 120.0,
                 ctx_method: str = "spawn"):
        self.ranges = [(int(lo), int(hi)) for lo, hi in ranges]
        self.num_shards = len(self.ranges)
        self.num_replicas = int(num_replicas)
        self.id_to_mr = list(id_to_mr)
        self.start_timeout_s = start_timeout_s
        self.call_timeout_s = call_timeout_s
        self._ctx = multiprocessing.get_context(ctx_method)
        self._listener: Optional[RpcListener] = None
        #: shard -> replica handles (dead ones stay listed until rejoin
        #: replaces them — membership history is part of the state)
        self.handles: Dict[int, List[RpcWorkerHandle]] = {
            sid: [] for sid in range(self.num_shards)}
        #: shard -> current slice payload (what a rejoining worker gets)
        self._payloads: Dict[int, dict] = {}
        #: shard -> payload staged by :meth:`stage`, not yet committed
        self._staged: Dict[int, dict] = {}
        self._rr = {sid: itertools.count()
                    for sid in range(self.num_shards)}
        self._lock = threading.RLock()
        self.membership_epoch = 0
        self.generation = 0
        self.started = False
        self.closed = False
        self.joins = 0
        self.leaves = 0
        self.rejoins = 0
        self.retries = 0
        self.obs = obs or NULL_OBS
        reg = self.obs.registry
        self._m_bytes = reg.counter(
            "rlc_rpc_bytes", desc="RPC bytes on the wire",
            unit="By", labelnames=("direction", "method"))
        self._m_rtt = reg.histogram(
            "rlc_rpc_roundtrip_seconds",
            desc="RPC request round-trip wall time", unit="s",
            labelnames=("method",))
        self._m_req = reg.counter(
            "rlc_rpc_requests", desc="RPC requests by outcome",
            labelnames=("method", "outcome"))
        self._m_retry = reg.counter(
            "rlc_rpc_retries",
            desc="calls retried on a sibling replica after a worker "
                 "died mid-request", labelnames=("method",))
        self._m_members = reg.counter(
            "rlc_rpc_membership", desc="worker membership events",
            labelnames=("event",))
        self._m_workers = reg.gauge(
            "rlc_rpc_workers", desc="live worker processes")

    # -- membership ------------------------------------------------------ #
    def start(self, frozen: FrozenRLCIndex, generation: int = 0) -> None:
        """Spawn one worker per (shard, replica), ship every shard its
        slice, and wait for the fleet to come up."""
        if self.started:
            return
        self.generation = int(generation)
        self._listener = RpcListener()
        for sid, (lo, hi) in enumerate(self.ranges):
            self._payloads[sid] = _slice_payload(
                frozen.slice_rows(lo, hi), lo, hi, self.generation,
                self.id_to_mr)
        pending: Dict[str, Tuple[int, int, object]] = {}
        for sid in range(self.num_shards):
            for rid in range(self.num_replicas):
                wid = f"s{sid}r{rid}"
                proc = self._spawn(wid)
                pending[wid] = (sid, rid, proc)
        deadline = time.monotonic() + self.start_timeout_s
        while pending:
            ep = self._listener.accept(
                timeout=max(deadline - time.monotonic(), 0.1))
            hello = ep.recv(timeout=self.start_timeout_s)
            wid = hello.get("worker_id")
            if wid not in pending:
                ep.close()
                continue
            sid, rid, proc = pending.pop(wid)
            h = RpcWorkerHandle(sid, rid, wid, proc, ep)
            self._init_handle(h)
            self.handles[sid].append(h)
            self._on_join("join")
        self.started = True

    def _spawn(self, worker_id: str):
        proc = self._ctx.Process(
            target=worker_main,
            args=(tuple(self._listener.address), self._listener.authkey,
                  worker_id),
            name=f"rlc-shard-{worker_id}", daemon=True)
        proc.start()
        return proc

    def _init_handle(self, h: RpcWorkerHandle) -> None:
        payload = self._payloads[h.shard_id]
        self._call(h, "init", shard_id=h.shard_id,
                   replica_id=h.replica_id, **payload)
        h.generation = int(payload["generation"])
        if h.shard_id in self._staged:
            # joined between a stage and its commit: stage it too
            self._call(h, "swap", **self._staged[h.shard_id])
        # per-worker round-trip watch
        h.straggler = StragglerMonitor(window=32, factor=4.0)

    def _on_join(self, event: str) -> None:
        self.membership_epoch += 1
        self.joins += 1 if event == "join" else 0
        self.rejoins += 1 if event == "rejoin" else 0
        self._m_members.labels(event=event).inc()
        self._m_workers.set(self.live_workers)

    def _mark_left(self, h: RpcWorkerHandle, event: str = "leave") -> None:
        if not h.alive:
            return
        h.alive = False
        h.ep.close()
        self.membership_epoch += 1
        self.leaves += 1
        self._m_members.labels(event=event).inc()
        self._m_workers.set(self.live_workers)

    def leave(self, shard_id: int, replica_id: int,
              graceful: bool = True) -> bool:
        """Take one worker out of the fleet (drain/failure drill). The
        remaining replicas — or the caller's degrade path — keep the
        shard serving."""
        with self._lock:
            h = self._find(shard_id, replica_id, alive=True)
            if h is None:
                return False
            if graceful:
                try:
                    h.ep.request("shutdown", timeout=5.0)
                except RpcError:
                    pass
            self._mark_left(h)
        if h.proc is not None:
            h.proc.join(timeout=5.0)
            if h.proc.is_alive():           # pragma: no cover - stuck
                h.proc.terminate()
        return True

    def rejoin(self, shard_id: int, replica_id: int) -> RpcWorkerHandle:
        """Bring a (shard, replica) seat back: spawn a fresh process and
        re-ship the shard's *current* slice payload."""
        with self._lock:
            live = self._find(shard_id, replica_id, alive=True)
            if live is not None:
                return live
            wid = f"s{shard_id}r{replica_id}g{self.membership_epoch}"
            proc = self._spawn(wid)
            deadline = time.monotonic() + self.start_timeout_s
            while True:
                ep = self._listener.accept(
                    timeout=max(deadline - time.monotonic(), 0.1))
                hello = ep.recv(timeout=self.start_timeout_s)
                if hello.get("worker_id") == wid:
                    break
                ep.close()
            h = RpcWorkerHandle(shard_id, replica_id, wid, proc, ep)
            self._init_handle(h)
            # replace the dead seat in place (membership history lives
            # in the counters, not the handle list)
            self.handles[shard_id] = [
                x for x in self.handles[shard_id]
                if not (x.replica_id == replica_id and not x.alive)]
            self.handles[shard_id].append(h)
            self._on_join("rejoin")
            return h

    def _find(self, shard_id: int, replica_id: int,
              alive: Optional[bool] = None) -> Optional[RpcWorkerHandle]:
        for h in self.handles[shard_id]:
            if h.replica_id == replica_id and (alive is None
                                               or h.alive == alive):
                return h
        return None

    @property
    def live_workers(self) -> int:
        return sum(h.alive for hs in self.handles.values() for h in hs)

    def serving_workers(self, shard_id: int) -> List[RpcWorkerHandle]:
        return [h for h in self.handles[shard_id] if h.alive]

    # -- call plane ------------------------------------------------------ #
    def _call(self, h: RpcWorkerHandle, method: str, **params) -> dict:
        t0 = time.perf_counter()
        try:
            reply, sent, received = h.ep.request(
                method, timeout=self.call_timeout_s, **params)
        except WorkerGone:
            self._m_req.labels(method=method, outcome="gone").inc()
            self._mark_left(h, event="died")
            raise
        except RemoteError:
            self._m_req.labels(method=method, outcome="error").inc()
            raise
        dt = time.perf_counter() - t0
        h.calls += 1
        if h.straggler is not None:
            h.straggler.record(h.calls, dt)
        self._m_rtt.labels(method=method).observe(dt)
        self._m_bytes.labels(direction="sent", method=method).inc(sent)
        self._m_bytes.labels(direction="received",
                             method=method).inc(received)
        self._m_req.labels(method=method, outcome="ok").inc()
        return reply

    def _acquire(self, shard_id: int) -> Optional[RpcWorkerHandle]:
        live = self.serving_workers(shard_id)
        if not live:
            return None
        return live[next(self._rr[shard_id]) % len(live)]

    def _call_shard(self, shard_id: int, method: str, **params) -> dict:
        """Round-robin a request onto a live worker of ``shard_id``,
        retrying the sibling replicas when one dies mid-call."""
        tried = 0
        while True:
            h = self._acquire(shard_id)
            if h is None:
                raise WorkerLost(
                    f"shard {shard_id} has no serving worker "
                    f"(method={method!r})")
            try:
                return self._call(h, method, **params)
            except WorkerGone:
                tried += 1
                self.retries += 1
                self._m_retry.labels(method=method).inc()
                if tried > self.num_replicas:
                    raise WorkerLost(
                        f"shard {shard_id}: every replica died "
                        f"mid-{method}") from None

    # -- shard operations ------------------------------------------------ #
    def execute(self, shard_id: int, s, t, mr) -> Tuple[np.ndarray, str]:
        r = self._call_shard(shard_id, "execute",
                             s=np.asarray(s, np.int32),
                             t=np.asarray(t, np.int32),
                             mr=np.asarray(mr, np.int32))
        return np.asarray(r["ans"], dtype=bool), str(r["backend"])

    def gather_digest(self, shard_id: int, s) -> dict:
        return self._call_shard(shard_id, "gather_digest",
                                s=np.asarray(s, np.int64))

    def join_digest(self, shard_id: int, s, t, mr,
                    digest: dict) -> np.ndarray:
        r = self._call_shard(shard_id, "join_digest",
                             s=np.asarray(s, np.int64),
                             t=np.asarray(t, np.int64),
                             mr=np.asarray(mr, np.int64),
                             digest_indptr=digest["indptr"],
                             digest_hub=digest["hub"],
                             digest_mr=digest["mr"])
        return np.asarray(r["ans"], dtype=bool)

    def stage(self, shard_id: int, generation: int,
              frozen_slice: FrozenRLCIndex) -> int:
        """Ship one shard's next generation to each of its live workers,
        which build it beside the generation they keep serving. Returns
        the number of workers staged; a dead seat gets it at rejoin."""
        lo, hi = self.ranges[shard_id]
        payload = _slice_payload(frozen_slice, lo, hi, generation,
                                 self.id_to_mr)
        with self._lock:
            self._staged[shard_id] = payload
            staged = 0
            for h in list(self.handles[shard_id]):
                if not h.alive:
                    continue
                try:
                    self._call(h, "swap", **payload)
                    staged += 1
                except WorkerGone:
                    continue        # seat stays dead; rejoin re-ships
            return staged

    def commit(self, generation: int) -> int:
        """Serve every staged shard's generation ``generation`` on every
        live worker. The caller holds the fan-out's generation gate, so
        no batch is in flight. Returns the number of workers switched."""
        with self._lock:
            self.generation = max(self.generation, int(generation))
            switched = 0
            for sid, payload in sorted(self._staged.items()):
                self._payloads[sid] = payload
                for h in list(self.handles[sid]):
                    if not h.alive:
                        continue
                    try:
                        self._call(h, "commit", generation=int(generation))
                        h.generation = int(generation)
                        switched += 1
                    except WorkerGone:
                        continue
            self._staged.clear()
            return switched

    def worker_stats(self) -> List[dict]:
        out = []
        for sid in range(self.num_shards):
            for h in self.handles[sid]:
                row = dict(shard=sid, replica=h.replica_id,
                           worker_id=h.worker_id, pid=h.pid,
                           alive=h.alive, generation=h.generation,
                           calls=h.calls,
                           stragglers=(len(h.straggler.flagged)
                                       if h.straggler is not None else 0))
                if h.alive:
                    try:
                        row.update(self._call(h, "stats"))
                        row.pop("id", None)
                        row.pop("ok", None)
                    except RpcError:
                        pass
                out.append(row)
        return out

    def stats(self) -> dict:
        ep_bytes = dict(sent=0, received=0)
        for hs in self.handles.values():
            for h in hs:
                ep_bytes["sent"] += h.ep.bytes_sent
                ep_bytes["received"] += h.ep.bytes_received
        return dict(
            transport="rpc",
            num_shards=self.num_shards,
            num_replicas=self.num_replicas,
            live_workers=self.live_workers,
            membership_epoch=self.membership_epoch,
            generation=self.generation,
            joins=self.joins, leaves=self.leaves,
            rejoins=self.rejoins, retries=self.retries,
            wire_bytes=ep_bytes,
            workers=self.worker_stats(),
        )

    # -- shutdown -------------------------------------------------------- #
    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        for hs in self.handles.values():
            for h in hs:
                if not h.alive:
                    continue
                try:
                    h.ep.request("shutdown", timeout=5.0)
                except RpcError:
                    pass
                h.alive = False
                h.ep.close()
        for hs in self.handles.values():
            for h in hs:
                if h.proc is not None:
                    h.proc.join(timeout=5.0)
                    if h.proc.is_alive():   # pragma: no cover - stuck
                        h.proc.terminate()
        if self._listener is not None:
            self._listener.close()
        self._m_workers.set(0)
