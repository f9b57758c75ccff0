"""Shard-host worker process: one shard slice, served over RPC.

``worker_main`` is the spawn target (top-level and importable, so the
``spawn`` start method works everywhere). A worker dials back to the
controller's listener, announces itself (``hello``), then serves
requests until ``shutdown`` or controller death.

A worker holds **only shard-local state**: the
:meth:`FrozenRLCIndex.slice_rows` view of its shard's row range shipped
over the wire, plus a dict-index slice reconstructed locally from those
same rows (:func:`repro_torch.service.sharded.replica.dict_index_slice`)
as the python fallback — never the global dict index. The two-sided
routing invariant makes that sufficient: every sub-batch a worker
executes has both endpoints in its range, and cross-shard queries arrive
as out-row digests to join against local in-rows (``join_digest``) or
leave as digests gathered from local out-rows (``gather_digest``).

Workers answer **from the host**, through the frozen-numpy merge join
(``backend="numpy"``, with the dict-slice python path as fallback): a
worker builds no :class:`DeviceIndex` and creates no CUDA tensor. It is
spawned, not forked, so it never inherits the controller's CUDA
context; on a card, only the controller process serves from the device.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.minimum_repeat import LabelSeq
from repro_torch.core.rlc_index import FrozenRLCIndex, merge_join_rows

__all__ = ["worker_main", "ShardWorker"]


def _frozen_from_payload(p: dict) -> FrozenRLCIndex:
    return FrozenRLCIndex(
        int(p["num_vertices"]), int(p["k"]),
        np.asarray(p["aid"], dtype=np.int64),
        np.asarray(p["out_indptr"], dtype=np.int64),
        np.asarray(p["out_hub"], dtype=np.int32),
        np.asarray(p["out_mr"], dtype=np.int32),
        np.asarray(p["in_indptr"], dtype=np.int64),
        np.asarray(p["in_hub"], dtype=np.int32),
        np.asarray(p["in_mr"], dtype=np.int32))


class ShardWorker:
    """The in-process half of one worker: shard state + request
    handlers. Factored out of :func:`worker_main` so tests can drive the
    protocol without a process."""

    def __init__(self, worker_id: str):
        self.worker_id = worker_id
        self.shard_id: Optional[int] = None
        self.replica_id: Optional[int] = None
        self.generation = -1
        self.lo = 0
        self.hi = 0
        self.frozen: Optional[FrozenRLCIndex] = None
        self.executor = None
        self._staged: Optional[dict] = None   # swapped in, not committed
        self.id_to_mr: List[LabelSeq] = []
        self.batches = 0
        self.queries = 0
        self.joins = 0
        self.digests = 0
        self.swaps = 0

    # -- state install --------------------------------------------------- #
    def _build(self, p: dict) -> dict:
        """The serving state of one generation, from its payload."""
        from repro_torch.service.executor import BatchExecutor
        from repro_torch.service.sharded.replica import dict_index_slice
        lo, hi = int(p["lo"]), int(p["hi"])
        frozen = _frozen_from_payload(p)
        id_to_mr = ([tuple(int(x) for x in mr) for mr in p["id_to_mr"]]
                    if "id_to_mr" in p else self.id_to_mr)
        index_slice = dict_index_slice(frozen, lo, hi, id_to_mr)
        # no device layout and the backend pinned to "numpy": the worker
        # answers from the host CSR and never touches a card
        executor = BatchExecutor(index_slice, frozen, None, id_to_mr,
                                 backend="numpy")
        return dict(generation=int(p["generation"]), lo=lo, hi=hi,
                    frozen=frozen, id_to_mr=id_to_mr, executor=executor)

    def _adopt(self, state: dict) -> None:
        for k, v in state.items():
            setattr(self, k, v)

    # -- handlers --------------------------------------------------------- #
    def on_init(self, msg: dict) -> dict:
        self.shard_id = int(msg["shard_id"])
        self.replica_id = int(msg["replica_id"])
        self._adopt(self._build(msg))
        return dict(shard_id=self.shard_id, replica_id=self.replica_id,
                    generation=self.generation,
                    entries=int(self.frozen.num_entries()))

    def on_swap(self, msg: dict) -> dict:
        """Stage a new generation beside the serving one, which keeps
        answering until ``commit`` (the controller commits every worker
        of every shard together, so no batch joins two generations)."""
        if int(msg["generation"]) < self.generation:
            raise ValueError(
                f"stale swap: at generation {self.generation}, "
                f"got {msg['generation']}")
        self._staged = self._build(msg)
        return dict(staged=self._staged["generation"],
                    entries=int(self._staged["frozen"].num_entries()))

    def on_commit(self, msg: dict) -> dict:
        """Serve the staged generation ``msg["generation"]``."""
        staged = self._staged
        if staged is None or staged["generation"] != int(msg["generation"]):
            raise ValueError(
                f"commit of generation {msg['generation']}, staged "
                f"{staged and staged['generation']}")
        self._adopt(staged)
        self._staged = None
        self.swaps += 1
        return dict(generation=self.generation,
                    entries=int(self.frozen.num_entries()))

    def on_execute(self, msg: dict) -> dict:
        s = np.asarray(msg["s"], dtype=np.int32)
        t = np.asarray(msg["t"], dtype=np.int32)
        mr = np.asarray(msg["mr"], dtype=np.int32)
        ans, backend = self.executor.execute(s, t, mr)
        self.batches += 1
        self.queries += len(s)
        return dict(ans=np.asarray(ans, dtype=bool), backend=backend)

    def on_gather_digest(self, msg: dict) -> dict:
        """Out-row digests for the scatter hop of cross-shard queries:
        per-query ``L_out(s)`` rows, concatenated + indexed (ragged rows
        serialize as three flat arrays instead of per-row frames)."""
        s = np.asarray(msg["s"], dtype=np.int64)
        indptr = np.zeros(len(s) + 1, dtype=np.int64)
        hubs, mrs = [], []
        for q, v in enumerate(s):
            oh, om = self.frozen.row_out(int(v))
            indptr[q + 1] = indptr[q] + len(oh)
            hubs.append(oh)
            mrs.append(om)
        cat = (lambda parts: np.concatenate(parts)  # noqa: E731
               if parts else np.empty(0, np.int32))
        self.digests += len(s)
        return dict(indptr=indptr, hub=cat(hubs).astype(np.int32),
                    mr=cat(mrs).astype(np.int32))

    def on_join_digest(self, msg: dict) -> dict:
        """The gather hop: merge-join shipped out-row digests against
        this shard's local in-rows (Algorithm 1 over two explicit rows;
        both sides share the global aid order)."""
        s = np.asarray(msg["s"], dtype=np.int64)
        t = np.asarray(msg["t"], dtype=np.int64)
        mr = np.asarray(msg["mr"], dtype=np.int64)
        dp = np.asarray(msg["digest_indptr"], dtype=np.int64)
        dh = np.asarray(msg["digest_hub"], dtype=np.int32)
        dm = np.asarray(msg["digest_mr"], dtype=np.int32)
        aid = self.frozen.aid
        out = np.zeros(len(s), dtype=bool)
        for q in range(len(s)):
            oh = dh[dp[q]:dp[q + 1]]
            om = dm[dp[q]:dp[q + 1]]
            ih, im = self.frozen.row_in(int(t[q]))
            out[q] = merge_join_rows(oh, om, ih, im, aid,
                                     int(s[q]), int(t[q]), int(mr[q]))
        self.joins += len(s)
        return dict(ans=out)

    def on_stats(self, msg: dict) -> dict:
        ex = self.executor
        return dict(
            worker_id=self.worker_id, shard_id=self.shard_id,
            replica_id=self.replica_id, generation=self.generation,
            lo=self.lo, hi=self.hi,
            entries=(int(self.frozen.num_entries())
                     if self.frozen is not None else 0),
            batches=self.batches, queries=self.queries,
            joins=self.joins, digests=self.digests, swaps=self.swaps,
            fallbacks=(ex.fallbacks if ex is not None else 0),
            backends=(ex.stats() if ex is not None else {}))

    def on_ping(self, msg: dict) -> dict:
        return dict(pong=True, generation=self.generation)

    def handle(self, msg: dict) -> Tuple[dict, bool]:
        """Dispatch one request; returns ``(reply, keep_serving)``."""
        method = msg.get("method")
        rid = msg.get("id")
        if method == "shutdown":
            return dict(id=rid, ok=True), False
        handler = getattr(self, f"on_{method}", None)
        if handler is None:
            return dict(id=rid, ok=False,
                        error=f"unknown method {method!r}"), True
        try:
            result = handler(msg)
        except Exception as e:  # noqa: BLE001 — reported to the peer
            return dict(id=rid, ok=False, error=repr(e)), True
        return dict(result, id=rid, ok=True), True


def worker_main(address, authkey: bytes, worker_id: str) -> None:
    """Spawn target: dial the controller, announce, serve until told to
    stop (or until the controller's side of the socket dies)."""
    import os

    from . import wire
    from .transport import WorkerGone, connect
    ep = connect(tuple(address), authkey)
    worker = ShardWorker(worker_id)
    ep.send(dict(method="hello", worker_id=worker_id, pid=os.getpid(),
                 codec=wire.codec_name()))
    try:
        while True:
            try:
                msg = ep.recv()
            except WorkerGone:
                break               # controller died: exit quietly
            reply, keep = worker.handle(msg)
            try:
                ep.send(reply)
            except WorkerGone:
                break
            if not keep:
                break
    finally:
        ep.close()
