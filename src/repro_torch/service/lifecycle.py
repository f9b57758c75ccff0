"""Async admission: ``submit()`` futures + the unified service
lifecycle.

:class:`AsyncEngine` turns a synchronous :class:`RLCService` /
``ShardedRLCService`` into a non-blocking one. ``submit(s, t,
constraint)`` runs *admission only* on the caller's thread — parse,
cache probe, admission-control decision, micro-batch enqueue — and
returns a :class:`concurrent.futures.Future` that resolves to a typed
:class:`~repro_torch.service.answer.Answer`. Batch *execution* happens on the
engine's worker thread, fed by the scheduler's deadline ticker and by
full batches handed over at submit time — so admission of query *i+1*
overlaps execution of query *i*'s batch, which is the point.

Correctness notes (the races this design closes):

* Waiter registration and future resolution both happen under one
  engine lock, and a submitter registers its future *before* releasing
  it — a ticker-flushed batch picked up by the worker thread blocks on
  that lock, so a future can never miss its answer.
* Duplicate in-flight keys coalesce in the scheduler exactly like the
  sync path: every coalesced submitter's future hangs off the same
  ``req_id`` and resolves from the single execution.
* Admission-control evictions resolve the victim's futures with
  :data:`SHED` (never a fabricated boolean), same as ``query_batch``.
* An execution failure resolves every future of the failed batch with
  the exception (``Future.set_exception``); later submits still work.

The engine also keeps the overlap ledger the benches report: wall time
spent admitting vs executing and how much of the execution happened
*while* admission was still going (``stats()["overlap_s"]``) — the
observable proof that ``submit()`` is actually asynchronous.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

from .answer import SHED, Answer

__all__ = ["AsyncEngine"]

_CLOSE = object()       # worker-thread shutdown sentinel


class AsyncEngine:
    def __init__(self, svc, tick_interval_s: float = 0.002):
        self.svc = svc
        self.tick_interval_s = float(tick_interval_s)
        self._lock = threading.RLock()
        #: req_id -> futures awaiting that request (coalesced submits
        #: share one req_id)
        self._waiters: Dict[int, List[Future]] = {}
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self.active = False
        # counters + the admission/execution overlap ledger
        self.submitted = 0
        self.completed = 0
        self.cache_hits = 0
        self.shed = 0
        self.failed_batches = 0
        self.exec_batches = 0
        self.exec_s = 0.0
        self.admit_s = 0.0
        self.overlap_s = 0.0
        self._first_submit: Optional[float] = None
        self._last_submit: Optional[float] = None
        reg = svc.obs.registry
        self._m_inflight = reg.gauge(
            "rlc_async_inflight", desc="futures awaiting resolution")
        self._m_submit = reg.counter(
            "rlc_async_submits", desc="async submissions by outcome",
            labelnames=("outcome",))

    # -- lifecycle ------------------------------------------------------- #
    def start(self) -> None:
        if self.active:
            return
        self.active = True
        self._thread = threading.Thread(
            target=self._serve, name="rlc-async-exec", daemon=True)
        self._thread.start()
        # deadline flushes land in the execution queue; ticker errors
        # must surface on futures, not die in a counter
        self.svc.batcher.start_ticker(self._queue.put,
                                      self.tick_interval_s,
                                      on_error=self._on_ticker_error)

    def close(self) -> None:
        """Drain everything admitted so far, resolve its futures, stop
        the threads. Idempotent."""
        if not self.active:
            return
        self.active = False
        self.svc.batcher.stop_ticker()
        with self._lock:
            for batch in self.svc.batcher.drain():
                self._queue.put(batch)
        self._queue.put(_CLOSE)
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def flush(self) -> None:
        """Force-flush the scheduler and block until every batch queued
        so far has executed (the sync-bridge for ``query_batch``)."""
        with self._lock:
            for batch in self.svc.batcher.drain():
                self._queue.put(batch)
        self._queue.join()

    # -- admission (caller thread) --------------------------------------- #
    def submit(self, s: int, t: int, constraint,
               now: Optional[float] = None) -> Future:
        """Non-blocking admission; the returned future resolves to an
        :class:`Answer` (or :data:`SHED`). Malformed queries raise here,
        synchronously — an argument error is the caller's bug, not a
        deferred execution outcome."""
        svc = self.svc
        t0 = time.perf_counter()
        fut: Future = Future()
        with self._lock:
            s, t, mr_id, mr_len = svc._admit(s, t, constraint)
            key = (s, t, mr_id)
            self.submitted += 1
            self._first_submit = self._first_submit or t0
            svc.queries_served += 1
            svc.ctl.observe_admit(key, mr_len)
            hit = svc.cache.get(key, mr_len=mr_len)
            if hit is not None:
                self.cache_hits += 1
                self._m_submit.labels(outcome="cache_hit").inc()
                fut.set_result(Answer(hit, "cache_hit"))
                return fut
            admission = svc.ctl.admission
            if admission is not None:
                decision, victim = admission.decide(key, mr_len,
                                                    svc.batcher)
                if decision == "shed":
                    self._shed_future(fut)
                    return fut
                if decision == "evict" and svc.batcher.evict(victim):
                    for vf in self._waiters.pop(victim.req_id, ()):
                        self._shed_future(vf)
            req, ready = svc.batcher.submit(s, t, mr_id, mr_len, now)
            self._waiters.setdefault(req.req_id, []).append(fut)
            self._m_inflight.set(sum(len(v)
                                     for v in self._waiters.values()))
            self._m_submit.labels(outcome="queued").inc()
            for batch in ready:
                self._queue.put(batch)
            self._last_submit = time.perf_counter()
            self.admit_s += self._last_submit - t0
        return fut

    def _shed_future(self, fut: Future) -> None:
        self.shed += 1
        self.svc.queries_shed += 1
        self._m_submit.labels(outcome="shed").inc()
        fut.set_result(SHED)

    # -- execution (engine thread) ---------------------------------------- #
    def _serve(self) -> None:
        while True:
            batch = self._queue.get()
            try:
                if batch is _CLOSE:
                    return
                self._execute(batch)
            finally:
                self._queue.task_done()

    def _on_ticker_error(self, exc: BaseException) -> None:
        """A deadline flush blew up inside the scheduler ticker: fail
        every pending future rather than hang their callers."""
        with self._lock:
            waiters, self._waiters = self._waiters, {}
        for futures in waiters.values():
            for fut in futures:
                if not fut.done():
                    fut.set_exception(exc)

    def _execute(self, batch) -> None:
        svc = self.svc
        t0 = time.perf_counter()
        try:
            vals, backends = svc._run_batch(batch)
        except Exception as exc:    # noqa: BLE001 — delivered to futures
            self.failed_batches += 1
            with self._lock:
                for req in batch.requests:
                    for fut in self._waiters.pop(req.req_id, ()):
                        if not fut.done():
                            fut.set_exception(exc)
            return
        t1 = time.perf_counter()
        svc.ctl.on_batch_executed(batch, t1 - t0)
        with self._lock:
            self.exec_batches += 1
            self.exec_s += t1 - t0
            if self._first_submit is not None:
                # execution time spent while admission was still running
                # = the overlap submit() buys over the sync path
                lo = max(t0, self._first_submit)
                hi = min(t1, self._last_submit or t1)
                self.overlap_s += max(hi - lo, 0.0)
            for req, val, backend in zip(batch.requests, vals, backends):
                val = bool(val)
                svc.cache.put((req.s, req.t, req.mr_id), val,
                              mr_len=batch.mr_len)
                ans = Answer(
                    val,
                    "degraded" if backend == "bibfs" else "computed",
                    backend)
                futures = self._waiters.pop(req.req_id, ())
                for fut in futures:
                    if not fut.done():
                        fut.set_result(ans)
                self.completed += len(futures)
                if svc._shadow is not None:
                    svc._shadow.offer(req.s, req.t, req.mr_id, val)
            self._m_inflight.set(sum(len(v)
                                     for v in self._waiters.values()))

    # -- introspection ---------------------------------------------------- #
    def stats(self) -> dict:
        with self._lock:
            inflight = sum(len(v) for v in self._waiters.values())
            return dict(
                active=self.active,
                submitted=self.submitted,
                completed=self.completed,
                cache_hits=self.cache_hits,
                shed=self.shed,
                inflight=inflight,
                exec_batches=self.exec_batches,
                failed_batches=self.failed_batches,
                admit_s=round(self.admit_s, 6),
                exec_s=round(self.exec_s, 6),
                overlap_s=round(self.overlap_s, 6),
            )
