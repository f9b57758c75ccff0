"""Micro-batching scheduler for RLC queries.

Incoming ``(s, t, mr)`` requests accumulate into fixed-size batches so the
batched engines (torch sorted-key / CUDA merge join) amortize dispatch and keep
a single jit specialization per batch shape — the same slot pattern as the
LM serving engine (:mod:`repro_torch.serve.engine`), transplanted to queries.

Buckets are keyed by MR length: all requests in a batch share ``|MR|``, so
Zipf-heavy short constraints don't ride in batches padded for long ones,
and per-bucket arrival rates stay observable. A batch flushes when it is
full (``batch_size`` requests) or when its oldest request has waited
``max_wait_s`` (deadline flush, checked by :meth:`MicroBatcher.poll`).
Both limits are per-bucket overridable via ``params_fn`` — the hook the
SLO batch controller (``repro.service.control``) uses to size batches
and deadlines per MR length from observed queue-wait/compute costs.

Flushed batches carry exactly their real requests — underfull deadline
flushes are *not* padded to ``batch_size`` (repeating the first request
used to burn executor slots on every deadline flush; the executor now
pads to a power-of-two internally for the jit backends, which bounds the
number of compiled shapes without recomputing duplicate slots). The
``rlc_batcher_padding_ratio`` histogram records padded/total slots per
flush so the waste stays provably gone.

Duplicate in-flight keys are *coalesced*: submitting a ``(s, t, mr_id)``
already queued returns the queued :class:`Request` instead of occupying a
second batch slot — the caller fans the single answer out to every
submitter (see ``RLCService.query_batch``'s slot map). Under a Zipf
workload most duplicates are absorbed by the result cache, but duplicates
*within one in-flight window* only exist here, before any answer is
cached.

The scheduler is clock-driven and synchronous by default: callers hand it
a ``now`` timestamp (or let it read the injected clock), and flushed
batches come back for the caller to execute. An optional background
*deadline ticker* (:meth:`MicroBatcher.start_ticker`, off by default) adds
the first step toward async admission: a daemon thread polls for deadline
flushes so an underfull bucket drains even when no new admission ever
arrives to piggyback the poll on. All mutating entry points take the
internal lock, so ticker flushes and caller admissions interleave safely.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import NULL_OBS


@dataclass(frozen=True)
class Request:
    """One admitted query, already canonicalized to an indexed MR."""

    req_id: int
    s: int
    t: int
    mr_id: int
    mr_len: int
    enqueued_at: float = 0.0

    @property
    def key(self) -> Tuple[int, int, int]:
        return (self.s, self.t, self.mr_id)


@dataclass
class Batch:
    """A launch-ready batch of same-``|MR|`` requests (real slots only)."""

    requests: List[Request]     # the real requests, in admission order
    s: np.ndarray               # (n_real,) int32 — no padding slots
    t: np.ndarray
    mr_id: np.ndarray
    mr_len: int
    reason: str                 # "full" | "deadline" | "drain"
    flushed_at: float = 0.0     # scheduler-clock flush time (queue-wait
                                # spans: flushed_at - request.enqueued_at)

    @property
    def n_real(self) -> int:
        return len(self.requests)

    @property
    def n_padding(self) -> int:
        return len(self.s) - len(self.requests)


class MicroBatcher:
    def __init__(self, batch_size: int, max_wait_s: float = 0.002,
                 clock: Callable[[], float] = time.monotonic, obs=None,
                 params_fn: Optional[
                     Callable[[int], Tuple[int, float]]] = None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        self.batch_size = batch_size
        self.max_wait_s = max_wait_s
        #: optional per-MR-length override: ``mr_len -> (batch_size,
        #: max_wait_s)`` — the SLO controller's entry point; ``None``
        #: keeps the fixed constructor values for every bucket
        self.params_fn = params_fn
        self.clock = clock
        self._buckets: Dict[int, List[Request]] = {}
        self._inflight: Dict[Tuple[int, int, int], Request] = {}
        self._ids = itertools.count()
        self._lock = threading.RLock()
        self._ticker: Optional[threading.Thread] = None
        self._ticker_stop = threading.Event()
        self.batches_full = 0
        self.batches_deadline = 0
        self.batches_drain = 0
        self.coalesced = 0
        self.ticker_errors = 0
        # registry cells: per-request queue wait (admission -> flush) and
        # per-batch flush reason — the always-on half of the queue-wait
        # vs compute decomposition (spans are the sampled half)
        self.obs = obs or NULL_OBS
        reg = self.obs.registry
        wait = reg.histogram(
            "rlc_batcher_queue_wait_seconds",
            desc="per-request wait from admission to batch flush",
            unit="s", labelnames=("reason",))
        flush = reg.counter("rlc_batcher_batches",
                            desc="flushed batches by reason",
                            labelnames=("reason",))
        self._m_wait = {r: wait.labels(reason=r)
                        for r in ("full", "deadline", "drain")}
        self._m_flush = {r: flush.labels(reason=r)
                         for r in ("full", "deadline", "drain")}
        self._m_coalesced = reg.counter(
            "rlc_batcher_coalesced",
            desc="duplicate in-flight requests coalesced").labels()
        fill = reg.histogram(
            "rlc_batcher_batch_fill",
            desc="real requests per flushed batch", unit="1",
            labelnames=("reason",))
        self._m_fill = {r: fill.labels(reason=r)
                        for r in ("full", "deadline", "drain")}
        self._m_padding = reg.histogram(
            "rlc_batcher_padding_ratio",
            desc="padded slots / total slots per flushed batch "
                 "(0 since underfull flushes stopped padding)",
            unit="1").labels()
        self._m_evicted = reg.counter(
            "rlc_batcher_evicted",
            desc="queued requests evicted pre-flush by admission "
                 "control").labels()

    # ------------------------------------------------------------------ #
    def params(self, mr_len: int) -> Tuple[int, float]:
        """Effective ``(batch_size, max_wait_s)`` for one bucket."""
        if self.params_fn is None:
            return self.batch_size, self.max_wait_s
        return self.params_fn(mr_len)

    # ------------------------------------------------------------------ #
    def submit(self, s: int, t: int, mr_id: int, mr_len: int,
               now: Optional[float] = None) -> Tuple[Request, List[Batch]]:
        """Admit one request; return it plus any batches now ready (the
        request's own bucket on fill, any bucket past its deadline).

        A duplicate of an in-flight ``(s, t, mr_id)`` is coalesced: the
        already-queued request comes back (compare ``req_id``) and no new
        batch slot is taken — the caller must fan the answer out to every
        position that mapped onto that request.
        """
        with self._lock:
            now = self.clock() if now is None else now
            key = (int(s), int(t), int(mr_id))
            existing = self._inflight.get(key)
            if existing is not None:
                self.coalesced += 1
                self._m_coalesced.inc()
                # still a natural poll point for every bucket's deadline
                return existing, self.poll(now)
            req = Request(next(self._ids), key[0], key[1], key[2],
                          int(mr_len), now)
            bucket = self._buckets.setdefault(mr_len, [])
            bucket.append(req)
            self._inflight[key] = req
            out: List[Batch] = []
            cap, _wait = self.params(mr_len)
            if len(bucket) >= cap:
                out.append(self._flush_bucket(mr_len, "full"))
            # An admission is also a natural poll point for other buckets.
            out.extend(self.poll(now))
            return req, out

    def poll(self, now: Optional[float] = None) -> List[Batch]:
        """Flush every bucket whose oldest request has hit the deadline."""
        with self._lock:
            now = self.clock() if now is None else now
            out: List[Batch] = []
            for mr_len in list(self._buckets):
                bucket = self._buckets[mr_len]
                if not bucket:
                    continue
                _cap, wait = self.params(mr_len)
                if now - bucket[0].enqueued_at >= wait:
                    out.append(self._flush_bucket(mr_len, "deadline"))
            return out

    def drain(self) -> List[Batch]:
        """Flush everything regardless of fill or age (end of a sync call)."""
        with self._lock:
            return [self._flush_bucket(m, "drain")
                    for m in list(self._buckets) if self._buckets[m]]

    def pending(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._buckets.values())

    def evict(self, req: Request) -> bool:
        """Remove one still-queued request before it flushes (admission
        control sheds it in favor of a higher-priority arrival). Returns
        ``False`` when the request already flushed or was coalesced away
        — the caller must then answer it normally."""
        with self._lock:
            bucket = self._buckets.get(req.mr_len)
            if not bucket:
                return False
            for i, r in enumerate(bucket):
                if r.req_id == req.req_id:
                    del bucket[i]
                    self._inflight.pop(r.key, None)
                    self._m_evicted.inc()
                    return True
            return False

    def lowest_priority_pending(
            self, score_fn: Callable[[Request], float]
    ) -> Optional[Request]:
        """The queued request minimizing ``score_fn`` (admission control's
        eviction victim scan), or ``None`` when nothing is queued."""
        with self._lock:
            worst: Optional[Request] = None
            worst_score = float("inf")
            for bucket in self._buckets.values():
                for r in bucket:
                    sc = score_fn(r)
                    if sc < worst_score:
                        worst, worst_score = r, sc
            return worst

    def median_pending_priority(
            self, score_fn: Callable[[Request], float]
    ) -> Optional[float]:
        """Lower-median ``score_fn`` over queued requests (the
        back-pressure shed threshold — lower, so that in a uniform-
        priority queue arrivals at that priority still shed), or
        ``None`` when the queue is empty."""
        with self._lock:
            scores = sorted(score_fn(r) for bucket in self._buckets.values()
                            for r in bucket)
            if not scores:
                return None
            return scores[(len(scores) - 1) // 2]

    def is_inflight(self, key: Tuple[int, int, int]) -> bool:
        """Whether ``(s, t, mr_id)`` is queued awaiting a flush — i.e. a
        duplicate submitted now would coalesce. Read-only (EXPLAIN's
        coalescing disposition; never takes a batch slot)."""
        with self._lock:
            return tuple(int(x) for x in key) in self._inflight

    # -- background deadline ticker ------------------------------------- #
    def start_ticker(self, on_batch: Callable[[Batch], None],
                     interval_s: Optional[float] = None,
                     on_error: Optional[
                         Callable[[BaseException], None]] = None) -> None:
        """Start a daemon thread that fires deadline flushes on its own.

        Without a ticker, ``max_wait_s`` is only honored when some caller
        happens to submit or poll; with it, an underfull bucket flushes at
        most ~``interval_s`` after its deadline even if no admission ever
        arrives again. ``on_batch`` runs on the ticker thread for every
        flushed batch (execute + backfill caches there). Off by default.

        ``on_error`` (optional) is invoked with the exception when
        ``on_batch`` raises — async callers use it to fail pending
        futures instead of silently counting the error; without it (or
        if it raises itself) the failure just lands in
        ``ticker_errors``. The ticker survives either way.
        """
        if interval_s is None:
            interval_s = max(self.max_wait_s / 4.0, 1e-4)

        def loop():
            while not self._ticker_stop.wait(interval_s):
                for batch in self.poll():
                    try:
                        on_batch(batch)
                    except Exception as exc:
                        # a failing callback must not kill the ticker —
                        # later deadline flushes still have to fire
                        self.ticker_errors += 1
                        if on_error is not None:
                            try:
                                on_error(exc)
                            except Exception:
                                self.ticker_errors += 1

        with self._lock:
            if self._ticker is not None:
                raise RuntimeError("ticker already running")
            self._ticker_stop.clear()
            self._ticker = threading.Thread(
                target=loop, name="microbatcher-ticker", daemon=True)
            self._ticker.start()

    def stop_ticker(self) -> None:
        """Stop the ticker thread (no-op when not running)."""
        with self._lock:
            ticker, self._ticker = self._ticker, None
            if ticker is None:
                return
            self._ticker_stop.set()
        # join outside the lock: the ticker's poll() needs it to finish
        ticker.join()

    @property
    def ticker_running(self) -> bool:
        return self._ticker is not None

    # ------------------------------------------------------------------ #
    def _flush_bucket(self, mr_len: int, reason: str) -> Batch:
        bucket = self._buckets[mr_len]
        cap, _wait = self.params(mr_len)
        reqs, rest = bucket[:cap], bucket[cap:]
        self._buckets[mr_len] = rest
        for r in reqs:
            self._inflight.pop(r.key, None)
        if reason == "full":
            self.batches_full += 1
        elif reason == "deadline":
            self.batches_deadline += 1
        else:
            self.batches_drain += 1
        now = self.clock()
        self._m_flush[reason].inc()
        self._m_fill[reason].observe(len(reqs))
        wait_cell = self._m_wait[reason]
        for r in reqs:
            wait_cell.observe(now - r.enqueued_at)
        # real slots only — the executor pads jit backends internally
        self._m_padding.observe(0.0)
        n = len(reqs)
        s = np.fromiter((r.s for r in reqs), np.int32, n)
        t = np.fromiter((r.t for r in reqs), np.int32, n)
        mr = np.fromiter((r.mr_id for r in reqs), np.int32, n)
        return Batch(reqs, s, t, mr, mr_len, reason, flushed_at=now)
