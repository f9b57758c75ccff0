"""Closed-loop serving control plane: SLO-aware batching, admission
control + load shedding, and prioritized cache warming.

The serving path is observable — `rlc_batcher_queue_wait_seconds`
and `rlc_batcher_batch_fill` expose where a request's latency goes,
`rlc_executor_batch_seconds` what each backend costs, `rlc_cache_lookups`
how the Zipf head behaves. This module adds the feedback loops that
*consume* those series:

* :class:`SLOBatchController` — replaces the fixed
  ``batch_size``/``max_wait_s`` with a per-MR-length controller. Each
  bucket's deadline is sized from the latency budget left after the
  observed compute cost (``target_p99_ms`` minus the EWMA batch-execute
  time), and its batch size adapts multiplicatively: grow while compute
  is cheap relative to the budget and batches flush full (amortize
  more), shrink when a batch's execute time alone threatens the SLO.

* :class:`AdmissionController` — a bounded admission queue with a
  back-pressure signal. Two triggers: the *hard* bound (scheduler
  pending >= ``admission_max_pending``) and the *soft* back-pressure
  signal (EWMA queue wait past ``admission_backpressure_ms``, the
  control-loop reading of ``rlc_batcher_queue_wait_seconds``). Shed
  requests get the explicit :data:`SHED` answer — never a fabricated
  boolean. Priority follows one rule: deepest-MR, coldest-key
  requests go first (score = frequency estimate / MR length); under the
  hard bound a high-priority arrival may instead *evict* the
  lowest-priority queued request.

* :class:`CacheWarmer` — a frequency-sketch-backed warmer that
  re-materializes the hottest ``(s, t, mr)`` answers after
  ``apply_delta`` / ``hot_swap`` under a byte/time budget, so an
  invalidation storm refills the Zipf head off the critical path instead
  of as a p99 spike of cold misses. Warming is *epoch-fenced* exactly
  like the shadow verifier: a mutation bumps the epoch, and a warm
  pass started against the old index aborts rather than writing stale
  answers into the new-epoch cache.

:class:`FrequencySketch` is the shared signal: a count-min sketch (with
periodic halving, so it tracks *recent* popularity) plus a bounded
exact top-K candidate heap — the priority-queue sampling shape from
prioritized experience replay, applied to query keys. Admission reads it
for "coldest-key", the warmer for "hot rows worth re-materializing".

:class:`VirtualClock` supports open-loop overload replay in a
synchronous harness: the bench advances it to each request's *arrival*
stamp while the service advances it by measured *execute* time, so queue
waits grow exactly as they would in an open-loop system where offered
load exceeds capacity (the ``bench_sharded`` overload stage and the
injected-overload tests both drive it).
"""
from __future__ import annotations

import heapq
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import NULL_OBS

from .answer import SHED  # noqa: F401 — historical home, re-exported

Key = Tuple[int, int, int]  # (s, t, mr_id)

__all__ = [
    "SHED", "VirtualClock", "FrequencySketch", "SLOBatchController",
    "AdmissionController", "CacheWarmer", "ControlPlane",
]


class VirtualClock:
    """Settable + advanceable clock for open-loop arrival replay.

    Inject as ``ServiceConfig.clock``: the scheduler stamps admissions
    and flushes with it, the service advances it by each batch's
    measured execute time, and the driver advances it to each chunk's
    arrival stamp (:meth:`at_least`). Monotone by construction.
    """

    __slots__ = ("t",)

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        if dt > 0:
            self.t += float(dt)
        return self.t

    def at_least(self, t: float) -> float:
        if t > self.t:
            self.t = float(t)
        return self.t


# --------------------------------------------------------------------- #
# Frequency sketch
# --------------------------------------------------------------------- #
class FrequencySketch:
    """Count-min sketch with halving decay + bounded exact top-K heap.

    ``observe(key)`` increments the sketch and returns the (conservative)
    count estimate; every ``decay_every`` observations all counts halve,
    so estimates track the *recent* request mix rather than all of
    history — a post-delta warm pass should refill today's Zipf head, not
    last hour's. The top-K candidate set (``hot()``) is the part a sketch
    alone cannot give: warming needs actual keys to re-execute, so the
    hottest ``hot_capacity`` keys ride a min-heap keyed by estimate (the
    PER priority-queue shape: cheap priorities for everyone, exact
    entries for the head of the distribution).
    """

    def __init__(self, width: int = 2048, depth: int = 4,
                 hot_capacity: int = 256, decay_every: int = 8192):
        if width < 8 or depth < 1:
            raise ValueError(f"bad sketch shape ({width}x{depth})")
        self.width = int(width)
        self.depth = int(depth)
        self.hot_capacity = int(hot_capacity)
        self.decay_every = int(decay_every)
        self.counts = np.zeros((depth, width), dtype=np.int64)
        self.observed = 0
        self.decays = 0
        # exact candidates: key -> (estimate, mr_len); kept <= capacity
        self._hot: Dict[Key, Tuple[int, int]] = {}

    def _rows(self, key: Key) -> List[int]:
        h = zlib.crc32(np.asarray(key, dtype=np.int64).tobytes())
        out = []
        for d in range(self.depth):
            h = (h * 1103515245 + 12345 + d) & 0x7FFFFFFF
            out.append(h % self.width)
        return out

    def observe(self, key: Key, mr_len: int = 0) -> int:
        """Count one occurrence; returns the post-increment estimate."""
        cols = self._rows(key)
        for d, c in enumerate(cols):
            self.counts[d, c] += 1
        est = int(min(self.counts[d, c]
                      for d, c in enumerate(cols)))
        self.observed += 1
        hot = self._hot
        if key in hot or len(hot) < self.hot_capacity:
            hot[key] = (est, int(mr_len))
        else:
            # admit only past the coldest current candidate
            coldest = min(hot, key=lambda k: hot[k][0])
            if est > hot[coldest][0]:
                del hot[coldest]
                hot[key] = (est, int(mr_len))
        if self.observed % self.decay_every == 0:
            self.decay()
        return est

    def estimate(self, key: Key) -> int:
        return int(min(self.counts[d, c]
                       for d, c in enumerate(self._rows(key))))

    def decay(self) -> None:
        """Halve every count (recency: old traffic fades geometrically)."""
        self.counts >>= 1
        self._hot = {k: (e >> 1, ln) for k, (e, ln) in self._hot.items()
                     if e >> 1 > 0}
        self.decays += 1

    def hot(self, n: Optional[int] = None) -> List[Tuple[int, int, Key]]:
        """Top candidates as ``(estimate, mr_len, key)``, hottest first."""
        items = [(est, ln, k) for k, (est, ln) in self._hot.items()]
        n = len(items) if n is None else int(n)
        return heapq.nlargest(n, items, key=lambda it: (it[0], -it[1]))

    def stats(self) -> dict:
        return dict(observed=self.observed, decays=self.decays,
                    hot_tracked=len(self._hot),
                    hot_capacity=self.hot_capacity)


def _ewma(prev: Optional[float], x: float, alpha: float) -> float:
    return x if prev is None else prev + alpha * (x - prev)


# --------------------------------------------------------------------- #
# SLO-aware batching
# --------------------------------------------------------------------- #
class SLOBatchController:
    """Per-MR-length batch size + deadline from the queue-wait/compute
    decomposition, targeting ``target_p99_s``.

    The control law, applied per MR-length bucket at most every
    ``interval_s`` seconds (piggybacked on batch completions):

    * **deadline**: the wait a request may be held is the SLO budget
      minus what executing its batch costs —
      ``max_wait = clamp(headroom_frac * (target - exec_ewma), floor,
      target/2)``. Expensive buckets get short deadlines (they cannot
      afford to sit), cheap ones batch longer.
    * **batch size**: multiplicative-increase/decrease within
      ``[min_batch, max_batch]``. Shrink (halve) when the EWMA execute
      time alone eats more than ``shrink_frac`` of the budget; grow
      (double) when execute time is under ``grow_frac`` of the budget
      *and* batches have been flushing full (fill ratio — the
      ``rlc_batcher_batch_fill`` signal — says demand exists).

    Observations arrive via :meth:`observe_batch` (the service calls it
    after every executed batch); the pooled registry reservoirs
    (``rlc_batcher_queue_wait_seconds``, ``rlc_executor_batch_seconds``)
    remain the monitoring view of the same signals and seed the global
    p99 read-back in :meth:`stats`.
    """

    #: bounds and gains — class attrs so tests can subclass/monkeypatch
    WAIT_FLOOR_S = 5e-5
    HEADROOM_FRAC = 0.25
    SHRINK_FRAC = 0.5
    GROW_FRAC = 0.125
    FULL_FILL = 0.9
    ALPHA = 0.3

    def __init__(self, registry, target_p99_s: float, base_batch: int,
                 base_wait_s: float, min_batch: int = 1,
                 max_batch: Optional[int] = None,
                 interval_s: float = 0.05,
                 clock: Callable[[], float] = time.monotonic):
        if target_p99_s <= 0:
            raise ValueError(f"target_p99_s must be > 0, got {target_p99_s}")
        self.registry = registry
        self.target_p99_s = float(target_p99_s)
        self.base_batch = int(base_batch)
        self.base_wait_s = float(base_wait_s)
        self.min_batch = max(1, int(min_batch))
        self.max_batch = int(max_batch if max_batch is not None
                             else 4 * base_batch)
        self.interval_s = float(interval_s)
        self.clock = clock
        self.updates = 0
        # per-mr-len state: current params + EWMAs of exec time and fill
        self._batch: Dict[int, int] = {}
        self._wait: Dict[int, float] = {}
        self._exec_ewma: Dict[int, float] = {}
        self._fill_ewma: Dict[int, float] = {}
        self._last_update: Dict[int, float] = {}
        reg = registry if registry is not None else NULL_OBS.registry
        self._m_batch = reg.gauge(
            "rlc_control_batch_size",
            desc="controller-chosen batch size per MR length",
            labelnames=("mr_len",))
        self._m_wait = reg.gauge(
            "rlc_control_max_wait_seconds",
            desc="controller-chosen deadline per MR length", unit="s",
            labelnames=("mr_len",))
        self._m_updates = reg.counter(
            "rlc_control_updates",
            desc="SLO controller parameter recomputations").labels()

    # -- the scheduler-facing surface ----------------------------------- #
    def params(self, mr_len: int) -> Tuple[int, float]:
        """Current ``(batch_size, max_wait_s)`` for one MR-length bucket."""
        return (self._batch.get(mr_len, self.base_batch),
                self._wait.get(mr_len, self.base_wait_s))

    # -- the service-facing feedback ------------------------------------ #
    def observe_batch(self, mr_len: int, n_real: int, exec_s: float,
                      now: Optional[float] = None) -> None:
        """Feed one executed batch; recompute the bucket's params when
        its update interval elapsed."""
        mr_len = int(mr_len)
        self._exec_ewma[mr_len] = _ewma(
            self._exec_ewma.get(mr_len), float(exec_s), self.ALPHA)
        cap = self._batch.get(mr_len, self.base_batch)
        self._fill_ewma[mr_len] = _ewma(
            self._fill_ewma.get(mr_len), min(n_real / cap, 1.0), self.ALPHA)
        now = self.clock() if now is None else now
        if now - self._last_update.get(mr_len, -1e18) >= self.interval_s:
            self._update(mr_len, now)

    def _update(self, mr_len: int, now: float) -> None:
        target = self.target_p99_s
        exec_s = self._exec_ewma.get(mr_len, 0.0)
        fill = self._fill_ewma.get(mr_len, 0.0)
        cap = self._batch.get(mr_len, self.base_batch)
        if exec_s > self.SHRINK_FRAC * target:
            cap = max(self.min_batch, cap // 2)
        elif exec_s < self.GROW_FRAC * target and fill >= self.FULL_FILL:
            cap = min(self.max_batch, cap * 2)
        wait = min(self.HEADROOM_FRAC * (target - exec_s), target / 2)
        wait = max(wait, self.WAIT_FLOOR_S)
        self._batch[mr_len] = cap
        self._wait[mr_len] = wait
        self._last_update[mr_len] = now
        self.updates += 1
        self._m_batch.set(cap, mr_len=mr_len)
        self._m_wait.set(wait, mr_len=mr_len)
        self._m_updates.inc()

    # -- monitoring ------------------------------------------------------ #
    def _pooled_p99(self, name: str) -> float:
        m = self.registry.get(name) if self.registry is not None else None
        if m is None:
            return 0.0
        samples: List[float] = []
        for _key, cell in m.series():
            samples.extend(cell.reservoir.samples)
        if not samples:
            return 0.0
        return float(np.percentile(np.asarray(samples), 99))

    def stats(self) -> dict:
        return dict(
            target_p99_ms=self.target_p99_s * 1e3,
            updates=self.updates,
            batch_size={ln: b for ln, b in sorted(self._batch.items())},
            max_wait_ms={ln: round(w * 1e3, 4)
                         for ln, w in sorted(self._wait.items())},
            exec_ewma_ms={ln: round(v * 1e3, 4)
                          for ln, v in sorted(self._exec_ewma.items())},
            queue_p99_ms=round(
                self._pooled_p99("rlc_batcher_queue_wait_seconds") * 1e3, 4),
            exec_p99_ms=round(
                self._pooled_p99("rlc_executor_batch_seconds") * 1e3, 4),
        )


# --------------------------------------------------------------------- #
# Admission control + load shedding
# --------------------------------------------------------------------- #
class AdmissionController:
    """Bounded admission queue + back-pressure shedding.

    ``decide`` runs per cache-missed arrival, *before* the scheduler
    takes a slot:

    * pending < bound and back-pressure clear — ``("admit", None)``;
    * soft back-pressure (EWMA queue wait > ``backpressure_s``) — shed
      the arrival only if it is low-priority (colder/deeper than the
      current queue median priority); hot short queries keep flowing
      while the controller drains the backlog. An empty queue has no
      backlog left to drain, so the arrival is admitted: the EWMA moves
      only when batches execute, and shedding every arrival there (as
      ``repro.service.control`` does) would hold it above the threshold,
      and the service shedding, for good;
    * hard bound (pending >= ``max_pending``) — compare the arrival
      against the lowest-priority *queued* request: if the arrival wins,
      ``("evict", victim)`` (the caller sheds the victim and admits the
      arrival); otherwise ``("shed", None)``.

    Priority: ``frequency_estimate / mr_len`` — deepest-MR, coldest-key
    requests are worth the least under overload (most compute for the
    least-repeated key). Every decision lands in
    ``rlc_admission_requests{decision}`` / ``rlc_admission_shed{reason}``,
    and the recovering EWMA means shedding *stops* once queue waits
    drain back under the threshold.
    """

    ALPHA = 0.2

    def __init__(self, registry, sketch: FrequencySketch,
                 max_pending: Optional[int] = None,
                 backpressure_s: Optional[float] = None):
        if max_pending is not None and max_pending < 1:
            raise ValueError(
                f"admission_max_pending must be >= 1, got {max_pending}")
        self.sketch = sketch
        self.max_pending = max_pending
        self.backpressure_s = backpressure_s
        self.wait_ewma: Optional[float] = None
        self.admitted = 0
        self.shed = 0
        reg = registry if registry is not None else NULL_OBS.registry
        dec = reg.counter("rlc_admission_requests",
                          desc="admission decisions",
                          labelnames=("decision",))
        self._m_admit = dec.labels(decision="admitted")
        self._m_shed = dec.labels(decision="shed")
        why = reg.counter("rlc_admission_shed",
                          desc="requests shed, by trigger",
                          labelnames=("reason",))
        self._m_why = {r: why.labels(reason=r)
                       for r in ("queue_full", "backpressure", "evicted")}
        self._m_pending = reg.gauge(
            "rlc_admission_pending",
            desc="scheduler pending depth at the last admission").labels()

    # ------------------------------------------------------------------ #
    def priority(self, key: Key, mr_len: int) -> float:
        """Higher = more worth serving under overload."""
        return self.sketch.estimate(key) / max(int(mr_len), 1)

    def observe_wait(self, wait_s: float) -> None:
        """Feed one request's realized queue wait (admission -> flush) —
        the control-loop reading of ``rlc_batcher_queue_wait_seconds``."""
        self.wait_ewma = _ewma(self.wait_ewma, float(wait_s), self.ALPHA)

    @property
    def backpressured(self) -> bool:
        return (self.backpressure_s is not None
                and self.wait_ewma is not None
                and self.wait_ewma > self.backpressure_s)

    def decide(self, key: Key, mr_len: int, batcher
               ) -> Tuple[str, Optional[object]]:
        """One of ``("admit", None)`` / ``("shed", None)`` /
        ``("evict", victim_request)``; see the class docstring."""
        pending = batcher.pending()
        self._m_pending.set(pending)
        prio = self.priority(key, mr_len)
        if self.max_pending is not None and pending >= self.max_pending:
            victim = batcher.lowest_priority_pending(
                lambda r: self.priority((r.s, r.t, r.mr_id), r.mr_len))
            if victim is not None and prio > self.priority(
                    (victim.s, victim.t, victim.mr_id), victim.mr_len):
                self.shed += 1
                self._m_shed.inc()
                self._m_why["evicted"].inc()
                self._m_admit.inc()
                self.admitted += 1
                return "evict", victim
            self.shed += 1
            self._m_shed.inc()
            self._m_why["queue_full"].inc()
            return "shed", None
        if self.backpressured:
            median = batcher.median_pending_priority(
                lambda r: self.priority((r.s, r.t, r.mr_id), r.mr_len))
            if median is not None and prio <= median:
                self.shed += 1
                self._m_shed.inc()
                self._m_why["backpressure"].inc()
                return "shed", None
        self.admitted += 1
        self._m_admit.inc()
        return "admit", None

    def stats(self) -> dict:
        total = self.admitted + self.shed
        return dict(
            admitted=self.admitted, shed=self.shed,
            shed_ratio=self.shed / total if total else 0.0,
            max_pending=self.max_pending,
            backpressure_ms=(None if self.backpressure_s is None
                             else self.backpressure_s * 1e3),
            wait_ewma_ms=(None if self.wait_ewma is None
                          else round(self.wait_ewma * 1e3, 4)),
            backpressured=self.backpressured,
        )


# --------------------------------------------------------------------- #
# Prioritized cache warming
# --------------------------------------------------------------------- #
class CacheWarmer:
    """Re-materialize the hot Zipf head after an invalidation event.

    ``warm(trigger)`` takes the sketch's top candidates, drops those
    still cached (``cache.peek`` — non-mutating), ranks the rest by
    ``frequency x (1 + miss_rate(mr_len))`` (the per-MR-length hit-rate
    breakdown the cache now exposes: lengths that miss more benefit more
    from pre-materialization), and re-executes them in MR-length-grouped
    chunks through ``execute_fn`` — the *service's* serving path, so a
    sharded stack warms through the same fan-out its queries take.

    Budgets: ``budget_bytes`` caps the cache footprint written
    (``ENTRY_BYTES`` per answer, the LRU's dict-node estimate) and
    ``budget_s`` the wall time; whichever exhausts first stops the pass,
    with the remainder counted as ``skipped_budget``.

    Epoch fencing mirrors the shadow verifier: ``bump_epoch()`` is
    called at the *start* of every ``apply_delta``/``hot_swap``; a warm
    pass checks the epoch before every chunk's ``cache.put`` and aborts
    (``stale`` counter) if a newer mutation landed, so answers computed
    against a dead index never enter the cache.
    """

    #: LRU footprint estimate per cached answer: OrderedDict node + key
    #: tuple of 3 ints + (bool, stamp) value tuple.
    ENTRY_BYTES = 160

    def __init__(self, cache, sketch: FrequencySketch,
                 execute_fn: Callable[[np.ndarray, np.ndarray, np.ndarray,
                                       int], np.ndarray],
                 budget_bytes: int = 1 << 20, budget_s: float = 0.25,
                 chunk: int = 64, obs=None,
                 clock: Callable[[], float] = time.perf_counter):
        self.cache = cache
        self.sketch = sketch
        self.execute_fn = execute_fn
        self.budget_bytes = int(budget_bytes)
        self.budget_s = float(budget_s)
        self.chunk = max(1, int(chunk))
        self.clock = clock
        self.epoch = 0
        self.runs = 0
        self.warmed = 0
        self.obs = obs or NULL_OBS
        reg = self.obs.registry
        self._m_runs = reg.counter("rlc_warm_runs",
                                   desc="warm passes, by trigger",
                                   labelnames=("trigger",))
        keys = reg.counter("rlc_warm_keys",
                           desc="warm candidates, by outcome",
                           labelnames=("outcome",))
        self._m_keys = {o: keys.labels(outcome=o)
                        for o in ("warmed", "already_cached",
                                  "skipped_budget", "stale")}
        self._m_bytes = reg.counter(
            "rlc_warm_bytes",
            desc="estimated cache bytes written by warming",
            unit="By").labels()
        self._m_secs = reg.histogram(
            "rlc_warm_seconds", desc="wall time of one warm pass",
            unit="s").labels()

    def bump_epoch(self) -> int:
        """Invalidate in-flight warm work (call at mutation start)."""
        self.epoch += 1
        return self.epoch

    # ------------------------------------------------------------------ #
    def candidates(self) -> List[Tuple[float, int, Key]]:
        """Uncached hot keys as ``(score, mr_len, key)``, best first."""
        by_len = getattr(self.cache, "hit_rate_by_mr_len", lambda: {})()
        out = []
        for est, mr_len, key in self.sketch.hot():
            if self.cache.peek(key) is not None:
                self._m_keys["already_cached"].inc()
                continue
            miss_rate = 1.0 - by_len.get(mr_len, 0.0)
            out.append((est * (1.0 + miss_rate), mr_len, key))
        out.sort(key=lambda it: (-it[0], it[1]))
        return out

    def warm(self, trigger: str = "manual") -> dict:
        """One budgeted warm pass; returns its accounting dict."""
        t0 = self.clock()
        epoch = self.epoch
        self.runs += 1
        self._m_runs.labels(trigger=trigger).inc()
        cands = self.candidates()
        budget_keys = self.budget_bytes // self.ENTRY_BYTES
        warmed = skipped = stale = 0
        bytes_written = 0
        # group by MR length so warm batches mirror serving batches
        by_len: Dict[int, List[Key]] = {}
        for _score, mr_len, key in cands:
            if warmed + sum(len(v) for v in by_len.values()) >= budget_keys:
                skipped += 1
                continue
            by_len.setdefault(mr_len, []).append(key)
        aborted = False
        for mr_len, keys in sorted(by_len.items()):
            for i in range(0, len(keys), self.chunk):
                part = keys[i:i + self.chunk]
                if aborted or self.clock() - t0 > self.budget_s:
                    skipped += len(part)
                    aborted = aborted or True
                    continue
                s = np.fromiter((k[0] for k in part), np.int32, len(part))
                t = np.fromiter((k[1] for k in part), np.int32, len(part))
                mr = np.fromiter((k[2] for k in part), np.int32, len(part))
                ans = self.execute_fn(s, t, mr, mr_len)
                if self.epoch != epoch:
                    # a mutation landed while we executed: these answers
                    # belong to a dead index — drop them all
                    stale += len(part)
                    aborted = True
                    continue
                for k, a in zip(part, ans):
                    self.cache.put(k, bool(a), mr_len=mr_len)
                warmed += len(part)
                bytes_written += len(part) * self.ENTRY_BYTES
        dt = self.clock() - t0
        self.warmed += warmed
        self._m_keys["warmed"].inc(warmed)
        self._m_keys["skipped_budget"].inc(skipped)
        self._m_keys["stale"].inc(stale)
        self._m_bytes.inc(bytes_written)
        self._m_secs.observe(dt)
        return dict(trigger=trigger, epoch=epoch, warmed=warmed,
                    skipped_budget=skipped, stale=stale,
                    bytes=bytes_written, seconds=dt)

    def stats(self) -> dict:
        return dict(runs=self.runs, warmed=self.warmed, epoch=self.epoch,
                    budget_bytes=self.budget_bytes,
                    budget_s=self.budget_s,
                    sketch=self.sketch.stats())


# --------------------------------------------------------------------- #
# Assembly
# --------------------------------------------------------------------- #
class ControlPlane:
    """The per-service bundle of control loops (each independently
    optional): built by :meth:`from_config`, threaded through the
    services' admission/execute/mutation paths. ``None`` members mean
    that loop is off and its call sites stay branch-cheap."""

    def __init__(self, sketch: Optional[FrequencySketch] = None,
                 slo: Optional[SLOBatchController] = None,
                 admission: Optional[AdmissionController] = None,
                 warmer: Optional[CacheWarmer] = None):
        self.sketch = sketch
        self.slo = slo
        self.admission = admission
        self.warmer = warmer

    @classmethod
    def from_config(cls, config, obs, cache, execute_fn,
                    clock: Callable[[], float]) -> "ControlPlane":
        """Wire the loops a :class:`ServiceConfig` asks for.

        ``target_p99_ms`` enables the SLO batch controller;
        ``admission_max_pending`` / ``admission_backpressure_ms`` the
        admission controller (back-pressure defaults to ``2 x
        target_p99_ms`` when an SLO is set); ``warm_capacity > 0`` the
        warmer. The frequency sketch exists whenever admission or
        warming needs it.
        """
        registry = obs.registry
        target_s = (None if config.target_p99_ms is None
                    else config.target_p99_ms * 1e-3)
        backpressure_s = (config.admission_backpressure_ms * 1e-3
                          if config.admission_backpressure_ms is not None
                          else (2.0 * target_s
                                if target_s is not None else None))
        admission_on = (config.admission_max_pending is not None
                        or (backpressure_s is not None
                            and target_s is not None))
        warming_on = config.warm_capacity > 0
        sketch = None
        if admission_on or warming_on:
            sketch = FrequencySketch(
                hot_capacity=max(config.warm_capacity, 256))
        slo = None
        if target_s is not None:
            slo = SLOBatchController(
                registry, target_s, base_batch=config.batch_size,
                base_wait_s=config.max_wait_ms * 1e-3,
                max_batch=config.max_batch_size,
                interval_s=config.control_interval_s, clock=clock)
        admission = None
        if admission_on:
            admission = AdmissionController(
                registry, sketch,
                max_pending=config.admission_max_pending,
                backpressure_s=backpressure_s)
        warmer = None
        if warming_on:
            warmer = CacheWarmer(
                cache, sketch, execute_fn,
                budget_bytes=config.warm_budget_bytes,
                budget_s=config.warm_budget_s, obs=obs)
        return cls(sketch, slo, admission, warmer)

    @property
    def active(self) -> bool:
        return (self.sketch is not None or self.slo is not None
                or self.admission is not None or self.warmer is not None)

    # -- hooks the serving loop calls ----------------------------------- #
    def observe_admit(self, key: Key, mr_len: int) -> None:
        if self.sketch is not None:
            self.sketch.observe(key, mr_len)

    def on_batch_executed(self, batch, exec_s: float) -> None:
        """Feed one executed batch into the loops (queue waits into the
        admission back-pressure EWMA, exec time into the SLO EWMAs)."""
        if self.admission is not None:
            for r in batch.requests:
                self.admission.observe_wait(
                    max(batch.flushed_at - r.enqueued_at, 0.0))
        if self.slo is not None:
            self.slo.observe_batch(batch.mr_len, batch.n_real, exec_s)

    def bump_epoch(self) -> None:
        if self.warmer is not None:
            self.warmer.bump_epoch()

    def warm(self, trigger: str) -> Optional[dict]:
        if self.warmer is None:
            return None
        return self.warmer.warm(trigger)

    def stats(self) -> Optional[dict]:
        if not self.active:
            return None
        return dict(
            slo=self.slo.stats() if self.slo is not None else None,
            admission=(self.admission.stats()
                       if self.admission is not None else None),
            warmer=self.warmer.stats() if self.warmer is not None else None,
            sketch=(self.sketch.stats()
                    if self.sketch is not None else None),
        )
