"""LRU result cache for RLC query answers.

Keys are ``(s, t, mr_id)`` triples; values are booleans — *both* positive
and negative answers are cached (a false reachability answer is exactly as
expensive to recompute as a true one; the index is immutable between
rebuilds/deltas, so staleness is driven by explicit invalidation, not
time — but an optional TTL is available for deployments that prefer
bounded staleness over precise invalidation). Hit/miss/eviction counters
feed the service stats and the Zipf-workload benchmark.

Graphs became mutable with the delta-build engine
(:mod:`repro_torch.build.delta`): a delta changes the answers of exactly the
queries whose source row (``L_out(s)``) or target row (``L_in(t)``) went
dirty, so :meth:`ResultCache.invalidate_rows` evicts only those keys and
every other cached answer survives.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

from repro_torch.obs import NULL_OBS
from repro_torch.obs.metrics import Reservoir

Key = Tuple[int, int, int]  # (s, t, mr_id)


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    expirations: int = 0
    invalidations: int = 0
    # per-MR-length (hits, misses) — the warming-priority input: MR
    # lengths that miss more benefit more from pre-materialization
    by_mr_len: Dict[int, Tuple[int, int]] = field(default_factory=dict)

    @property
    def lookups(self) -> int:
        # expirations are lookups too (an entry was found but stale) —
        # they dilute the hit rate without counting as plain misses
        return self.hits + self.misses + self.expirations

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def record(self, mr_len: Optional[int], hit: bool) -> None:
        if mr_len is None:
            return
        h, m = self.by_mr_len.get(mr_len, (0, 0))
        self.by_mr_len[mr_len] = (h + 1, m) if hit else (h, m + 1)

    def hit_rate_by_mr_len(self) -> Dict[int, float]:
        return {ln: h / (h + m) if h + m else 0.0
                for ln, (h, m) in sorted(self.by_mr_len.items())}

    def as_dict(self) -> dict:
        return dict(hits=self.hits, misses=self.misses,
                    evictions=self.evictions,
                    expirations=self.expirations,
                    invalidations=self.invalidations,
                    hit_rate=self.hit_rate,
                    hit_rate_by_mr_len=self.hit_rate_by_mr_len())


class ResultCache:
    """Bounded LRU mapping ``(s, t, mr_id) -> bool``.

    ``ttl_s``: optional time-to-live; an entry older than this counts as
    a miss (and is evicted) on lookup. ``clock`` is injectable for
    tests.
    """

    def __init__(self, capacity: int, ttl_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic, obs=None):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        if ttl_s is not None and ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0, got {ttl_s}")
        self.capacity = capacity
        self.ttl_s = ttl_s
        self.clock = clock
        self._d: "OrderedDict[Key, Tuple[bool, float]]" = OrderedDict()
        self.stats = CacheStats()
        # registry cells mirroring CacheStats (the registry survives
        # service-internal resets and feeds the exporters)
        self.obs = obs or NULL_OBS
        reg = self.obs.registry
        look = reg.counter("rlc_cache_lookups",
                           desc="result-cache lookups by outcome",
                           labelnames=("outcome",))
        self._m_hit = look.labels(outcome="hit")
        self._m_miss = look.labels(outcome="miss")
        self._m_expired = look.labels(outcome="expired")
        self._m_evict = reg.counter(
            "rlc_cache_evictions",
            desc="LRU capacity evictions").labels()
        self._m_inval = reg.counter(
            "rlc_cache_invalidations",
            desc="entries dropped by invalidate_rows/clear").labels()
        self._m_size = reg.gauge("rlc_cache_size",
                                 desc="entries currently cached").labels()
        self._m_mr = reg.counter(
            "rlc_cache_mr_lookups",
            desc="result-cache lookups by outcome and MR length",
            labelnames=("outcome", "mr_len"))
        self._m_evict_age = reg.histogram(
            "rlc_cache_eviction_age_seconds",
            desc="entry age (insert -> LRU eviction) at capacity "
                 "eviction", unit="s").labels()
        # standalone reservoir so eviction_age_summary works with the
        # null registry too (warming reads it without telemetry on)
        self.eviction_ages = Reservoir()

    def __len__(self) -> int:
        return len(self._d)

    def get(self, key: Key, mr_len: Optional[int] = None) -> Optional[bool]:
        """Answer if cached and fresh (refreshing recency), else ``None``."""
        if self.capacity == 0:
            self.stats.misses += 1
            self.stats.record(mr_len, hit=False)
            self._m_miss.inc()
            return None
        try:
            val, stamp = self._d[key]
        except KeyError:
            self.stats.misses += 1
            self.stats.record(mr_len, hit=False)
            self._m_miss.inc()
            if mr_len is not None:
                self._m_mr.labels(outcome="miss", mr_len=mr_len).inc()
            return None
        if self.ttl_s is not None and self.clock() - stamp >= self.ttl_s:
            del self._d[key]
            # expired is its own outcome: the lookup found a (stale)
            # entry, so it is neither a hit nor a plain miss — it still
            # dilutes hit_rate via CacheStats.lookups
            self.stats.expirations += 1
            self.stats.record(mr_len, hit=False)
            self._m_expired.inc()
            if mr_len is not None:
                self._m_mr.labels(outcome="expired", mr_len=mr_len).inc()
            return None
        self._d.move_to_end(key)
        self.stats.hits += 1
        self.stats.record(mr_len, hit=True)
        self._m_hit.inc()
        if mr_len is not None:
            self._m_mr.labels(outcome="hit", mr_len=mr_len).inc()
        return val

    def peek(self, key: Key) -> Optional[bool]:
        """Non-mutating probe: the cached answer if present and fresh,
        else ``None``. No recency refresh, no stats, no counters —
        EXPLAIN's cache-disposition probe must not perturb the serving
        LRU or the hit-rate series it reports on."""
        if self.capacity == 0:
            return None
        pair = self._d.get(key)
        if pair is None:
            return None
        val, stamp = pair
        if self.ttl_s is not None and self.clock() - stamp >= self.ttl_s:
            return None
        return val

    def put(self, key: Key, value: bool,
            mr_len: Optional[int] = None) -> None:
        if self.capacity == 0:
            return
        if key in self._d:
            self._d.move_to_end(key)
        now = self.clock()
        self._d[key] = (bool(value), now)
        while len(self._d) > self.capacity:
            _k, (_v, stamp) = self._d.popitem(last=False)
            self.stats.evictions += 1
            self._m_evict.inc()
            age = max(now - stamp, 0.0)
            self.eviction_ages.add(age)
            self._m_evict_age.observe(age)
        self._m_size.set(len(self._d))

    def hit_rate_by_mr_len(self) -> Dict[int, float]:
        """Per-MR-length hit rates — the warmer's priority input."""
        return self.stats.hit_rate_by_mr_len()

    def eviction_age_summary(self) -> dict:
        """Percentiles of entry age at LRU eviction: a low p50 means the
        capacity is churning entries before they can be re-hit."""
        return self.eviction_ages.summary()

    def invalidate_rows(self, dirty_s=None, dirty_t=None) -> int:
        """Evict every key whose source row is in ``dirty_s`` or target
        row is in ``dirty_t`` (containers supporting ``in``); returns the
        eviction count. The targeted flavor of :meth:`clear` for delta
        updates: untouched keys keep serving."""
        dirty_s = dirty_s if dirty_s is not None else ()
        dirty_t = dirty_t if dirty_t is not None else ()
        doomed = [k for k in self._d
                  if k[0] in dirty_s or k[1] in dirty_t]
        for k in doomed:
            del self._d[k]
        self.stats.invalidations += len(doomed)
        self._m_inval.inc(len(doomed))
        self._m_size.set(len(self._d))
        return len(doomed)

    def clear(self) -> None:
        self.stats.invalidations += len(self._d)
        self._m_inval.inc(len(self._d))
        self._d.clear()
        self._m_size.set(0)
