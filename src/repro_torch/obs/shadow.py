"""Continuous shadow verification: sampled oracle re-execution.

"Bit-identical in tests" is a build-time claim; the shadow verifier
turns it into a *continuously monitored serving invariant*. A configured
fraction of answered queries (``ServiceConfig.shadow_sample_rate``) is
banked on the hot path — one RNG draw and a bounded deque append — and
re-executed later against the BiBFS product-automaton oracle
(:func:`repro_torch.core.baselines.bibfs_rlc`), off the serving path:

* synchronously at the drain points (``service.drain_shadow()``,
  ``telemetry_snapshot()``), or
* on a daemon thread (``ServiceConfig.shadow_background``) that chips
  away at the pending queue between queries.

Every check lands in the ``rlc_shadow_checked`` / ``rlc_shadow_divergent``
counters; a divergence additionally captures a full EXPLAIN bundle
(:meth:`RLCService.explain` — backend, cache disposition, witness, plus
the oracle's answer) so the first diverging query arrives with its own
debugging record attached (see "debugging a divergence" in the JAX
package's ``src/repro/obs/README.md``).

Mutations invalidate pending work: ``apply_delta`` / ``hot_swap`` call
:meth:`ShadowVerifier.discard_pending`, because an answer that was
correct against the pre-delta graph may legitimately differ from the
post-delta oracle — verifying across the mutation would manufacture
false divergences.
"""
from __future__ import annotations

import random
import threading
from collections import deque
from typing import Deque, List, Optional, Tuple

__all__ = ["ShadowVerifier", "attach_shadow"]


class ShadowVerifier:
    """Sampling re-verifier bound to one serving stack.

    ``service`` is duck-typed: it must expose ``graph``, ``_id_to_mr``,
    and ``explain(s, t, constraint)`` — both :class:`RLCService` and
    :class:`ShardedRLCService` qualify.
    """

    def __init__(self, service, sample_rate: float,
                 max_pending: int = 1024, max_bundles: int = 8,
                 seed: int = 0, obs=None):
        if not (0.0 <= sample_rate <= 1.0):
            raise ValueError(
                f"sample_rate must be in [0, 1], got {sample_rate}")
        self.service = service
        self.sample_rate = float(sample_rate)
        self.max_pending = int(max_pending)
        self.max_bundles = int(max_bundles)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        # (epoch, s, t, mr_id, served_answer)
        self._pending: Deque[Tuple[int, int, int, int, bool]] = deque()
        self._epoch = 0
        self.offered = 0
        self.checked = 0
        self.divergent = 0
        self.dropped = 0
        self.discarded = 0
        self.divergences: List[dict] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        from repro_torch.obs import NULL_OBS
        reg = (obs or NULL_OBS).registry
        self._m_offered = reg.counter(
            "rlc_shadow_offered",
            desc="answered queries sampled into the shadow queue").labels()
        self._m_checked = reg.counter(
            "rlc_shadow_checked",
            desc="shadow queries re-executed against the BiBFS "
                 "oracle").labels()
        self._m_divergent = reg.counter(
            "rlc_shadow_divergent",
            desc="shadow checks where the served answer disagreed with "
                 "the oracle").labels()
        self._m_dropped = reg.counter(
            "rlc_shadow_dropped",
            desc="sampled queries dropped because the pending queue was "
                 "full").labels()
        self._m_pending = reg.gauge(
            "rlc_shadow_pending",
            desc="shadow checks awaiting verification").labels()

    # -- hot path ------------------------------------------------------- #
    def offer(self, s: int, t: int, mr_id: int, answer: bool) -> bool:
        """Maybe bank one answered query for later verification.

        Cheap enough for the serve loop: one RNG draw, and on a sampled
        query a locked deque append (bounded — the oldest pending entry
        is dropped, and counted, rather than growing without bound)."""
        if self._rng.random() >= self.sample_rate:
            return False
        with self._lock:
            self.offered += 1
            self._m_offered.inc()
            if len(self._pending) >= self.max_pending:
                self._pending.popleft()
                self.dropped += 1
                self._m_dropped.inc()
            self._pending.append(
                (self._epoch, int(s), int(t), int(mr_id), bool(answer)))
            self._m_pending.set(len(self._pending))
        return True

    # -- mutation fence ------------------------------------------------- #
    def discard_pending(self) -> int:
        """Drop every pending check and advance the epoch — called around
        graph/index mutations so stale offers never verify against a
        graph they were not served from."""
        with self._lock:
            n = len(self._pending)
            self._pending.clear()
            self._epoch += 1
            self.discarded += n
            self._m_pending.set(0)
        return n

    # -- verification (off the hot path) -------------------------------- #
    def run_pending(self, limit: Optional[int] = None) -> int:
        """Verify up to ``limit`` pending checks (all when None);
        returns how many ran."""
        from repro_torch.core.baselines import bibfs_rlc
        ran = 0
        while limit is None or ran < limit:
            with self._lock:
                if not self._pending:
                    break
                epoch, s, t, mr_id, answer = self._pending.popleft()
                self._m_pending.set(len(self._pending))
                stale = epoch != self._epoch
            if stale:
                continue
            mr = self.service._id_to_mr[mr_id]
            oracle = bool(bibfs_rlc(self.service.graph, s, t, mr))
            self.checked += 1
            self._m_checked.inc()
            if oracle != answer:
                self.divergent += 1
                self._m_divergent.inc()
                self._capture(s, t, mr, answer, oracle)
            ran += 1
        return ran

    def drain(self) -> int:
        """Verify everything pending now (the synchronous drain point)."""
        return self.run_pending(None)

    def _capture(self, s, t, mr, answer, oracle) -> None:
        if len(self.divergences) >= self.max_bundles:
            return
        try:
            bundle = self.service.explain(s, t, mr)
        except Exception as e:  # noqa: BLE001 — the capture must not
            # crash verification; record what we know instead
            bundle = dict(s=s, t=t, mr=list(mr), error=repr(e))
        bundle["served_answer"] = bool(answer)
        bundle["oracle"] = bool(oracle)
        self.divergences.append(bundle)

    # -- background mode ------------------------------------------------ #
    def start(self, interval_s: float = 0.02, chunk: int = 64) -> None:
        """Verify on a daemon thread: every ``interval_s`` it runs up to
        ``chunk`` pending checks, keeping oracle work off every caller."""
        if self._thread is not None:
            raise RuntimeError("shadow verifier already running")

        def loop():
            while not self._stop.wait(interval_s):
                self.run_pending(chunk)

        self._stop.clear()
        self._thread = threading.Thread(
            target=loop, name="shadow-verifier", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        thread, self._thread = self._thread, None
        if thread is None:
            return
        self._stop.set()
        thread.join()

    @property
    def running(self) -> bool:
        return self._thread is not None

    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        with self._lock:
            pending = len(self._pending)
        return dict(sample_rate=self.sample_rate, offered=self.offered,
                    checked=self.checked, divergent=self.divergent,
                    dropped=self.dropped, discarded=self.discarded,
                    pending=pending, divergences=len(self.divergences),
                    background=self.running)


def attach_shadow(service) -> Optional[ShadowVerifier]:
    """Construct (and maybe start) the verifier a service's config asks
    for; ``None`` when ``shadow_sample_rate`` is 0 so the serve loop
    stays branch-predictable."""
    cfg = service.config
    if cfg.shadow_sample_rate <= 0.0:
        return None
    sv = ShadowVerifier(service, cfg.shadow_sample_rate,
                        max_pending=cfg.shadow_max_pending,
                        obs=service.obs)
    if cfg.shadow_background:
        sv.start()
    return sv
