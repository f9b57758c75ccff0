"""The :class:`RLCService` facade: build -> freeze -> device -> serve.

Wires the serving path together::

    g = erdos_renyi(500, 4.0, 4)
    svc = RLCService.build(g, ServiceConfig(k=2, batch_size=16))
    svc.query(3, 17, "(0 1)+")                  # single, through the cache
    svc.query_batch([(s, t, "(a b)+"), ...])    # micro-batched

Admission: each query's constraint is parsed/validated/canonicalized to a
minimum repeat (:mod:`repro_torch.service.expr`), checked against the
result cache, and — on miss — handed to the micro-batcher. Flushed batches
run on the executor; answers backfill the cache. ``query_batch`` is
synchronous: it drains the scheduler before returning, so every admitted
query is answered in admission order.

Beyond the synchronous path the facade offers the rest of the
single-host service: ``explain`` (witness bundles), ``apply_delta``
(incremental rebuilds, :mod:`repro_torch.build.delta`), async admission
(``start``/``submit``/``close``, :mod:`repro_torch.service.lifecycle`),
the control plane (SLO batching, admission with ``SHED``, cache warming,
:mod:`repro_torch.service.control`), shadow verification, the index
audit, and telemetry exports; ``stats()`` is a
``repro.service.stats/1`` document.

``ServiceConfig.device`` (default ``"cuda"``) decides where the work
runs. On a CUDA device the build's ``auto`` backend is the ``cuda`` one
(frontier kernel) for the first build and for every delta build, the
padded :class:`DeviceIndex` lives on the card and every batch goes
through the merge-join kernel. A failed device transfer, kernel launch
or device-row gather raises, also after a delta and on the async
engine's thread (where the batch's futures carry the error): the service
never quietly serves or explains from the CPU or a plain version in
place of the card. ``device="cpu"`` keeps the reference's host build
(``auto`` = ``numpy``) and backend chain.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.build import BuildStats, get_backend
from repro_torch.core.device_index import DeviceIndex
from repro_torch.core.devices import resolve_device
from repro_torch.core.graph import LabeledGraph
from repro_torch.core.minimum_repeat import LabelSeq, mr_id_space
from repro_torch.core.rlc_index import RLCIndex
from repro_torch.obs import Observability
from repro_torch.obs.shadow import attach_shadow

from .answer import SHED, Answer
from .cache import ResultCache
from .control import ControlPlane
from .executor import BatchExecutor
from .expr import PathExpression, canonicalize, parse_expression
from .scheduler import Batch, MicroBatcher, Request

Constraint = Union[str, Sequence[int], PathExpression]
Query = Tuple[int, int, Constraint]


@dataclass
class ServiceConfig:
    k: int = 2
    batch_size: int = 32
    max_wait_ms: float = 2.0
    cache_capacity: int = 4096
    cache_ttl_s: Optional[float] = None   # optional TTL on cached answers
    #: "auto" | "cuda" | "sorted" | "numpy" | "python"; on a CUDA device
    #: only "auto" and "cuda" (the kernel) are accepted
    backend: str = "auto"
    #: repro_torch.build backend; "auto" is "cuda" on a CUDA device and
    #: "numpy" on the CPU
    build_backend: str = "auto"
    #: build the padded DeviceIndex layout; False (host CSR serving) only
    #: with device="cpu"
    use_device: bool = True
    label_names: Optional[Dict[str, int]] = None  # e.g. {"knows": 0, ...}
    #: incremental-build budget for apply_delta (see DeltaBuilder);
    #: 1.0 disables the full-rebuild fallback
    delta_fallback_frac: float = 0.25
    #: metrics registry on/off (counters and histograms, default-on —
    #: cheap). Off replaces every cell with the null registry.
    telemetry: bool = True
    #: fraction of query_batch calls that record spans (0 = tracing off)
    trace_sample_rate: float = 0.0
    #: span buffer bound; past it spans are dropped and counted
    trace_max_events: int = 50_000
    #: fraction of answered queries re-executed against the BiBFS oracle
    #: by the shadow verifier (0 = shadow verification off)
    shadow_sample_rate: float = 0.0
    #: shadow queue bound; past it the oldest pending check is dropped
    shadow_max_pending: int = 1024
    #: run shadow checks on a background thread (else they run when
    #: drained explicitly or at snapshot time)
    shadow_background: bool = False
    # -- control plane (repro_torch.service.control) --------------------- #
    #: per-query p99 latency SLO; setting it turns on the SLO batch
    #: controller (per-MR-length batch sizes + deadlines replace the
    #: fixed batch_size/max_wait_ms above)
    target_p99_ms: Optional[float] = None
    #: minimum time between controller parameter recomputations
    control_interval_s: float = 0.05
    #: ceiling for controller-grown batch sizes (None -> 4 * batch_size)
    max_batch_size: Optional[int] = None
    #: hard admission bound: scheduler pending depth past which arrivals
    #: are shed (or evict a lower-priority queued request); None = off
    admission_max_pending: Optional[int] = None
    #: soft back-pressure: shed low-priority arrivals while the EWMA
    #: queue wait exceeds this (None -> 2 * target_p99_ms when the SLO
    #: controller is on, else off)
    admission_backpressure_ms: Optional[float] = None
    #: hot-key candidates tracked for warming; > 0 turns the prioritized
    #: cache warmer on (it runs after apply_delta)
    warm_capacity: int = 0
    #: warming budgets: estimated cache bytes written / wall seconds
    warm_budget_bytes: int = 1 << 20
    warm_budget_s: float = 0.25
    #: injectable scheduler clock (e.g. control.VirtualClock for open-loop
    #: overload replay); None = time.monotonic
    clock: Optional[Callable[[], float]] = None
    #: where the device layout, the build's device waves and every served
    #: batch run
    device: str = "cuda"


def _check_device(config: ServiceConfig):
    """``config.device`` as a torch device; raises where it asks for a card
    that is absent, or for host-only serving on a card."""
    if not config.use_device and torch.device(config.device).type != "cpu":
        raise ValueError("use_device=False serves from the host CSR; it "
                         f"needs device='cpu', not {config.device!r}")
    return resolve_device(config.device)


def _backend_on(name: str, dev: torch.device) -> Tuple[str, dict]:
    """A build backend name and its keyword arguments on ``dev``: ``auto``
    is the ``cuda`` backend on a CUDA device, and ``cuda`` runs its waves
    on ``dev``."""
    if name == "auto" and dev.type == "cuda":
        name = "cuda"
    return name, ({"device": dev} if name == "cuda" else {})


class RLCService:
    def __init__(self, graph: LabeledGraph, index: RLCIndex,
                 config: ServiceConfig,
                 build_stats: Optional[BuildStats] = None,
                 obs: Optional[Observability] = None):
        self.graph = graph
        self.index = index
        self.config = config
        self.build_stats = build_stats   # None when the index was adopted
        #: the build backend's ``last_build_info`` (the ``parallel``
        #: backend's mode, DAG, epochs, makespan, executor); empty when
        #: the backend keeps none or the index was adopted
        self.build_info: Dict = {}
        # one telemetry context for the whole stack (passed in by build()
        # so offline build phases land in the same registry)
        self.obs = obs or Observability(
            enabled=config.telemetry,
            trace_sample_rate=config.trace_sample_rate,
            max_trace_events=config.trace_max_events)
        self.device = _check_device(config)
        self.mr_ids = mr_id_space(graph.num_labels, config.k)
        self._id_to_mr: List[LabelSeq] = [
            mr for mr, _ in sorted(self.mr_ids.items(), key=lambda kv: kv[1])]
        self.frozen = index.freeze(self.mr_ids)
        self.device_index = self._make_device_index()
        self.executor = BatchExecutor(
            index, self.frozen, self.device_index, self._id_to_mr,
            backend=config.backend, obs=self.obs)
        self.cache = ResultCache(config.cache_capacity,
                                 ttl_s=config.cache_ttl_s, obs=self.obs)
        clock = config.clock if config.clock is not None else time.monotonic
        self.ctl = ControlPlane.from_config(
            config, self.obs, self.cache, self._warm_execute, clock)
        self.batcher = MicroBatcher(
            config.batch_size, config.max_wait_ms * 1e-3,
            clock=clock, obs=self.obs,
            params_fn=(self.ctl.slo.params
                       if self.ctl.slo is not None else None))
        self.queries_served = 0
        self.queries_shed = 0
        self.deltas_applied = 0
        self._delta = None          # lazy DeltaBuilder (apply_delta)
        self._engine = None         # lazy AsyncEngine (start()/submit())
        self._closed = False
        self._last_audit = None     # most recent audit_report() document
        self._m_explain = self.obs.registry.counter(
            "rlc_explain_requests",
            desc="EXPLAIN bundles produced, by witness kind",
            labelnames=("kind",))
        self._shadow = attach_shadow(self)

    # ------------------------------------------------------------------ #
    @classmethod
    def build(cls, graph: LabeledGraph,
              config: Optional[ServiceConfig] = None,
              index: Optional[RLCIndex] = None) -> "RLCService":
        """Build (or adopt) the RLC index for ``graph`` and start serving.
        Builds go through the configured :mod:`repro_torch.build`
        backend; ``auto`` on a CUDA device, and ``cuda`` by name, run the
        build's device waves on ``config.device``. ``parallel`` builds on
        the host's worker processes and then serves on
        ``config.device``; its ``last_build_info`` lands in
        :attr:`build_info`."""
        config = config or ServiceConfig()
        dev = _check_device(config)
        obs = Observability(enabled=config.telemetry,
                            trace_sample_rate=config.trace_sample_rate,
                            max_trace_events=config.trace_max_events)
        build_stats = None
        build_info: Dict = {}
        if index is None:
            name, kw = _backend_on(config.build_backend, dev)
            backend = get_backend(name, **kw).set_observer(
                obs.build_observer())
            index, build_stats = backend.build(graph, config.k)
            build_info = dict(getattr(backend, "last_build_info", {}))
        elif index.k != config.k:
            raise ValueError(
                f"index built with k={index.k} but config.k={config.k}")
        svc = cls(graph, index, config, build_stats=build_stats, obs=obs)
        svc.build_info = build_info
        return svc

    # -- admission ------------------------------------------------------ #
    def parse(self, constraint: Constraint) -> PathExpression:
        if isinstance(constraint, PathExpression):
            return constraint
        if isinstance(constraint, str):
            return parse_expression(
                constraint, num_labels=self.graph.num_labels,
                k=self.config.k, label_names=self.config.label_names)
        return canonicalize(constraint, num_labels=self.graph.num_labels,
                            k=self.config.k)

    def _admit(self, s: int, t: int, constraint: Constraint
               ) -> Tuple[int, int, int, int]:
        n = self.graph.num_vertices
        s, t = int(s), int(t)
        if not (0 <= s < n and 0 <= t < n):
            raise ValueError(
                f"vertex ids ({s}, {t}) out of range [0, {n})")
        expr = self.parse(constraint)
        return s, t, self.mr_ids[expr.mr], len(expr.mr)

    # -- serving -------------------------------------------------------- #
    def query(self, s: int, t: int, constraint: Constraint) -> Answer:
        """Synchronous single query (cache -> batch-of-one on miss)."""
        return self.query_batch([(s, t, constraint)])[0]

    def query_batch(self, queries: Sequence[Query],
                    now: Optional[float] = None) -> List[Answer]:
        """Answer ``queries`` in order through cache + scheduler + executor.

        Each answer is a typed :class:`Answer` (value + disposition +
        backend attribution); ``bool(ans)`` / ``ans == True`` behave like
        the bare boolean. ``now``: optional admission timestamp (for
        replaying a timed arrival trace); defaults to the scheduler's
        clock per admission.

        With admission control on (``admission_max_pending`` /
        ``admission_backpressure_ms``), a dropped query's answer is the
        :data:`SHED` sentinel — never a fabricated boolean; check
        ``ans is SHED`` or ``ans.shed`` (SHED raises on ``bool()``).

        When the async engine is running (:meth:`start`), the scheduler
        is ticker-driven and shared with :meth:`submit` callers, so this
        method bridges through the engine instead of draining the
        batcher itself — same answers, no lost-flush race.
        """
        if self._engine is not None and self._engine.active:
            futures = [self.submit(s, t, c) for (s, t, c) in queries]
            self._engine.flush()
            return [f.result(timeout=60.0) for f in futures]
        answers: List[Optional[Answer]] = [None] * len(queries)
        # canonical (s, t, mr_id) per position, kept only when the shadow
        # verifier wants to sample answered queries afterwards
        keys: Optional[List[Tuple[int, int, int]]] = (
            [None] * len(queries) if self._shadow is not None else None)
        # scheduler req_id -> output positions (> 1 when duplicate in-flight
        # queries were coalesced onto one request)
        slot: Dict[int, List[int]] = {}
        # one sampled trace per query_batch call; None on the unsampled
        # hot path, so every span below is a single comparison away
        tr = self.obs.tracer.maybe_trace()
        admission = self.ctl.admission
        for i, (s, t, constraint) in enumerate(queries):
            t0 = tr.tracer._now() if tr is not None else 0.0
            s, t, mr_id, mr_len = self._admit(s, t, constraint)
            if keys is not None:
                keys[i] = (s, t, mr_id)
            # the frequency sketch counts every arrival (hits included)
            self.ctl.observe_admit((s, t, mr_id), mr_len)
            hit = self.cache.get((s, t, mr_id), mr_len=mr_len)
            if tr is not None:
                tr.add(f"admit[{i}]", t0, tr.tracer._now() - t0,
                       cat="admission", mr_len=mr_len,
                       cache="hit" if hit is not None else "miss")
            if hit is not None:
                answers[i] = Answer(hit, "cache_hit")
                continue
            if admission is not None:
                decision, victim = admission.decide(
                    (s, t, mr_id), mr_len, self.batcher)
                if decision == "shed":
                    answers[i] = SHED
                    continue
                if decision == "evict" and self.batcher.evict(victim):
                    # the victim's submitters get the explicit SHED
                    for pos in slot.pop(victim.req_id, ()):
                        answers[pos] = SHED
            req, ready = self.batcher.submit(s, t, mr_id, mr_len, now)
            slot.setdefault(req.req_id, []).append(i)
            for batch in ready:
                self._execute(batch, answers, slot, tr)
        for batch in self.batcher.drain():
            self._execute(batch, answers, slot, tr)
        if any(a is None for a in answers):
            # a batch was flushed outside this call — fail loud rather
            # than coerce the hole to False
            raise RuntimeError(
                "query_batch lost answers to an external flush; do not "
                "share a ticker-driven or concurrent MicroBatcher with "
                "synchronous query_batch")
        self.queries_served += len(queries)
        out: List[Answer] = answers
        self.queries_shed += sum(1 for a in out if a.shed)
        if keys is not None:
            for (s, t, mr_id), ans in zip(keys, out):
                if not ans.shed:        # no answer to verify
                    self._shadow.offer(s, t, mr_id, ans.value)
        return out

    def _run_batch(self, batch: Batch, tr=None):
        """Produce one answer per real request, plus per-request backend
        attribution: ``(values, backends)``."""
        ans, backend = self.executor.execute(
            batch.s, batch.t, batch.mr_id, batch.n_real, trace=tr)
        return ans, [backend] * len(batch.requests)

    def _warm_execute(self, s: np.ndarray, t: np.ndarray,
                      mr_id: np.ndarray, mr_len: int) -> np.ndarray:
        """Cache-warmer execution hook: answer hot keys through the same
        batch path queries take, bypassing the scheduler — warming is off
        the serving critical path by construction."""
        reqs = [Request(-1 - i, int(s[i]), int(t[i]), int(mr_id[i]),
                        int(mr_len)) for i in range(len(s))]
        batch = Batch(reqs, np.asarray(s, np.int32),
                      np.asarray(t, np.int32),
                      np.asarray(mr_id, np.int32), int(mr_len), "warm")
        vals, _backends = self._run_batch(batch)
        return np.asarray(vals, dtype=bool)

    def _execute(self, batch: Batch, answers: List[Optional[Answer]],
                 slot: Dict[int, List[int]], tr=None) -> None:
        t0 = time.perf_counter()
        if tr is not None:
            # queue wait is measured on the scheduler's clock; only the
            # duration crosses into the tracer's timeline
            oldest = min(r.enqueued_at for r in batch.requests)
            tr.add_ending_now("queue_wait",
                              max(batch.flushed_at - oldest, 0.0),
                              cat="batcher", reason=batch.reason,
                              mr_len=batch.mr_len, n=batch.n_real)
            with tr.span("execute", cat="service",
                         n=batch.n_real, mr_len=batch.mr_len):
                vals, backends = self._run_batch(batch, tr)
        else:
            vals, backends = self._run_batch(batch)
        exec_s = time.perf_counter() - t0
        # feed the control loops (SLO EWMAs, back-pressure queue waits);
        # a virtual scheduler clock also advances by the measured execute
        # time so open-loop replay accumulates realistic queue waits
        self.ctl.on_batch_executed(batch, exec_s)
        advance = getattr(self.batcher.clock, "advance", None)
        if advance is not None:
            advance(exec_s)
        for req, val, backend in zip(batch.requests, vals, backends):
            val = bool(val)
            self.cache.put((req.s, req.t, req.mr_id), val,
                           mr_len=batch.mr_len)
            ans = Answer(val,
                         "degraded" if backend == "bibfs" else "computed",
                         backend)
            for pos in slot.get(req.req_id, ()):
                answers[pos] = ans

    # -- EXPLAIN / provenance -------------------------------------------- #
    def explain(self, s: int, t: int, constraint: Constraint,
                max_hubs: int = 8) -> dict:
        """Answer ``(s, t, constraint)`` with its full derivation.

        The bundle carries the witness the serving join path would
        produce (``repro.obs.witness/1``: Case-2 entries / Case-1 join
        hubs for positives, the ruling-out fact for negatives), which
        backend explained it, and the *disposition* the query would get
        right now — whether the answer is sitting in the result cache
        and whether an identical key is in-flight in the micro-batcher.
        Read-only: no cache mutation, no batch slot, no served-query
        accounting; when a trace is sampled it lands as one ``explain``
        span. On a CUDA layout the witness comes from the rows on the
        card, and a failure there raises.
        """
        tr = self.obs.tracer.maybe_trace()
        t0 = tr.tracer._now() if tr is not None else 0.0
        s, t, mr_id, _mr_len = self._admit(s, t, constraint)
        key = (s, t, mr_id)
        bundle = self._explain_admitted(s, t, mr_id, max_hubs=max_hubs)
        cached = self.cache.peek(key)
        bundle.update(
            s=s, t=t, mr_id=mr_id, mr=list(self._id_to_mr[mr_id]),
            cache=dict(
                disposition="hit" if cached is not None else "miss",
                answer=cached),
            coalesced=self.batcher.is_inflight(key))
        kind = bundle["witness"].get("kind", "unknown")
        if tr is not None:
            tr.add("explain", t0, tr.tracer._now() - t0, cat="explain",
                   answer=bundle["answer"], backend=bundle["backend"],
                   kind=kind)
        self._m_explain.labels(kind=kind).inc()
        return bundle

    def _explain_admitted(self, s: int, t: int, mr_id: int,
                          max_hubs: int = 8) -> dict:
        """Backend dispatch for one admitted query (the executor's
        chain)."""
        ws, backend = self.executor.explain_batch(
            np.array([s]), np.array([t]), np.array([mr_id]),
            max_hubs=max_hubs)
        return dict(answer=ws[0]["answer"], backend=backend,
                    witness=ws[0])

    # -- incremental graph mutation -------------------------------------- #
    def _delta_backend(self) -> Tuple[str, dict]:
        """The delta builder's backend and its keyword arguments: ``auto``
        is the ``cuda`` backend on a CUDA device and ``numpy`` on the CPU;
        ``python`` (no phase runner to replay through) maps to ``numpy``."""
        b = self.config.build_backend
        if b in ("python", "parallel") or (
                b == "auto" and self.device.type != "cuda"):
            b = "numpy"
        return _backend_on(b, self.device)

    def _make_device_index(self):
        """The padded layout of ``self.frozen`` on the service's device
        (None for host-only serving). A failure raises on every device."""
        if not self.config.use_device:
            return None
        return DeviceIndex.from_frozen(self.frozen, self.mr_ids,
                                       device=self.device)

    def _ensure_delta_builder(self):
        """Bootstrap the incremental builder on first use: one traced
        full (re)build of the current graph. If the serving index was
        *adopted* pre-built, the whole serving state is resynced to the
        rebuilt index — the later partial re-freezes patch rows against
        the builder's entry sets, so serving a different vintage would
        leave stale entries in rows the builder never marks dirty."""
        if self._delta is None:
            from repro_torch.build.delta import DeltaBuilder
            adopted = self.build_stats is None
            backend, kw = self._delta_backend()
            db = DeltaBuilder(
                self.graph, self.config.k, backend=backend,
                fallback_frac=self.config.delta_fallback_frac,
                obs=self.obs, **kw)
            db.full()
            if adopted:
                self._adopt_rebuilt_index(db)
            self._delta = db
        return self._delta

    def _adopt_rebuilt_index(self, db) -> None:
        """Swap the full serving state onto the delta builder's index
        (bootstrap over an adopted index; see _ensure_delta_builder)."""
        self.index = db.index
        self.build_stats = db.stats
        self.frozen = self.index.freeze(self.mr_ids)
        self.device_index = self._make_device_index()
        self.executor.index = self.index
        self.executor.frozen = self.frozen
        self.executor.device_index = self.device_index
        self.cache.clear()

    def apply_delta(self, delta) -> dict:
        """Apply a :class:`repro_torch.core.graph.GraphDelta` end-to-end.

        Incrementally re-derives the index (:mod:`repro_torch.build.delta`),
        re-freezes only the dirty/re-sorted row ranges, rebuilds the
        device layout, and evicts exactly the cached answers whose
        ``(s, t)`` rows went dirty — everything else keeps serving from
        cache. Returns a summary dict (delta accounting + evictions).

        Safe while the async engine runs: the old layout stays referenced
        by a batch that is still joining on it, and every launch is
        ordered on the device's current stream, so no tensor is freed
        under a kernel that reads it.
        """
        # fence in-flight warm work first: answers computed against the
        # pre-delta index must never land in the post-delta cache
        self.ctl.bump_epoch()
        db = self._ensure_delta_builder()
        res = db.apply(delta)
        self.graph = db.graph
        self.index = db.index
        self.build_stats = res.stats
        if res.fallback:
            self.frozen = self.index.freeze(self.mr_ids)
        else:
            self.frozen = self.frozen.patch_rows(
                self.index, self.mr_ids,
                set(res.dirty_out.tolist()) | set(res.resort_out.tolist()),
                set(res.dirty_in.tolist()) | set(res.resort_in.tolist()))
        self.device_index = self._make_device_index()
        # the executor keeps its latency recorders; only the index
        # references move. Repoint BEFORE invalidating the cache: a
        # concurrent ticker flush that executed on the old index must not
        # be able to re-cache a stale answer for a just-evicted key.
        self.executor.index = self.index
        self.executor.frozen = self.frozen
        self.executor.device_index = self.device_index
        if res.fallback:
            evicted = len(self.cache)
            self.cache.clear()
        else:
            evicted = self.cache.invalidate_rows(
                dirty_s=set(res.dirty_out.tolist()),
                dirty_t=set(res.dirty_in.tolist()))
        self.deltas_applied += 1
        if self._shadow is not None:
            # pending checks were served by the pre-delta index; the
            # oracle now walks the mutated graph, so they'd diverge
            # spuriously
            self._shadow.discard_pending()
        # re-materialize the hot Zipf head against the new index, under
        # the warmer's byte/time budget (no-op when warming is off)
        warm = self.ctl.warm("apply_delta")
        return dict(delta=res.as_dict(), cache_evicted=evicted,
                    dirty_out=res.dirty_out.tolist(),
                    dirty_in=res.dirty_in.tolist(),
                    deltas_applied=self.deltas_applied,
                    warm=warm)

    # -- lifecycle -------------------------------------------------------- #
    def start(self, tick_interval_s: float = 0.002) -> "RLCService":
        """Bring up async admission: after ``start()``, :meth:`submit`
        returns immediately with a future and batches execute on a
        background thread (deadline-ticker driven). Idempotent; returns
        ``self`` so ``with svc.start():`` reads naturally. Synchronous
        :meth:`query` / :meth:`query_batch` keep working (they bridge
        through the engine)."""
        if self._closed:
            raise RuntimeError("service is closed")
        if self._engine is None:
            from .lifecycle import AsyncEngine
            self._engine = AsyncEngine(self, tick_interval_s)
        self._engine.start()
        return self

    def submit(self, s: int, t: int, constraint: Constraint,
               now: Optional[float] = None):
        """Non-blocking query: admission happens now, execution happens
        on the engine thread; returns a
        :class:`concurrent.futures.Future` resolving to an
        :class:`Answer` (or :data:`SHED` under admission control), or
        carrying the batch's exception when its execution failed.
        Starts the engine on first use."""
        if self._engine is None or not self._engine.active:
            self.start()
        return self._engine.submit(s, t, constraint, now)

    def close(self) -> None:
        """Idempotent shutdown: drain + stop the async engine (resolving
        every in-flight future), stop the background deadline ticker and
        the shadow verifier. Safe to call any number of times; the
        service can keep answering synchronous queries afterwards."""
        if self._closed:
            return
        self._closed = True
        if self._engine is not None:
            self._engine.close()
        self.batcher.stop_ticker()
        if self._shadow is not None:
            self._shadow.stop()

    def __enter__(self) -> "RLCService":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    # -- deprecated lifecycle entry points -------------------------------- #
    def start_ticker(self, on_batch=None,
                     interval_s: Optional[float] = None) -> None:
        """Deprecated: use :meth:`start`. Kept as a shim for callers
        that drove the scheduler ticker through the service; ignores
        ``on_batch`` and brings up the unified async engine instead."""
        import warnings
        warnings.warn(
            "RLCService.start_ticker() is deprecated; use start() — "
            "the unified lifecycle runs the ticker and an execution "
            "thread for you", DeprecationWarning, stacklevel=2)
        self.start(tick_interval_s=interval_s
                   if interval_s is not None else 0.002)

    def stop_ticker(self) -> None:
        """Deprecated: use :meth:`close` (or the context manager)."""
        import warnings
        warnings.warn(
            "RLCService.stop_ticker() is deprecated; use close()",
            DeprecationWarning, stacklevel=2)
        self.close()

    # -- observability --------------------------------------------------- #
    def audit_report(self, sample: int = 128, seed: int = 0) -> dict:
        """Walk the serving index and return a ``repro.obs.audit/1``
        health report (entry histograms, redundancy/soundness probes,
        byte accounting, drift fingerprint). The report is kept for the
        next :meth:`telemetry_snapshot` and its headline numbers are
        banked as ``rlc_audit_*`` gauges."""
        from repro_torch.obs.audit import audit_index, bank_audit_metrics
        rep = audit_index(self.frozen, self._id_to_mr, index=self.index,
                          graph=self.graph,
                          device_index=self.device_index,
                          sample=sample, seed=seed)
        self._last_audit = rep
        bank_audit_metrics(self.obs.registry, rep)
        return rep

    def drain_shadow(self) -> int:
        """Run every pending shadow check now (foreground); returns the
        number checked. No-op (0) when shadow verification is off."""
        return self._shadow.drain() if self._shadow is not None else 0

    def telemetry_snapshot(self, extra: Optional[dict] = None) -> dict:
        """Versioned registry+tracer snapshot (``repro.obs/1``)."""
        ex = dict(extra) if extra else {}
        ex.setdefault("queries_served", self.queries_served)
        ex.setdefault("deltas_applied", self.deltas_applied)
        if self._shadow is not None:
            self._shadow.drain()
            ex.setdefault("shadow", self._shadow.stats())
        if self._last_audit is not None:
            ex.setdefault("audit", self._last_audit)
        return self.obs.snapshot(extra=ex)

    def chrome_trace(self) -> dict:
        """Recorded spans as a Chrome ``trace_event`` JSON object."""
        return self.obs.chrome_trace()

    def prometheus(self) -> str:
        """The registry in Prometheus text exposition format."""
        return self.obs.prometheus()

    def stats(self) -> dict:
        """Versioned observability snapshot (``repro.service.stats/1``;
        see :mod:`repro_torch.service.stats`, validate with
        :func:`repro_torch.service.stats.validate_stats`).

        Every subsystem is one sub-dict — ``executor`` holds both the
        per-backend latency summaries and the fallback count; ``index``
        names the layout's device (None for host-only serving).
        """
        from .stats import base_stats
        out = base_stats(self, "single", "local")
        out.update(
            executor=dict(
                backends=self.executor.stats(),
                fallbacks=self.executor.fallbacks),
            index=dict(
                entries=self.index.num_entries(),
                size_bytes=self.index.size_bytes(),
                num_mrs=len(self.mr_ids),
                device=(str(self.device_index.device)
                        if self.device_index is not None else None),
                row_len=(self.device_index.row_len
                         if self.device_index is not None else None)),
        )
        return out
