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

``ServiceConfig.device`` (default ``"cuda"``) decides where the work
runs. On a CUDA device the build's ``auto`` backend is the ``cuda`` one
(frontier kernel), the padded :class:`DeviceIndex` lives on the card and
every batch goes through the merge-join kernel. A failed device transfer
or kernel launch raises: the service never quietly serves from the CPU
or a plain version in place of the card. ``device="cpu"`` keeps the
reference's host build (``auto`` = ``numpy``) and backend chain.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.build import BuildStats, build_rlc_index_with_stats
from repro_torch.core.device_index import DeviceIndex
from repro_torch.core.devices import resolve_device
from repro_torch.core.graph import LabeledGraph
from repro_torch.core.minimum_repeat import LabelSeq, mr_id_space
from repro_torch.core.rlc_index import RLCIndex
from repro_torch.obs import Observability

from .answer import Answer
from .cache import ResultCache
from .executor import BatchExecutor
from .expr import PathExpression, canonicalize, parse_expression
from .scheduler import Batch, MicroBatcher

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
    #: metrics registry on/off (counters and histograms, default-on —
    #: cheap). Off replaces every cell with the null registry.
    telemetry: bool = True
    #: fraction of query_batch calls that record spans (0 = tracing off)
    trace_sample_rate: float = 0.0
    #: span buffer bound; past it spans are dropped and counted
    trace_max_events: int = 50_000
    #: injectable scheduler clock (e.g. a virtual clock for replaying a
    #: timed arrival trace); None = time.monotonic
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


class RLCService:
    def __init__(self, graph: LabeledGraph, index: RLCIndex,
                 config: ServiceConfig,
                 build_stats: Optional[BuildStats] = None,
                 obs: Optional[Observability] = None):
        self.graph = graph
        self.index = index
        self.config = config
        self.build_stats = build_stats   # None when the index was adopted
        self.obs = obs or Observability(
            enabled=config.telemetry,
            trace_sample_rate=config.trace_sample_rate,
            max_trace_events=config.trace_max_events)
        _check_device(config)
        self.mr_ids = mr_id_space(graph.num_labels, config.k)
        self._id_to_mr: List[LabelSeq] = [
            mr for mr, _ in sorted(self.mr_ids.items(), key=lambda kv: kv[1])]
        self.frozen = index.freeze(self.mr_ids)
        self.device_index = (
            DeviceIndex.from_frozen(self.frozen, self.mr_ids,
                                    device=config.device)
            if config.use_device else None)
        self.executor = BatchExecutor(
            index, self.frozen, self.device_index, self._id_to_mr,
            backend=config.backend, obs=self.obs)
        self.cache = ResultCache(config.cache_capacity,
                                 ttl_s=config.cache_ttl_s, obs=self.obs)
        clock = config.clock if config.clock is not None else time.monotonic
        self.batcher = MicroBatcher(
            config.batch_size, config.max_wait_ms * 1e-3,
            clock=clock, obs=self.obs)
        self.queries_served = 0

    # ------------------------------------------------------------------ #
    @classmethod
    def build(cls, graph: LabeledGraph,
              config: Optional[ServiceConfig] = None,
              index: Optional[RLCIndex] = None) -> "RLCService":
        """Build (or adopt) the RLC index for ``graph`` and start serving.
        Builds go through the configured :mod:`repro_torch.build`
        backend; ``auto`` on a CUDA device, and ``cuda`` by name, run the
        build's device waves on ``config.device``."""
        config = config or ServiceConfig()
        dev = _check_device(config)
        obs = Observability(enabled=config.telemetry,
                            trace_sample_rate=config.trace_sample_rate,
                            max_trace_events=config.trace_max_events)
        build_stats = None
        if index is None:
            backend = config.build_backend
            if backend == "auto" and dev.type == "cuda":
                backend = "cuda"
            kw = {"device": dev} if backend == "cuda" else {}
            index, build_stats = build_rlc_index_with_stats(
                graph, config.k, backend=backend,
                observer=obs.build_observer(), **kw)
        elif index.k != config.k:
            raise ValueError(
                f"index built with k={index.k} but config.k={config.k}")
        return cls(graph, index, config, build_stats=build_stats, obs=obs)

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
        """
        answers: List[Optional[Answer]] = [None] * len(queries)
        # scheduler req_id -> output positions (> 1 when duplicate in-flight
        # queries were coalesced onto one request)
        slot: Dict[int, List[int]] = {}
        # one sampled trace per query_batch call; None on the unsampled
        # hot path, so every span below is a single comparison away
        tr = self.obs.tracer.maybe_trace()
        for i, (s, t, constraint) in enumerate(queries):
            t0 = tr.tracer._now() if tr is not None else 0.0
            s, t, mr_id, mr_len = self._admit(s, t, constraint)
            hit = self.cache.get((s, t, mr_id), mr_len=mr_len)
            if tr is not None:
                tr.add(f"admit[{i}]", t0, tr.tracer._now() - t0,
                       cat="admission", mr_len=mr_len,
                       cache="hit" if hit is not None else "miss")
            if hit is not None:
                answers[i] = Answer(hit, "cache_hit")
                continue
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
                "share the MicroBatcher with a concurrent caller")
        self.queries_served += len(queries)
        return answers

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
                vals, backend = self.executor.execute(
                    batch.s, batch.t, batch.mr_id, batch.n_real, trace=tr)
        else:
            vals, backend = self.executor.execute(
                batch.s, batch.t, batch.mr_id, batch.n_real)
        # a virtual scheduler clock advances by the measured execute time
        # so replay accumulates realistic queue waits
        advance = getattr(self.batcher.clock, "advance", None)
        if advance is not None:
            advance(time.perf_counter() - t0)
        for req, val in zip(batch.requests, vals):
            val = bool(val)
            self.cache.put((req.s, req.t, req.mr_id), val,
                           mr_len=batch.mr_len)
            ans = Answer(val, "computed", backend)
            for pos in slot.get(req.req_id, ()):
                answers[pos] = ans

    # -- observability --------------------------------------------------- #
    def stats(self) -> dict:
        """Serving counters: cache, scheduler, executor (per-backend
        latency summaries and the fallback count), index and build."""
        return dict(
            queries_served=self.queries_served,
            cache=self.cache.stats.as_dict(),
            scheduler=dict(
                batches_full=self.batcher.batches_full,
                batches_deadline=self.batcher.batches_deadline,
                batches_drain=self.batcher.batches_drain,
                coalesced=self.batcher.coalesced,
                pending=self.batcher.pending()),
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
            build=(self.build_stats.as_dict()
                   if self.build_stats is not None else None),
            telemetry=dict(enabled=self.obs.enabled,
                           tracing=self.obs.tracer.stats()),
        )
