"""The :class:`ShardedRLCService` facade: plan -> slice -> replicate ->
route -> scatter/gather.

Drop-in for :class:`repro_torch.service.RLCService` (same ``query`` /
``query_batch`` / ``submit`` / ``stats`` surface, same admission pipeline
of parser -> result cache -> micro-batcher), but flushed batches fan out
across shard replica sets instead of one executor::

    g = erdos_renyi(2000, 4.0, 4)
    svc = ShardedRLCService.build(
        g, ShardedServiceConfig(k=2, num_shards=4, num_replicas=2))
    svc.query(3, 1700, "(0 1)+")
    svc.hot_swap(graph=updated_g)       # rolling rebuild under traffic

Placement: every shard gets an explicit device. With ``config.device`` on
CUDA and more than one card visible, shards are dealt round-robin over
``cuda:0 .. cuda:{n-1}``; otherwise every shard lives on
``config.device`` (one card: all shards share ``cuda:0``). Each shard's
layout holds only its row window, and its same-shard sub-batches go
through the merge-join kernel with ``row_base = lo``. A layout that
cannot be built, placed or joined raises: the service never serves a
CUDA shard from the host in its place. ``transport="rpc"`` serves from
the host in worker processes, so it takes ``device="cpu"``.

Swaps (:meth:`~ShardedRLCService.hot_swap`,
:meth:`~ShardedRLCService.apply_delta`) build every touched shard's new
state beside the serving one, then publish all shards at once under the
fan-out's generation gate: every batch runs on one generation.

See :mod:`repro_torch.service.sharded` for the routing invariant and
:mod:`repro_torch.service.sharded.fanout` for the scatter/gather
mechanics.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.build import BuildStats, build_rlc_index_with_stats
from repro_torch.core.graph import LabeledGraph
from repro_torch.core.minimum_repeat import LabelSeq, mr_id_space
from repro_torch.core.rlc_index import FrozenRLCIndex, RLCIndex
from repro_torch.obs import Observability
from repro_torch.obs.shadow import attach_shadow

from ..cache import ResultCache
from ..control import ControlPlane
from ..scheduler import Batch, MicroBatcher
from ..service import RLCService, ServiceConfig, _backend_on, _check_device
from .fanout import ScatterGatherExecutor
from .plan import ShardPlan, plan_shards
from .replica import ShardReplicaSet, build_device_layout, build_replica
from .router import TwoSidedRouter


@dataclass
class ShardedServiceConfig(ServiceConfig):
    num_shards: int = 2
    num_replicas: int = 1
    #: "inproc" — shard replicas live in this process, each shard's
    #: layout on its device; "rpc" — one shard-host *worker process* per
    #: (shard, replica), each holding only its shard slice on the host,
    #: driven over the message-based RPC transport
    #: (:mod:`repro_torch.service.rpc`); it needs ``device="cpu"``
    transport: str = "inproc"
    #: per-request RPC timeout (rpc transport only)
    rpc_call_timeout_s: float = 120.0
    #: worker fleet boot timeout (rpc transport only)
    rpc_start_timeout_s: float = 60.0


def _shard_devices(num_shards: int, device: torch.device
                   ) -> List[torch.device]:
    """Each shard's device: round-robin over the visible cards when
    ``device`` is CUDA and more than one card is visible, else
    ``device`` for every shard."""
    count = torch.cuda.device_count() if device.type == "cuda" else 0
    if count > 1:
        return [torch.device("cuda", i % count) for i in range(num_shards)]
    return [device] * num_shards


def _serving_device(config: ShardedServiceConfig) -> torch.device:
    """``config.device`` as checked by :func:`_check_device`, after the
    transport: ``rpc`` serves from the host, so it takes only the CPU."""
    if config.transport not in ("inproc", "rpc"):
        raise ValueError(
            f"transport must be 'inproc' or 'rpc', got {config.transport!r}")
    if config.transport == "rpc" and torch.device(config.device).type != "cpu":
        raise ValueError(
            "transport='rpc' serves from the host in worker processes; "
            f"pass device='cpu' (got device={config.device!r})")
    return _check_device(config)


class ShardedRLCService:
    def __init__(self, graph: LabeledGraph, index: RLCIndex,
                 config: ShardedServiceConfig,
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
        self.device = _serving_device(config)
        self.mr_ids = mr_id_space(graph.num_labels, config.k)
        self._id_to_mr: List[LabelSeq] = [
            mr for mr, _ in sorted(self.mr_ids.items(), key=lambda kv: kv[1])]
        self.frozen = index.freeze(self.mr_ids)
        self.plan: ShardPlan = plan_shards(self.frozen, config.num_shards)
        self.generation = 0
        self.cluster = None         # RpcShardCluster under transport="rpc"
        self.shards: List[ShardReplicaSet] = []
        self.router = TwoSidedRouter(self.plan, obs=self.obs)
        if config.transport == "rpc":
            # multi-process serving: one shard-host worker process per
            # (shard, replica), each serving its slice from the host;
            # this process keeps only the global frozen (for EXPLAIN,
            # audit and rebuilds)
            from ..rpc import RpcShardCluster
            from .fanout import RpcScatterGatherExecutor
            self.cluster = RpcShardCluster(
                self.plan.ranges(), config.num_replicas, self._id_to_mr,
                obs=self.obs, start_timeout_s=config.rpc_start_timeout_s,
                call_timeout_s=config.rpc_call_timeout_s)
            self.cluster.start(self.frozen, generation=self.generation)
            self.fanout = RpcScatterGatherExecutor(
                self.cluster, self.router, config.batch_size,
                obs=self.obs, graph=graph, id_to_mr=self._id_to_mr)
        else:
            devices = _shard_devices(config.num_shards, self.device)
            for sid in range(config.num_shards):
                lo, hi = self.plan.range(sid)
                sl = self.frozen.slice_rows(lo, hi)
                layout = (build_device_layout(sl, self.mr_ids,
                                              rows=(lo, hi),
                                              device=devices[sid])
                          if config.use_device else None)
                replicas = [
                    build_replica(sid, rid, self.generation, sl,
                                  self.mr_ids, index, self._id_to_mr,
                                  backend=config.backend,
                                  use_device=config.use_device,
                                  device=devices[sid], rows=(lo, hi),
                                  shared_device_index=layout, obs=self.obs)
                    for rid in range(config.num_replicas)]
                self.shards.append(
                    ShardReplicaSet(sid, lo, hi, replicas, obs=self.obs))
            self.fanout = ScatterGatherExecutor(
                self.shards, self.router, config.batch_size, obs=self.obs,
                graph=graph, id_to_mr=self._id_to_mr)
        self.cache = ResultCache(config.cache_capacity,
                                 ttl_s=config.cache_ttl_s, obs=self.obs)
        clock = (config.clock if config.clock is not None
                 else time.monotonic)
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
        self._swap_lock = threading.RLock()   # one hot_swap/delta at a time
        self._last_audit = None     # most recent audit_report() document
        self._m_explain = self.obs.registry.counter(
            "rlc_explain_requests",
            desc="EXPLAIN bundles produced, by witness kind",
            labelnames=("kind",))
        self._shadow = attach_shadow(self)

    # ------------------------------------------------------------------ #
    @classmethod
    def build(cls, graph: LabeledGraph,
              config: Optional[ShardedServiceConfig] = None,
              index: Optional[RLCIndex] = None) -> "ShardedRLCService":
        """Build (or adopt) the RLC index for ``graph``, shard it, serve.
        Builds go through the configured :mod:`repro_torch.build`
        backend; ``auto`` on a CUDA device is the ``cuda`` backend."""
        config = config or ShardedServiceConfig()
        dev = _serving_device(config)
        obs = Observability(enabled=config.telemetry,
                            trace_sample_rate=config.trace_sample_rate,
                            max_trace_events=config.trace_max_events)
        build_stats = None
        if index is None:
            backend, kw = _backend_on(config.build_backend, dev)
            index, build_stats = build_rlc_index_with_stats(
                graph, config.k, backend=backend,
                observer=obs.build_observer(), **kw)
        elif index.k != config.k:
            raise ValueError(
                f"index built with k={index.k} but config.k={config.k}")
        return cls(graph, index, config, build_stats=build_stats, obs=obs)

    # -- admission + serving loop (shared with RLCService) --------------- #
    # Borrowed unbound: the whole parser -> cache -> micro-batcher ->
    # backfill loop is identical; only _run_batch (scatter/gather fan-out
    # instead of one executor) differs.
    parse = RLCService.parse
    _admit = RLCService._admit
    query = RLCService.query
    query_batch = RLCService.query_batch
    _execute = RLCService._execute
    _warm_execute = RLCService._warm_execute
    _delta_backend = RLCService._delta_backend
    _ensure_delta_builder = RLCService._ensure_delta_builder
    explain = RLCService.explain
    drain_shadow = RLCService.drain_shadow
    telemetry_snapshot = RLCService.telemetry_snapshot
    chrome_trace = RLCService.chrome_trace
    prometheus = RLCService.prometheus
    # one lifecycle on both facades (one AsyncEngine implementation)
    start = RLCService.start
    submit = RLCService.submit
    start_ticker = RLCService.start_ticker
    stop_ticker = RLCService.stop_ticker
    __enter__ = RLCService.__enter__
    __exit__ = RLCService.__exit__

    def close(self) -> None:
        """Same contract as :meth:`RLCService.close`, plus the worker
        fleet: under ``transport="rpc"`` the shard-host processes get a
        graceful shutdown after the engine drains."""
        already = self._closed
        RLCService.close(self)
        if not already and self.cluster is not None:
            self.cluster.close()

    def _adopt_rebuilt_index(self, db) -> None:
        """Sharded flavour of the bootstrap-over-adopted-index resync:
        a full hot swap onto the builder's index, which also clears the
        cache (hot_swap nulls the builder reference it knows nothing
        about; the caller reassigns it right after this returns)."""
        self.hot_swap(index=db.index)
        self.build_stats = db.stats

    def _run_batch(self, batch: Batch, tr=None):
        return self.fanout.execute(batch, trace=tr)

    def _explain_admitted(self, s: int, t: int, mr_id: int,
                          max_hubs: int = 8) -> dict:
        """Sharded backend dispatch for one admitted query, with the
        routing hops attached: which shards own ``s``/``t``, whether the
        join ran on one shard or joined a shipped out-row digest against
        the remote in-row, and what that digest weighed. Uses
        :meth:`ShardPlan.shard_of` directly (not the router) so EXPLAIN
        never skews the routing counters."""
        from repro_torch.obs.explain import explain_rows
        # one generation for both sides, as a batch sees it
        with self.fanout.gate.read():
            shard_s = self.plan.shard_of(s)
            shard_t = self.plan.shard_of(t)
            route = dict(shard_s=shard_s, shard_t=shard_t, home=shard_t)
            if self.cluster is not None:
                # rpc transport: serving rows live in worker processes, but
                # the controller's global frozen holds byte-identical rows
                # (workers were initialized from its slices) — EXPLAIN joins
                # those without a round-trip, off the routing counters
                oh, om = self.frozen.row_out(s)
                ih, im = self.frozen.row_in(t)
                w = explain_rows(oh, om, ih, im, s, t, mr_id,
                                 aid=self.frozen.aid, max_hubs=max_hubs)
                if shard_s == shard_t:
                    route.update(path="local")
                else:
                    route.update(path="remote", digest_entries=int(len(oh)),
                                 digest_bytes=int(oh.nbytes + om.nbytes))
                return dict(answer=w["answer"], backend="rpc:frozen",
                            witness=w, route=route)
            if shard_s == shard_t:
                rep = self.shards[shard_s].acquire()
                ws, backend = rep.executor.explain_batch(
                    np.array([s]), np.array([t]), np.array([mr_id]),
                    max_hubs=max_hubs)
                w = ws[0]
                route.update(path="local")
            else:
                # cross-shard: the serving path ships s's out-row digest to
                # the in-side owner (two-sided routing); the witness joins
                # the exact rows that digest join would see
                src = self.shards[shard_s].acquire()
                dst = self.shards[shard_t].acquire()
                oh, om = src.frozen.row_out(s)
                ih, im = dst.frozen.row_in(t)
                w = explain_rows(oh, om, ih, im, s, t, mr_id,
                                 aid=src.frozen.aid, max_hubs=max_hubs)
                backend = "digest"
                route.update(path="remote", digest_entries=int(len(oh)),
                             digest_bytes=int(oh.nbytes + om.nbytes))
            return dict(answer=w["answer"], backend=backend, witness=w,
                        route=route)

    # -- incremental graph mutation -------------------------------------- #
    def _owns(self, refreeze: Optional[np.ndarray], lo: int, hi: int
              ) -> bool:
        """Whether rows ``[lo, hi)`` hold a re-frozen row (all do after a
        fallback, ``refreeze=None``)."""
        return refreeze is None or bool(np.searchsorted(refreeze, lo)
                                        < np.searchsorted(refreeze, hi))

    def _swap_shards(self, slices: Dict[int, FrozenRLCIndex],
                     index: RLCIndex, frozen: FrozenRLCIndex,
                     graph: LabeledGraph,
                     build_backend: Optional[str]) -> None:
        """Serve ``index``/``frozen``/``graph`` at ``self.generation``:
        each shard in ``slices`` gets its new slice. Every such shard's
        new state is built first, beside the serving one (RPC workers
        stage it); then all of it is published at once under the
        fan-out's generation gate, so no batch and no cross-shard join
        ever mixes two generations. Shards not in ``slices`` keep their
        replicas (their rows are unchanged), but the python backend must
        see the new dict index."""
        gen = self.generation
        fresh = {}
        if self.cluster is not None:
            for sid, sl in slices.items():
                self.cluster.stage(sid, gen, sl)
        else:
            fresh = {sid: self.shards[sid].prepare(
                         gen, sl, self.mr_ids, index, self._id_to_mr,
                         backend=self.config.backend,
                         use_device=self.config.use_device)
                     for sid, sl in slices.items()}
        with self.fanout.gate.write():
            if self.cluster is not None:
                self.cluster.commit(gen)
            for rs in self.shards:
                if rs.shard_id in fresh:
                    rs.publish(fresh[rs.shard_id], build_backend)
                else:
                    for replica in rs.replicas:
                        replica.executor.index = index
            self.index, self.frozen = index, frozen
            self.graph = self.fanout.graph = graph

    def apply_delta(self, delta) -> dict:
        """Apply a :class:`repro_torch.core.graph.GraphDelta` across the
        shards.

        The delta is re-derived incrementally once (the in-process global
        build; on a card through the ``cuda`` delta backend), then routed
        to its owning shards: only shards whose row range intersects the
        dirty rows get fresh slices, built beside the serving ones and
        published with the rest of the new state at once (see
        :meth:`_swap_shards`); untouched shards keep their replicas and
        only repoint the python backend's index. Cached answers are
        evicted only for dirty ``(s, t)`` rows.
        """
        with self._swap_lock:
            # fence in-flight warm work before any state moves (see
            # RLCService.apply_delta)
            self.ctl.bump_epoch()
            db = self._ensure_delta_builder()
            res = db.apply(delta)
            self.build_stats = res.stats
            if res.fallback:
                frozen = db.index.freeze(self.mr_ids)
                refreeze = None           # every shard swaps
            else:
                dirty_out = set(res.dirty_out.tolist())
                dirty_in = set(res.dirty_in.tolist())
                # patch under the *stable* aid every shard already serves
                # with (Algorithm 1 only needs one consistent hub order,
                # and cross-shard digest joins mix row vintages) — so
                # re-sorted mover rows need no re-freeze, only
                # content-dirty rows do
                frozen = self.frozen.patch_rows(
                    db.index, self.mr_ids, dirty_out, dirty_in,
                    aid=self.frozen.aid)
                refreeze = np.unique(np.concatenate(
                    [res.dirty_out, res.dirty_in]))
            self.generation += 1
            touched = [sid for sid, (lo, hi) in
                       enumerate(self.plan.ranges())
                       if self._owns(refreeze, lo, hi)]
            self._swap_shards(
                {sid: frozen.slice_rows(*self.plan.range(sid))
                 for sid in touched},
                db.index, frozen, db.graph,
                f"delta[{self._delta_backend()[0]}]")
            # invalidate only after every shard serves the new state (see
            # RLCService.apply_delta on the ticker-flush ordering)
            if res.fallback:
                evicted = len(self.cache)
                self.cache.clear()
            else:
                evicted = self.cache.invalidate_rows(dirty_s=dirty_out,
                                                     dirty_t=dirty_in)
            self.deltas_applied += 1
            if self._shadow is not None:
                # pre-delta answers may legitimately differ from the
                # mutated graph's oracle (see RLCService.apply_delta)
                self._shadow.discard_pending()
        warm = self.ctl.warm("apply_delta")
        return dict(delta=res.as_dict(), shards_touched=touched,
                    dirty_out=res.dirty_out.tolist(),
                    dirty_in=res.dirty_in.tolist(),
                    cache_evicted=evicted, generation=self.generation,
                    warm=warm)

    # -- hot swap -------------------------------------------------------- #
    def hot_swap(self, index: Optional[RLCIndex] = None,
                 graph: Optional[LabeledGraph] = None,
                 build_backend: Optional[str] = None) -> int:
        """Atomically replace every shard's frozen/device slice.

        Rebuild the index from ``graph`` (same vertex set — the plan's
        ranges keep their meaning), or adopt a pre-built ``index``, or —
        with neither — re-freeze the current index (a no-op refresh).
        Rebuilds run on ``build_backend`` (default: the configured
        ``config.build_backend``; ``auto`` is the ``cuda`` backend on a
        CUDA device). Every shard's new replicas are built while the old
        ones serve, then all are published at once (see
        :meth:`_swap_shards`): batches in flight finish on the old
        generation, later ones run on the new. The result cache is
        cleared — cached answers may be stale against the new index.
        Returns the new generation number.
        """
        build_backend = build_backend or self.config.build_backend
        with self._swap_lock:
            # a swap invalidates any in-flight warm pass the same way a
            # delta does — its answers were computed against the outgoing
            # index
            self.ctl.bump_epoch()
            rebuilt = False
            if index is not None:
                # adopted pre-built index: we didn't build it, don't
                # claim to
                self.build_stats = None
            if graph is not None:
                if (graph.num_vertices != self.graph.num_vertices
                        or graph.num_labels != self.graph.num_labels):
                    raise ValueError(
                        "hot_swap requires an identical vertex/label space "
                        f"(got V={graph.num_vertices} "
                        f"L={graph.num_labels}, serving "
                        f"V={self.graph.num_vertices} "
                        f"L={self.graph.num_labels})")
                if index is None:
                    backend, kw = _backend_on(build_backend, self.device)
                    index, self.build_stats = build_rlc_index_with_stats(
                        graph, self.config.k, backend=backend,
                        observer=self.obs.build_observer("swap"), **kw)
                    rebuilt = True
            index = self.index if index is None else index
            if index.k != self.config.k:
                raise ValueError(f"index built with k={index.k} but "
                                 f"config.k={self.config.k}")
            if index.num_vertices != self.plan.num_vertices:
                raise ValueError(
                    f"index has {index.num_vertices} vertices but the "
                    f"shard plan covers {self.plan.num_vertices}")
            frozen = index.freeze(self.mr_ids)
            self.generation += 1
            self._swap_shards(
                {sid: frozen.slice_rows(lo, hi)
                 for sid, (lo, hi) in enumerate(self.plan.ranges())},
                index, frozen, self.graph if graph is None else graph,
                build_backend if rebuilt else None)
            self.cache.clear()
            if self._shadow is not None:
                # answers served pre-swap verified against the old state
                self._shadow.discard_pending()
            # a cached DeltaBuilder is pinned to the pre-swap graph/index
            # — drop it so the next apply_delta re-bootstraps from the
            # swapped state instead of silently reverting the swap
            self._delta = None
        # refill the hot Zipf head against the swapped index (the clear
        # above just cold-started the whole cache); no-op when warming
        # is off
        self.ctl.warm("hot_swap")
        return self.generation

    # -- observability --------------------------------------------------- #
    def audit_report(self, sample: int = 128, seed: int = 0) -> dict:
        """Global-index audit plus a per-shard byte/entry breakdown —
        the serving state a sharded stack actually holds is the shard
        slices, so the global report carries one row per shard naming
        its frozen/device allocation and entry count."""
        from repro_torch.obs.audit import (audit_index, bank_audit_metrics,
                                           device_nbytes, frozen_nbytes)
        rep = audit_index(self.frozen, self._id_to_mr, index=self.index,
                          graph=self.graph, device_index=None,
                          sample=sample, seed=seed)
        shards = []
        for rs in self.shards:
            r0 = rs.replicas[0]
            shards.append(dict(
                shard=rs.shard_id, lo=int(rs.lo), hi=int(rs.hi),
                generation=rs.generation,
                replicas=len(rs.replicas),
                entries=int(r0.frozen.num_entries()),
                frozen_bytes=frozen_nbytes(r0.frozen),
                device_bytes=device_nbytes(r0.device_index)))
        rep["shards"] = shards
        dev = sum(s["device_bytes"] or 0 for s in shards)
        rep["bytes"]["device"] = dev if any(
            s["device_bytes"] is not None for s in shards) else None
        self._last_audit = rep
        bank_audit_metrics(self.obs.registry, rep)
        return rep

    def stats(self) -> dict:
        """The ``repro.service.stats/1`` shape plus per-shard breakdowns
        (shared sections built once in :mod:`repro_torch.service.stats`).
        Under ``transport="rpc"`` the ``shards`` list carries one row
        per worker process and ``rpc`` the cluster's membership/wire
        accounting."""
        from ..stats import base_stats
        out = base_stats(self, "sharded", self.config.transport)
        out.update(
            executor=self.fanout.stats(),
            router=self.router.stats(),
            shards=([rs.stats() for rs in self.shards]
                    if self.cluster is None
                    else self.cluster.worker_stats()),
            index=dict(
                entries=self.frozen.num_entries(),
                size_bytes=self.frozen.size_bytes(),
                num_mrs=len(self.mr_ids),
                num_shards=self.plan.num_shards,
                num_replicas=self.config.num_replicas,
                generation=self.generation,
                plan=self.plan.as_dict()),
        )
        if self.cluster is not None:
            out["rpc"] = self.cluster.stats()
        return out
