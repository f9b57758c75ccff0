"""The ``parallel`` build backend: epoch/merge coordination.

Orchestrates Algorithm 2 as per-worker dispatch rounds over the phase
DAG (:mod:`.dag`) with LPT list scheduling (:mod:`.scheduler`), N
worker engines (:mod:`.worker`) and a sequential validation/merge pass
that makes the result *provably* bit-identical to the sequential
reference. Dispatch is asynchronous and work-conserving: each worker
gets its next batch ("epoch") the moment it goes idle — there is no
global barrier, so per-round stragglers cost only their own worker's
time:

* workers hold the **speculative union** of every broadcast result —
  committed or parked — which PR2 keeps out of earlier phases' read
  sets (a phase only writes at later-ranked vertices), so a phase's
  view of its *own* read set is the sequential prefix whenever its
  true dependencies were broadcast and survive validation unchanged;
* validation walks the positions in sequential order and **commits** a
  parked result only when the worker's view of the phase's read set
  provably equalled the authoritative prefix at that position (entry
  masks + counter deltas are then exactly what the sequential build
  would have produced, since the phase is a pure function of its read
  set). With PR2 on this uses **version-vector validation**: worker
  state is a deterministic replay of the broadcast event log plus the
  worker's own earlier results, so the coordinator knows exactly which
  result-versions the phase saw; the phase is valid unless some
  position whose output the worker missed (or held a since-corrected
  version of) actually *touches* the read scope — adds an entry at the
  hub's vertex, or rewrites a row of a hub listed there. With PR2
  ablated, later-positioned speculation could contaminate earlier read
  sets, so workers instead ship a content fingerprint of the read set
  and the coordinator re-computes it against the authoritative prefix
  (and results are only broadcast once committed);
* on mismatch the phase was run against a stale view: the coordinator
  re-runs it in place on the authoritative state — the re-run *is* the
  sequential execution, so termination and exactness need no retry
  loop — and broadcasts a retract/apply correction. Results for
  positions past a re-run stay parked and are validated later (their
  fingerprints embed whatever they read, so chains built on a
  corrected phase invalidate themselves).

Counters commute (per-phase deltas sum to the build totals — the same
property ``rlc_build_counter_deltas`` relies on), so committing them
per phase in frontier order reproduces ``BuildStats`` exactly.

Dense graphs where the PR1 dependency structure serializes the DAG
(critical-path share of estimated work above ``serial_fallback``) skip
the protocol entirely and run the phases sequentially on one sliced-
mirror engine — same bits, no epoch overhead; ``last_build_info``
records which path ran.

Speedup accounting: this container may have fewer cores than workers,
so ``last_build_info`` reports both the measured wall time *and* the
schedule's achieved-concurrency makespan, computed on a virtual
timeline: each batch completes at its dispatch time plus its measured
phase seconds, an idle worker is re-dispatched at the virtual time of
the collection that freed its work, and the coordinator's validation
seconds accrue on their own (pipelined) timeline; the makespan is the
max over all worker clocks and the coordinator clock. With the inline
executor collections are sequenced in virtual completion order, so the
schedule replays exactly what a concurrent run with those phase
timings would have done. The JAX package's bench records both
(``parallel_speedup`` from the makespan model, ``parallel_wall_speedup``
measured) with the host's ``cpu_count`` alongside.
"""
from __future__ import annotations

import heapq
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.graph import LabeledGraph
from repro_torch.core.rlc_index import RLCIndex
from repro_torch.build.base import (BuildBackend, BuildStats, access_schedule,
                              mask_vertices, register_backend)
from repro_torch.build.batched import _two_hop_estimate

from .dag import PhaseDAG
from .scheduler import ListScheduler, PhaseCostModel
from .worker import Event, InlineExecutor, LocalEngine, ProcessExecutor

__all__ = ["ParallelBackend"]


def _add_counters(stats: BuildStats, delta: Tuple[int, ...]) -> None:
    for name, d in zip(BuildStats._COUNTERS, delta):
        if d:
            setattr(stats, name, getattr(stats, name) + d)


def _rec(masks: Dict[int, int]) -> Optional[Tuple[Dict[int, int], set]]:
    """One broadcast version of a phase output: its masks plus the set
    of vertices it wrote (so read-scope intersection tests are O(1)
    lookups instead of per-test big-int bit probes). ``None`` for empty
    outputs — every store skips those, so version records compare by
    object identity in the common all-seen case."""
    if not masks:
        return None
    vs: set = set()
    for m in masks.values():
        vs.update(mask_vertices(m))
    return (masks, vs)


class _Group:
    """One (worker, epoch) result batch's validation context.

    ``snap`` is the worker's replayed broadcast state frozen at
    dispatch, ``own`` its plan's nonzero outputs (which override the
    snapshot — the plan ran after the event slice was applied). The
    dirty sets accumulate, per commit the group missed (held version
    ``is not`` committed version), the union of written-vertex sets and
    writer hubs — keyed by which read scope they can contaminate:
    ``dirty_verts[backward]`` holds vertices whose membership map a
    ``backward``-direction phase iterates, ``dirty_hubs[backward]`` the
    hubs whose rows it may read. Phase validation is then two O(1)
    probes instead of a scan over the event log.

    ``ev_mark`` is the broadcast-event count at dispatch: the snapshot
    holds exactly the versions broadcast before it, so a valid commit
    whose apply event has index ``>= ev_mark`` is one this group's view
    missed — the only valid commits that need absorbing (a commit seen
    at dispatch is the identical record object). Stale corrections are
    newer than every live group's mark and always absorb."""

    __slots__ = ("snap", "own", "dirty_verts", "dirty_hubs", "refs",
                 "ev_mark")

    def __init__(self, snap: Dict, own: Dict, refs: int, ev_mark: int):
        self.snap = snap
        self.own = own
        self.dirty_verts = {True: set(), False: set()}
        self.dirty_hubs = {True: set(), False: set()}
        self.refs = refs
        self.ev_mark = ev_mark

    def absorb(self, pos: int, v: int, fin) -> None:
        """Fold the just-committed version of ``pos`` into the dirty
        sets if this group's view held something else."""
        held = self.own.get(pos)
        if held is None:
            held = self.snap.get(pos)
        if held is fin or held == fin:
            return
        fwd = (pos & 1) == 1
        dv = self.dirty_verts[fwd]
        if held:
            dv |= held[1]
        if fin:
            dv |= fin[1]
        self.dirty_hubs[not fwd].add(v)


class ParallelBackend(BuildBackend):
    """Hub-partitioned multi-worker construction (see module docstring).

    ``workers``: engine count (default: the ``RLC_PARALLEL_WORKERS``
    env var, else 4 — the env knob is how CI exercises the protocol at
    a fixed width); ``executor``: ``"process"`` (one OS process per
    worker, started as :func:`~.worker.start_method` says),
    ``"inline"`` (deterministic in-process — tests/1-core), or
    ``"auto"`` (process when ``workers > 1``).
    ``hot_prefix``/``locality`` shape the scheduling DAG (see
    :class:`~repro_torch.build.parallel.dag.PhaseDAG`), and ``auto_thin``
    lets the backend swap in a thinner DAG when the default one's
    critical path dominates (:attr:`THIN_AT`); ``serial_fallback`` is
    the critical-path work share above which the build degrades to the
    sequential path. ``mode``/thresholds reach the per-worker
    :class:`~repro_torch.build.batched.PhaseRunner` unchanged.
    """

    name = "parallel"

    #: critical-path work share of the default DAG above which the
    #: schedule is rebuilt with the thin knobs below: a serial chain
    #: costs the whole build every round, while the missed dependencies
    #: a thinner DAG gambles on cost one exact re-run each — measured
    #: on the AD stand-in (share 0.45) thinning roughly halves the
    #: makespan, while the wider EP/TW DAGs (shares <= 0.33) lose to
    #: the stale-re-run storms thinning causes there
    THIN_AT = 0.4
    THIN_HOT = 8
    THIN_LOCALITY = 1

    def __init__(self, use_pr1: bool = True, use_pr2: bool = True,
                 use_pr3: bool = True, workers: Optional[int] = None,
                 executor: str = "auto", mode: str = "hybrid",
                 scalar_threshold: Optional[int] = None,
                 gather_threshold: Optional[int] = None,
                 hot_prefix: int = 16, locality: Optional[int] = None,
                 balance: float = 1.6, serial_fallback: float = 0.92,
                 auto_thin: bool = True):
        super().__init__(use_pr1, use_pr2, use_pr3)
        if executor not in ("auto", "inline", "process"):
            raise ValueError(
                f"executor {executor!r} not in auto|inline|process")
        if workers is None:
            workers = int(os.environ.get("RLC_PARALLEL_WORKERS", "4"))
        self.workers = max(1, int(workers))
        self.executor = executor
        self.mode = mode
        self.scalar_threshold = scalar_threshold
        self.gather_threshold = gather_threshold
        self.hot_prefix = int(hot_prefix)
        self.locality = locality
        self.balance = float(balance)
        self.serial_fallback = float(serial_fallback)
        self.auto_thin = bool(auto_thin)
        #: populated by every build: schedule shape, epoch/stale counts,
        #: makespan decomposition (the bench artifact's source)
        self.last_build_info: Dict = {}

    def _engine_kw(self) -> Dict:
        return dict(use_pr1=self.use_pr1, use_pr2=self.use_pr2,
                    use_pr3=self.use_pr3, mode=self.mode,
                    scalar_threshold=self.scalar_threshold,
                    gather_threshold=self.gather_threshold)

    # ------------------------------------------------------------------ #
    def _build(self, graph: LabeledGraph, k: int, stats: BuildStats
               ) -> RLCIndex:
        t0 = time.perf_counter()
        order, aid = access_schedule(graph)
        V = graph.num_vertices
        dag = PhaseDAG(graph, k, order, hot_prefix=self.hot_prefix,
                       locality=self.locality)
        est = np.ones(2 * V)
        if V and graph.num_edges:
            bi, bn, _ = graph.bwd
            fi, fn, _ = graph.fwd
            est[0::2] = _two_hop_estimate(bi, bn, graph.in_degree())[order]
            est[1::2] = _two_hop_estimate(fi, fn,
                                          graph.out_degree())[order]
        cm = PhaseCostModel(est)
        dag_stats = dag.stats(cm.costs())
        info = self.last_build_info = dict(
            workers=self.workers, dag=dag_stats)
        serial_frac = dag_stats.get("serial_fraction", 1.0)
        if (self.auto_thin and self.workers > 1
                and self.THIN_AT <= serial_frac < self.serial_fallback):
            thin = PhaseDAG(graph, k, order, hot_prefix=self.THIN_HOT,
                            locality=self.THIN_LOCALITY)
            tstats = thin.stats(cm.costs())
            if tstats.get("serial_fraction", 1.0) < serial_frac:
                dag, dag_stats = thin, tstats
                serial_frac = dag_stats.get("serial_fraction", 1.0)
                info["dag"] = dag_stats
                info["thinned"] = True
        # the schedule's analysis (DAG passes, cost estimates) is host
        # time outside the makespan model
        info["dag_s"] = round(time.perf_counter() - t0, 6)
        if (self.workers <= 1 or dag_stats["phases"] <= 2
                or serial_frac >= self.serial_fallback):
            info["mode"] = "sequential"
            info["reason"] = (
                "workers<=1" if self.workers <= 1
                else "trivial" if dag_stats["phases"] <= 2
                else f"serial_fraction={serial_frac}")
            return self._sequential(graph, k, stats, order, aid)
        info["mode"] = "parallel"
        return _Coordinator(self, graph, k, stats, order, aid, dag,
                            cm).run()

    # -- degenerate / dense path ---------------------------------------- #
    def _sequential(self, graph: LabeledGraph, k: int, stats: BuildStats,
                    order: np.ndarray, aid: np.ndarray) -> RLCIndex:
        eng = LocalEngine(graph, k, aid, **self._engine_kw())
        obs = self.observer
        for v in order:
            v = int(v)
            for backward in (True, False):
                if not (eng.runner.in_deg[v] if backward
                        else eng.runner.out_deg[v]):
                    continue
                delta, secs = eng.run_phase(v, backward)
                if obs is not None:
                    obs.phase(v, backward, secs, counter_delta=delta)
        eng.mirror.size_bytes()
        index = eng.runner.finish()
        for name in BuildStats._COUNTERS:
            setattr(stats, name, getattr(eng.stats, name))
        stats.peak_mirror_bytes = max(stats.peak_mirror_bytes,
                                      eng.mirror.peak_bytes)
        return index


class _Coordinator:
    """One build's epoch loop: dispatch, validate, commit, account."""

    def __init__(self, backend: ParallelBackend, graph: LabeledGraph,
                 k: int, stats: BuildStats, order: np.ndarray,
                 aid: np.ndarray, dag: PhaseDAG, cm: PhaseCostModel):
        self.backend = backend
        self.graph = graph
        self.k = k
        self.stats = stats
        self.order = order
        self.dag = dag
        self.cm = cm
        self.nw = backend.workers
        #: authoritative prefix state (also the stale re-run engine)
        self.parent = LocalEngine(graph, k, aid, **backend._engine_kw())
        self.sched = ListScheduler(dag, cm, self.nw,
                                   balance=backend.balance)
        self.committed = ~dag.active.copy()   # inactive = trivially done
        self.frontier = 0
        #: broadcast state stream: apply/retract, sliced per worker
        self.events: List[Event] = []
        self.cursors = [0] * self.nw
        #: pos -> (fingerprint, version record, counter delta, seconds,
        #: worker, validation group)
        self.pending: Dict[int, Tuple] = {}
        #: groups with unvalidated results — every commit is folded into
        #: each one's dirty sets (identity-hit no-op for versions the
        #: group's view already held)
        self.live: List[_Group] = []
        #: commits that can contaminate some view, in order (spec mode):
        #: a plan in flight *during* a commit has no group yet to absorb
        #: it — at collection the log suffix since its dispatch is
        #: replayed into the new group, so the dirty sets cover the full
        #: dispatch-to-validation window. Entries are
        #: ``(pos, hub, record, apply-event index)`` (-1: correction,
        #: absorbed unconditionally)
        self.commit_log: List[Tuple] = []
        #: pos -> index of its speculative apply event (absorb filter)
        self.evt_idx: Dict[int, int] = {}
        #: replayed model of each worker's applied state (event log only;
        #: own results ride in the group's own-plan dict)
        self.views: List[Dict] = [{} for _ in range(self.nw)]
        # when to broadcast results to workers: speculatively at collect
        # (PR2 keeps speculation out of earlier read sets), else only
        # once committed; with PR1 off phases are read-free and workers
        # need no entry state at all
        self.broadcast = ("none" if not backend.use_pr1
                          else "spec" if backend.use_pr2 else "commit")
        kind = backend.executor
        if kind == "auto":
            kind = "process" if self.nw > 1 else "inline"
        cls = ProcessExecutor if kind == "process" else InlineExecutor
        self.executor = cls(self.nw, graph, k, aid,
                            **backend._engine_kw())

    def run(self) -> RLCIndex:
        info = self.backend.last_build_info
        obs = self.backend.observer
        rounds = stale_total = 0
        now = 0.0                      # virtual time of last collection
        clock = [0.0] * self.nw        # per-worker last completion
        coord_clock = 0.0              # pipelined validation timeline
        parent_serial = 0.0
        busy_total = [0.0] * self.nw
        peak = 0
        #: wid -> (dispatch vtime, frozen snapshot, plan, commit mark)
        inflight: Dict[int, Tuple] = {}
        inflight_pos: set = set()
        #: eager (inline) completions, popped in virtual time order
        done: List[Tuple[float, int, Tuple]] = []
        try:
            while not self.committed.all():
                # 1) hand every idle worker a fresh plan — no barrier:
                # a straggler never stalls the other workers' batches
                for wid in range(self.nw):
                    if wid in inflight:
                        continue
                    plan = self.sched.plan_for(
                        self.committed, self.pending, inflight_pos,
                        self.frontier)
                    if not plan:
                        break   # stateless in wid: empty for all idle
                    events = self.events[self.cursors[wid]:]
                    self.cursors[wid] = len(self.events)
                    view = self.views[wid]
                    for ev in events:
                        if ev[0] == "apply":
                            view[ev[1]] = ev[4]
                        else:
                            view.pop(ev[1], None)
                    # frozen view at dispatch: what the worker's state
                    # will be when the plan runs (validation may happen
                    # many rounds later, after this view has moved on)
                    inflight[wid] = (now, dict(view), plan,
                                     len(self.commit_log))
                    inflight_pos.update(plan)
                    payload = self.executor.submit(wid, (events, [
                        (p, int(self.order[p >> 1]), p % 2 == 0)
                        for p in plan]))
                    if payload is not None:    # inline: runs eagerly
                        busy = sum(r[4] for r in payload[0])
                        heapq.heappush(done, (now + busy, wid, payload))
                if not inflight:
                    # nothing runnable anywhere: every remaining active
                    # position is parked — drain the frontier to finish
                    before = self.frontier
                    t0 = time.perf_counter()
                    stale_total += self._validate(obs)
                    val_s = time.perf_counter() - t0
                    parent_serial += val_s
                    coord_clock = max(coord_clock, now) + val_s
                    if self.committed.all():
                        break
                    if self.frontier == before:
                        raise RuntimeError(
                            "parallel build made no progress "
                            f"(frontier={self.frontier})")  # unreachable
                    continue
                # 2) collect the next completion: virtual order for the
                # inline executor, arrival order for processes
                if done:
                    comp, wid, payload = heapq.heappop(done)
                else:
                    wid, payload = self.executor.recv_any()
                    comp = inflight[wid][0] + sum(
                        r[4] for r in payload[0])
                now = max(now, comp)
                _, snap, plan, mark = inflight.pop(wid)
                inflight_pos.difference_update(plan)
                res_list, wpeak = payload
                peak = max(peak, wpeak)
                recs = {pos: _rec(masks)
                        for pos, _, masks, _, _ in res_list}
                own = {pos: r for pos, r in recs.items() if r}
                group = _Group(snap, own, len(res_list),
                               self.cursors[wid])
                # commits that landed while this plan was in flight are
                # in neither its snapshot nor (yet) its dirty sets —
                # replay the commit-log suffix before validation can
                # trust the group
                for cpos, cv, crec, ci in self.commit_log[mark:]:
                    if ci < 0 or ci >= group.ev_mark:
                        group.absorb(cpos, cv, crec)
                self.live.append(group)
                busy = 0.0
                for pos, fp, masks, cdelta, secs in res_list:
                    rec = recs[pos]
                    self.pending[pos] = (fp, rec, cdelta, secs, wid,
                                         group)
                    if rec and self.broadcast == "spec":
                        self.evt_idx[pos] = len(self.events)
                        self.events.append(
                            ("apply", pos, int(self.order[pos >> 1]),
                             pos % 2 == 0, rec))
                    busy += secs
                    self.cm.observe(pos, secs)
                busy_total[wid] += busy
                clock[wid] = comp
                rounds += 1
                if rounds % 8 == 0:
                    self.cm.refit()
                # 3) advance the frontier over everything now parked —
                # pipelined: with the process executor this genuinely
                # overlaps the other workers' compute, and the virtual
                # accounting models the same overlap for the inline one
                t0 = time.perf_counter()
                stale = self._validate(obs)
                val_s = time.perf_counter() - t0
                parent_serial += val_s
                coord_clock = max(coord_clock, now) + val_s
                stale_total += stale
                if obs is not None:
                    obs.epoch(busy + val_s, phases=len(res_list),
                              stale_reruns=stale)
        finally:
            self.executor.close()
        self.parent.mirror.size_bytes()
        index = self.parent.runner.finish()
        self.stats.peak_mirror_bytes = max(
            self.stats.peak_mirror_bytes, peak,
            self.parent.mirror.peak_bytes)
        info.update(
            epochs=rounds, stale_reruns=stale_total,
            makespan_s=round(max(max(clock), coord_clock), 6),
            worker_busy_s=[round(b, 6) for b in busy_total],
            parent_serial_s=round(parent_serial, 6),
            executor=self.executor.kind,
            start_method=self.executor.start_method,
            startup_s=round(self.executor.startup_s, 6))
        return index

    def _validate(self, obs) -> int:
        """Advance the sequential commit frontier: validate parked
        results in position order, re-running stale ones in place on the
        authoritative prefix. Returns the number of stale re-runs."""
        stale = 0
        parent = self.parent
        while self.frontier < self.dag.npos:
            pos = self.frontier
            if self.committed[pos]:
                self.frontier += 1
                continue
            got = self.pending.pop(pos, None)
            if got is None:
                break                      # not yet executed: next epoch
            v = int(self.order[pos >> 1])
            backward = pos % 2 == 0
            fp, rec, cdelta, secs, wid, group = got
            ok = self._is_valid(v, backward, fp, group)
            if ok:
                parent.apply_output(v, backward, rec[0] if rec else {})
                worker = str(wid)
                if rec and self.broadcast == "commit":
                    self.events.append(
                        ("apply", pos, v, backward, rec))
            else:
                stale += 1
                cdelta, secs = parent.run_phase(v, backward)
                masks = parent.extract_output(v, backward)
                parent.apply_output(v, backward, masks, in_index=True)
                worker = "parent"
                rec = _rec(masks)
                # correct the mis-speculation everywhere
                if self.broadcast != "none":
                    self.events.append(("retract", pos))
                    if rec:
                        self.events.append(
                            ("apply", pos, v, backward, rec))
            # fold the committed version into every live group's dirty
            # sets: a group whose view held a different version (usually
            # "nothing yet" — a same-window cross-worker result) has its
            # later phases' read scopes contaminated at these vertices /
            # hub rows. PR2 bounds every output (even junk speculation —
            # the rank filter is applied at insert, whatever the input
            # state) to vertices ranked above its own hub, so commits at
            # or past a phase's position can never reach its read scope,
            # and commit order == position order makes this exact.
            if group.refs == 1:
                self.live.remove(group)
            else:
                group.refs -= 1
            if self.broadcast == "spec":
                if not ok:
                    # correction: newer than every live group's view
                    self.commit_log.append((pos, v, rec, -1))
                    for g in self.live:
                        g.absorb(pos, v, rec)
                elif rec is not None:
                    # a group missed this exact version only if it was
                    # dispatched before the result's broadcast; everyone
                    # else holds the identical record (empty outputs
                    # were never broadcast and contaminate nothing)
                    i = self.evt_idx[pos]
                    self.commit_log.append((pos, v, rec, i))
                    for g in self.live:
                        if g.ev_mark <= i:
                            g.absorb(pos, v, rec)
            _add_counters(self.stats, cdelta)
            if obs is not None:
                obs.phase(v, backward, secs, counter_delta=cdelta)
                obs.worker_phase(worker, secs)
            self.committed[pos] = True
            self.frontier += 1
        return stale

    def _is_valid(self, v: int, backward: bool, fp: int,
                  group: _Group) -> bool:
        """Did the worker's view of this phase's read set equal the
        authoritative prefix at its position? (All earlier positions are
        committed when the frontier reaches it, and every commit the
        group's view missed is in its dirty sets.) The read scope is the
        entry dict at ``v`` plus the rows of the hubs it lists: backward
        phases read ``l_in[v]`` (written by forward phases) and the
        out-rows of the hubs there (written by those hubs' backward
        phases); forward phases symmetrically."""
        backend = self.backend
        if not backend.use_pr1:
            return True                    # read-free phase
        if not backend.use_pr2:
            # content-fingerprint path (see module docstring)
            return fp == self.parent.fingerprint(v, backward)
        if v in group.dirty_verts[backward]:
            return False
        hubs = group.dirty_hubs[backward]
        if hubs:
            amap = (self.parent.index.l_in if backward
                    else self.parent.index.l_out)[v]
            if not hubs.isdisjoint(amap):
                return False
        return True


register_backend("parallel", ParallelBackend)
