"""The incremental build engine: affected-hub analysis + phase replay.

Algorithm 2 processes hubs sequentially in access order, each ``(hub,
direction)`` phase reading (a) the graph along its traversal and (b) the
index entries earlier phases left at the vertices it visits (PR1) plus
the access-id order (PR2). A :class:`repro_torch.core.graph.GraphDelta`
therefore changes a phase's outcome only if one of four conditions
holds, each checkable against the previous build's
:class:`~repro_torch.build.delta.trace.BuildTrace` with a handful of bitmask
ANDs:

A. **traversal** — a delta edge's tail sits where the phase expands:
   in the full-fanout region (``near``, kernel-search depth < k plus
   the hub itself) for any label, or in the label-``l`` expansion mask
   (``lab[l]``, kernel-BFS product states) for a delta edge labeled
   ``l``;
B. **moved hub** — the hub's own access rank changed (only delta
   endpoints can change score, and any crossing pair contains an
   endpoint whose rank moved);
C. **crossing** — a moved endpoint ``u`` crossed the hub in access
   order and either ``u`` is visited (a PR2 comparison flips) or
   ``u``'s output is readable by the phase's PR1 — Algorithm 1's
   case 1 needs ``u``'s entry at the hub AND at a visited vertex, on
   opposite sides;
D. **upstream diff** — an earlier re-run phase changed entries the
   phase's PR1 reads, with the same case-1 hub gating as C.

Clean phases are *replayed*: their old entries bulk-merge into the new
index from the carried replay tables and their recorded counters
accumulate — no traversal, no PR1 evaluation. Dirty phases re-run
through the very same :class:`repro_torch.build.batched.PhaseRunner` a full
build uses, against the index state accumulated so far (which, by
induction over the schedule, equals the full build's pre-phase state at
every vertex the phase can read). Old entries of a dirty phase are
tombstoned — dropped from the replay tables — and superseded by
whatever the re-run derives; XOR-diffing the hub's packed coverage-
mirror rows yields the vertices whose rows changed, which feeds
condition D, the partial re-freeze, and the serving layer's targeted
cache invalidation. When the affected set exceeds
``fallback_frac * total_work`` the engine abandons the pass and falls
back to a full traced rebuild (:meth:`DeltaBuilder.rebuild_delta`).

To keep a small delta's cost proportional to what it touches, the
builder carries state across applies and patches it in place:

* the packed :class:`~repro_torch.core.rlc_index.BitMirror` — replayed hubs'
  rows are exactly their old outputs, so only re-run hubs' rows move;
* the replay tables (``hub -> {row: mr-set}``) — the mr-sets are
  *shared* with the index dicts, which is safe because a row's per-hub
  set is only ever mutated during that hub's own phase, and a hub's
  phase only runs when its old entries were tombstoned, never replayed;
* the bits-tier packed adjacency and the scalar tier's neighbor lists —
  only the delta edges' endpoint rows are recomputed.

The ``cuda`` backend's device adjacency is *not* carried: every apply's
:class:`PhaseRunner` makes its engine from the mutated graph
(:class:`repro_torch.build.cuda_backend.CudaEngine` packs it on the
card), so device waves never expand over pre-delta edges.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.graph import GraphDelta, LabeledGraph
from repro_torch.core.minimum_repeat import mr_id_space
from repro_torch.core.rlc_index import RLCIndex
from repro_torch.obs import NULL_OBS

from ..base import (BuildStats, PhaseProbe, access_schedule, get_backend,
                    mask_vertices, vertex_mask)
from ..batched import BatchedBackend, PhaseRunner
from .trace import BuildTrace, PhaseTrace

#: replay table: hub -> {row -> set of MRs} (sets shared with the index)
HubTable = Dict[int, Dict[int, Set[tuple]]]


class _FallbackNeeded(Exception):
    """Internal signal: the affected set blew the incremental budget."""


def _add_counters(stats: BuildStats, tup) -> None:
    for name, d in zip(BuildStats._COUNTERS, tup):
        setattr(stats, name, getattr(stats, name) + d)


def _sub_counters(a, b) -> Tuple[int, ...]:
    return tuple(x - y for x, y in zip(a, b))


def _rows_of(mask: int) -> np.ndarray:
    return np.fromiter(mask_vertices(mask), dtype=np.int64)


@dataclass
class DeltaResult:
    """Outcome of one :meth:`DeltaBuilder.apply`.

    ``stats`` carries the counters an equivalent full rebuild would
    report (replayed + re-run); the row arrays drive the partial
    re-freeze and targeted cache invalidation:

    * ``dirty_out``/``dirty_in`` — vertices whose L_out/L_in entry rows
      changed (answers involving them as source/target may change);
    * ``resort_out``/``resort_in`` — rows whose entries are unchanged
      but whose aid sort order may have shifted (they hold a hub whose
      access rank moved): they must re-freeze but never invalidate
      cached answers.

    On ``fallback`` every row counts as dirty and the arrays are empty —
    callers should re-freeze and invalidate wholesale.
    """

    stats: BuildStats
    fallback: bool = False
    #: why the incremental pass was abandoned (None when it succeeded):
    #: ``"static_budget"`` — conditions A/B alone blew the budget before
    #: any carried state was touched; ``"budget"`` — the re-run work
    #: crossed it mid-pass; ``"requested"`` — rebuild_delta called
    #: directly.
    fallback_reason: Optional[str] = None
    phases_total: int = 0
    phases_rerun: int = 0
    phases_replayed: int = 0
    dirty_out: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    dirty_in: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    resort_out: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.int64))
    resort_in: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.int64))
    #: why phases went dirty: traversal / moved_hub / crossing / upstream
    causes: Dict[str, int] = field(default_factory=dict)

    def as_dict(self) -> dict:
        return dict(fallback=self.fallback,
                    fallback_reason=self.fallback_reason,
                    phases_total=self.phases_total,
                    phases_rerun=self.phases_rerun,
                    phases_replayed=self.phases_replayed,
                    dirty_rows=int(len(self.dirty_out) + len(self.dirty_in)),
                    resort_rows=int(len(self.resort_out)
                                    + len(self.resort_in)),
                    causes=dict(self.causes),
                    build=self.stats.as_dict())


class DeltaBuilder:
    """Stateful incremental builder: one traced index + its graph.

    ``backend`` must be a batched backend name (``numpy``/``cuda`` —
    the python reference has no phase runner to replay through);
    ``**backend_kw`` reaches its constructor (``use_pr1/2/3``, ``mode``,
    thresholds), so pruning ablations delta-build too.
    ``fallback_frac`` bounds the incremental pass at that fraction of
    the previous build's traversal work before the full-rebuild escape
    hatch fires; ``1.0`` disables the fallback entirely.
    """

    def __init__(self, graph: LabeledGraph, k: int, backend: str = "numpy",
                 fallback_frac: float = 0.25, obs=None, **backend_kw):
        if not (0.0 < fallback_frac <= 1.0):
            raise ValueError(
                f"fallback_frac must be in (0, 1], got {fallback_frac}")
        self.graph = graph
        self.k = int(k)
        self.fallback_frac = fallback_frac
        self._backend_name = backend
        self._backend_kw = dict(backend_kw)
        # delta-engine telemetry: apply outcomes, fallback attribution,
        # phase dispositions, dirty causes. Per-phase timings go through
        # BuildPhaseObserver ("delta" context for re-runs, "delta_full"
        # for the traced bootstraps/rebuilds).
        self.obs = obs or NULL_OBS
        reg = self.obs.registry
        self._m_apply = reg.counter(
            "rlc_delta_applies", desc="delta applies by outcome",
            labelnames=("outcome",))
        self._m_fb = reg.counter(
            "rlc_delta_fallbacks",
            desc="incremental applies abandoned to a full rebuild",
            labelnames=("reason",))
        phases = reg.counter("rlc_delta_phases",
                             desc="phases per incremental apply",
                             labelnames=("kind",))
        self._m_rerun = phases.labels(kind="rerun")
        self._m_replay = phases.labels(kind="replayed")
        self._m_cause = reg.counter(
            "rlc_delta_dirty_causes",
            desc="why phases went dirty (A/B/C/D conditions)",
            labelnames=("cause",))
        self._m_apply_s = reg.histogram(
            "rlc_delta_apply_seconds",
            desc="end-to-end wall time of one apply()", unit="s").labels()
        self._new_backend()     # fail fast on bad names/kwargs
        self.index: Optional[RLCIndex] = None
        self.trace: Optional[BuildTrace] = None
        self.stats: Optional[BuildStats] = None
        # carried across applies (see module doc): coverage mirror,
        # replay tables + output-row masks, packed adjacency, neighbor
        # lists. All patched in place per delta.
        self._mirror = None
        self._rep: Dict[bool, HubTable] = {True: {}, False: {}}
        self._omask: Dict[bool, Dict[int, int]] = {True: {}, False: {}}
        self._adjb: Dict[bool, tuple] = {}
        self._nbrs = None
        self._needs_full = False
        self.deltas_applied = 0
        self.fallbacks = 0

    def _new_backend(self, context: Optional[str] = None) -> BatchedBackend:
        b = get_backend(self._backend_name, **self._backend_kw)
        if not isinstance(b, BatchedBackend):
            raise ValueError(
                f"delta builds need a batched backend, got "
                f"{self._backend_name!r}")
        if context is not None:
            # None observer in disabled mode — phases stay untimed
            b.set_observer(self.obs.build_observer(context))
        return b

    # ------------------------------------------------------------------ #
    def _capture(self, runner: PhaseRunner, index: RLCIndex) -> None:
        """Carry the runner's reusable state into the builder."""
        self._mirror = index._mirror
        self._adjb = dict(runner.ctx._adjb) if runner.can_batch else {}
        self._nbrs = runner._nbrs
        runner.finish()

    def _rebuild_tables(self, index: RLCIndex) -> None:
        """Full re-derivation of the carried replay tables (out side =
        backward phases' output, in side = forward phases'). The per-row
        mr-sets are shared with the index, not copied."""
        for backward, maps in ((True, index.l_out), (False, index.l_in)):
            tab: HubTable = {}
            masks: Dict[int, int] = {}
            for y, d in enumerate(maps):
                bit_y = 1 << y
                for hub, mrs in d.items():
                    row = tab.get(hub)
                    if row is None:
                        row = tab[hub] = {}
                    row[y] = mrs
                    masks[hub] = masks.get(hub, 0) | bit_y
            self._rep[backward] = tab
            self._omask[backward] = masks

    def _traced_build(self, graph: LabeledGraph
                      ) -> Tuple[RLCIndex, BuildStats, BuildTrace]:
        """Full build through the phase runner, recording a trace."""
        nl = graph.num_labels
        stats = BuildStats(backend=f"{self._backend_name}+trace")
        t0 = time.perf_counter()
        order, aid = access_schedule(graph)
        index = RLCIndex(graph.num_vertices, self.k, aid)
        runner = PhaseRunner(self._new_backend("delta_full"), graph, self.k,
                             index, stats)
        trace = BuildTrace(graph.num_vertices, nl)
        for v in order:
            v = int(v)
            for backward in (True, False):
                probe = PhaseProbe(nl)
                c0 = stats.counters()
                runner.run(v, backward, probe)
                trace.put(v, backward, PhaseTrace(
                    probe.visited, probe.near, tuple(probe.lab),
                    _sub_counters(stats.counters(), c0)))
        self._capture(runner, index)
        stats.wall_time_s = time.perf_counter() - t0
        return index, stats, trace

    def full(self) -> Tuple[RLCIndex, BuildStats]:
        """(Re)build the index for the current graph from scratch, traced."""
        self.index, self.stats, self.trace = self._traced_build(self.graph)
        self._rebuild_tables(self.index)
        self._needs_full = False
        return self.index, self.stats

    def rebuild_delta(self, delta: GraphDelta, validate: bool = True,
                      reason: str = "requested") -> DeltaResult:
        """Escape hatch: apply the delta, then full traced rebuild.
        ``reason`` records *why* the incremental pass was abandoned
        (surfaced in ``DeltaResult.fallback_reason`` and the
        ``rlc_delta_fallbacks`` counter)."""
        if validate:
            delta.validate(self.graph)
        self.graph = self.graph.apply_delta(delta, validate=False)
        self.full()
        self.deltas_applied += 1
        self.fallbacks += 1
        self._m_apply.inc(1, outcome="fallback")
        self._m_fb.inc(1, reason=reason)
        V2 = 2 * self.graph.num_vertices
        return DeltaResult(stats=self.stats, fallback=True,
                           fallback_reason=reason,
                           phases_total=V2, phases_rerun=V2)

    # ------------------------------------------------------------------ #
    def _patch_adjacency(self, new_graph: LabeledGraph,
                         delta: GraphDelta) -> None:
        """Recompute the carried packed-adjacency and neighbor-list rows
        of the delta edges' tail vertices (everything else is shared)."""
        rows = [r for r in (delta.inserts, delta.deletes) if r.size]
        if not rows:
            return
        edges = np.concatenate(rows)
        nl = new_graph.num_labels
        for backward in (True, False):
            touched = np.unique(edges[:, 2 if backward else 0]).tolist()
            adj = self._adjb.get(backward)
            if adj is not None:
                by_label, by_vertex = adj
                lptr, lnbr = new_graph.label_csr(backward)
                for v in touched:
                    for lv in range(nl):
                        key = v * nl + lv
                        bits = 0
                        for n in lnbr[lptr[key]:lptr[key + 1]].tolist():
                            bits |= 1 << n
                        by_label[lv][v] = bits
                    row = tuple((lv, by_label[lv][v]) for lv in range(nl)
                                if by_label[lv][v])
                    by_vertex[v] = row if row else ()
            if self._nbrs is not None:
                indptr, other, lab = (new_graph.bwd if backward
                                      else new_graph.fwd)
                lists = self._nbrs._dir[backward]
                for v in touched:
                    lo, hi = int(indptr[v]), int(indptr[v + 1])
                    lists[v] = list(zip(other[lo:hi].tolist(),
                                        lab[lo:hi].tolist()))

    # ------------------------------------------------------------------ #
    def apply(self, delta: GraphDelta, validate: bool = True) -> DeltaResult:
        """Incrementally rebuild for ``graph + delta`` (see module doc).

        The resulting ``self.index`` (entries *and* counters) is
        bit-identical to ``full()`` on the mutated graph; falls back to
        :meth:`rebuild_delta` when the affected set exceeds
        ``fallback_frac`` of the previous build's traversal work.
        """
        if self.index is None:
            raise RuntimeError("DeltaBuilder.apply before full()")
        if self._needs_full:     # a previous apply died mid-mutation
            self.full()
        if validate:
            delta.validate(self.graph)
        t0 = time.perf_counter()
        old_graph = self.graph
        new_graph = old_graph.apply_delta(delta, validate=False)
        V, nl = new_graph.num_vertices, new_graph.num_labels
        old_trace = self.trace
        old_rank_l = np.asarray(self.index.aid).tolist()
        new_order, new_aid = access_schedule(new_graph)
        new_rank_l = new_aid.tolist()

        # -- condition A inputs: delta-edge tails per direction ---------- #
        edges = ([delta.inserts] if delta.inserts.size else []) + \
                ([delta.deletes] if delta.deletes.size else [])
        all_rows = (np.concatenate(edges) if edges
                    else np.empty((0, 3), np.int32))
        tails_any = {}
        tails_lab = {}
        for backward in (True, False):
            tail_col = all_rows[:, 2 if backward else 0]
            tails_any[backward] = vertex_mask(tail_col, V)
            per_lab = [0] * nl
            for lv in np.unique(all_rows[:, 1]).tolist():
                per_lab[lv] = vertex_mask(
                    tail_col[all_rows[:, 1] == lv], V)
            tails_lab[backward] = per_lab

        # -- condition B/C inputs: endpoints whose access rank moved ----- #
        movers = [int(u) for u in delta.endpoints()
                  if old_rank_l[u] != new_rank_l[u]]
        mover_set = set(movers)
        mover_bits = 0
        for u in movers:
            mover_bits |= 1 << u

        def bail(reason: str) -> DeltaResult:
            """Hand over to the full-rebuild escape hatch."""
            self.graph = old_graph
            res = self.rebuild_delta(delta, validate=False, reason=reason)
            res.stats.wall_time_s = time.perf_counter() - t0
            self._m_apply_s.observe(res.stats.wall_time_s)
            return res

        # -- static pre-pass: evaluate conditions A/B once for every
        #    phase (the main loop reuses the verdicts), and bail to the
        #    full rebuild before touching any carried state if they
        #    alone blow the budget (fallback_frac=1.0 never falls back) -- #
        budget = (float("inf") if self.fallback_frac >= 1.0
                  else max(1, int(self.fallback_frac
                                  * max(old_trace.total_work, 1))))
        est = 0
        static_cause: List[Optional[str]] = [None] * (2 * V)
        for v in range(V):
            bit_v = 1 << v
            for backward in (True, False):
                pt = old_trace.get(v, backward)
                c = None
                if (pt.near | bit_v) & tails_any[backward]:
                    c = "traversal"
                elif pt.lab:
                    for lmask, tmask in zip(pt.lab, tails_lab[backward]):
                        if lmask & tmask:
                            c = "traversal"
                            break
                if c is None and v in mover_set:
                    c = "moved_hub"
                if c is not None:
                    static_cause[(v << 1) | backward] = c
                    est += pt.work + 1
            if est > budget:
                return bail("static_budget")

        rep = self._rep
        old_mask = self._omask

        # -- the incremental pass over the new schedule ------------------ #
        self._needs_full = True    # cleared on success or clean fallback
        self._patch_adjacency(new_graph, delta)
        stats = BuildStats(backend=f"delta[{self._backend_name}]")
        index = RLCIndex(V, self.k, new_aid)
        runner = PhaseRunner(self._new_backend("delta"), new_graph, self.k,
                             index, stats, mirror=self._mirror)
        adopted = runner.adopted_mirror
        if runner.can_batch and self._adjb:
            runner.ctx._adjb.update(self._adjb)
        if self._nbrs is not None:
            runner._nbrs = self._nbrs
        acc = [0] * len(BuildStats._COUNTERS)   # replayed counters
        dirty_rows = {True: 0, False: 0}
        # per re-run hub: its new output-row masks, and the rows where
        # its output changed (condition C/D inputs)
        new_out_mask: Dict[bool, Dict[int, int]] = {True: {}, False: {}}
        changed_by_hub: Dict[bool, Dict[int, int]] = {True: {}, False: {}}
        causes: Dict[str, int] = {}
        # prefilter mask: rows holding any mover's output (old; new rows
        # OR in as mover phases re-run) — a phase can only be
        # crossing-dirty when its hub or visited set touches these
        mover_gate = mover_bits
        for u in movers:
            mover_gate |= (old_mask[True].get(u, 0)
                           | old_mask[False].get(u, 0))
        rerun_hubs: Dict[bool, List[int]] = {True: [], False: []}
        pending_tab: Dict[bool, HubTable] = {True: {}, False: {}}
        rerun = replayed = 0
        work = 0
        try:
            for v in new_order.tolist():
                rv_old, rv_new = old_rank_l[v], new_rank_l[v]
                bit_v = 1 << v
                for backward in (True, False):
                    pt = old_trace.get(v, backward)
                    # A/B evaluated once in the pre-pass
                    cause = static_cause[(v << 1) | backward]
                    dirty = cause is not None
                    # C: crossings (v itself cannot be a mover here —
                    # the pre-pass already marked those "moved_hub")
                    if not dirty and movers and (
                            (mover_bits & pt.visited)
                            or (mover_gate & bit_v)):
                        for u in movers:
                            ru_old, ru_new = old_rank_l[u], new_rank_l[u]
                            if (ru_old < rv_old) == (ru_new < rv_new):
                                continue          # no crossing with v
                            if (1 << u) & pt.visited:
                                cause = "crossing"
                                break
                            if ru_new < rv_new:
                                om_out = new_out_mask[True].get(u, 0)
                                om_in = new_out_mask[False].get(u, 0)
                            else:
                                om_out = old_mask[True].get(u, 0)
                                om_in = old_mask[False].get(u, 0)
                            if backward:
                                hit = (om_in & bit_v) and \
                                    (om_out & pt.visited)
                            else:
                                hit = (om_out & bit_v) and \
                                    (om_in & pt.visited)
                            if hit:
                                cause = "crossing"
                                break
                        dirty = cause is not None
                    # D: an earlier re-run changed entries the phase's
                    # PR1 reads. A backward phase reads the in-side row
                    # at the hub plus, via Algorithm 1's case 1, hub-u
                    # out-side rows at visited vertices — the latter only
                    # for hubs u that sit in the hub's in-row, so each
                    # changed hub is gated on having an opposite-side
                    # entry at v (mirrored for forward phases).
                    if not dirty:
                        gate_side = not backward
                        if dirty_rows[gate_side] & bit_v:
                            cause = "upstream"
                        elif dirty_rows[backward] & pt.visited:
                            for u, ch in changed_by_hub[backward].items():
                                if not (ch & pt.visited):
                                    continue
                                gate = (old_mask[gate_side].get(u, 0)
                                        | new_out_mask[gate_side].get(u, 0))
                                if gate & bit_v:
                                    cause = "upstream"
                                    break
                        dirty = cause is not None

                    old_out = rep[backward].get(v)
                    if not dirty:
                        replayed += 1
                        if old_out:
                            if adopted:
                                # mirror rows already hold this output —
                                # dict-only merge, sharing the mr-sets
                                maps = (index.l_out if backward
                                        else index.l_in)
                                for y, ms in old_out.items():
                                    maps[y][v] = ms
                            else:
                                # fresh mirror: inverted bulk insert so
                                # the mirror rows get repopulated too
                                by_mr: Dict[tuple, List[int]] = {}
                                for y, ms in old_out.items():
                                    for mr in ms:
                                        by_mr.setdefault(mr, []).append(y)
                                add = (index.add_out_many if backward
                                       else index.add_in_many)
                                for mr, ys in by_mr.items():
                                    add(ys, v, mr)
                        for i, d in enumerate(pt.counters):
                            acc[i] += d
                        continue

                    # re-run the phase (old entries are tombstoned: they
                    # are simply never replayed)
                    rerun += 1
                    rerun_hubs[backward].append(v)
                    causes[cause] = causes.get(cause, 0) + 1
                    work += pt.work + 1
                    if work > budget:
                        raise _FallbackNeeded
                    mirror = index._mirror
                    if mirror is not None:
                        side_rows = mirror.out if backward else mirror.in_
                        if adopted:
                            # the carried rows ARE the old output; zero
                            # them so the re-run derives from scratch
                            old_rows = side_rows[v].copy()
                            side_rows[v] = 0
                        else:
                            old_rows = np.zeros_like(side_rows[v])
                            if old_out:
                                mr_ids = index._mr_ids
                                for y, ms in old_out.items():
                                    yb, ybit = y >> 3, 1 << (y & 7)
                                    for mr in ms:
                                        old_rows[mr_ids[mr], yb] |= ybit
                    probe = PhaseProbe(nl)
                    c0 = stats.counters()
                    runner.run(v, backward, probe)
                    old_trace.put(v, backward, PhaseTrace(
                        probe.visited, probe.near, tuple(probe.lab),
                        _sub_counters(stats.counters(), c0)))
                    # diff old vs new output -> condition-D marks
                    if mirror is not None:
                        # vectorized: XOR the hub's packed mirror rows
                        # against its old output rows
                        new_rows = side_rows[v]
                        changed = int.from_bytes(np.bitwise_or.reduce(
                            new_rows ^ old_rows, axis=0).tobytes(),
                            "little")
                        new_ys = int.from_bytes(np.bitwise_or.reduce(
                            new_rows, axis=0).tobytes(), "little")
                    else:
                        side_maps = index.l_out if backward else index.l_in
                        old_ys = old_mask[backward].get(v, 0)
                        changed = 0
                        new_ys = 0
                        newtab: Dict[int, Set[tuple]] = {}
                        old_tab = old_out or {}
                        for y in mask_vertices(probe.visited | old_ys):
                            new_mrs = side_maps[y].get(v)
                            if new_mrs:
                                new_ys |= 1 << y
                                newtab[y] = new_mrs
                            if (new_mrs or set()) != (old_tab.get(y)
                                                     or set()):
                                changed |= 1 << y
                        pending_tab[backward][v] = newtab
                    new_out_mask[backward][v] = new_ys
                    if v in mover_set:
                        mover_gate |= new_ys
                    if changed:
                        changed_by_hub[backward][v] = changed
                        dirty_rows[backward] |= changed
        except _FallbackNeeded:
            return bail("budget")

        _add_counters(stats, acc)
        self._capture(runner, index)
        stats.wall_time_s = time.perf_counter() - t0
        self.graph = new_graph
        self.index = index
        self.stats = stats
        self.deltas_applied += 1

        # rows that must re-freeze because a mover hub's aid shifted the
        # row's sort order (entries themselves unchanged)
        resort = {True: 0, False: 0}
        for backward in (True, False):
            for u in movers:
                resort[backward] |= (old_mask[backward].get(u, 0)
                                     | new_out_mask[backward].get(u, 0))
            resort[backward] &= ~dirty_rows[backward]

        # refresh the carried replay tables for the re-run hubs (clean
        # hubs keep their shared rows untouched)
        mrs_by_c = (
            [mr for mr, _ in sorted(mr_id_space(nl, self.k).items(),
                                    key=lambda kv: kv[1])]
            if self._mirror is not None else None)
        for backward in (True, False):
            side_all = None
            if self._mirror is not None:
                side_all = (self._mirror.out if backward
                            else self._mirror.in_)
            tab = rep[backward]
            masks = old_mask[backward]
            for v in rerun_hubs[backward]:
                if side_all is not None:
                    rows = side_all[v]
                    newtab = {}
                    for c in np.nonzero(rows.any(axis=1))[0].tolist():
                        mr = mrs_by_c[c]
                        for y in np.nonzero(np.unpackbits(
                                rows[c], count=V,
                                bitorder="little"))[0].tolist():
                            row = newtab.get(y)
                            if row is None:
                                row = newtab[y] = set()
                            row.add(mr)
                else:
                    newtab = pending_tab[backward].get(v, {})
                if newtab:
                    tab[v] = newtab
                else:
                    tab.pop(v, None)
                new_ys = new_out_mask[backward][v]
                if new_ys:
                    masks[v] = new_ys
                else:
                    masks.pop(v, None)
        self._needs_full = False
        self._m_apply.inc(1, outcome="incremental")
        self._m_rerun.inc(rerun)
        self._m_replay.inc(replayed)
        for cause, n in causes.items():
            self._m_cause.inc(n, cause=cause)
        self._m_apply_s.observe(stats.wall_time_s)
        return DeltaResult(
            stats=stats,
            phases_total=2 * V,
            phases_rerun=rerun,
            phases_replayed=replayed,
            dirty_out=_rows_of(dirty_rows[True]),
            dirty_in=_rows_of(dirty_rows[False]),
            resort_out=_rows_of(resort[True]),
            resort_in=_rows_of(resort[False]),
            causes=causes)
