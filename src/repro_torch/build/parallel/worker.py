"""Per-worker build engine + the epoch executors (inline / process).

A :class:`LocalEngine` is one process's view of the build: a dict
:class:`~repro_torch.core.rlc_index.RLCIndex`, a
:class:`~repro_torch.build.parallel.mirror.HubSliceMirror` for the PR1 rows,
and a :class:`~repro_torch.build.batched.PhaseRunner` so every phase executes
*exactly* the hybrid scalar/bits/vector path a sequential batched build
would have used. The coordinator keeps one holding only the
authoritative committed prefix (for fingerprint validation and exact
stale re-runs); each worker's holds the **speculative union** — every
result the coordinator has broadcast, validated or not.

Speculative forwarding is what keeps the stale-re-run rate at the
missed-DAG-edge level instead of the commit-frontier-lag level: a
parked result is shipped to workers the epoch after it runs, so
dependents dispatched later read real (if unvalidated) content. PR2
makes this safe to apply eagerly — a phase only ever writes entries at
*later-ranked* vertices than its hub, so a result from sequential
position ``q`` can never appear in the read set of a phase at position
``p < q``; an earlier phase's view is never contaminated by speculation
from ahead of it. (With PR2 ablated the contamination is possible and
simply shows up as extra stale re-runs — never wrong bits, since
commits still require a fingerprint match against the authoritative
prefix.)

Worker epoch cycle:

1. apply the coordinator's event-log slice — ``apply`` events add a
   result's entry masks (idempotent re-delivery of its own results is
   skipped by mask equality), ``retract`` events wipe a mis-speculated
   result (exact: a hub's write-side row has only one writer);
2. run the assigned phases in position order, fingerprinting each
   phase's PR1 read set *before* running it (entries at the hub vertex
   + exact row contents of the hubs they name — row *content*, not
   counts: a predecessor that later turns out stale can leave
   equal-cardinality, different-bit rows);
3. ship ``(position, fingerprint, output masks, counter deltas, wall
   time)`` per phase; its own writes stay in place as speculation.

Within an epoch a worker's later phases see its earlier phases' writes
(local chaining); the fingerprints embed exactly what was seen, so the
coordinator's in-order validation catches any chain built on a phase
that had to be re-run.
"""
from __future__ import annotations

import os
import time
import traceback
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.graph import LabeledGraph
from repro_torch.core.minimum_repeat import mr_id_space
from repro_torch.core.rlc_index import RLCIndex
from repro_torch.build.base import BuildStats, mask_vertices
from repro_torch.build.batched import PhaseRunner
from repro_torch.build.numpy_backend import NumpyBackend

from .mirror import HubSliceMirror

__all__ = ["LocalEngine", "BuildWorker", "InlineExecutor",
           "ProcessExecutor", "PhaseResult", "start_method"]

#: one executed phase: (position, fingerprint, {mr id: new-entry mask},
#: BuildStats counter delta, wall seconds)
PhaseResult = Tuple[int, int, Dict[int, int], Tuple[int, ...], float]


class LocalEngine:
    """Prefix-state index + sliced mirror + the shared phase executor."""

    def __init__(self, graph: LabeledGraph, k: int, aid: np.ndarray,
                 use_pr1: bool = True, use_pr2: bool = True,
                 use_pr3: bool = True, mode: str = "hybrid",
                 scalar_threshold: Optional[int] = None,
                 gather_threshold: Optional[int] = None):
        self.graph = graph
        self.k = int(k)
        mr_ids = mr_id_space(graph.num_labels, k) if graph.num_labels \
            else {}
        self.index = RLCIndex(graph.num_vertices, k,
                              np.asarray(aid, dtype=np.int64))
        self.stats = BuildStats()
        self.mirror = HubSliceMirror(len(mr_ids), graph.num_vertices)
        # the sliced mirror is allocation-proportional, so the dense
        # budget guard must never push phases off the batched tiers
        self._backend = NumpyBackend(
            use_pr1=use_pr1, use_pr2=use_pr2, use_pr3=use_pr3, mode=mode,
            scalar_threshold=scalar_threshold,
            gather_threshold=gather_threshold, mirror_budget=1 << 62)
        self.runner = PhaseRunner(self._backend, graph, k, self.index,
                                  self.stats, mirror=self.mirror)
        if not self.runner.adopted_mirror:
            # scalar mode skips the batch setup; attach the mirror anyway
            # so inserts keep it in sync (output extraction reads it)
            self.index._mirror = self.mirror
            self.index._mr_ids = dict(mr_ids)
        self.mrs_by_c = [mr for mr, _ in
                         sorted(mr_ids.items(), key=lambda kv: kv[1])]
        self.use_pr1 = use_pr1
        self.use_pr2 = use_pr2

    # -- phase execution ------------------------------------------------ #
    def run_phase(self, v: int, backward: bool
                  ) -> Tuple[Tuple[int, ...], float]:
        """Run one phase; returns (counter delta, wall seconds)."""
        before = self.stats.counters()
        t0 = time.perf_counter()
        self.runner.run(v, backward)
        dt = time.perf_counter() - t0
        return tuple(a - b for a, b in
                     zip(self.stats.counters(), before)), dt

    def extract_output(self, v: int, backward: bool) -> Dict[int, int]:
        """The phase's new entries as ``{mr id: vertex mask}`` — the
        write-side hub block *is* the output (uncommitted hubs have
        empty prefix rows)."""
        side = self.mirror.out if backward else self.mirror.in_
        return side.masks(v)

    def fingerprint(self, v: int, backward: bool) -> int:
        """Digest of everything PR1 can read during phase ``(v, dir)``:
        the entry items at ``v`` plus the exact packed rows of the hubs
        they name (row *content*, not counts — a chained predecessor
        that later turns out stale can leave equal-cardinality,
        different-bit rows). A commutative sum of per-item tuple hashes:
        order-independent without sorting, deterministic across worker
        processes, forked or spawned (int/tuple hashing is unseeded),
        and far cheaper than a cryptographic digest — this runs once per
        phase on every worker *and* once per phase inside the
        coordinator's serial merge.
        Zero with PR1 off — the phase is then read-free and can never
        be stale."""
        if not self.use_pr1:
            return 0
        row = self.index.l_in[v] if backward else self.index.l_out[v]
        side = self.mirror.out if backward else self.mirror.in_
        mr_ids = self.index._mr_ids
        acc = 0
        for x, mrs in row.items():
            for mr in mrs:
                c = mr_ids[mr]
                acc = (acc + hash((x, c, side.row_int(x, c)))) \
                    & 0xFFFFFFFFFFFFFFFF
        return acc

    # -- state mutation -------------------------------------------------- #
    def apply_output(self, v: int, backward: bool,
                     masks: Dict[int, int], in_index: bool = False
                     ) -> None:
        """Add a phase's output entries to the local state. ``in_index``
        skips the dict insert (the coordinator re-running a phase on its
        own index already holds the entries — only the rows lag)."""
        side = self.mirror.out if backward else self.mirror.in_
        maps = self.index.l_out if backward else self.index.l_in
        for c, mask in masks.items():
            side.apply_mask(v, c, mask)
            if not in_index:
                mr = self.mrs_by_c[c]
                for y in mask_vertices(mask):
                    maps[y].setdefault(v, set()).add(mr)

    def retract_output(self, v: int, backward: bool,
                       masks: Dict[int, int]) -> None:
        """Remove a phase's output (own writes or mis-speculated
        broadcast — exact either way: the hub's write-side row has no
        other writer)."""
        side = self.mirror.out if backward else self.mirror.in_
        side.clear_row(v)
        maps = self.index.l_out if backward else self.index.l_in
        mr_by_c = self.mrs_by_c
        for c, mask in masks.items():
            mr = mr_by_c[c]
            for y in mask_vertices(mask):
                s = maps[y].get(v)
                if s is not None:
                    s.discard(mr)
                    if not s:
                        del maps[y][v]


#: coordinator -> worker state event:
#: ("apply", pos, hub, backward, ({mr id: mask}, written-vertex set))
#: | ("retract", pos)
Event = Tuple


class BuildWorker:
    """One worker's epoch loop over a :class:`LocalEngine`."""

    def __init__(self, graph: LabeledGraph, k: int, aid: np.ndarray,
                 **engine_kw):
        self.engine = LocalEngine(graph, k, aid, **engine_kw)
        #: results currently applied locally: pos -> (hub, backward,
        #: masks). Own runs land here too, so re-delivery of an
        #: unchanged own result is a no-op and a corrected one retracts
        #: cleanly.
        self.applied: Dict[int, Tuple[int, bool, Dict[int, int]]] = {}

    def run_epoch(self, events: List[Event],
                  phases: List[Tuple[int, int, bool]]
                  ) -> Tuple[List[PhaseResult], int]:
        """Apply the coordinator's event-log slice, then run
        ``(pos, hub, backward)`` phases in order; returns (results, peak
        mirror bytes). Writes stay in place as speculation."""
        eng = self.engine
        for ev in events:
            if ev[0] == "apply":
                _, pos, v, backward, rec = ev
                masks = rec[0]      # (masks, written-vertex set) record
                held = self.applied.get(pos)
                if held is not None:
                    if held[2] == masks:
                        continue
                    eng.retract_output(*held)
                eng.apply_output(v, backward, masks)
                self.applied[pos] = (v, backward, masks)
            else:   # ("retract", pos)
                held = self.applied.pop(ev[1], None)
                if held is not None:
                    eng.retract_output(*held)
        # content fingerprints back the PR2-ablated validation path; with
        # PR2 on the coordinator validates from its event-log replay of
        # this worker's state instead, and the digest work is skipped
        need_fp = eng.use_pr1 and not eng.use_pr2
        results: List[PhaseResult] = []
        for pos, v, backward in phases:
            fp = eng.fingerprint(v, backward) if need_fp else 0
            counter_delta, secs = eng.run_phase(v, backward)
            masks = eng.extract_output(v, backward)
            self.applied[pos] = (v, backward, masks)
            results.append((pos, fp, masks, counter_delta, secs))
        return results, eng.mirror.size_bytes()


class InlineExecutor:
    """Deterministic in-process executor (tests, 1-core fallbacks).

    ``submit`` runs the batch immediately and returns its payload — the
    coordinator then sequences collections in *virtual* completion
    order (dispatch time + measured busy seconds), so the scheduling
    decisions replay what a truly concurrent run with these phase
    timings would have made. ``recv_any`` is never called on this
    executor."""

    kind = "inline"
    start_method = None
    startup_s = 0.0

    def __init__(self, workers: int, graph: LabeledGraph, k: int,
                 aid: np.ndarray, **engine_kw):
        self._workers = [BuildWorker(graph, k, aid, **engine_kw)
                         for _ in range(workers)]

    def submit(self, wid: int,
               job: Tuple[List[Event], List[Tuple[int, int, bool]]]
               ) -> Tuple[List[PhaseResult], int]:
        return self._workers[wid].run_epoch(*job)

    def recv_any(self):  # pragma: no cover - inline submits are eager
        raise RuntimeError("InlineExecutor completes jobs at submit")

    def close(self) -> None:
        pass


def _worker_main(conn):  # pragma: no cover
    # (child process body; exercised via ProcessExecutor tests)
    try:
        graph, k, aid, engine_kw = conn.recv()
        worker = BuildWorker(graph, k, aid, **engine_kw)
    except Exception:
        conn.send(("err", traceback.format_exc()))
        conn.close()
        return
    conn.send(("ready", None))
    while True:
        msg = conn.recv()
        if msg is None:
            conn.close()
            return
        try:
            conn.send(("ok", worker.run_epoch(*msg)))
        except Exception:
            conn.send(("err", traceback.format_exc()))


def start_method() -> str:
    """The start method of the process executor's workers: the
    ``RLC_PARALLEL_MP_CONTEXT`` environment variable when set, else
    ``spawn`` once the caller's process holds a CUDA context, else
    ``fork``.

    ``fork`` works for any caller script (``spawn`` re-imports
    ``__main__`` in the child, so the caller must be import-guarded),
    but a child forked from a process with a CUDA context or live
    threads can deadlock or crash; a process that has touched the card
    spawns its workers instead. The workers are host numpy either way
    and never create a CUDA tensor; the pipes are the only shared
    state."""
    method = os.environ.get("RLC_PARALLEL_MP_CONTEXT")
    if method:
        return method
    import torch
    return "spawn" if torch.cuda.is_initialized() else "fork"


class ProcessExecutor:
    """One OS process per worker, pipe-speaking the batch protocol.
    ``submit`` returns as soon as the job is on the pipe; ``recv_any``
    blocks for whichever in-flight worker finishes first, so the
    coordinator re-dispatches each worker the moment it goes idle and
    its validation/merge pass genuinely overlaps worker compute. A
    worker that raises, or dies, raises :class:`RuntimeError` here.

    Every worker is started before any is sent the engine's inputs
    (graph, access ids, options): as ``Process`` arguments they would
    ride in the ``spawn`` payload, whose write blocks until the child
    has imported the package, and the children would start one after
    another. The constructor returns once every worker has built its
    engine (:attr:`startup_s`)."""

    kind = "process"

    def __init__(self, workers: int, graph: LabeledGraph, k: int,
                 aid: np.ndarray, **engine_kw):
        import multiprocessing as mp
        t0 = time.perf_counter()
        self.start_method = start_method()
        ctx = mp.get_context(self.start_method)
        self._conns = []
        self._procs = []
        self._inflight: set = set()
        for _ in range(workers):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_worker_main, args=(child,),
                            daemon=True)
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)
        for wid in range(workers):
            self._send(wid, (graph, k, aid, engine_kw))
        for wid in range(workers):
            self._recv(wid)
        self.startup_s = time.perf_counter() - t0

    def _send(self, wid: int, msg) -> None:
        try:
            self._conns[wid].send(msg)
        except OSError as e:
            self.close()
            raise RuntimeError(
                f"parallel build worker {wid} is gone: {e}") from e

    def _recv(self, wid: int):
        """The payload of worker ``wid``'s next reply; a failure or an
        exit raises :class:`RuntimeError` after stopping every worker."""
        try:
            status, payload = self._conns[wid].recv()
        except EOFError:
            self._procs[wid].join(timeout=5)
            status, payload = "err", (
                f"the process exited with code "
                f"{self._procs[wid].exitcode}")
        if status == "err":
            self.close()
            raise RuntimeError(
                f"parallel build worker {wid} failed:\n{payload}")
        return payload

    def submit(self, wid: int, job) -> None:
        self._send(wid, job)
        self._inflight.add(wid)

    def recv_any(self) -> Tuple[int, Tuple[List[PhaseResult], int]]:
        from multiprocessing.connection import wait
        conn = wait([self._conns[w] for w in self._inflight])[0]
        wid = self._conns.index(conn)
        self._inflight.discard(wid)
        return wid, self._recv(wid)

    def close(self) -> None:
        for conn, p in zip(self._conns, self._procs):
            try:
                conn.send(None)
                conn.close()
            except OSError:
                pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():  # pragma: no cover
                p.terminate()
                p.join()
