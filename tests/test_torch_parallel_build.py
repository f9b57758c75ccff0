"""Port vs reference: the ``parallel`` build backend and ``IndexBuilder``.

The port's ``ParallelBackend`` must give the index entries *and* pruning
counters of ``repro``'s sequential ``python`` backend (and of the port's
``numpy`` backend) for every worker count, executor, DAG shaping and
pruning ablation, as ``tests/test_parallel_build.py`` holds the JAX
package's. The DAG, the scheduler's plans and the sliced mirror are
held against ``repro``'s on the same inputs; the process executor runs
with two workers, forked and spawned; a failing worker raises; the
service builds with ``build_backend="parallel"`` and answers as
``repro``'s does; the parallel ``BuildObs`` series match the run.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import graphgen as jgen  # noqa: E402
from repro.build import build_rlc_index_with_stats as j_build  # noqa: E402
from repro_torch import graphgen as tgen  # noqa: E402
from repro_torch.build import build_rlc_index_with_stats as t_build  # noqa: E402
from repro_torch.build import get_backend  # noqa: E402
from repro_torch.build.base import access_schedule  # noqa: E402
from repro_torch.build.parallel import (HubSliceMirror, ListScheduler,  # noqa: E402
                                        ParallelBackend, PhaseCostModel,
                                        PhaseDAG)
from repro_torch.build.parallel import worker as tworker  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

#: pinned to 2 in CI so tier-1 exercises the protocol at a fixed width
WORKERS = int(os.environ.get("RLC_PARALLEL_WORKERS", "2"))


def entry_sets(idx):
    return tuple(tuple(sorted((v, h, m) for v, d in enumerate(maps)
                              for h, ms in d.items() for m in ms))
                 for maps in (idx.l_out, idx.l_in))


def graphs(name, *args, **kw):
    """(JAX package graph, port graph) from one generator call."""
    return (getattr(jgen, name)(*args, **kw),
            getattr(tgen, name)(*args, **kw))


def assert_matches_python(jg, tg, k, flags=None, **kw):
    """The port's parallel build equals ``repro``'s python build and the
    port's numpy build, entries and counters."""
    flags = flags or {}
    want_idx, want_st = j_build(jg, k, backend="python", **flags)
    np_idx, np_st = t_build(tg, k, backend="numpy", **flags)
    kw.setdefault("workers", WORKERS)
    kw.setdefault("executor", "inline")
    be = ParallelBackend(**flags, **kw)
    idx, st = be.build(tg, k)
    assert st.backend == "parallel"
    assert entry_sets(idx) == entry_sets(want_idx) == entry_sets(np_idx), \
        (flags, kw)
    assert st.counters() == want_st.counters() == np_st.counters(), \
        (flags, kw)
    return be


# ------------------------------------------------------------------ #
# Exactness: random graphs x workers x pruning flags
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("k,num_labels,loops", [
    (1, 2, 0.0), (2, 2, 0.2), (2, 3, 0.0), (3, 2, 0.3)])
def test_parallel_matches_python_random(seed, k, num_labels, loops):
    jg, tg = graphs("random_labeled_graph", num_vertices=14, num_edges=46,
                    num_labels=num_labels, seed=seed, self_loop_frac=loops)
    assert_matches_python(jg, tg, k)


@pytest.mark.parametrize("workers", [1, 2, 3, 4])
def test_parallel_worker_counts(workers):
    jg, tg = graphs("erdos_renyi", 28, 2.5, 3, seed=5)
    be = assert_matches_python(jg, tg, 2, workers=workers)
    assert be.last_build_info["mode"] == (
        "sequential" if workers == 1 else "parallel")


@pytest.mark.parametrize("flags", [
    dict(use_pr2=False),                  # content-fingerprint path
    dict(use_pr1=False),                  # read-free phases
    dict(use_pr3=False),
    dict(use_pr1=False, use_pr2=False, use_pr3=False)],
    ids=lambda f: "-".join(f))
def test_parallel_pruning_ablations(flags):
    jg, tg = graphs("random_labeled_graph", num_vertices=16, num_edges=52,
                    num_labels=2, seed=11, self_loop_frac=0.2)
    assert_matches_python(jg, tg, 2, flags=flags)


def test_parallel_fig2_exact():
    (jg, _), (tg, _) = jgen.fig2_graph(), tgen.fig2_graph()
    be = assert_matches_python(jg, tg, 2)
    assert be.last_build_info["mode"] in ("parallel", "sequential")


def test_forced_conflicts_repair_exactly():
    """The DAG stripped to intra-hub edges (hot_prefix=0, locality=0)
    makes the scheduler speculate across real dependencies: stale
    re-runs must fire, and the result must still be exact."""
    jg, tg = graphs("erdos_renyi", 40, 2.5, 2, seed=3)
    be = assert_matches_python(jg, tg, 2, workers=4, hot_prefix=0,
                               locality=0, auto_thin=False)
    info = be.last_build_info
    assert info["mode"] == "parallel"
    assert info["stale_reruns"] > 0 and info["epochs"] > 0
    # the reference's coordinator takes the same decisions: the inline
    # executor sequences by measured times, so only the shape compares
    from repro.build.parallel import ParallelBackend as JParallel
    jbe = JParallel(workers=4, executor="inline", hot_prefix=0, locality=0,
                    auto_thin=False)
    jbe.build(jg, 2)
    assert jbe.last_build_info["dag"] == info["dag"]
    assert jbe.last_build_info["mode"] == info["mode"]


# ------------------------------------------------------------------ #
# The process executor: start method, exactness, failures
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("flags", [dict(), dict(use_pr2=False)],
                         ids=["all", "no-pr2"])
@pytest.mark.parametrize("method", ["fork", "spawn"])
def test_process_executor_matches(method, flags, monkeypatch):
    """Across processes too: with PR2 off the coordinator checks the
    workers' read-set fingerprints (tuple hashes of ints, the same in
    every process) against its own."""
    monkeypatch.setenv("RLC_PARALLEL_MP_CONTEXT", method)
    jg, tg = graphs("erdos_renyi", 24, 2.0, 3, seed=7)
    be = assert_matches_python(jg, tg, 2, flags=flags, workers=2,
                               executor="process")
    info = be.last_build_info
    assert info["executor"] == "process"
    assert info["start_method"] == method
    assert info["startup_s"] > 0 and info["dag_s"] > 0


def test_start_method_spawns_once_cuda_is_initialized(monkeypatch):
    monkeypatch.delenv("RLC_PARALLEL_MP_CONTEXT", raising=False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert tworker.start_method() == "fork"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert tworker.start_method() == "spawn"
    monkeypatch.setenv("RLC_PARALLEL_MP_CONTEXT", "forkserver")
    assert tworker.start_method() == "forkserver"


def test_spawned_build_when_cuda_is_initialized(monkeypatch):
    """With a CUDA context in the parent (patched here) the default
    build spawns its workers and stays exact."""
    monkeypatch.delenv("RLC_PARALLEL_MP_CONTEXT", raising=False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    jg, tg = graphs("erdos_renyi", 30, 2.5, 3, seed=9)
    be = assert_matches_python(jg, tg, 2, workers=2, executor="auto")
    info = be.last_build_info
    assert (info["mode"], info["executor"], info["start_method"]) == (
        "parallel", "process", "spawn")


def _executor(workers=1):
    g = tgen.erdos_renyi(12, 2.0, 2, seed=1)
    order, aid = access_schedule(g)
    return g, order, tworker.ProcessExecutor(workers, g, 2, aid)


def test_failing_worker_raises_and_stops_the_workers(monkeypatch):
    monkeypatch.setenv("RLC_PARALLEL_MP_CONTEXT", "fork")
    g, order, ex = _executor()
    try:
        ex.submit(0, ([], [(0, g.num_vertices + 5, True)]))  # no such hub
        with pytest.raises(RuntimeError, match="worker 0 failed"):
            ex.recv_any()
        assert not any(p.is_alive() for p in ex._procs)
    finally:
        ex.close()


@pytest.mark.parametrize("method", ["fork", "spawn"])
def test_worker_failing_at_start_raises(method, monkeypatch):
    monkeypatch.setenv("RLC_PARALLEL_MP_CONTEXT", method)
    g = tgen.erdos_renyi(12, 2.0, 2, seed=1)
    _, aid = access_schedule(g)
    with pytest.raises(RuntimeError, match="mode 'bogus'"):
        tworker.ProcessExecutor(2, g, 2, aid, mode="bogus")
    import multiprocessing
    assert not [p for p in multiprocessing.active_children()
                if p.name.startswith(("Process", "SpawnProcess",
                                      "ForkProcess"))]


def test_dead_worker_raises(monkeypatch):
    monkeypatch.setenv("RLC_PARALLEL_MP_CONTEXT", "fork")
    g, order, ex = _executor()
    try:
        ex._procs[0].kill()
        ex._procs[0].join(timeout=30)
        with pytest.raises(RuntimeError, match="worker 0"):
            ex.submit(0, ([], [(1, int(order[0]), False)]))
            ex.recv_any()
        assert not any(p.is_alive() for p in ex._procs)
    finally:
        ex.close()


def test_registered_backend_and_env_default(monkeypatch):
    monkeypatch.setenv("RLC_PARALLEL_WORKERS", "3")
    be = get_backend("parallel")
    assert isinstance(be, ParallelBackend) and be.workers == 3
    monkeypatch.delenv("RLC_PARALLEL_WORKERS")
    assert get_backend("parallel").workers == 4
    with pytest.raises(ValueError):
        ParallelBackend(executor="threads")


# ------------------------------------------------------------------ #
# Units against the reference: DAG, scheduler, sliced mirror
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("kw", [dict(), dict(hot_prefix=0, locality=0),
                                dict(hot_prefix=8, locality=1)],
                         ids=["default", "intra-hub", "thin"])
def test_phase_dag_matches_reference(kw):
    from repro.build.base import access_schedule as j_schedule
    from repro.build.parallel import PhaseDAG as JDAG
    jg, tg = graphs("erdos_renyi", 30, 2.0, 3, seed=1)
    order, _ = access_schedule(tg)
    assert np.array_equal(order, j_schedule(jg)[0])
    dag, jdag = PhaseDAG(tg, 2, order, **kw), JDAG(jg, 2, order, **kw)
    assert dag.preds == jdag.preds
    assert np.array_equal(dag.active, jdag.active)
    assert np.array_equal(dag.levels(), jdag.levels())
    cost = np.linspace(1.0, 2.0, dag.npos)
    assert dag.stats(cost) == jdag.stats(cost)
    for p, preds in enumerate(dag.preds):
        assert all(q < p for q in preds)


def test_scheduler_plans_match_reference():
    """Under a fixed cost model the port's plans equal ``repro``'s over a
    whole simulated build: three workers dispatched in turn, results
    parked, the frontier committed in order."""
    from repro.build.parallel import ListScheduler as JSched
    from repro.build.parallel import PhaseCostModel as JCost
    from repro.build.parallel import PhaseDAG as JDAG
    jg, tg = graphs("erdos_renyi", 40, 2.5, 3, seed=2)
    order, _ = access_schedule(tg)
    est = np.arange(2 * tg.num_vertices) % 7 + 1.0
    dag = PhaseDAG(tg, 2, order)
    scheds = (ListScheduler(dag, PhaseCostModel(est), workers=3),
              JSched(JDAG(jg, 2, order), JCost(est), workers=3))
    committed = ~dag.active.copy()
    pending, inflight, frontier, rounds = set(), {}, 0, 0
    while not committed.all():
        for wid in range(3):
            if wid in inflight:
                continue
            busy = set().union(*inflight.values()) if inflight else set()
            plans = [s.plan_for(committed.copy(), sorted(pending), busy,
                                frontier) for s in scheds]
            assert plans[0] == plans[1]
            if not plans[0]:
                break
            assert plans[0] == sorted(plans[0])
            assert not busy.intersection(plans[0])
            assert all(p < frontier + ListScheduler.WINDOW
                       for p in plans[0])
            inflight[wid] = plans[0]
        done = min(inflight)          # complete the lowest worker id
        pending.update(inflight.pop(done))
        while frontier < dag.npos and (committed[frontier]
                                       or frontier in pending):
            pending.discard(frontier)
            committed[frontier] = True
            frontier += 1
        rounds += 1
    assert rounds > 3
    cm, jcm = PhaseCostModel(est), JCost(est)
    for pos, secs in ((0, 3e-4), (5, 1e-3), (9, 2e-5)):
        cm.observe(pos, secs)
        jcm.observe(pos, secs)
    assert cm.refit() == jcm.refit()
    assert np.array_equal(cm.costs(), jcm.costs())


def test_hub_slice_mirror_bytes_track():
    from repro.build.parallel import HubSliceMirror as JMirror
    mirrors = (HubSliceMirror(num_mrs=3, num_vertices=64),
               JMirror(num_mrs=3, num_vertices=64))
    for m in mirrors:
        assert m.size_bytes() == 0
        m.set1(m.out, 1, 5, 33)
        m.set1(m.in_, 2, 6, 12)
        m.set_many(m.in_, 0, 7, list(range(0, 64, 3)))
        m.out.apply_mask(9, 1, (1 << 33) | (1 << 60))
    m, jm = mirrors
    assert m.size_bytes() == jm.size_bytes() > 0
    assert m.peak_bytes == jm.peak_bytes
    assert m.out.row_int(5, 1) == 1 << 33
    assert m.in_.masks(7) == jm.in_.masks(7)
    # the running byte tally equals a walk from scratch
    expect = (len(m.out.blocks) * m.out.C * m.out.W
              + sum((v.bit_length() + 7) // 8 + 16
                    for d in m.out.rows.values() for v in d.values()))
    assert m.out.bytes_now() == expect
    m.out.clear_row(9)
    assert m.out.row_int(9, 1) == 0
    assert m.size_bytes() < m.peak_bytes


def test_peak_mirror_bytes_recorded():
    g = tgen.erdos_renyi(30, 2.5, 3, seed=9)
    be = ParallelBackend(workers=2, executor="inline")
    _, st = be.build(g, 2)
    assert st.peak_mirror_bytes > 0
    info = be.last_build_info
    assert info["mode"] == "parallel" and info["makespan_s"] > 0
    assert len(info["worker_busy_s"]) == 2 and info["epochs"] >= 1
    assert set(info) >= {"dag", "epochs", "stale_reruns", "makespan_s",
                         "worker_busy_s", "parent_serial_s", "executor"}


# ------------------------------------------------------------------ #
# Service + telemetry integration
# ------------------------------------------------------------------ #
def test_service_builds_with_parallel_backend():
    from repro.service import RLCService as JService
    from repro.service import ServiceConfig as JConfig
    from repro_torch.service import RLCService, ServiceConfig
    jg, tg = graphs("erdos_renyi", 24, 2.0, 3, seed=4)
    svc = RLCService.build(tg, ServiceConfig(
        k=2, device="cpu", build_backend="parallel"))
    jsvc = JService.build(jg, JConfig(k=2, build_backend="parallel"))
    assert svc.build_stats.backend == "parallel"
    assert svc.build_info["mode"] == "parallel"
    assert entry_sets(svc.index) == entry_sets(jsvc.index)
    rng = np.random.default_rng(0)
    exprs = ["0+", "1+", "(0 1)+", "(2 0)+", "2+"]
    queries = [(int(s), int(t), exprs[c]) for s, t, c in zip(
        rng.integers(0, 24, 300), rng.integers(0, 24, 300),
        rng.integers(0, len(exprs), 300))]
    got = [a.value for a in svc.query_batch(queries)]
    assert got == [a.value for a in jsvc.query_batch(queries)]
    # delta rebuilds map to a batched sequential backend, as in repro
    assert svc._delta_backend() == ("numpy", {})
    assert jsvc._delta_backend_name() == "numpy"
    svc.close()


def test_parallel_build_obs_series():
    from repro_torch.obs import BuildPhaseObserver, MetricsRegistry
    g = tgen.erdos_renyi(30, 2.5, 3, seed=6)
    reg = MetricsRegistry()
    be = ParallelBackend(workers=2, executor="inline")
    be.set_observer(BuildPhaseObserver(reg, context="full"))
    be.build(g, 2)
    snap = reg.as_dict()
    info = be.last_build_info
    assert info["mode"] == "parallel"
    epochs = sum(s["value"] for s in snap["rlc_build_epochs"]["series"])
    assert epochs == info["epochs"]
    stale = sum(s["value"] for s in
                snap.get("rlc_build_stale_reruns", {}).get("series", []))
    assert stale == info["stale_reruns"]
    assert snap["rlc_build_epoch_seconds"]["series"]
    workers = {s["labels"]["worker"] for s in
               snap["rlc_build_worker_phase_seconds"]["series"]}
    assert workers and workers <= {"0", "1", "parent"}
    assert snap["rlc_build_phase_seconds"]["series"]


# ------------------------------------------------------------------ #
# The back-compat surface
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("flags", [dict(), dict(use_pr2=False)],
                         ids=["all", "no-pr2"])
def test_index_builder_matches_reference(flags):
    from repro.core.index_builder import IndexBuilder as JBuilder
    from repro_torch.build import IndexBuilder as BuildIndexBuilder
    from repro_torch.core import index_builder
    assert index_builder.IndexBuilder is BuildIndexBuilder
    jg, tg = graphs("random_labeled_graph", num_vertices=14, num_edges=46,
                    num_labels=2, seed=3, self_loop_frac=0.2)
    jb, tb = JBuilder(jg, 2, **flags), index_builder.IndexBuilder(
        tg, 2, **flags)
    assert tb.index is None and tb.stats.backend == "python"
    idx = tb.build()
    assert idx is tb.index
    assert entry_sets(idx) == entry_sets(jb.build())
    assert tb.stats.counters() == jb.stats.counters()
    got, st = index_builder.build_rlc_index_with_stats(tg, 2, **flags)
    assert entry_sets(got) == entry_sets(idx)
    assert isinstance(st, index_builder.BuildStats)
    assert entry_sets(index_builder.build_rlc_index(tg, 2)) == \
        entry_sets(JBuilder(jg, 2).build())


@pytest.mark.parametrize("module", [
    "repro_torch.build.parallel", "repro_torch.core.index_builder",
    "repro_torch.core.distributed"])
def test_new_modules_import_without_jax(module):
    code = ("import sys; sys.modules['jax'] = None; "
            f"import {module}; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'imported the JAX package'")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
