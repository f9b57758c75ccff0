"""Port sharded serving (``repro_torch.service.sharded``) against the JAX
package's ``ShardedRLCService`` and the port's own ``RLCService``.

One reference-built index is carried across (``repro_torch.convert``) and
served by both packages' sharded facades over shards {1, 2, 4} x replicas
{1, 2}, with a frozen scheduler clock so both flush the same batches:
answers must be bit-identical to each other and to the port's
single-host service, through a mid-stream ``hot_swap`` and an
``apply_delta``, with equal fan-out counters (``sub_batches``,
``remote_joins_*``, ``digest_bytes``). The planner and router must
equal the reference's; EXPLAIN routes, the per-shard audit and the
``stats()`` document must carry the same keys. Each place where the
reference turns a device error into host serving raises in the port on
a CUDA layout (a layout claiming a CUDA device, whose device work
fails, stands in for a card here); on CPU layouts the reference's
fallbacks stay.
"""
import dataclasses
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as hst

torch = pytest.importorskip("torch")

from repro_torch import graphgen as tgen  # noqa: E402
from repro_torch.build import build_rlc_index as t_build  # noqa: E402
from repro_torch.convert import (frozen_from_arrays,  # noqa: E402
                                 index_from_entries)
from repro_torch.core.baselines import bibfs_rlc  # noqa: E402
from repro_torch.core.minimum_repeat import (enumerate_mrs,  # noqa: E402
                                             mr_id_space)
from repro_torch.service import (RLCService, ServiceConfig,  # noqa: E402
                                 ShardedRLCService, ShardedServiceConfig,
                                 validate_stats)
from repro_torch.service.executor import BatchExecutor  # noqa: E402
from repro_torch.service.sharded import (TwoSidedRouter,  # noqa: E402
                                         build_device_layout, plan_shards)
from repro_torch.service.sharded import replica as replica_mod  # noqa: E402
from repro_torch.service.sharded import service as service_mod  # noqa: E402

K = 2
FIELDS = ("aid", "out_indptr", "out_hub", "out_mr", "in_indptr", "in_hub",
          "in_mr")
FANOUT = ("sub_batches", "remote_joins_device", "remote_joins_numpy",
          "digest_bytes", "degraded")


def frozen_clock():
    return 0.0


def jax_pkg():
    """The JAX package's generators, build and services (imported only
    by the comparison tests)."""
    pytest.importorskip("jax")
    return dict(gen=pytest.importorskip("repro.graphgen"),
                build=pytest.importorskip("repro.build"),
                svc=pytest.importorskip("repro.service"),
                sharded=pytest.importorskip("repro.service.sharded"))


def carry(jidx):
    """The port's RLCIndex holding a reference index's entries."""
    return index_from_entries(jidx.num_vertices, jidx.k, jidx.aid,
                              jidx.l_out, jidx.l_in)


def stream(n, count, seed, num_labels=3):
    rng = np.random.default_rng(seed)
    mrs = enumerate_mrs(num_labels, K)
    return [(int(rng.integers(n)), int(rng.integers(n)),
             mrs[int(rng.integers(len(mrs)))]) for _ in range(count)]


def values(answers):
    return [bool(a) for a in answers]


def fanout(svc):
    ex = svc.stats()["executor"]
    return {k: ex[k] for k in FANOUT}


def cfg(**kw):
    base = dict(k=K, batch_size=8, cache_capacity=128, build_backend="numpy",
                delta_fallback_frac=1.0, clock=frozen_clock)
    base.update(kw)
    return base


# ------------------------------------------------------------------ #
# Planner and router against the reference
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module")
def carried_frozen():
    j = jax_pkg()
    g = j["gen"].barabasi_albert(120, 3, 3, seed=5)
    ids = mr_id_space(3, K)
    jfrozen = j["build"].build_rlc_index(g, K, backend="numpy").freeze(ids)
    tfrozen = frozen_from_arrays(jfrozen.num_vertices, jfrozen.k,
                                 *(getattr(jfrozen, f) for f in FIELDS))
    return j, jfrozen, tfrozen


@pytest.mark.parametrize("num_shards", [1, 2, 3, 4, 8])
def test_plan_and_router_equal_reference(carried_frozen, num_shards):
    j, jfrozen, tfrozen = carried_frozen
    jplan = j["sharded"].plan_shards(jfrozen, num_shards)
    tplan = plan_shards(tfrozen, num_shards)
    np.testing.assert_array_equal(tplan.starts, jplan.starts)
    np.testing.assert_array_equal(tplan.entries, jplan.entries)
    assert tplan.as_dict() == jplan.as_dict()
    v = np.arange(tfrozen.num_vertices)
    np.testing.assert_array_equal(tplan.shard_of_batch(v),
                                  jplan.shard_of_batch(v))
    jr, tr = j["sharded"].TwoSidedRouter(jplan), TwoSidedRouter(tplan)
    rng = np.random.default_rng(num_shards)
    for s, t in rng.integers(0, tfrozen.num_vertices, (200, 2)).tolist():
        a, b = tr.route(s, t), jr.route(s, t)
        assert (a.shard_s, a.shard_t, a.home, a.local) == \
            (b.shard_s, b.shard_t, b.home, b.local)
        assert a.home == tplan.shard_of(t)
    assert tr.stats() == jr.stats()


def test_plan_rejects_bad_shard_counts():
    g = tgen.erdos_renyi(10, 2.0, 2, seed=0)
    frozen = t_build(g, K).freeze(mr_id_space(2, K))
    for bad in (0, 11):
        with pytest.raises(ValueError):
            plan_shards(frozen, bad)


# ------------------------------------------------------------------ #
# Sharded serving: port vs reference vs the port's single host
# ------------------------------------------------------------------ #
N = 60


@pytest.fixture(scope="module")
def world():
    """One graph from one seed in both packages, the reference's index
    carried into the port, the stream, the swap graph and one delta."""
    j = jax_pkg()
    jg = j["gen"].erdos_renyi(N, 3.5, 3, seed=21)
    tg = tgen.erdos_renyi(N, 3.5, 3, seed=21)
    np.testing.assert_array_equal(tg.edges, jg.edges)
    jidx = j["build"].build_rlc_index(jg, K, backend="numpy")
    jg2 = j["gen"].erdos_renyi(N, 5.0, 3, seed=22)
    tg2 = tgen.erdos_renyi(N, 5.0, 3, seed=22)
    np.testing.assert_array_equal(tg2.edges, jg2.edges)
    jdelta = j["gen"].random_delta(jg2, 3, 3, np.random.default_rng(23))
    tdelta = tgen.random_delta(tg2, 3, 3, np.random.default_rng(23))
    for f in ("inserts", "deletes"):
        np.testing.assert_array_equal(getattr(tdelta, f),
                                      getattr(jdelta, f))
    single = RLCService.build(tg, ServiceConfig(device="cpu", **cfg()),
                              index=carry(jidx))
    qs = stream(N, 120, seed=24)
    return dict(j=j, jg=jg, tg=tg, jidx=jidx, jg2=jg2, tg2=tg2,
                jdelta=jdelta, tdelta=tdelta, single=single, qs=qs,
                want=values(single.query_batch(qs)))


@pytest.mark.parametrize("num_replicas", [1, 2])
@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_sharded_matches_reference_and_single_host(world, num_shards,
                                                   num_replicas):
    j, qs = world["j"], world["qs"]
    shape = dict(num_shards=num_shards, num_replicas=num_replicas)
    ref = j["sharded"].ShardedRLCService.build(
        world["jg"], j["sharded"].ShardedServiceConfig(**cfg(**shape)),
        index=world["jidx"])
    svc = ShardedRLCService.build(
        world["tg"], ShardedServiceConfig(device="cpu", **cfg(**shape)),
        index=carry(world["jidx"]))
    half = len(qs) // 2

    def both(queries):
        got, want = values(svc.query_batch(queries)), \
            values(ref.query_batch(queries))
        assert got == want
        assert fanout(svc) == fanout(ref)
        return got

    # the stream, cold and then through the warm cache
    assert both(qs) == world["want"]
    assert both(qs) == world["want"]
    # a hot swap to a denser graph in the middle of a stream
    svc.cache.clear()
    ref.cache.clear()
    assert both(qs[:half]) == world["want"][:half]
    assert svc.hot_swap(graph=world["tg2"]) == \
        ref.hot_swap(graph=world["jg2"]) == 1
    after = both(qs[half:])
    assert after == [bibfs_rlc(world["tg2"], s, t, L)
                     for s, t, L in qs[half:]]
    # an incremental delta (its bootstrap, then the dirty shards swap)
    tsum = svc.apply_delta(world["tdelta"])
    jsum = ref.apply_delta(world["jdelta"])
    for k in ("shards_touched", "dirty_out", "dirty_in", "cache_evicted",
              "generation"):
        assert tsum[k] == jsum[k], k
    assert not tsum["delta"]["fallback"]
    got = both(qs)
    assert got == [bibfs_rlc(svc.graph, s, t, L) for s, t, L in qs]
    # and the port's single host on the mutated graph
    single = RLCService.build(svc.graph, ServiceConfig(device="cpu",
                                                       **cfg()))
    assert values(single.query_batch(qs)) == got
    if num_shards > 1:
        f = fanout(svc)
        assert f["remote_joins_device"] > 0 and f["digest_bytes"] > 0
        assert f["remote_joins_numpy"] == 0 and f["degraded"] == 0
    st = svc.stats()
    assert [(s["generation"], s["swaps"]) for s in st["shards"]] == \
        [(s["generation"], s["swaps"]) for s in ref.stats()["shards"]]


@settings(deadline=None, max_examples=4)
@given(hst.integers(0, 10_000), hst.integers(40, 70))
def test_sharded_matches_single_host_and_oracle_on_random_graphs(seed, n):
    """The port's twin of the reference's property test: on random
    graphs, shards {1, 2, 4} x replicas {1, 2} answer bit-identically to
    the port's single host and to the BiBFS oracle, cold and warm."""
    g = tgen.erdos_renyi(n, 3.5, 3, seed=seed)
    base = RLCService.build(g, ServiceConfig(device="cpu", **cfg()))
    qs = stream(n, 100, seed=seed + 1)
    want = values(base.query_batch(qs))
    assert want == [bibfs_rlc(g, s, t, L) for s, t, L in qs]
    for num_shards in (1, 2, 4):
        for num_replicas in (1, 2):
            svc = ShardedRLCService.build(g, ShardedServiceConfig(
                device="cpu", **cfg(num_shards=num_shards,
                                    num_replicas=num_replicas)),
                index=base.index)
            assert values(svc.query_batch(qs)) == want
            assert values(svc.query_batch(qs)) == want


def test_stats_explain_and_audit_carry_the_reference_keys(world):
    j, qs = world["j"], world["qs"]
    shape = dict(num_shards=3, num_replicas=2)
    ref = j["sharded"].ShardedRLCService.build(
        world["jg"], j["sharded"].ShardedServiceConfig(**cfg(**shape)),
        index=world["jidx"])
    svc = ShardedRLCService.build(
        world["tg"], ShardedServiceConfig(device="cpu", **cfg(**shape)),
        index=carry(world["jidx"]))
    svc.query_batch(qs)
    ref.query_batch(qs)
    tst, jst = validate_stats(svc.stats()), ref.stats()
    j["svc"].validate_stats(tst)
    assert set(tst) == set(jst)
    for sec in ("executor", "router", "index"):
        assert set(tst[sec]) == set(jst[sec]), sec
    assert tst["router"] == jst["router"]
    assert tst["index"] == jst["index"]
    for a, b in zip(tst["shards"], jst["shards"]):
        assert set(a) == set(b)
        for k in ("lo", "hi", "entries", "size_bytes", "row_len"):
            assert a[k] == b[k], k
    for s, t, L in qs[:24]:
        ta, ja = svc.explain(s, t, L), ref.explain(s, t, L)
        assert ta["answer"] == ja["answer"]
        assert ta["route"] == ja["route"]
    trep, jrep = svc.audit_report(sample=16), ref.audit_report(sample=16)
    assert trep["shards"] == jrep["shards"]
    assert trep["bytes"]["device"] == jrep["bytes"]["device"]


def test_windowed_layouts_are_shared_and_served_through_the_kernel(world):
    """Each shard's layout holds only its rows and is shared by its
    replicas; with ``backend="cuda"`` (the merge kernel's plain version
    on CPU tensors) every same-shard sub-batch goes through the kernel's
    entry point at ``row_base = lo``."""
    from repro_torch.kernels import mergejoin
    svc = ShardedRLCService.build(
        world["tg"], ShardedServiceConfig(device="cpu", backend="cuda",
                                          **cfg(num_shards=4,
                                                num_replicas=2)),
        index=carry(world["jidx"]))
    bases = []
    real = mergejoin.query_batch

    def spy(*args, row_base_out=0, row_base_in=0):
        bases.append((row_base_out, row_base_in))
        return real(*args, row_base_out=row_base_out,
                    row_base_in=row_base_in)

    mergejoin.query_batch = spy
    try:
        got = svc.query_batch(world["qs"])
    finally:
        mergejoin.query_batch = real
    assert values(got) == world["want"]
    assert {a.backend for a in got if a.disposition == "computed"} == \
        {"cuda", "digest"}
    los = {rs.lo for rs in svc.shards}
    assert bases and {b for b, _ in bases} <= los
    assert all(a == b for a, b in bases)
    old = []
    for rs in svc.shards:
        r0, r1 = rs.replicas
        assert r0.device_index is r1.device_index
        assert r0.device_index.out_hub.shape[0] == rs.hi - rs.lo
        assert r0.device_index.row_lo == rs.lo
        old.append(r0.device_index)
    svc.hot_swap()
    for rs, layout in zip(svc.shards, old):
        r0, r1 = rs.replicas
        assert r0.device_index is r1.device_index is not layout


def test_async_submit_with_a_hot_swap_from_another_thread(world):
    svc = ShardedRLCService.build(
        world["tg"], ShardedServiceConfig(
            device="cpu", **cfg(num_shards=4, num_replicas=2,
                                clock=None)),
        index=carry(world["jidx"]))
    qs = world["qs"]
    futs = [None] * len(qs)

    def submit(lo):
        for i in range(lo, len(qs), 4):
            futs[i] = svc.submit(*qs[i])

    with svc.start():
        workers = [threading.Thread(target=submit, args=(i,))
                   for i in range(4)]
        swapper = threading.Thread(target=svc.hot_swap)
        for w in workers[:2]:
            w.start()
        swapper.start()
        for w in workers[2:]:
            w.start()
        for th in workers + [swapper]:
            th.join(timeout=60)
            assert not th.is_alive()
        svc._engine.flush()
        got = [f.result(timeout=60) for f in futs]
    assert values(got) == world["want"]
    assert svc.generation == 1
    assert svc._engine.failed_batches == 0


def test_sharded_service_honours_cache_ttl_and_close(world):
    svc = ShardedRLCService.build(
        world["tg"], ShardedServiceConfig(device="cpu", cache_ttl_s=45.0,
                                          **cfg()),
        index=carry(world["jidx"]))
    assert svc.cache.ttl_s == 45.0
    svc.start()
    svc.close()
    svc.close()                                  # idempotent
    assert not svc.batcher.ticker_running
    assert values(svc.query_batch(world["qs"][:8])) == world["want"][:8]


# ------------------------------------------------------------------ #
# No silent degradation on a CUDA layout
# ------------------------------------------------------------------ #
class _FailingCudaLayout:
    """A shard layout on a CUDA device whose device work fails, as a
    kernel or a copy that does not build or launch would."""
    device = torch.device("cuda")
    row_len = 8

    def query_batch(self, *args, **kw):
        raise RuntimeError("rlc_mergejoin failed to launch")

    def gather_out_rows(self, s):
        raise RuntimeError("digest gather failed on the card")

    gather_in_rows = gather_out_rows


class _FailingCpuLayout(_FailingCudaLayout):
    device = torch.device("cpu")


def _with_layout(svc, shard_id, layout):
    """Give every replica of ``shard_id`` the layout ``layout``."""
    rs = svc.shards[shard_id]
    for i, rep in enumerate(rs.replicas):
        ex = BatchExecutor(rep.executor.index, rep.frozen, layout,
                           svc._id_to_mr, obs=svc.obs,
                           shard=str(shard_id))
        rs.replicas[i] = dataclasses.replace(rep, device_index=layout,
                                             executor=ex)


def _two_shards(world, **kw):
    return ShardedRLCService.build(
        world["tg"], ShardedServiceConfig(device="cpu",
                                          **cfg(num_shards=2, **kw)),
        index=carry(world["jidx"]))


def test_shard_devices_are_explicit(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert service_mod._shard_devices(3, cpu) == [cpu] * 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert service_mod._shard_devices(3, cuda) == [cuda] * 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert service_mod._shard_devices(4, cuda) == [
        torch.device("cuda", i) for i in (0, 1, 2, 0)]
    # the CPU never spreads over cards
    assert service_mod._shard_devices(2, cpu) == [cpu] * 2


def test_a_missing_card_raises_instead_of_pinning_nothing(world):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        ShardedRLCService.build(world["tg"], ShardedServiceConfig(**cfg()),
                                index=carry(world["jidx"]))
    with pytest.raises(ValueError):         # host serving on a card
        ShardedRLCService.build(world["tg"], ShardedServiceConfig(
            use_device=False, **cfg()), index=carry(world["jidx"]))


def test_pin_moves_the_layout_or_raises(world, monkeypatch):
    svc = _two_shards(world)
    layout = svc.shards[0].replicas[0].device_index
    pinned = replica_mod._pin(layout, "cpu")
    for f in replica_mod._LAYOUT_TENSORS:
        assert torch.equal(getattr(pinned, f), getattr(layout, f))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            replica_mod._pin(layout, "cuda")

    def fail(self, *args, **kw):
        raise RuntimeError("device copy failed")

    monkeypatch.setattr(torch.Tensor, "to", fail)
    with pytest.raises(RuntimeError, match="device copy failed"):
        replica_mod._pin(layout, "cpu")


def test_a_layout_that_cannot_be_built_raises(world, monkeypatch):
    svc = _two_shards(world)

    def fail(*args, **kw):
        raise RuntimeError("device transfer failed")

    monkeypatch.setattr(replica_mod.DeviceIndex, "from_frozen", fail)
    with pytest.raises(RuntimeError, match="device transfer failed"):
        build_device_layout(svc.frozen, svc.mr_ids, rows=(0, 10),
                            device="cpu")
    with pytest.raises(RuntimeError, match="device transfer failed"):
        svc.hot_swap()
    with pytest.raises(RuntimeError, match="device transfer failed"):
        _two_shards(world)


def _cross_queries(svc, world):
    return [q for q in world["qs"]
            if svc.plan.shard_of(q[0]) == 0 and svc.plan.shard_of(q[1]) == 1]


def test_cross_shard_join_raises_on_a_cuda_layout(world):
    svc = _two_shards(world)
    _with_layout(svc, 0, _FailingCudaLayout())
    qs = _cross_queries(svc, world)
    with pytest.raises(RuntimeError, match="digest gather failed"):
        svc.query_batch(qs)
    f = fanout(svc)
    assert f["remote_joins_numpy"] == 0 and f["degraded"] == 0


def test_cross_shard_join_falls_back_on_a_cpu_layout(world):
    """Off the card the reference's numpy join still answers a failed
    device join, counted."""
    svc = _two_shards(world)
    _with_layout(svc, 0, _FailingCpuLayout())
    qs = _cross_queries(svc, world)
    got = svc.query_batch(qs)
    assert values(got) == [bibfs_rlc(world["tg"], *q) for q in qs]
    f = fanout(svc)
    assert f["remote_joins_numpy"] > 0 and f["remote_joins_device"] == 0


def test_a_failed_launch_raises_on_a_cuda_layout(world):
    """A same-shard sub-batch whose launch fails raises on the caller's
    thread and on the async engine's; BiBFS answers nothing."""
    sync, engine = _two_shards(world), _two_shards(world)
    for svc in (sync, engine):
        _with_layout(svc, 1, _FailingCudaLayout())
    local = [q for q in world["qs"]
             if sync.plan.shard_of(q[0]) == sync.plan.shard_of(q[1]) == 1]
    with pytest.raises(RuntimeError, match="failed to launch"):
        sync.query_batch(local)
    with engine.start(tick_interval_s=10.0):
        futs = [engine.submit(*q) for q in local]
        engine._engine.flush()
        for f in futs:
            with pytest.raises(RuntimeError, match="failed to launch"):
                f.result(timeout=30)
    assert engine._engine.failed_batches >= 1
    for svc in (sync, engine):
        assert fanout(svc)["degraded"] == 0
        assert svc.shards[1].fallbacks == 0


def test_a_failed_sub_batch_degrades_to_bibfs_on_a_cpu_layout(world):
    svc = _two_shards(world, backend="sorted")
    rs = svc.shards[1]
    for rep in rs.replicas:
        rep.executor.available = lambda b: False   # nothing can serve
    local = [q for q in world["qs"]
             if svc.plan.shard_of(q[0]) == svc.plan.shard_of(q[1]) == 1]
    got = svc.query_batch(local)
    assert values(got) == [bibfs_rlc(world["tg"], *q) for q in local]
    assert {a.backend for a in got
            if a.disposition != "cache_hit"} == {"bibfs"}
    assert fanout(svc)["degraded"] > 0


def test_mid_swap_sub_batches_degrade_exactly(world):
    """A batch served while a hot swap is building the new shards (here:
    from inside the last shard's ``prepare``, after the first shard's
    new replicas exist) runs wholly on the old generation, cross-shard
    joins included: nothing degrades, and no join meets one shard's new
    rows beside another's old ones. After the publish every batch runs
    on the new graph's index."""
    svc = _two_shards(world)
    last = svc.shards[-1]
    real, mid = last.prepare, []

    def prepare(*args, **kw):
        fresh = real(*args, **kw)
        assert svc.shards[0].swaps == 0          # nothing published yet
        svc.cache.clear()
        mid.append(svc.query_batch(world["qs"]))
        return fresh

    last.prepare = prepare
    svc.hot_swap(graph=world["tg2"])
    assert values(mid[0]) == world["want"]
    assert "degraded" not in {a.disposition for a in mid[0]}
    assert "digest" in {a.backend for a in mid[0]}
    assert [rs.swaps for rs in svc.shards] == [1, 1]
    after = svc.query_batch(world["qs"])
    assert values(after) == [bibfs_rlc(world["tg2"], *q)
                             for q in world["qs"]]
    f = fanout(svc)
    assert f["degraded"] == 0 and f["remote_joins_numpy"] == 0


def test_a_publish_waits_for_the_batch_in_flight(world):
    """A hot swap that reaches its publish while a batch is between two
    sub-batches waits for it: the batch ends on the generation it began
    on, and the swap lands right after."""
    import time
    qs = world["qs"][:16]
    svc = _two_shards(world, batch_size=len(qs))          # one batch
    entered, release, out = threading.Event(), threading.Event(), []
    real = svc.fanout._run_sub

    def held(*args, **kw):
        entered.set()
        assert release.wait(30)
        return real(*args, **kw)

    svc.fanout._run_sub = held
    batch = threading.Thread(target=lambda: out.append(svc.query_batch(qs)))
    batch.start()
    assert entered.wait(30)
    swapper = threading.Thread(target=svc.hot_swap,
                               kwargs=dict(graph=world["tg2"]))
    swapper.start()
    deadline = time.monotonic() + 30
    while svc.fanout.gate._writers_waiting == 0:
        assert time.monotonic() < deadline, "the swap never reached the gate"
        time.sleep(0.005)
    assert [rs.swaps for rs in svc.shards] == [0, 0]
    release.set()
    batch.join(30)
    swapper.join(30)
    assert not batch.is_alive() and not swapper.is_alive()
    assert values(out[0]) == world["want"][:16]
    assert [rs.swaps for rs in svc.shards] == [1, 1]
    svc.fanout._run_sub = real
    assert values(svc.query_batch(qs)) == [bibfs_rlc(world["tg2"], *q)
                                           for q in qs]
    assert fanout(svc)["degraded"] == 0


def test_borrowed_delta_backend_is_the_ports():
    assert ShardedRLCService._delta_backend is RLCService._delta_backend
    assert ShardedRLCService._ensure_delta_builder is \
        RLCService._ensure_delta_builder


def test_sharded_and_rpc_import_with_jax_blocked():
    root = Path(__file__).resolve().parents[1]
    code = ("import sys; sys.modules['jax'] = None\n"
            "import repro_torch.service.sharded, repro_torch.service.rpc\n"
            "from repro_torch.service import (ShardedRLCService, "
            "ShardedServiceConfig)\n"
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# decided at test setup (a string condition), never at import time
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")


@needs_cuda
@pytest.mark.parametrize("num_shards", [2, 4])
def test_cuda_shards_serve_through_the_kernel_on_the_card(num_shards):
    """On the card: every shard's windowed layout lies on a CUDA device,
    same-shard sub-batches launch the merge kernel, digest joins run on
    the card, and the answers equal a CPU single host's."""
    from repro_torch.kernels import mergejoin
    g = tgen.erdos_renyi(200, 3.0, 3, seed=31)
    idx = t_build(g, K)
    qs = stream(200, 300, seed=32)
    want = values(RLCService.build(g, ServiceConfig(device="cpu", **cfg()),
                                   index=idx).query_batch(qs))
    svc = ShardedRLCService.build(g, ShardedServiceConfig(
        **cfg(num_shards=num_shards, num_replicas=2)), index=idx)
    assert all(rs.on_cuda for rs in svc.shards)
    before = mergejoin.KERNEL.launches
    got = svc.query_batch(qs)
    assert values(got) == want
    assert mergejoin.KERNEL.launches > before
    f = fanout(svc)
    assert f["remote_joins_device"] > 0 and f["remote_joins_numpy"] == 0
    assert {a.backend for a in got
            if a.disposition == "computed"} <= {"cuda", "digest"}
