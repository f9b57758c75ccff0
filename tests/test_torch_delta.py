"""Port delta builds (``repro_torch.build.delta``) against the JAX package's.

Chained random deltas go through the port's ``DeltaBuilder`` over its
``numpy`` backend and over its ``cuda`` backend (plain versions on the
CPU, ``mode="vector"`` so every hub takes a device wave), and through
``repro.build.delta.DeltaBuilder`` over ``numpy``, on graphs made from
one seed. Every step must give the same entries, counters, dirty and
re-sorted rows, ``fallback``, ``fallback_reason`` and phase counts on
both sides, and equal a full rebuild of the mutated graph.
``FrozenRLCIndex.patch_rows`` and the service's ``apply_delta``
summaries and cache evictions are held the same way.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import graphgen as tgen  # noqa: E402
from repro_torch.build import (DeltaBuilder, GraphDelta,  # noqa: E402
                               build_rlc_index_with_stats)
from repro_torch.core.minimum_repeat import (enumerate_mrs,  # noqa: E402
                                             mr_id_space)
from repro_torch.service import RLCService, ServiceConfig  # noqa: E402

FROZEN_FIELDS = ("out_indptr", "out_hub", "out_mr", "in_indptr", "in_hub",
                 "in_mr", "aid")


def entry_sets(idx):
    out = tuple(sorted((v, h, m) for v, d in enumerate(idx.l_out)
                       for h, ms in d.items() for m in ms))
    inn = tuple(sorted((v, h, m) for v, d in enumerate(idx.l_in)
                       for h, ms in d.items() for m in ms))
    return out, inn


def result_fields(res):
    """What the two packages' DeltaResults must agree on (the build
    stats' backend label and wall time aside)."""
    return dict(fallback=res.fallback, fallback_reason=res.fallback_reason,
                phases_total=res.phases_total,
                phases_rerun=res.phases_rerun,
                phases_replayed=res.phases_replayed,
                dirty_out=res.dirty_out.tolist(),
                dirty_in=res.dirty_in.tolist(),
                resort_out=res.resort_out.tolist(),
                resort_in=res.resort_in.tolist(), causes=dict(res.causes),
                counters=res.stats.counters())


def jax_delta():
    pytest.importorskip("jax")
    return (pytest.importorskip("repro.build.delta"),
            pytest.importorskip("repro.graphgen"))


PORT_BACKENDS = {"numpy": {}, "cuda": dict(mode="vector", device="cpu")}


@pytest.mark.parametrize("backend", sorted(PORT_BACKENDS))
@pytest.mark.parametrize("seed,frac", [(0, 1.0), (1, 1.0), (2, 0.05),
                                       (3, 0.3)])
def test_chained_deltas_equal_reference_and_rebuild(backend, seed, frac):
    jdelta, jgen = jax_delta()
    args = dict(num_vertices=14, num_edges=50, num_labels=3, seed=seed,
                self_loop_frac=0.15)
    g = tgen.random_labeled_graph(**args)
    jg = jgen.random_labeled_graph(**args)
    db = DeltaBuilder(g, 2, backend=backend, fallback_frac=frac,
                      **PORT_BACKENDS[backend])
    jdb = jdelta.DeltaBuilder(jg, 2, backend="numpy", fallback_frac=frac)
    db.full()
    jdb.full()
    assert entry_sets(db.index) == entry_sets(jdb.index)
    assert db.stats.counters() == jdb.stats.counters()
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        res = db.apply(tgen.random_delta(db.graph, 2, 2, rng))
        jres = jdb.apply(jgen.random_delta(jdb.graph, 2, 2, jrng))
        assert np.array_equal(db.graph.edges, jdb.graph.edges)
        assert result_fields(res) == result_fields(jres)
        assert res.stats.backend == (f"delta[{backend}]" if not res.fallback
                                     else f"{backend}+trace")
        assert entry_sets(db.index) == entry_sets(jdb.index)
        ref, ref_stats = build_rlc_index_with_stats(db.graph, 2,
                                                    backend="numpy")
        assert entry_sets(db.index) == entry_sets(ref)
        assert db.stats.counters() == ref_stats.counters()
    assert db.fallbacks == jdb.fallbacks


def test_cuda_backend_packs_each_apply_from_the_mutated_graph(monkeypatch):
    """Every apply's engine is made from the graph it runs on: the
    device adjacency never carries pre-delta edges."""
    from repro_torch.build import cuda_backend
    seen = []
    make = cuda_backend.CudaBackend._make_engine

    def spy(self, graph):
        seen.append(graph)
        return make(self, graph)

    monkeypatch.setattr(cuda_backend.CudaBackend, "_make_engine", spy)
    g = tgen.erdos_renyi(40, 2.5, 3, seed=4)
    db = DeltaBuilder(g, 2, backend="cuda", fallback_frac=1.0,
                      mode="vector", device="cpu")
    db.full()
    rng = np.random.default_rng(5)
    for _ in range(2):
        db.apply(tgen.random_delta(db.graph, 3, 3, rng))
        assert seen[-1] is db.graph
    assert len(seen) == 3


@pytest.mark.parametrize("seed", range(3))
def test_patch_rows_equal_reference_and_fresh_freeze(seed):
    jdelta, jgen = jax_delta()
    args = dict(num_vertices=14, num_edges=50, num_labels=3, seed=seed,
                self_loop_frac=0.15)
    db = DeltaBuilder(tgen.random_labeled_graph(**args), 2,
                      fallback_frac=1.0)
    jdb = jdelta.DeltaBuilder(jgen.random_labeled_graph(**args), 2,
                              fallback_frac=1.0)
    db.full()
    jdb.full()
    mr_ids = mr_id_space(3, 2)
    frozen, jfrozen = db.index.freeze(mr_ids), jdb.index.freeze(mr_ids)
    rng, jrng = np.random.default_rng(seed + 30), \
        np.random.default_rng(seed + 30)
    for _ in range(3):
        res = db.apply(tgen.random_delta(db.graph, 2, 2, rng))
        jres = jdb.apply(jgen.random_delta(jdb.graph, 2, 2, jrng))
        rows = lambda r: (  # noqa: E731
            set(r.dirty_out.tolist()) | set(r.resort_out.tolist()),
            set(r.dirty_in.tolist()) | set(r.resort_in.tolist()))
        frozen = frozen.patch_rows(db.index, mr_ids, *rows(res))
        jfrozen = jfrozen.patch_rows(jdb.index, mr_ids, *rows(jres))
        fresh = db.index.freeze(mr_ids)
        for fld in FROZEN_FIELDS:
            np.testing.assert_array_equal(getattr(frozen, fld),
                                          getattr(jfrozen, fld), fld)
            np.testing.assert_array_equal(getattr(frozen, fld),
                                          getattr(fresh, fld), fld)


def test_delta_builder_rejects_bad_config():
    g = tgen.erdos_renyi(10, 2.0, 2, seed=0)
    with pytest.raises(ValueError):
        DeltaBuilder(g, 2, backend="python")      # not a batched backend
    with pytest.raises(ValueError):
        DeltaBuilder(g, 2, fallback_frac=0.0)
    with pytest.raises(RuntimeError):
        DeltaBuilder(g, 2).apply(GraphDelta.of([], []))   # before full()


# ------------------------------------------------------------------ #
# RLCService.apply_delta
# ------------------------------------------------------------------ #
def sample_queries(g, k, rng, n_per_mr=6):
    return [(int(rng.integers(g.num_vertices)),
             int(rng.integers(g.num_vertices)), mr)
            for mr in enumerate_mrs(g.num_labels, k)
            for _ in range(n_per_mr)]


def summary_fields(summary):
    d = dict(summary)
    delta = dict(d.pop("delta"))
    build = dict(delta.pop("build"))
    build.pop("wall_time_s")
    build.pop("backend")
    warm = d.pop("warm")
    if warm is not None:
        warm = {k: v for k, v in warm.items() if k != "seconds"}
    return d, delta, build, warm


@pytest.mark.parametrize("build_backend", ["numpy", "cuda"])
def test_apply_delta_summaries_and_evictions_equal_reference(build_backend):
    pytest.importorskip("jax")
    jgen = pytest.importorskip("repro.graphgen")
    jservice = pytest.importorskip("repro.service")
    args = (120, 2.2, 3)
    g, jg = tgen.erdos_renyi(*args, seed=41), jgen.erdos_renyi(*args,
                                                                seed=41)
    common = dict(k=2, use_device=False, backend="numpy",
                  delta_fallback_frac=1.0, warm_capacity=32)
    svc = RLCService.build(g, ServiceConfig(
        build_backend=build_backend, device="cpu", **common))
    jsvc = jservice.RLCService.build(jg, jservice.ServiceConfig(
        build_backend="numpy", **common))
    rng, jrng = np.random.default_rng(42), np.random.default_rng(42)
    queries = sample_queries(g, 2, np.random.default_rng(7))
    for _ in range(3):
        got, want = svc.query_batch(queries), jsvc.query_batch(queries)
        assert [a.value for a in got] == [a.value for a in want]
        assert [a.disposition for a in got] == \
            [a.disposition for a in want]
        summary = svc.apply_delta(tgen.random_delta(svc.graph, 2, 2, rng))
        jsummary = jsvc.apply_delta(jgen.random_delta(jsvc.graph, 2, 2,
                                                      jrng))
        assert summary_fields(summary) == summary_fields(jsummary)
        assert svc.build_stats.backend == f"delta[{build_backend}]"
        assert set(svc.cache._d) == set(jsvc.cache._d)
    ref, _ = build_rlc_index_with_stats(svc.graph, 2, backend="numpy")
    assert [a.value for a in svc.query_batch(queries)] == \
        [ref.query(s, t, mr) for s, t, mr in queries]
    assert svc.stats()["deltas_applied"] == 3


def test_apply_delta_on_adopted_index_resyncs():
    from repro_torch.build import build_rlc_index
    g = tgen.erdos_renyi(60, 2.5, 3, seed=43)
    idx = build_rlc_index(g, 2, use_pr3=False)
    svc = RLCService.build(g, ServiceConfig(k=2, device="cpu",
                                            delta_fallback_frac=1.0),
                           index=idx)
    rng = np.random.default_rng(44)
    svc.apply_delta(tgen.random_delta(svc.graph, 2, 2, rng))
    ref, _ = build_rlc_index_with_stats(svc.graph, 2, backend="numpy")
    assert entry_sets(svc.index) == entry_sets(ref)
    queries = sample_queries(svc.graph, 2, rng)
    assert [a.value for a in svc.query_batch(queries)] == \
        [ref.query(s, t, mr) for s, t, mr in queries]


def test_apply_delta_invalid_delta_raises():
    g = tgen.erdos_renyi(50, 2.0, 3, seed=43)
    svc = RLCService.build(g, ServiceConfig(k=2, device="cpu",
                                            use_device=False))
    with pytest.raises(ValueError):
        svc.apply_delta(GraphDelta.of([g.edges[0].tolist()], []))
    assert svc.deltas_applied == 0


def test_delta_backend_follows_the_device():
    g = tgen.erdos_renyi(30, 2.0, 3, seed=1)
    cases = {("auto", "cpu"): ("numpy", {}),
             ("python", "cpu"): ("numpy", {}),
             ("numpy", "cpu"): ("numpy", {}),
             ("cuda", "cpu"): ("cuda", {"device": torch.device("cpu")})}
    for (backend, dev), want in cases.items():
        svc = RLCService.build(g, ServiceConfig(
            k=2, device=dev, build_backend=backend))
        assert svc._delta_backend() == want


def test_failed_device_layout_after_a_delta_raises(monkeypatch):
    """A layout that cannot be rebuilt after a delta raises; the service
    never drops to host serving in its place."""
    from repro_torch.service import service as service_mod
    g = tgen.erdos_renyi(60, 2.5, 3, seed=45)
    svc = RLCService.build(g, ServiceConfig(k=2, device="cpu",
                                            delta_fallback_frac=1.0))

    def fail(*args, **kw):
        raise RuntimeError("device transfer failed")

    monkeypatch.setattr(service_mod.DeviceIndex, "from_frozen", fail)
    with pytest.raises(RuntimeError, match="device transfer failed"):
        svc.apply_delta(tgen.random_delta(svc.graph, 2, 2,
                                          np.random.default_rng(3)))


# decided at test setup (a string condition), never at import time
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")


@needs_cuda
def test_cuda_service_deltas_explain_and_submit_on_the_card():
    """On the card: deltas build through the ``cuda`` backend, the
    layout is rebuilt on the card, submits and warm batches go through
    the merge kernel and ``explain`` reads the card's rows — each equal
    to a CPU service fed the same deltas."""
    from repro_torch.kernels import KERNELS
    g = tgen.erdos_renyi(200, 3.0, 3, seed=46)
    cfg = dict(k=2, delta_fallback_frac=1.0, warm_capacity=32)
    svc = RLCService.build(g, ServiceConfig(**cfg))
    cpu = RLCService.build(g, ServiceConfig(device="cpu", **cfg))
    assert svc.device_index.device.type == "cuda"
    rng, crng = np.random.default_rng(47), np.random.default_rng(47)
    queries = sample_queries(g, 2, np.random.default_rng(8))
    before = KERNELS["mergejoin"].launches
    with svc.start():
        for _ in range(2):
            summary = svc.apply_delta(tgen.random_delta(svc.graph, 3, 3,
                                                        rng))
            csummary = cpu.apply_delta(tgen.random_delta(cpu.graph, 3, 3,
                                                         crng))
            # the warm pass runs under a wall-time budget: compare the rest
            assert summary_fields(summary)[:3] == \
                summary_fields(csummary)[:3]
            assert summary["warm"]["stale"] == 0
            assert svc.device_index.device.type == "cuda"
            assert entry_sets(svc.index) == entry_sets(cpu.index)
            futs = [svc.submit(*q) for q in queries]
            got = [f.result(timeout=60) for f in futs]
            assert [a.value for a in got] == \
                [a.value for a in cpu.query_batch(queries)]
            assert {a.backend for a in got} <= {"cuda", None}
        for q in queries[:16]:
            b, cb = svc.explain(*q), cpu.explain(*q)
            assert b["backend"] == "cuda"
            assert b["answer"] == cb["answer"]
    assert svc.build_stats.backend == "delta[cuda]"
    assert KERNELS["mergejoin"].launches > before
    assert svc.stats()["async"]["failed_batches"] == 0
    assert svc.executor.fallbacks == 0
