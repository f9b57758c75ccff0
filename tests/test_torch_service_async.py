"""Port async admission (``submit()`` futures, ``start``/``close``) and the
``repro.service.stats/1`` schema against the JAX package's.

``submit()`` answers must equal the synchronous answers and the JAX
service's on one stream; coalescing, exception propagation (a failed
kernel launch on a CUDA layout reaches the futures and is never served
from the CPU), lifecycle idempotence and the ``query_batch`` bridge must
hold; and the JAX package's ``validate_stats`` must accept the port's
``stats()``. Tests wait through ``flush()`` and futures, never a sleep.
"""
import threading
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import graphgen as tgen  # noqa: E402
from repro_torch.service import (SHED, Answer, RLCService,  # noqa: E402
                                 ServiceConfig, validate_stats)
from repro_torch.service.executor import BatchExecutor  # noqa: E402

K = 2
GRAPH = (80, 3.0, 3)


def _svc(**kw):
    g = tgen.erdos_renyi(*GRAPH, seed=11)
    cfg = dict(k=K, batch_size=8, backend="numpy", use_device=False,
               device="cpu")
    cfg.update(kw)
    return g, RLCService.build(g, ServiceConfig(**cfg))


def _queries(g, n=40, seed=0):
    rng = np.random.default_rng(seed)
    st = rng.integers(0, g.num_vertices, size=(n, 2))
    mrs = [(0,), (1,), (0, 1), (2, 0)]
    return [(int(s), int(t), mrs[i % 4]) for i, (s, t) in enumerate(st)]


def jax_svc():
    pytest.importorskip("jax")
    jgen = pytest.importorskip("repro.graphgen")
    js = pytest.importorskip("repro.service")
    jg = jgen.erdos_renyi(*GRAPH, seed=11)
    return js, js.RLCService.build(jg, js.ServiceConfig(
        k=K, batch_size=8, backend="numpy", use_device=False))


@pytest.mark.parametrize("threads", [1, 4])
def test_submit_equals_sync_and_reference(threads):
    js, jsvc = jax_svc()
    g, svc = _svc(device="cpu", use_device=True, backend="auto")
    qs = _queries(g, 120) + _queries(g, 30, seed=1)
    want = [bool(a) for a in jsvc.query_batch(qs)]
    sync = [bool(a) for a in svc.query_batch(qs)]
    assert sync == want
    svc.cache.clear()
    futs = [None] * len(qs)

    def run(lo):
        for i in range(lo, len(qs), threads):
            futs[i] = svc.submit(*qs[i])

    with svc.start():
        workers = [threading.Thread(target=run, args=(i,))
                   for i in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        svc._engine.flush()
        got = [f.result(timeout=30) for f in futs]
    assert [bool(a) for a in got] == want
    assert {a.disposition for a in got} <= {"computed", "cache_hit"}
    assert {a.backend for a in got} <= {"sorted", None}
    st = svc._engine.stats()
    assert st["failed_batches"] == 0 and st["inflight"] == 0
    assert st["submitted"] == len(qs)


def test_submit_coalesces_duplicate_inflight_keys():
    g, svc = _svc(batch_size=64, max_wait_ms=1e4)   # nothing auto-flushes
    s, t, c = _queries(g, 1, seed=5)[0]
    with svc.start(tick_interval_s=10.0):           # ticker effectively off
        futs = [svc.submit(s, t, c) for _ in range(3)]
        assert svc.batcher.coalesced >= 2
        svc._engine.flush()
        vals = {bool(f.result(timeout=30)) for f in futs}
    assert len(vals) == 1
    assert svc._engine.exec_batches == 1            # one execution served all


def test_submit_cache_hit_resolves_immediately():
    g, svc = _svc()
    s, t, c = _queries(g, 1)[0]
    expected = bool(svc.query(s, t, c))
    with svc.start(tick_interval_s=10.0):
        f = svc.submit(s, t, c)
        assert f.done()
        assert f.result().disposition == "cache_hit"
        assert bool(f.result()) == expected


def test_submit_propagates_execution_exceptions():
    g, svc = _svc(batch_size=4)
    qs = _queries(g, 4, seed=7)
    orig = svc._run_batch

    def bad_run_batch(batch, tr=None):
        raise RuntimeError("executor exploded")

    with svc.start(tick_interval_s=10.0):
        svc._run_batch = bad_run_batch
        futs = [svc.submit(s, t, c) for s, t, c in qs]
        svc._engine.flush()
        for f in futs:
            with pytest.raises(RuntimeError, match="executor exploded"):
                f.result(timeout=30)
        assert svc._engine.failed_batches >= 1
        svc._run_batch = orig            # the engine survives
        svc.cache.clear()
        f = svc.submit(*qs[0])
        svc._engine.flush()
        assert isinstance(f.result(timeout=30), Answer)


class _FailingCudaLayout:
    """A device layout on a CUDA device whose kernel launch fails."""
    device = torch.device("cuda")

    def query_batch(self, *args, **kw):
        raise RuntimeError("rlc_mergejoin failed to launch")


def test_failed_kernel_launch_reaches_the_futures():
    """On a CUDA layout a failed launch on the engine's thread fails the
    batch's futures; nothing answers them from the CPU."""
    g, svc = _svc(batch_size=4, device="cpu", use_device=True)
    svc.executor = BatchExecutor(svc.index, svc.frozen, _FailingCudaLayout(),
                                 svc._id_to_mr, obs=svc.obs)
    qs = _queries(g, 4, seed=7)
    with svc.start(tick_interval_s=10.0):
        futs = [svc.submit(s, t, c) for s, t, c in qs]
        svc._engine.flush()
        for f in futs:
            with pytest.raises(RuntimeError, match="failed to launch"):
                f.result(timeout=30)
    assert svc._engine.failed_batches >= 1
    assert svc._engine.exec_batches == 0
    assert svc.executor.fallbacks == 0
    assert svc.stats()["async"]["completed"] == 0


def test_submit_sheds_via_admission_control():
    g, svc = _svc(batch_size=64, max_wait_ms=1e4, admission_max_pending=2)
    qs = _queries(g, 12, seed=9)
    with svc.start(tick_interval_s=10.0):
        futs = [svc.submit(s, t, c) for s, t, c in qs]
        assert any(f.done() and f.result() is SHED for f in futs)
        svc._engine.flush()
        vals = [f.result(timeout=30) for f in futs]
    assert all(isinstance(v, Answer) for v in vals)
    assert svc.queries_shed == len([v for v in vals if v.shed])
    assert svc.stats()["async"]["shed"] == svc.queries_shed


def test_malformed_submit_raises_synchronously():
    g, svc = _svc()
    with svc.start():
        with pytest.raises(ValueError):
            svc.submit(-5, 10 ** 9, (0,))


def test_lifecycle_is_idempotent_and_context_managed():
    g, svc = _svc(shadow_sample_rate=0.5, shadow_background=True)
    assert svc.start() is svc
    svc.start()                          # second start is a no-op
    assert svc._engine.active and svc._shadow.running
    threads = [svc._engine._thread, svc._shadow._thread]
    svc.close()
    svc.close()                          # double close is fine
    assert not svc._engine.active and not svc._shadow.running
    assert not any(t.is_alive() for t in threads)
    with pytest.raises(RuntimeError):
        svc.start()                      # closed services stay closed
    assert svc.query(*_queries(g, 1)[0]).disposition in ("computed",
                                                          "cache_hit")
    g2, svc2 = _svc()
    with svc2.start() as inside:
        assert inside is svc2
    assert svc2._closed


def test_deprecated_ticker_shims_warn_and_delegate():
    g, svc = _svc()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        svc.start_ticker()
        assert any(issubclass(x.category, DeprecationWarning) for x in w)
    assert svc._engine is not None and svc._engine.active
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        svc.stop_ticker()
        assert any(issubclass(x.category, DeprecationWarning) for x in w)
    assert svc._closed


def test_query_batch_bridges_through_active_engine():
    g, svc = _svc()
    qs = _queries(g, 20)
    expected = [bool(a) for a in svc.query_batch(qs)]
    svc.cache.clear()
    with svc.start():
        got = svc.query_batch(qs)        # engine active: bridged path
        assert [bool(a) for a in got] == expected
        assert svc._engine.submitted >= 20


def test_reference_validates_port_stats():
    js, jsvc = jax_svc()
    g, svc = _svc(target_p99_ms=5.0, warm_capacity=16,
                  shadow_sample_rate=0.2)
    qs = _queries(g, 24)
    svc.query_batch(qs)
    jsvc.query_batch(qs)
    doc = js.validate_stats(svc.stats())
    assert doc["schema"] == "repro.service.stats/1"
    assert doc["facade"] == "single" and doc["transport"] == "local"
    assert doc["async"] is None           # engine never started
    assert set(doc) == set(jsvc.stats())
    assert doc["cache"] == jsvc.stats()["cache"]
    assert doc["index"]["device"] is None
    svc.start()
    svc.query_batch(qs)
    doc = js.validate_stats(svc.stats())
    assert doc["async"]["active"] and doc["async"]["submitted"] == 24
    assert validate_stats(doc) is doc
    svc.close()
    bad = dict(doc, schema="repro.service.stats/0")
    with pytest.raises(ValueError, match=r"\$\.schema"):
        validate_stats(bad)


def test_launch_counts_survive_concurrent_launches():
    """The async engine's thread and the caller both launch kernels; a
    count updated without the lock would lose increments here."""
    import sys

    from repro_torch.kernels._build import Kernel
    kern = Kernel("mergejoin", "rlc_mergejoin", [])
    kern._fn = lambda *args: 0            # a launch that always succeeds
    threads, calls = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda: [kern() for _ in range(calls)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(w.is_alive() for w in workers)
    assert kern.launches == threads * calls
