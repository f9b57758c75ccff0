"""Port control plane (``repro_torch.service.control``) against the JAX
package's.

The controllers are host code and must decide exactly as the
reference's on identical call sequences: sketch estimates and hot sets,
SLO batch parameters (fed injected execute times, never wall time),
admission decisions. End to end, a ``VirtualClock`` replay with a
depth-bound admission queue must give the same answers, dispositions
and ``SHED`` positions on both services — deadlines are set far out so
no flush depends on measured time. Warming after ``apply_delta`` must
be epoch-consistent.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import graphgen as tgen  # noqa: E402
from repro_torch.core.baselines import bibfs_rlc  # noqa: E402
from repro_torch.core.queries import biased_true_queries  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.service import (SHED, AdmissionController,  # noqa: E402
                                 CacheWarmer, FrequencySketch,
                                 MicroBatcher, ResultCache, RLCService,
                                 ServiceConfig, SLOBatchController,
                                 VirtualClock)


def jax_service():
    pytest.importorskip("jax")
    return pytest.importorskip("repro.service")


def key_stream(seed, n=3000, vertices=40):
    """Zipf-skewed (s, t, mr_id) keys with their MR lengths."""
    rng = np.random.default_rng(seed)
    pool = [(int(rng.integers(vertices)), int(rng.integers(vertices)),
             int(rng.integers(12))) for _ in range(200)]
    ranks = np.minimum(rng.zipf(1.3, n), len(pool)) - 1
    return [(pool[r], 1 + pool[r][2] % 3) for r in ranks]


@pytest.mark.parametrize("shape", [(256, 2, 16, 500), (2048, 4, 64, 10 ** 9)])
def test_sketch_estimates_equal_reference(shape):
    js = jax_service()
    width, depth, hot, decay = shape
    sk = FrequencySketch(width, depth, hot, decay)
    jsk = js.FrequencySketch(width, depth, hot, decay)
    stream = key_stream(1)
    for key, mr_len in stream:
        assert sk.observe(key, mr_len) == jsk.observe(key, mr_len)
    assert [sk.estimate(k) for k, _ in stream[:200]] == \
        [jsk.estimate(k) for k, _ in stream[:200]]
    assert sk.hot() == jsk.hot()
    assert sk.stats() == jsk.stats()


def test_slo_params_equal_reference_under_injected_exec_times():
    js = jax_service()
    clock, jclock = VirtualClock(), js.VirtualClock()
    kw = dict(target_p99_s=0.010, base_batch=8, base_wait_s=0.002,
              max_batch=64, interval_s=0.0)
    ctl = SLOBatchController(MetricsRegistry(), clock=clock, **kw)
    jobs = pytest.importorskip("repro.obs")
    jctl = js.SLOBatchController(jobs.MetricsRegistry(), clock=jclock, **kw)
    rng = np.random.default_rng(3)
    for _ in range(120):
        clock.advance(0.001)
        jclock.advance(0.001)
        mr_len = int(rng.integers(1, 4))
        exec_s = float(rng.choice([0.0001, 0.002, 0.009]))
        n = ctl.params(mr_len)[0]
        assert n == jctl.params(mr_len)[0]
        ctl.observe_batch(mr_len, n_real=n, exec_s=exec_s)
        jctl.observe_batch(mr_len, n_real=n, exec_s=exec_s)
        assert ctl.params(mr_len) == jctl.params(mr_len)
    assert ctl.stats() == jctl.stats()


def test_admission_decisions_equal_reference():
    js = jax_service()
    jobs = pytest.importorskip("repro.obs")
    sk, jsk = FrequencySketch(decay_every=10 ** 9), \
        js.FrequencySketch(decay_every=10 ** 9)
    adm = AdmissionController(MetricsRegistry(), sk, max_pending=6,
                              backpressure_s=0.004)
    jadm = js.AdmissionController(jobs.MetricsRegistry(), jsk,
                                  max_pending=6, backpressure_s=0.004)
    b = MicroBatcher(64, 100.0, clock=lambda: 0.0)
    jb = js.MicroBatcher(64, 100.0, clock=lambda: 0.0)
    decisions = []
    rng = np.random.default_rng(8)
    # the queue is never drained, so it is never empty under
    # back-pressure (where the port admits and repro sheds; see below)
    for key, mr_len in key_stream(2, n=600):
        sk.observe(key, mr_len)
        jsk.observe(key, mr_len)
        d, victim = adm.decide(key, mr_len, b)
        jd, jvictim = jadm.decide(key, mr_len, jb)
        assert d == jd
        assert (victim.key if victim else None) == \
            (jvictim.key if jvictim else None)
        if d == "evict":
            assert b.evict(victim) and jb.evict(jvictim)
        if d != "shed":
            b.submit(*key, mr_len)
            jb.submit(*key, mr_len)
        wait = float(rng.choice([0.0005, 0.01]))
        adm.observe_wait(wait)
        jadm.observe_wait(wait)
        decisions.append(d)
    assert {"admit", "shed", "evict"} <= set(decisions)
    assert adm.backpressured and adm.stats()["backpressured"]
    assert adm.stats() == jadm.stats()


def test_backpressure_admits_into_an_empty_queue_and_recovers():
    """Under back-pressure with nothing queued, ``repro`` sheds every
    arrival, and as only executed batches move the wait EWMA it never
    recovers; the port admits the arrival, so the EWMA can drain."""
    js = jax_service()
    jobs = pytest.importorskip("repro.obs")
    key, mr_len = (1, 2, 0), 1
    adm = AdmissionController(MetricsRegistry(), FrequencySketch(),
                              backpressure_s=0.004)
    jadm = js.AdmissionController(jobs.MetricsRegistry(),
                                  js.FrequencySketch(),
                                  backpressure_s=0.004)
    b = MicroBatcher(64, 100.0, clock=lambda: 0.0)
    jb = js.MicroBatcher(64, 100.0, clock=lambda: 0.0)
    for a in (adm, jadm):
        for _ in range(5):
            a.observe_wait(0.05)
        assert a.backpressured
    assert jadm.decide(key, mr_len, jb) == ("shed", None)
    assert adm.decide(key, mr_len, b) == ("admit", None)
    b.submit(*key, mr_len)
    batch, = b.drain()
    for _ in range(30):                  # the admitted batch's waits
        adm.observe_wait(0.0001)
    assert not adm.backpressured


# ------------------------------------------------------------------ #
# end to end under a VirtualClock
# ------------------------------------------------------------------ #
def test_depth_bound_replay_equals_reference():
    js = jax_service()
    jgen = pytest.importorskip("repro.graphgen")
    g, jg = tgen.erdos_renyi(100, 3.5, 3, seed=7), \
        jgen.erdos_renyi(100, 3.5, 3, seed=7)
    qs = biased_true_queries(g, 2, n=30, seed=3)
    pool = qs.true_queries + qs.false_queries
    rng = np.random.default_rng(4)
    stream = [pool[i] for i in np.minimum(rng.zipf(1.4, 400),
                                          len(pool)) - 1]
    # deadlines far out: flushes happen on full batches and at the end
    # of each call only, so nothing reads measured time
    common = dict(k=2, batch_size=8, max_wait_ms=1e9, backend="numpy",
                  use_device=False, cache_capacity=64,
                  admission_max_pending=5)
    clock, jclock = VirtualClock(), js.VirtualClock()
    svc = RLCService.build(g, ServiceConfig(clock=clock, device="cpu",
                                            **common))
    jsvc = js.RLCService.build(jg, js.ServiceConfig(clock=jclock, **common))
    shed = 0
    for lo in range(0, len(stream), 40):
        chunk = stream[lo:lo + 40]
        clock.at_least(lo * 1e-3)
        jclock.at_least(lo * 1e-3)
        got, want = svc.query_batch(chunk), jsvc.query_batch(chunk)
        assert [a is SHED for a in got] == [a is js.SHED for a in want]
        assert [a.disposition for a in got] == \
            [a.disposition for a in want]
        assert [a.value for a in got if a is not SHED] == \
            [a.value for a in want if a is not js.SHED]
        for (s, t, L), a in zip(chunk, got):
            if a is not SHED:
                assert a.value == bibfs_rlc(g, s, t, L)
        shed += sum(a is SHED for a in got)
    assert shed > 0
    assert svc.queries_shed == jsvc.queries_shed == shed
    assert svc.ctl.stats() == jsvc.ctl.stats()


def test_warming_after_apply_delta_is_epoch_consistent():
    g = tgen.erdos_renyi(80, 3.5, 3, seed=11)
    svc = RLCService.build(g, ServiceConfig(
        k=2, batch_size=8, backend="numpy", use_device=False, device="cpu",
        cache_capacity=256, warm_capacity=64))
    qs = biased_true_queries(g, 2, n=16, seed=5)
    pool = qs.true_queries + qs.false_queries
    for _ in range(3):
        svc.query_batch(pool)            # populate the sketch
    rep = svc.apply_delta(tgen.random_delta(svc.graph, 2, 2,
                                            np.random.default_rng(0)))
    assert rep["warm"] is not None and rep["warm"]["trigger"] == "apply_delta"
    assert rep["warm"]["stale"] == 0 and rep["warm"]["warmed"] > 0
    for key in list(svc.cache._d):
        s, t, mr_id = key
        assert svc.cache.peek(key) == bibfs_rlc(svc.graph, s, t,
                                                svc._id_to_mr[mr_id])


def test_warmer_epoch_fence_aborts_a_stale_pass():
    cache = ResultCache(64)
    sk = FrequencySketch(decay_every=10 ** 9)
    for i in range(8):
        sk.observe((i, i, 0), 1)
    warmer = None

    def execute(s, t, mr, mr_len):
        warmer.bump_epoch()             # a mutation lands mid-pass
        return np.zeros(len(s), bool)

    warmer = CacheWarmer(cache, sk, execute, budget_bytes=1 << 20,
                         budget_s=10.0, chunk=4)
    rep = warmer.warm("apply_delta")
    assert rep["warmed"] == 0 and rep["stale"] > 0
    assert len(cache) == 0
