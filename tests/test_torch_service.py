"""Port RLCService vs the JAX package's RLCService on one query stream.

Same graph, same stream (with duplicates, so coalescing and cache hits
occur), a frozen scheduler clock on both sides so no deadline flush
depends on timing: answer values and dispositions must be equal, the
answering backends must correspond (``pallas`` <-> ``cuda``, the rest by
name), and every answer must equal the BiBFS oracle. The JAX package is
imported inside the tests that compare with it, so the card tests of
this file also run where JAX is absent.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import graphgen as tgen  # noqa: E402
from repro_torch.core.baselines import bibfs_rlc  # noqa: E402
from repro_torch.core.queries import biased_true_queries  # noqa: E402
from repro_torch.kernels import KERNELS, mergejoin  # noqa: E402
from repro_torch.service import RLCService, ServiceConfig  # noqa: E402
from repro_torch.service.executor import BatchExecutor  # noqa: E402

# decided at test setup (a string condition), never at import time
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")

BACKEND_NAMES = {"pallas": "cuda", "sorted": "sorted", "numpy": "numpy",
                 "python": "python"}
GRAPH = (36, 3.0, 3)


def frozen_clock():
    return 0.0


@pytest.fixture(scope="module")
def stream():
    g = tgen.erdos_renyi(*GRAPH, seed=11)
    qs = biased_true_queries(g, 2, 40, seed=1)
    base = qs.true_queries + qs.false_queries
    rng = np.random.default_rng(0)
    dup = [base[i] for i in rng.integers(0, len(base), 30)]
    text = [(s, t, "(" + " ".join(map(str, L)) + ")+") for s, t, L in base]
    return g, base + dup + text[:10]


def pair(g, backend, build_backend="numpy", **kw):
    pytest.importorskip("jax")
    jgen = pytest.importorskip("repro.graphgen")
    jservice = pytest.importorskip("repro.service")
    JService, JConfig = jservice.RLCService, jservice.ServiceConfig
    jg = jgen.erdos_renyi(*GRAPH, seed=11)
    jsvc = JService.build(jg, JConfig(
        k=2, batch_size=16, backend=backend, clock=frozen_clock))
    tsvc = RLCService.build(g, ServiceConfig(
        k=2, batch_size=16, backend=BACKEND_NAMES.get(backend, backend),
        build_backend=build_backend, clock=frozen_clock, device="cpu", **kw))
    return jsvc, tsvc


@pytest.mark.parametrize("backend", ["auto", "pallas", "sorted", "numpy",
                                     "python"])
def test_answers_and_dispositions_equal(stream, backend):
    g, queries = stream
    jsvc, tsvc = pair(g, backend)
    for _ in range(2):                     # second pass: all cache hits
        want = jsvc.query_batch(queries)
        got = tsvc.query_batch(queries)
        assert [a.value for a in got] == [a.value for a in want]
        assert [a.disposition for a in got] == \
            [a.disposition for a in want]
        assert [a.backend for a in got] == \
            [BACKEND_NAMES.get(a.backend, a.backend) for a in want]
    assert tsvc.executor.fallbacks == jsvc.executor.fallbacks == 0
    for (s, t, c), a in zip(queries, got):
        assert a.value == bibfs_rlc(g, s, t, tsvc.parse(c).mr)


def test_cuda_build_backend_serves_like_reference(stream):
    g, queries = stream
    jsvc, tsvc = pair(g, "auto", build_backend="cuda")
    assert tsvc.build_stats.backend == "cuda"
    assert tsvc.index.num_entries() == jsvc.index.num_entries()
    before = {k: v.launches for k, v in KERNELS.items()}
    got = tsvc.query_batch(queries)
    assert [a.value for a in got] == \
        [a.value for a in jsvc.query_batch(queries)]
    assert {k: v.launches for k, v in KERNELS.items()} == before
    st = tsvc.stats()
    assert st["executor"]["fallbacks"] == 0
    assert st["index"]["device"] == "cpu"
    assert st["queries_served"] == len(queries)
    assert st["cache"]["hits"] == jsvc.stats()["cache"]["hits"]
    assert st["scheduler"]["coalesced"] == \
        jsvc.stats()["scheduler"]["coalesced"]


def test_adopted_index_and_host_only_service(stream):
    from repro_torch.build import build_rlc_index
    g, queries = stream
    idx = build_rlc_index(g, 2)
    svc = RLCService.build(g, ServiceConfig(k=2, device="cpu",
                                            use_device=False), index=idx)
    assert svc.device_index is None and svc.build_stats is None
    assert {a.backend for a in svc.query_batch(queries)} <= {"numpy", None}
    with pytest.raises(ValueError):
        RLCService.build(g, ServiceConfig(k=3, device="cpu"), index=idx)


def test_host_build_on_the_cpu_and_no_host_serving_on_a_card(stream):
    g, _ = stream
    svc = RLCService.build(g, ServiceConfig(k=2, device="cpu"))
    assert svc.build_stats.backend == "numpy"
    # host-only serving is refused before any card is looked for
    with pytest.raises(ValueError):
        RLCService.build(g, ServiceConfig(k=2, use_device=False))
    with pytest.raises(ValueError):
        RLCService(g, svc.index, ServiceConfig(k=2, use_device=False))


class _FailingCudaLayout:
    """A device layout that claims a CUDA device and whose join fails,
    as a kernel that does not build or launch would."""
    device = torch.device("cuda")

    def query_batch(self, *args, **kw):
        raise RuntimeError("rlc_mergejoin failed to launch")


def test_cuda_layout_serves_only_through_the_kernel(stream):
    g, _ = stream
    svc = RLCService.build(g, ServiceConfig(k=2, device="cpu"))
    args = (svc.index, svc.frozen, _FailingCudaLayout(), svc._id_to_mr)
    ex = BatchExecutor(*args)
    assert ex.resolve() == "cuda"
    s = np.array([0, 1]), np.array([2, 3]), np.array([0, 1])
    with pytest.raises(RuntimeError, match="failed to launch"):
        ex.execute(*s)
    assert ex.fallbacks == 0
    assert ex.stats() == {}
    for other in ("sorted", "numpy", "python"):
        with pytest.raises(ValueError):
            BatchExecutor(*args, backend=other)
        with pytest.raises(ValueError):
            ex.execute(*s, backend=other)


@needs_cuda
def test_card_service_builds_on_the_card_and_serves_through_the_kernel(
        stream, monkeypatch):
    g, queries = stream
    before = mergejoin.KERNEL.launches
    svc = RLCService.build(g, ServiceConfig(k=2, batch_size=16,
                                            clock=frozen_clock))
    assert svc.build_stats.backend == "cuda"
    assert svc.device_index.device.type == "cuda"
    got = svc.query_batch(queries)
    for (s, t, c), a in zip(queries, got):
        assert a.value == bibfs_rlc(g, s, t, svc.parse(c).mr)
    assert {a.backend for a in got if a.disposition == "computed"} == \
        {"cuda"}
    # a graph this small takes no device wave in the hybrid build
    assert mergejoin.KERNEL.launches > before
    # a kernel that fails makes query_batch raise; nothing falls back
    svc.cache.clear()
    monkeypatch.setattr(mergejoin.KERNEL, "_fn", lambda *args: 1)
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        svc.query_batch(queries)
    assert svc.executor.fallbacks == 0


def test_default_device_without_a_card_raises(stream):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g, _ = stream
    with pytest.raises(RuntimeError):
        RLCService.build(g, ServiceConfig(k=2))
