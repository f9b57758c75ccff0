"""Port correctness observability against the JAX package's.

Witnesses (``repro.obs.witness/1``) from every layout the port explains
over — the dict index, the frozen CSR, the padded device rows (full
height and a row window) and the executor's backends — must be equal to
the JAX package's on the same graph and queries, and replay under the
BiBFS oracle. Audit reports and drift fingerprints, telemetry snapshots
and Prometheus text must be equal and pass the JAX package's
validators; the shadow verifier must sample the same keys under one
seed and catch a corrupted index. The port's modules must import with
JAX absent.
"""
import json
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import graphgen as tgen  # noqa: E402
from repro_torch.build import build_rlc_index  # noqa: E402
from repro_torch.core.baselines import bibfs_rlc  # noqa: E402
from repro_torch.core.device_index import DeviceIndex  # noqa: E402
from repro_torch.core.minimum_repeat import mr_id_space  # noqa: E402
from repro_torch.core.queries import (biased_true_queries,  # noqa: E402
                                      sample_index_queries)
from repro_torch.obs import (MetricsRegistry, ShadowVerifier,  # noqa: E402
                             audit_index, fingerprint, replay_witness,
                             to_prometheus, validate_audit_report,
                             verify_witness_entries)
from repro_torch.service import RLCService, ServiceConfig  # noqa: E402
from repro_torch.service.executor import BatchExecutor  # noqa: E402

K = 2
GRAPH = (150, 3.5, 3)
BACKEND_NAMES = {"pallas": "cuda", "sorted": "sorted", "numpy": "numpy",
                 "python": "python"}


def jax_pkg(name):
    pytest.importorskip("jax")
    return pytest.importorskip(name)


@pytest.fixture(scope="module")
def pair():
    """The same graph, index, frozen layout and queries in both
    packages."""
    jgen = jax_pkg("repro.graphgen")
    jbuild = jax_pkg("repro.build")
    g, jg = tgen.erdos_renyi(*GRAPH, seed=11), jgen.erdos_renyi(*GRAPH,
                                                                 seed=11)
    idx, jidx = build_rlc_index(g, K), jbuild.build_rlc_index(jg, K)
    mr_ids = mr_id_space(GRAPH[2], K)
    qs = biased_true_queries(g, K, n=40, seed=7)
    queries = qs.true_queries + qs.false_queries
    return dict(g=g, jg=jg, idx=idx, jidx=jidx, mr_ids=mr_ids,
                frozen=idx.freeze(mr_ids), jfrozen=jidx.freeze(mr_ids),
                queries=queries)


def ids(pair, queries):
    s = np.array([q[0] for q in queries])
    t = np.array([q[1] for q in queries])
    c = np.array([pair["mr_ids"][tuple(q[2])] for q in queries])
    return s, t, c


# ------------------------------------------------------------------ #
# Witnesses
# ------------------------------------------------------------------ #
def test_dict_and_frozen_witnesses_equal_reference(pair):
    for s, t, L in pair["queries"]:
        c = pair["mr_ids"][tuple(L)]
        w = pair["idx"].explain(s, t, L, mr_id=c)
        assert w == pair["jidx"].explain(s, t, L, mr_id=c)
        fw = pair["frozen"].explain(s, t, c)
        assert fw == pair["jfrozen"].explain(s, t, c)
        assert fw["answer"] == w["answer"] == bibfs_rlc(pair["g"], s, t, L)
        assert replay_witness(pair["g"], fw, mr=L) is fw["answer"]
        assert verify_witness_entries(pair["idx"], fw, L)
    _, wits = pair["frozen"].query_batch(*ids(pair, pair["queries"]),
                                         witness=True)
    assert wits == [pair["frozen"].explain(s, t, c) for s, t, c in
                    zip(*ids(pair, pair["queries"]))]


@pytest.mark.parametrize("rows", [None, (30, 120)])
def test_device_witnesses_equal_reference(pair, rows):
    jdev = jax_pkg("repro.core.device_index")
    queries = pair["queries"]
    if rows is not None:
        lo, hi = rows
        queries = [q for q in queries if lo <= q[0] < hi and lo <= q[1] < hi]
        assert len(queries) >= 10
    dev = DeviceIndex.from_frozen(pair["frozen"], pair["mr_ids"], rows=rows,
                                  device="cpu")
    jd = jdev.DeviceIndex.from_frozen(pair["jfrozen"], pair["mr_ids"],
                                      rows=rows)
    s, t, c = ids(pair, queries)
    got = dev.explain_batch(s, t, c, max_hubs=4)
    assert got == jd.explain_batch(s, t, c, max_hubs=4)
    for w, (qs, qt, L) in zip(got, queries):
        assert w["answer"] == bibfs_rlc(pair["g"], qs, qt, L)
        assert w["hubs"] == [] or w["hubs"][0]["aid"] is None


@pytest.mark.parametrize("backend", ["pallas", "sorted", "numpy", "python"])
def test_executor_witnesses_equal_reference(pair, backend):
    jexec = jax_pkg("repro.service.executor")
    jdev = jax_pkg("repro.core.device_index")
    id_to_mr = sorted(pair["mr_ids"], key=pair["mr_ids"].get)
    ex = BatchExecutor(pair["idx"], pair["frozen"],
                       DeviceIndex.from_frozen(pair["frozen"],
                                               pair["mr_ids"],
                                               device="cpu"),
                       id_to_mr, backend=BACKEND_NAMES[backend])
    jex = jexec.BatchExecutor(pair["jidx"], pair["jfrozen"],
                              jdev.DeviceIndex.from_frozen(
                                  pair["jfrozen"], pair["mr_ids"]),
                              id_to_mr, backend=backend)
    s, t, c = ids(pair, pair["queries"])
    got, b = ex.explain_batch(s, t, c, n_real=len(s) - 3)
    want, jb = jex.explain_batch(s, t, c, n_real=len(s) - 3)
    assert got == want and b == BACKEND_NAMES[jb]
    answers, _ = ex.execute(s, t, c)
    assert [w["answer"] for w in got] == answers[:len(got)].tolist()


def test_device_witnesses_reject_ids_outside_the_rows(pair):
    dev = DeviceIndex.from_frozen(pair["frozen"], pair["mr_ids"],
                                  rows=(30, 120), device="cpu")
    with pytest.raises(IndexError):
        dev.explain_batch(np.array([29]), np.array([40]), np.array([0]))
    with pytest.raises(IndexError):
        dev.gather_in_rows(np.array([120]))


class _FailingCudaRows:
    """A device layout on a CUDA device whose row gather fails."""
    device = torch.device("cuda")

    def explain_batch(self, *args, **kw):
        raise RuntimeError("row gather failed on the card")


def test_explain_on_cuda_rows_raises_instead_of_falling_back(pair):
    id_to_mr = sorted(pair["mr_ids"], key=pair["mr_ids"].get)
    ex = BatchExecutor(pair["idx"], pair["frozen"], _FailingCudaRows(),
                       id_to_mr)
    with pytest.raises(RuntimeError, match="row gather failed"):
        ex.explain_batch(*ids(pair, pair["queries"][:2]))


def test_service_explain_bundles_equal_reference(pair):
    jservice = jax_pkg("repro.service")
    svc = RLCService.build(pair["g"], ServiceConfig(
        k=K, device="cpu", backend="numpy", use_device=False),
        index=pair["idx"])
    jsvc = jservice.RLCService.build(pair["jg"], jservice.ServiceConfig(
        k=K, backend="numpy", use_device=False), index=pair["jidx"])
    queries = pair["queries"][:20]
    svc.query_batch(queries[:10])
    jsvc.query_batch(queries[:10])
    for s, t, L in queries:
        b = svc.explain(s, t, L)
        assert b == jsvc.explain(s, t, L)
        assert replay_witness(pair["g"], b) is b["answer"]
    explained = lambda text: [ln for ln in text.splitlines()  # noqa: E731
                              if "rlc_explain_requests" in ln]
    assert explained(svc.prometheus()) == explained(jsvc.prometheus())
    assert len(explained(svc.prometheus())) > 2


# ------------------------------------------------------------------ #
# Audit
# ------------------------------------------------------------------ #
def test_audit_report_and_fingerprint_equal_reference(pair):
    jaudit = jax_pkg("repro.obs.audit")
    jdev = jax_pkg("repro.core.device_index")
    id_to_mr = sorted(pair["mr_ids"], key=pair["mr_ids"].get)
    assert fingerprint(pair["frozen"]) == jaudit.fingerprint(pair["jfrozen"])
    rep = audit_index(pair["frozen"], id_to_mr, index=pair["idx"],
                      graph=pair["g"],
                      device_index=DeviceIndex.from_frozen(
                          pair["frozen"], pair["mr_ids"], device="cpu"),
                      sample=64, seed=3)
    jrep = jaudit.audit_index(pair["jfrozen"], id_to_mr, index=pair["jidx"],
                              graph=pair["jg"],
                              device_index=jdev.DeviceIndex.from_frozen(
                                  pair["jfrozen"], pair["mr_ids"]),
                              sample=64, seed=3)
    assert rep == jrep
    assert rep["bytes"]["device"] > 0
    assert rep["soundness"]["violations"] == 0
    jaudit.validate_audit_report(json.loads(json.dumps(rep)))
    validate_audit_report(rep)


def test_audit_fingerprint_drifts_with_a_changed_row(pair):
    fp = fingerprint(pair["frozen"])
    bad = pair["idx"].freeze(pair["mr_ids"])
    v = int(np.argmax(np.diff(bad.out_indptr)))
    bad.out_hub[bad.out_indptr[v]] = -2
    fp2 = fingerprint(bad)
    assert fp2["combined"] != fp["combined"]
    drift = [b for b in range(64)
             if fp["row_buckets_out"][b] != fp2["row_buckets_out"][b]]
    assert drift == [v % 64]


# ------------------------------------------------------------------ #
# Snapshot, Prometheus text and the CLI
# ------------------------------------------------------------------ #
def _metric_ops(reg):
    c = reg.counter("rlc_demo_requests", desc="demo", labelnames=("kind",))
    c.labels(kind="a").inc(3)
    c.labels(kind="b").inc()
    reg.gauge("rlc_demo_depth", desc="depth").labels().set(7)
    h = reg.histogram("rlc_demo_seconds", desc="lat", unit="s").labels()
    for x in np.linspace(0.001, 0.05, 40):
        h.observe(float(x))


def test_prometheus_text_equal_for_identical_operations():
    jobs = jax_pkg("repro.obs")
    reg, jreg = MetricsRegistry(), jobs.MetricsRegistry()
    _metric_ops(reg)
    _metric_ops(jreg)
    assert to_prometheus(reg) == jobs.to_prometheus(jreg)


def test_reference_validates_port_snapshot_and_cli(pair, tmp_path, capsys):
    jexport = jax_pkg("repro.obs.export")
    from repro_torch.obs.__main__ import main
    svc = RLCService.build(pair["g"], ServiceConfig(
        k=K, device="cpu", trace_sample_rate=1.0, shadow_sample_rate=1.0),
        index=pair["idx"])
    svc.query_batch(pair["queries"][:20])
    svc.audit_report(sample=16)
    snap = json.loads(json.dumps(svc.telemetry_snapshot()))
    jexport.validate_snapshot(snap)
    assert snap["extra"]["shadow"]["divergent"] == 0
    assert snap["extra"]["shadow"]["checked"] == 20
    path = tmp_path / "snap.json"
    path.write_text(json.dumps(snap))
    assert main(["validate", str(path)]) == 0
    out = capsys.readouterr().out
    assert "OK repro.obs/1" in out and "OK repro.obs.audit/1" in out
    assert main(["prom", str(path)]) == 0
    assert "rlc_cache_lookups_total" in capsys.readouterr().out
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps(svc.chrome_trace()))
    assert main(["chrome", str(trace)]) == 0
    assert "spans" in capsys.readouterr().out
    svc.close()


def test_build_observer_times_the_cuda_backend_phases(pair):
    svc = RLCService.build(pair["g"], ServiceConfig(
        k=K, device="cpu", build_backend="cuda"))
    slow = svc.telemetry_snapshot()["extra"]["slowest_build_phases"]
    assert slow and all(p["seconds"] >= 0 for p in slow)
    assert "rlc_build_phase_seconds" in svc.prometheus()


def test_sampled_spans_land_on_the_profilers_timeline(monkeypatch):
    """A sampled ``Trace.span`` opens ``repro_torch.service.<name>`` while
    the profiler records (the service's ``execute`` among them) and no
    ``record_function`` while it does not; its own record is kept either
    way, and ``add`` / ``add_ending_now`` open no range."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import Tracer

    calls = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name, *a: calls.append(name) or real(name, *a))
    tracer = Tracer(sample_rate=1.0)
    tr = tracer.maybe_trace()
    with tr.span("execute", cat="service"):
        pass
    tr.add("after", 0.0, 1e-6)
    assert calls == [] and [e.name for e in tracer.events] == ["execute",
                                                               "after"]
    g = tgen.erdos_renyi(*GRAPH, seed=11)
    svc = RLCService(g, build_rlc_index(g, K), ServiceConfig(
        k=K, device="cpu", trace_sample_rate=1.0))
    queries = biased_true_queries(g, K, n=8, seed=7).true_queries
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("probe"):
            tr.add_ending_now("wait", 1e-6)
        svc.query_batch(queries)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "repro_torch.service.probe" in names
    assert "repro_torch.service.execute" in names
    assert not any(n.endswith(".wait") for n in names)
    assert "repro_torch.service.probe" in calls
    assert any(e.name == "execute" for e in svc.obs.tracer.events)
    svc.close()


# ------------------------------------------------------------------ #
# Shadow verification
# ------------------------------------------------------------------ #
class _Stub:
    """The duck-typed service surface a verifier needs."""

    def __init__(self, graph, id_to_mr):
        self.graph, self._id_to_mr = graph, id_to_mr


def test_shadow_samples_the_same_keys_as_reference(pair):
    jshadow = jax_pkg("repro.obs.shadow")
    id_to_mr = sorted(pair["mr_ids"], key=pair["mr_ids"].get)
    sv = ShadowVerifier(_Stub(pair["g"], id_to_mr), 0.3, seed=5)
    jsv = jshadow.ShadowVerifier(_Stub(pair["jg"], id_to_mr), 0.3, seed=5)
    for s, t, c in zip(*ids(pair, pair["queries"])):
        ans = bool(pair["frozen"].query(int(s), int(t), int(c)))
        assert sv.offer(s, t, c, ans) == jsv.offer(s, t, c, ans)
    assert list(sv._pending) == list(jsv._pending)
    assert sv.drain() == jsv.drain() > 0
    assert sv.stats() == jsv.stats()
    assert sv.divergent == 0


def test_shadow_reports_a_corrupted_index():
    g = tgen.erdos_renyi(120, 3.5, 3, seed=13)
    svc = RLCService.build(g, ServiceConfig(
        k=K, device="cpu", backend="numpy", use_device=False,
        cache_capacity=0, shadow_sample_rate=1.0))
    s, t, L = sample_index_queries(svc.frozen, svc._id_to_mr, n=1,
                                   seed=3)[0]
    assert svc.query(s, t, L) == True   # noqa: E712 — typed Answer
    svc.drain_shadow()
    assert svc._shadow.divergent == 0
    o0, o1 = svc.frozen.out_indptr[s], svc.frozen.out_indptr[s + 1]
    i0, i1 = svc.frozen.in_indptr[t], svc.frozen.in_indptr[t + 1]
    svc.frozen.out_hub[o0:o1] = -2
    svc.frozen.in_hub[i0:i1] = -2
    assert svc.query(s, t, L) == False  # noqa: E712 — corrupted path
    svc.drain_shadow()
    st = svc._shadow.stats()
    assert st["divergent"] >= 1
    bundle = svc._shadow.divergences[0]
    assert bundle["served_answer"] is False and bundle["oracle"] is True
    assert (bundle["s"], bundle["t"]) == (s, t)
    svc.close()


# ------------------------------------------------------------------ #
# Import gate
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("module", ["repro_torch.obs", "repro_torch.service",
                                    "repro_torch.build.delta"])
def test_port_modules_import_without_jax(module):
    code = ("import sys; sys.modules['jax'] = None; "
            f"import {module}; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'imported the JAX package'")
    subprocess.run([sys.executable, "-c", code], check=True)
