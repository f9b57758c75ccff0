"""The dense device builds' spans and counters, on the CPU.

``DenseEngine.build`` and ``build_condensed_device`` name their phases as
``torch.profiler`` ranges (``repro_torch.obs.region``) while the profiler
records and enter no ``record_function`` while it does not; the condensed
build counts its runs, entries and ``(vertex, hub)`` keys in
``repro_torch.obs.process_obs()``'s registry. The benchmark's readers
(``rlcbench/program_spans.py``) read these names and counters.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.core import dense as tdense  # noqa: E402
from repro_torch.graphgen import random_labeled_graph  # noqa: E402

G12_BUILD = dict(num_vertices=12, num_edges=34, num_labels=2,
                 self_loop_frac=0.15)
CALLER = "caller.build"
DENSE_SPANS = ["repro_torch.dense.adjacency", "repro_torch.dense.reach",
               "repro_torch.dense.download"]
CONDENSED_SPANS = ["repro_torch.condensed.prepare",
                   "repro_torch.condensed.hub_loop",
                   "repro_torch.condensed.index_fill",
                   "repro_torch.condensed.download",
                   "repro_torch.condensed.index_fill",
                   "repro_torch.condensed.download",
                   "repro_torch.condensed.index_fill"]


def entries(idx):
    return tuple(tuple(sorted((v, h, m) for v, d in enumerate(maps)
                              for h, ms in d.items() for m in ms))
                 for maps in (idx.l_out, idx.l_in))


def profiled(fn):
    """``fn()`` inside the caller's range under the profiler; returns its
    result, the program's ranges in start order as ``(name, start, end,
    thread)`` and the caller's range."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALLER):
            out = fn()
    rows = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                    e.start_thread_id())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("repro_torch.")
                   or e.name() == CALLER), key=lambda r: r[1])
    caller = next(r for r in rows if r[0] == CALLER)
    return out, [r for r in rows if r[0] != CALLER], caller


def assert_in_order_inside(spans, caller, names):
    assert [s[0] for s in spans] == names
    assert all(s[3] == caller[3] for s in spans)
    assert all(caller[1] <= s[1] <= s[2] <= caller[2] for s in spans)
    # one after another: no phase's range overlaps the next
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


def test_dense_engine_opens_its_spans_in_order():
    g = random_labeled_graph(seed=0, **G12_BUILD)
    eng, spans, caller = profiled(
        lambda: tdense.DenseEngine.build(g, 2, device="cpu"))
    assert_in_order_inside(spans, caller, DENSE_SPANS)
    plain = tdense.DenseEngine.build(g, 2, device="cpu")
    np.testing.assert_array_equal(eng.reach, plain.reach)


@pytest.mark.parametrize("with_reach", [True, False])
@pytest.mark.parametrize("hub_batch", [1, 8])
def test_condensed_build_opens_its_spans_in_order(hub_batch, with_reach):
    g = random_labeled_graph(seed=1, **G12_BUILD)
    reach = tdense.DenseEngine.build(g, 2, device="cpu").reach \
        if with_reach else None
    (idx, eng), spans, caller = profiled(
        lambda: tdense.build_condensed_device(
            g, 2, hub_batch=hub_batch, reach=reach, device="cpu"))
    want = CONDENSED_SPANS if with_reach else DENSE_SPANS + CONDENSED_SPANS
    assert_in_order_inside(spans, caller, want)
    plain, plain_eng = tdense.build_condensed_device(
        g, 2, hub_batch=hub_batch, reach=reach, device="cpu")
    assert entries(idx) == entries(plain)
    np.testing.assert_array_equal(eng.reach, plain_eng.reach)


def test_no_record_function_without_the_profiler(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        calls.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    g = random_labeled_graph(seed=2, **G12_BUILD)
    tdense.build_condensed_device(g, 2, hub_batch=4, device="cpu")
    assert calls == []
    # the same build under the profiler goes through the patched name
    with profile(activities=[ProfilerActivity.CPU]):
        tdense.build_condensed_device(g, 2, hub_batch=4, device="cpu")
    assert calls == DENSE_SPANS + CONDENSED_SPANS


def counted():
    """The process registry's condensed-build runs, and its entries and
    ``(vertex, hub)`` keys a side."""
    reg = obs.process_obs().registry

    def value(name, **labels):
        series = reg.get(name)
        return series.value(backend="device_condensed", **labels) \
            if series else 0.0
    return (value("rlc_build_runs", context="full"),
            value("rlc_build_entries", side="out"),
            value("rlc_build_entries", side="in"),
            value("rlc_build_pairs", side="out"),
            value("rlc_build_pairs", side="in"))


@pytest.mark.parametrize("with_reach", [True, False])
@pytest.mark.parametrize("hub_batch", [1, 5, 8])
def test_counters_match_the_index(hub_batch, with_reach):
    proc = obs.process_obs()
    assert proc is obs.process_obs() and proc.enabled
    g = random_labeled_graph(seed=3, **G12_BUILD)
    reach = tdense.DenseEngine.build(g, 2, device="cpu").reach \
        if with_reach else None
    before = counted()
    idx, _ = tdense.build_condensed_device(g, 2, hub_batch=hub_batch,
                                           reach=reach, device="cpu")
    runs, out, in_, pairs_out, pairs_in = (
        a - b for a, b in zip(counted(), before))
    want_out = sum(len(ms) for d in idx.l_out for ms in d.values())
    assert (runs, out, in_) == (1, want_out, idx.num_entries() - want_out)
    assert (pairs_out, pairs_in) == (sum(map(len, idx.l_out)),
                                     sum(map(len, idx.l_in)))
    assert 0 < pairs_out < out


def test_the_dense_engine_counts_nothing():
    g = random_labeled_graph(seed=4, **G12_BUILD)
    tdense.build_condensed_device(g, 2, hub_batch=8, device="cpu")
    before = obs.process_obs().registry.as_dict()
    tdense.DenseEngine.build(g, 2, device="cpu")
    assert obs.process_obs().registry.as_dict() == before


def test_region_names_and_costs_nothing_when_off():
    assert obs.region("x") is obs.region("y")       # the shared no-op
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.region("dense.reach"):
            pass
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "repro_torch.dense.reach" in names
