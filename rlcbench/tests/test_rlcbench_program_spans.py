"""The condensed build's span and counter readers (``program_spans.py`` and
the four ``metrics/*.rlc.py`` that use it) on hand-made traces, the names
they read against the names the program opens, and the cells they list."""
import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from rlcbench import harness, program_spans, tracing  # noqa: E402
from rlcbench.tests.test_rlcbench_harness import (  # noqa: E402
    Event, ctx_of, hand_trace, synthetic_events)

ROOT = Path(__file__).resolve().parents[2]
DENSE = ROOT / "src" / "repro_torch" / "core" / "dense.py"
NEW = ("prepare_ms.rlc", "hub_loop_idle_ms.rlc", "index_fill_ms.rlc",
       "index_fill_us_per_entry.rlc")
RLC_CELLS = ("ad-rlc-build", "ad3-rlc-build")


def spanned_trace():
    """``hand_trace``'s two builds, each with the condensed build's spans:
    build 1 (0-1 s) prepares 0.0-0.05, loops 0.05-0.4 (its kernel and
    copy run 0.1-0.3 and 0.35-0.5), downloads 0.4-0.45 and 0.6-0.65 and
    fills 0.45-0.6 and 0.65-0.95; build 2 (1.2-2.2 s) prepares 1.2-1.28,
    loops 1.28-1.7 (kernel 1.3-1.6, fill 1.6-1.7), fills 1.75-2.15."""
    tr = hand_trace()
    p = program_spans
    tr.cpu += [(p.PREPARE, 0.0, 0.05), (p.HUB_LOOP, 0.05, 0.4),
               (p.DOWNLOAD, 0.4, 0.45), (p.INDEX_FILL, 0.45, 0.6),
               (p.DOWNLOAD, 0.6, 0.65), (p.INDEX_FILL, 0.65, 0.95),
               (p.PREPARE, 1.2, 1.28), (p.HUB_LOOP, 1.28, 1.7),
               (p.INDEX_FILL, 1.75, 2.15),
               # outside every build: not read
               (p.INDEX_FILL, 2.3, 2.4)]
    return tr


def read_all(tr, workload="ad-rlc-build"):
    cell, ctx = ctx_of(tr, workload)
    return {name: cell.readers[name](ctx) for name in NEW}


class Registry:
    """The two series ``entries_per_build`` reads."""

    def __init__(self, runs, out, in_):
        self.values = {"rlc_build_runs": runs, "out": out, "in": in_}

    def get(self, name):
        values = self.values

        class Series:
            def value(self, **labels):
                assert labels["backend"] == "device_condensed"
                return values[labels.get("side", name)]
        return Series()


class Obs:
    def __init__(self, registry):
        self.registry = registry


@pytest.mark.parametrize("workload", RLC_CELLS)
def test_readers_arithmetic_on_a_spanned_trace(workload, monkeypatch):
    monkeypatch.setattr(program_spans, "program_obs",
                        lambda: Obs(Registry(4, 3000.0, 1000.0)))
    got = read_all(spanned_trace(), workload)
    assert math.isclose(got["prepare_ms.rlc"], 1e3 * (0.05 + 0.08) / 2)
    assert math.isclose(got["index_fill_ms.rlc"],
                        1e3 * (0.15 + 0.3 + 0.4) / 2)
    # idle inside the loops: 0.05-0.1 and 0.3-0.35 in build 1, 1.28-1.3
    # in build 2
    assert math.isclose(got["hub_loop_idle_ms.rlc"],
                        1e3 * (0.05 + 0.05 + 0.02) / 2)
    # 425 ms a build over 1,000 entries a build
    assert math.isclose(got["index_fill_us_per_entry.rlc"],
                        1e3 * got["index_fill_ms.rlc"] / 1000.0)


def test_the_program_registry_is_read_by_default():
    from repro_torch.core import dense
    from repro_torch.graphgen import random_labeled_graph
    from repro_torch.obs import process_obs

    g = random_labeled_graph(seed=5, num_vertices=12, num_edges=34,
                             num_labels=2, self_loop_frac=0.15)
    idx, _ = dense.build_condensed_device(g, 2, hub_batch=4, device="cpu")
    assert program_spans.program_obs() is process_obs()
    entries = program_spans.entries_per_build()
    reg = process_obs().registry
    runs = reg.get("rlc_build_runs").value(context="full",
                                           backend="device_condensed")
    assert runs >= 1 and entries > 0
    assert math.isclose(entries * runs, sum(
        reg.get("rlc_build_entries").value(backend="device_condensed",
                                           side=s) for s in ("out", "in")))
    got = read_all(spanned_trace())
    assert math.isclose(got["index_fill_us_per_entry.rlc"],
                        1e3 * got["index_fill_ms.rlc"] / entries)


def test_none_without_device_work():
    for tr in (spanned_trace(), hand_trace()):
        tr.device = []
        for workload in RLC_CELLS:
            assert all(v is None for v in read_all(tr, workload).values())


def test_zero_where_the_program_opened_no_span(monkeypatch):
    got = read_all(hand_trace())
    assert got["prepare_ms.rlc"] == got["hub_loop_idle_ms.rlc"] == \
        got["index_fill_ms.rlc"] == 0.0
    assert got["index_fill_us_per_entry.rlc"] == 0.0
    # spans, but no entry counted
    monkeypatch.setattr(program_spans, "program_obs",
                        lambda: Obs(Registry(0, 0.0, 0.0)))
    assert read_all(spanned_trace())["index_fill_us_per_entry.rlc"] == 0.0


def test_none_from_a_program_without_spans_and_counters(monkeypatch):
    monkeypatch.setattr(program_spans, "program_obs", lambda: None)
    assert all(v is None for v in read_all(spanned_trace()).values())


def test_ranges_from_the_profiler_reach_the_readers():
    """A program range in the profiler's events is kept as a host span of
    the window's thread; its mirror on the card moves no device metric
    and a foreign ``repro_torch.*`` range moves none of the four."""
    ms = 1_000_000
    cpu, gpu = "DeviceType.CPU", "DeviceType.CUDA"
    spans = [(program_spans.HUB_LOOP, cpu, 5 * ms, 70 * ms, 1),
             (program_spans.HUB_LOOP, gpu, 9 * ms, 60 * ms, 0),
             (program_spans.INDEX_FILL, cpu, 76 * ms, 10 * ms, 1),
             (program_spans.INDEX_FILL, cpu, 95 * ms, 3 * ms, 1)]
    events = synthetic_events(False) + [Event(*r) for r in spans]
    tr = tracing.from_events(events)
    bare = tracing.from_events(synthetic_events(False))
    assert tr.device == bare.device
    got = read_all(tr)
    # the loop's 5-75 ms holds kernels 10-30, 60-65, a copy 40-50 and a
    # fill 55-56: idle 5 + 10 + 5 + 4 + 10 ms; the fill at 95 ms lies
    # outside the build (1-91 ms)
    assert math.isclose(got["hub_loop_idle_ms.rlc"], 34.0)
    assert math.isclose(got["index_fill_ms.rlc"], 10.0)
    assert got["prepare_ms.rlc"] == 0.0
    foreign = tracing.from_events(events + synthetic_events(True)[-2:])
    assert read_all(foreign) == got


def test_the_program_opens_the_names_the_readers_read():
    """The names ``dense.py`` opens are the readers' names, and none is a
    foreign range that the harness's tests plant
    (``repro_torch.hub_loop``, ``repro_torch.extra_span``)."""
    opened = {"repro_torch." + n
              for n in re.findall(r'region\("([^"]+)"\)', DENSE.read_text())}
    assert {program_spans.PREPARE, program_spans.HUB_LOOP,
            program_spans.DOWNLOAD, program_spans.INDEX_FILL} <= opened
    assert not opened & {"repro_torch.hub_loop", "repro_torch.extra_span"}
    bench = harness.load_benchmark(ROOT)
    new = [m for m in bench["per_layer"] if m["name"] in NEW]
    assert [m["name"] for m in new] == list(NEW)
    assert all(m["layer"] == "condensed build" and m["moves"] == "build_s.rlc"
               for m in new)


def test_span_metrics_keep_their_cells_and_read_only_rlc_builds():
    """Each span metric lists the two Advogato rlc cells and no cell that
    does not report ``build_s.rlc``: a cell may be added to the lists, and
    none taken away."""
    bench = harness.load_benchmark(ROOT)
    builds = next(m for m in bench["end_to_end"]
                  if m["name"] == "build_s.rlc")["workloads"]
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            assert set(RLC_CELLS) <= set(m["workloads"]) <= set(builds), \
                m["name"]
