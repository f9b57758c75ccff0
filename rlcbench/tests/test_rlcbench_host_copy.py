"""``host_copy_mib.rlc``, the condensed build's bytes between host and card
a build, read from the program's ``rlc_build_host_bytes`` counter: its
arithmetic on a hand-made registry, its silence where there is nothing
to read, the program's own registry, and its place in
``BENCHMARK.json``."""
import math

import pytest

torch = pytest.importorskip("torch")

from rlcbench import harness, program_spans  # noqa: E402
from rlcbench.tests.test_rlcbench_harness import (ROOT, ctx_of,  # noqa: E402
                                                  hand_trace)

NAME = "host_copy_mib.rlc"
RLC_CELLS = ("ad-rlc-build", "ad3-rlc-build", "ep-rlc-build")


class Registry:
    """``rlc_build_runs`` and, unless ``copied`` is None, the two
    directions of ``rlc_build_host_bytes``."""

    def __init__(self, runs, copied):
        self.runs, self.copied = runs, copied

    def get(self, name):
        if name == "rlc_build_runs":
            value = lambda **kv: self.runs  # noqa: E731
        elif name == "rlc_build_host_bytes" and self.copied is not None:
            value = lambda **kv: self.copied[kv["direction"]]  # noqa: E731
        else:
            return None

        class Series:
            def value(self, **labels):
                assert labels["backend"] == "device_condensed"
                return value(**labels)
        return Series()


class Obs:
    def __init__(self, registry):
        self.registry = registry


def read(tr, workload="ep-rlc-build"):
    cell, ctx = ctx_of(tr, workload)
    return cell.readers[NAME](ctx)


@pytest.mark.parametrize("workload", RLC_CELLS)
def test_bytes_both_ways_over_the_builds_counted(workload, monkeypatch):
    monkeypatch.setattr(program_spans, "program_obs", lambda: Obs(
        Registry(4, {"up": 4 * 385_054_681.0, "down": 4 * 12_817_440.0})))
    assert math.isclose(read(hand_trace(), workload),
                        (385_054_681 + 12_817_440) / 2 ** 20)


def test_none_without_device_work_or_without_the_counter(monkeypatch):
    tr = hand_trace()
    tr.device = []
    assert read(tr) is None
    monkeypatch.setattr(program_spans, "program_obs", lambda: None)
    assert read(hand_trace()) is None
    # a program older than the counter
    monkeypatch.setattr(program_spans, "program_obs",
                        lambda: Obs(Registry(3, None)))
    assert read(hand_trace()) is None
    monkeypatch.setattr(program_spans, "program_obs",
                        lambda: Obs(Registry(0, {"up": 0.0, "down": 0.0})))
    assert read(hand_trace()) == 0.0


def test_the_program_registry_is_read_by_default():
    from repro_torch.core import dense
    from repro_torch.graphgen import random_labeled_graph
    from repro_torch.obs import process_obs

    g = random_labeled_graph(seed=6, num_vertices=12, num_edges=34,
                             num_labels=2, self_loop_frac=0.15)
    reach = dense.DenseEngine.build(g, 2, device="cpu").reach
    dense.build_condensed_device(g, 2, hub_batch=4, reach=reach,
                                 device="cpu")
    reg = process_obs().registry
    runs = reg.get("rlc_build_runs").value(context="full",
                                           backend="device_condensed")
    copied = sum(reg.get("rlc_build_host_bytes").value(
        backend="device_condensed", direction=d) for d in ("up", "down"))
    assert runs >= 1 and copied >= reach.size
    assert math.isclose(read(hand_trace()), copied / runs / 2 ** 20)


def test_listed_in_the_rlc_cells_under_its_layer():
    bench = harness.load_benchmark(ROOT)
    m = next(m for m in bench["per_layer"] if m["name"] == NAME)
    assert (m["unit"], m["layer"], m["moves"]) == (
        "MiB", "condensed build", "build_s.rlc")
    builds = next(e for e in bench["end_to_end"]
                  if e["name"] == "build_s.rlc")["workloads"]
    assert set(m["workloads"]) == set(RLC_CELLS) <= set(builds)
    counts = (ROOT / "src" / "repro_torch" / "obs" / "build_obs.py")
    assert '"rlc_build_host_bytes"' in counts.read_text()
