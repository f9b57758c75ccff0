"""The benchmark's files against its contract, a CPU rehearsal of every
traffic at a tiny size, and the per-layer arithmetic on recorded and
hand-made traces."""
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from rlcbench import bounds, harness, tracing  # noqa: E402
from rlcbench.tests.conftest import tiny  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
BENCH = harness.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["rlcbench"]
    assert BENCH["command"] == ["python3", "rlcbench/run.py"]
    assert (ROOT / BENCH["command"][1]).is_file()
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_have_the_contracts_keys_and_names(section):
    seen = set()
    for entry in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert ENTRY_KEYS[section] <= set(entry) <= ENTRY_KEYS[section] | extra
        assert NAME.match(entry["name"]), entry["name"]
        assert entry["name"] not in seen
        seen.add(entry["name"])
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200
                assert "\n" not in entry[key] and "\t" not in entry[key]
        for key in entry.get("reduced", []):
            assert NAME.match(key)


def test_metrics_sources_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert m["workloads"] and set(m["workloads"]) <= set(CELLS)
        moves = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moves.get("workloads", CELLS))
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_its_files_by_name(workload):
    cell = harness.resolve(BENCH, workload, ROOT)
    entry = next(w for w in BENCH["workloads"] if w["name"] == workload)
    cfg = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert cfg["file"].startswith("rlcbench/configs/")
    assert cell.config["name"] == cfg["name"]
    assert cell.config["reduced"] == cfg["reduced"]
    assert len(cell.config["source"]) <= 200
    assert cell.chips == 1
    entry = ROOT / "rlcbench" / "entrypoints" / f"{cell.traffic['entry']}.py"
    assert entry.is_file()
    module = harness.load_entrypoint(cell.traffic["entry"])
    assert callable(module.ENTRY.window) and module.CONTROLS
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer and all(callable(r)
                                  for r in cell.readers.values())
    metrics = ROOT / "rlcbench" / "metrics"
    for m in cell.per_layer:
        assert (metrics / f"{m['name']}.py").is_file() \
            or (metrics / f"{m['name'].split('.')[0]}.py").is_file()


def test_every_config_is_used_and_pairs_are_unique():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_check_budget_fits_with_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_cpu_rehearsal_of_each_cell(workload, trace):
    cell = tiny(harness.resolve(BENCH, workload, ROOT))
    line = harness.run_cell(cell, 2 ** 31 + 17, 0.05, trace, "cpu")
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert list(line)[-1] == "checks"
    assert all(c["value"] == 0 for c in line["checks"].values())
    json.dumps(line)
    if trace:
        # no device on the CPU: the readers find nothing and say nothing
        assert line["metrics"] == {}
        assert line["device"]["busy_s"] == 0
        assert line["device"]["window_s"] > 0
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
        builds = [v["value"] for name, v in line["metrics"].items()
                  if name.split(".")[0] == "build_s"]
        assert len(builds) == 1 and builds[0] > 0


def test_recorded_trace_reduces_to_the_windows_ranges():
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tracing.WINDOW):
            for _ in range(3):
                with record_function(tracing.BUILD):
                    torch.ones(64, 64) @ torch.ones(64, 64)
    tr = tracing.from_profiler(prof)
    assert tr.window() is not None and len(tr.builds()) == 3
    w = tr.window()
    assert all(w[0] <= s <= e <= w[1] for s, e in tr.builds())
    assert any(name == "aten::mm" for name, _, _ in tr.cpu)
    assert tr.device == []
    assert tracing.idle_gaps(tr, *w) == [w]


def hand_trace():
    """Two builds of 1 s in a 2.5 s window. Build 1 runs a 0.2 s kernel and
    a 0.15 s copy, build 2 a 0.3 s kernel and a 0.1 s fill; each ends
    0.5 s after its last device operation. A 0.02 s fill runs between
    them."""
    tr = tracing.Trace()
    tr.ranges = [(tracing.WINDOW, 0.0, 2.5), (tracing.BUILD, 0.0, 1.0),
                 (tracing.BUILD, 1.2, 2.2)]
    tr.cpu = [("aten::bmm", 0.05, 0.15), ("aten::copy_", 0.3, 0.45)]
    tr.device = [("gemm", "kernel", 0.1, 0.3),
                 ("Memcpy DtoH", "memcpy", 0.35, 0.5),
                 ("fill", "memset", 1.0, 1.02),
                 ("gemm", "kernel", 1.3, 1.6), ("fill", "memset", 1.6, 1.7)]
    return tr


def ctx_of(tr, workload, n=6541, hub_batch=8, lengths=(1,) * 3 + (2,) * 6):
    cell = harness.resolve(BENCH, workload, ROOT)
    return cell, harness.Context(tr, cell.config, cell.traffic, n, 2,
                                 hub_batch, list(lengths))


def test_per_layer_arithmetic_on_a_hand_made_trace():
    tr = hand_trace()
    assert math.isclose(tracing.busy_s(tr, 0.0, 2.5), 0.77)
    cell, ctx = ctx_of(tr, "ad-etc-build")
    got = {m: r(ctx) for m, r in cell.readers.items()}
    assert math.isclose(got["device_idle_share.etc"], 100 * (1 - 0.77 / 2.5))
    assert math.isclose(got["reach_copy_ms.etc"], 75.0)
    kernel_s = 0.2 + 0.3
    want = 100 * bounds.reach_bound_s(ctx.mr_lengths, 6541) * 2 / kernel_s
    assert math.isclose(got["reach_roofline.etc"], want)
    cell, ctx = ctx_of(tr, "ad-rlc-build")
    got = {m: r(ctx) for m, r in cell.readers.items()}
    assert math.isclose(got["host_tail_ms.rlc"], 500.0)
    want = 100 * bounds.hub_loop_bound_s(9, 6541, 8)[0] * 2 / kernel_s
    assert math.isclose(got["hub_loop_roofline.rlc"], want)
    b = tracing.breakdown(tr)
    assert b["device_ops"][0] == ["gemm", pytest.approx(0.5)]
    idle = dict(b["idle_gaps"])
    assert idle == pytest.approx({"aten::bmm": 0.1, "aten::copy_": 0.05,
                                  "build_host": 0.5 + 0.8,
                                  "harness": 0.28})


def test_readers_say_nothing_without_device_work():
    tr = hand_trace()
    tr.device = []
    for workload in CELLS:
        cell, ctx = ctx_of(tr, workload)
        assert all(r(ctx) is None for r in cell.readers.values())


def test_roofline_counts_follow_the_shapes():
    # k = 2 over 3 labels: 3 MRs of length 1, 6 of length 2; n = 6541
    # needs 13 squarings: 6 chain + 117 doubling products
    lengths = [1] * 3 + [2] * 6
    assert bounds.doubling_steps(6541) == 13
    assert bounds.reach_ops(lengths, 6541) == 2.0 * 6541 ** 3 * 123
    t, by = bounds.hub_loop_bound_s(9, 6541, 8)
    assert by == "bytes"
    batches = math.ceil(6541 / 8)
    stacks = batches * 2 * 9 * 6541 ** 2 / 8
    assert t > stacks / bounds.HBM_BYTES_PER_S
    assert t < 1.01 * stacks / bounds.HBM_BYTES_PER_S


def test_reservoir_keeps_a_seeded_uniform_sample():
    picks = []
    for seed in range(200):
        r = harness.Reservoir(2, seed)
        for i in range(10):
            r.offer(i)
        assert len(r.kept) == 2 and len(set(r.kept)) == 2
        picks.extend(r.kept)
    again = harness.Reservoir(2, 7)
    for i in range(10):
        again.offer(i)
    first = harness.Reservoir(2, 7)
    for i in range(10):
        first.offer(i)
    assert again.kept == first.kept
    assert min(picks.count(i) for i in range(10)) > 10


def test_harness_loads_no_forbidden_module():
    code = (
        "import sys; sys.path[0:0] = [%r, %r]\n"
        "from rlcbench import harness\n"
        "from rlcbench.tests.conftest import tiny\n"
        "cell = tiny(harness.resolve(harness.load_benchmark(), "
        "'ad-rlc-build'))\n"
        "harness.run_cell(cell, 3, 0.01, True, 'cpu')\n"
        "print(harness.forbidden_modules(), 'repro_torch' in sys.modules)\n"
    ) % (str(ROOT), str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["repro_torch.core", "reprox"]) == []
    assert harness.forbidden_modules(["repro.core", "jax.numpy",
                                      "benchmarks"]) == ["benchmarks",
                                                         "jax", "repro"]


def test_run_refuses_without_a_card_or_without_the_program(tmp_path):
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", lone)
    shutil.copytree(ROOT / "rlcbench", lone / "rlcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for where in (ROOT, lone):
        out = subprocess.run(
            [sys.executable, "rlcbench/run.py", "--workload", "ad-etc-build",
             "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=where,
            capture_output=True, text=True, timeout=300,
            env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0
        assert out.stdout.strip() == ""


def test_a_whole_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "rlcbench/run.py", "--workload", "ad-etc-build",
         "--seed", "5", "--seconds", "2", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["busy_s"] > 0
    assert 0 < line["metrics"]["reach_roofline.etc"]["value"] <= 100


class Event:
    """A profiler event as ``tracing.from_events`` reads it."""

    def __init__(self, name, device, start_ns, duration_ns, thread):
        self._row = (name, device, start_ns, duration_ns, thread)

    def name(self):
        return self._row[0]

    def device_type(self):
        return self._row[1]

    def start_ns(self):
        return self._row[2]

    def duration_ns(self):
        return self._row[3]

    def start_thread_id(self):
        return self._row[4]


def synthetic_events(extra: bool):
    """A window of one build: two kernels, a copy and a fill on the card;
    with ``extra`` the program adds a range of its own inside the build,
    which the profiler mirrors onto the device's timeline."""
    cpu, gpu = "DeviceType.CPU", "DeviceType.CUDA"
    ms = 1_000_000
    rows = [(tracing.WINDOW, cpu, 0, 100 * ms, 1),
            (tracing.BUILD, cpu, 1 * ms, 90 * ms, 1),
            ("aten::bmm", cpu, 2 * ms, 5 * ms, 1),
            ("aten::mm", cpu, 3 * ms, 1 * ms, 2),
            (tracing.WINDOW, gpu, 0, 100 * ms, 0),
            (tracing.BUILD, gpu, 1 * ms, 90 * ms, 0),
            ("gemm_kernel", gpu, 10 * ms, 20 * ms, 0),
            ("Memcpy DtoH (Device -> Pageable)", gpu, 40 * ms, 10 * ms, 0),
            ("Memset (Device)", gpu, 55 * ms, 1 * ms, 0),
            ("mask_kernel", gpu, 60 * ms, 5 * ms, 0)]
    if extra:
        rows += [("repro_torch.hub_loop", cpu, 5 * ms, 70 * ms, 1),
                 ("repro_torch.hub_loop", gpu, 9 * ms, 60 * ms, 0)]
    return [Event(*r) for r in rows]


def test_a_program_range_moves_no_device_metric():
    plain_tr = tracing.from_events(synthetic_events(False))
    extra_tr = tracing.from_events(synthetic_events(True))
    assert sorted(extra_tr.device) == sorted(plain_tr.device)
    kinds = sorted(kind for _, kind, _, _ in plain_tr.device)
    assert kinds == ["kernel", "kernel", "memcpy", "memset"]
    assert math.isclose(tracing.busy_s(extra_tr, *extra_tr.window()), 0.036)
    assert [n for n, _, _ in extra_tr.cpu] == ["aten::bmm",
                                               "repro_torch.hub_loop"]
    for workload in CELLS:
        cell, a = ctx_of(plain_tr, workload)
        _, b = ctx_of(extra_tr, workload)
        for name, read in cell.readers.items():
            assert read(a) == read(b) and read(a) is not None, name


def recorded_events(drop=()):
    """The events of a trace recorded on an H100 (torch 2.11): in one
    window, a ``DenseEngine.build`` and a ``build_condensed_device`` on a
    96-vertex graph, twice, the second time each inside a range of the
    program's own, ``repro_torch.extra_span``. Events named in ``drop``
    are left out."""
    import gzip
    path = ROOT / "rlcbench" / "tests" / "data" / "trace_two_builds.json.gz"
    with gzip.open(path, "rt") as f:
        rows = json.load(f)["events"]
    return [Event(*r) for r in rows if r[0] not in drop]


def test_recorded_program_range_moves_no_device_metric():
    events = recorded_events()
    mirrors = [e for e in events if e.name() == "repro_torch.extra_span"
               and not e.device_type().endswith("CPU")]
    assert mirrors, "the profiler mirrors a program range on the device"
    tr = tracing.from_events(events)
    bare = tracing.from_events(recorded_events({"repro_torch.extra_span"}))
    host = {e.name() for e in events if e.device_type().endswith("CPU")}
    assert not any(name in host for name, _, _, _ in tr.device)
    assert tr.device == bare.device and len(tr.builds()) == 4
    kinds = {k: sum(op[1] == k for op in tr.device)
             for k in ("kernel", "memcpy", "memset")}
    assert kinds == {"kernel": 386, "memcpy": 28, "memset": 138}
    assert tracing.busy_s(tr, *tr.window()) == \
        tracing.busy_s(bare, *bare.window()) > 0
    for workload in CELLS:
        cell, a = ctx_of(tr, workload, n=96, hub_batch=32)
        _, b = ctx_of(bare, workload, n=96, hub_batch=32)
        for name, read in cell.readers.items():
            assert read(a) == read(b) and read(a) is not None, name
