"""The benchmark takes a new cell by new files and entries alone, as its
README promises. A copy of ``rlcbench/`` and ``BENCHMARK.json`` gets, and
only as new files and entries: a configuration, a graph recipe, a traffic
that drives a renamed copy of the ``condensed`` entry point with its
faults file, and a cell listed under ``build_s.rlc`` and every ``.rlc``
per-layer metric. The copy's controls, span and harness tests then run in
a fresh process against it: nothing may fail to collect, and the new
cell's controls, faults and CPU rehearsals have to pass."""
import json
import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[2]
CELL, CONFIG, TRAFFIC = "probe-rlc-build", "probe-er8", "rlc-probe"
ENTRY, RECIPE = "condensed_probe", "probe_erdos_renyi"
TESTS = ("test_rlcbench_controls.py", "test_rlcbench_program_spans.py",
         "test_rlcbench_harness.py")
# the card's whole run rebuilds the kernels; the repository's own test run
# makes it
DESELECT = "test_rlcbench_harness.py::test_a_whole_run_on_the_card"

RECIPE_SOURCE = '''"""Directed Erdos-Renyi edges with Zipf-2 labels."""
import numpy as np

from rlcbench.gen.graphs import zipf_labels


def generate(num_vertices, avg_degree, num_labels, seed,
             label_zipf_exponent=2.0):
    rng = np.random.default_rng(seed)
    m = int(round(num_vertices * avg_degree))
    src = rng.integers(0, num_vertices, size=m)
    dst = rng.integers(0, num_vertices, size=m)
    lab = zipf_labels(m, num_labels, rng, label_zipf_exponent)
    return np.stack([src, lab, dst], axis=1).astype(np.int32)
'''

PROBE_CONFIG = {
    "name": CONFIG,
    "source": "RLC index paper, arXiv:2203.08606, Table III: Soc-Epinions "
              "(EP), 8 labels; Zipf-2 labels; k = 2",
    "graph": {"generator": RECIPE, "num_vertices": 16384,
              "avg_degree": 6.7, "num_labels": 8,
              "label_zipf_exponent": 2.0},
    "k": 2,
    "hub_batch": 8,
    "reduced": ["num_vertices", "topology"],
    "assumed": {"topology": "a directed Erdos-Renyi graph"},
}


def add_probe(bench_root: Path, dst: Path) -> None:
    """Copy ``bench_root``'s ``rlcbench/`` and ``BENCHMARK.json`` into
    ``dst`` and add the probe cell there as new files and entries. The
    probe's entry point is a renamed copy of the copied ``condensed``; its
    faults file a copy of this tree's."""
    shutil.copytree(bench_root / "rlcbench", dst / "rlcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(bench_root / "BENCHMARK.json", dst)
    (dst / "src").symlink_to(ROOT / "src", target_is_directory=True)
    here = dst / "rlcbench"
    faults = ROOT / "rlcbench" / "tests" / "faults" / "condensed.py"
    files = {
        here / "gen" / f"{RECIPE}.py": RECIPE_SOURCE,
        here / "configs" / f"{CONFIG}.json": json.dumps(PROBE_CONFIG),
        here / "traffic" / f"{TRAFFIC}.json": json.dumps(
            {"entry": ENTRY, "describe": "the condensed entry, renamed"}),
        here / "entrypoints" / f"{ENTRY}.py":
            (here / "entrypoints" / "condensed.py").read_text(),
        here / "tests" / "faults" / f"{ENTRY}.py": faults.read_text(),
    }
    for path, text in files.items():
        assert not path.exists(), f"{path} is not new"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)

    bench = json.loads((dst / "BENCHMARK.json").read_text())
    assert CELL not in {w["name"] for w in bench["workloads"]}
    bench["configs"].append({
        "name": CONFIG, "source": PROBE_CONFIG["source"],
        "file": f"rlcbench/configs/{CONFIG}.json",
        "reduced": PROBE_CONFIG["reduced"], "why": "the probe's graph"})
    bench["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": TRAFFIC, "chips": 1,
        "why": "the probe's cell"})
    rlc = [m for m in bench["end_to_end"] + bench["per_layer"]
           if m["name"].endswith(".rlc")]
    assert "build_s.rlc" in {m["name"] for m in rlc}
    for m in rlc:
        m["workloads"].append(CELL)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


def run_tests(dst: Path, timeout: float = 900):
    """Run the copy's controls, span and harness tests in a fresh process;
    return its exit code, its output's end and each case's outcome by
    ``<file stem>::<test id>`` (``collect`` for a file that did not
    collect)."""
    report = dst / "report.xml"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTEST", "PYTHON"))}
    env["PYTHONPATH"] = str(dst / "src")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-c", os.devnull, "--rootdir", str(dst),
         "--continue-on-collection-errors",
         f"--junitxml={report}", "--deselect", f"rlcbench/tests/{DESELECT}",
         *(f"rlcbench/tests/{t}" for t in TESTS)],
        cwd=dst, env=env, capture_output=True, text=True, timeout=timeout)
    outcomes = {}
    for case in ET.parse(report).getroot().iter("testcase"):
        kids = {child.tag for child in case}
        outcome = next((k for k in ("error", "failure", "skipped")
                        if k in kids), "passed")
        stem = case.get("classname", "").split(".")[-1]
        outcomes[f"{stem}::{case.get('name')}"] = outcome
    return out.returncode, out.stdout[-4000:], outcomes


def probe_cases():
    """The cases the probe cell and its entry point have to pass."""
    c = "test_rlcbench_controls::"
    return ([f"{c}test_control_comes_out_not_correct[{CELL}-{name}]"
             for name in ("short_closure", "no_case1")]
            + [f"{c}test_fault_in_the_program_comes_out_not_correct"
               f"[{CELL}-{f}]"
               for f in ("closure_returns_its_state",
                         "hub_step_returns_its_state",
                         "half_of_each_hub_batch", "one_entry_altered")]
            + [f"{c}test_each_entry_brings_its_controls_and_faults[{ENTRY}]"]
            + [f"test_rlcbench_harness::test_cpu_rehearsal_of_each_cell"
               f"[{CELL}-{trace}]" for trace in (False, True)]
            + [f"test_rlcbench_harness::test_cell_resolves_its_files_by_name"
               f"[{CELL}]"])


def test_a_new_cell_comes_in_by_new_files_and_entries(tmp_path):
    add_probe(ROOT, tmp_path)
    rc, tail, outcomes = run_tests(tmp_path)
    bad = {k: v for k, v in outcomes.items() if v in ("error", "failure")}
    assert rc == 0 and not bad, (bad, tail)
    assert {t.split("::")[0] for t in outcomes} == {
        t[:-len(".py")] for t in TESTS}
    missing = [t for t in probe_cases() if outcomes.get(t) != "passed"]
    assert not missing, (missing, tail)
