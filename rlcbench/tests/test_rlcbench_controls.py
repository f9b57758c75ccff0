"""The check fails what it has to fail: each control (the reference in the
program's place with a guarantee broken), and each fault planted in the
program underneath a whole run, at a size a CPU test run holds. A
cell has one chip, so no exchange between chips can be left out.

The cases are found by each cell's entry point: its ``CONTROLS`` in
``rlcbench/entrypoints/<entry>.py`` and its ``FAULTS`` in
``rlcbench/tests/faults/<entry>.py``. An entry point without them gets one
failing case of its own, never an error that stops collection."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rlcbench import controls, harness  # noqa: E402
from rlcbench.tests.conftest import tiny  # noqa: E402

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
FAULTS_DIR = harness.HERE / "tests" / "faults"


def entry_of(workload):
    return harness.resolve(BENCH, workload).traffic["entry"]


def controls_of(entry):
    return list(harness.load_entrypoint(entry).CONTROLS)


def faults_of(entry):
    """The ``FAULTS`` of ``rlcbench/tests/faults/<entry>.py``."""
    return list(harness._load(FAULTS_DIR / f"{entry}.py").FAULTS)


def entries_of(cells):
    """Each cell's entry point; a cell whose entry cannot be read stands
    under its own name (its harness tests say why)."""
    found = {}
    for w in cells:
        try:
            found[w] = entry_of(w)
        except (OSError, KeyError, ValueError, StopIteration):
            found[w] = w
    return found


def cases(find, entries):
    """``(workload, item)`` for each cell of ``entries`` (cell -> entry
    point) and each item ``find`` gives for its entry point; and, by entry
    point, why ``find`` gave none. Nothing raises here, since collection
    would stop: a missing file, name or list is reported by
    ``test_each_entry_brings_its_controls_and_faults``."""
    found, missing = [], {}
    for w, entry in entries.items():
        try:
            items = find(entry)
        except Exception as e:  # reported by a case, never raised
            items, missing[entry] = [], f"{find.__name__}: {e!r}"
        if not items:
            missing.setdefault(entry, f"{find.__name__}: none")
        found += [(w, item) for item in items]
    return found, missing


ENTRIES = entries_of(CELLS)
CONTROL_CASES, NO_CONTROLS = cases(controls_of, ENTRIES)
FAULT_CASES, NO_FAULTS = cases(faults_of, ENTRIES)


@pytest.mark.parametrize("entry", sorted(set(ENTRIES.values())))
def test_each_entry_brings_its_controls_and_faults(entry):
    missing = [m[entry] for m in (NO_CONTROLS, NO_FAULTS) if entry in m]
    assert not missing, f"entry point {entry!r}: {missing}"


def test_an_entry_without_its_files_is_one_failing_case():
    entries = {"cell-a": "no_such_entry", "cell-b": "no_such_entry"}
    for find in (controls_of, faults_of):
        found, missing = cases(find, entries)
        assert found == [] and list(missing) == ["no_such_entry"]
        assert missing["no_such_entry"].startswith(find.__name__)


@pytest.mark.parametrize("workload,control", CONTROL_CASES)
def test_control_comes_out_not_correct(workload, control):
    cell = tiny(harness.resolve(BENCH, workload), 80)
    seeds = (1, 2 ** 31 + 5, 2 ** 33 + 7)
    readings = list(controls.run_controls(cell, seeds, "cpu", [control]))
    assert [r["seed"] for r in readings] == list(seeds)
    for r in readings:
        assert r["correct"] is False
        assert max(c["value"] for c in r["checks"].values()) > 0


@pytest.mark.parametrize("workload,fault", FAULT_CASES,
                         ids=[f"{w}-{f.__name__}" for w, f in FAULT_CASES])
def test_fault_in_the_program_comes_out_not_correct(workload, fault,
                                                    monkeypatch):
    cell = tiny(harness.resolve(BENCH, workload), 80)
    fault(monkeypatch)
    line = harness.run_cell(cell, 2 ** 31 + 11, 0.0, False, "cpu")
    assert line["correct"] is False
    assert line["failed"] >= 1


def test_sound_run_reads_zero_on_every_number():
    cell = tiny(harness.resolve(BENCH, "ad-rlc-build"), 80)
    for seed in (3, 2 ** 32 + 3):
        line = harness.run_cell(cell, seed, 0.0, False, "cpu")
        assert line["correct"] is True
        assert np.all([c["value"] == 0 for c in line["checks"].values()])
