"""The check fails what it has to fail: each control (the reference in the
program's place with a guarantee broken), and each fault planted in the
program underneath a whole run, at a size a CPU test run holds. A
cell has one chip, so no exchange between chips can be left out."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rlcbench import controls, harness  # noqa: E402
from rlcbench.tests.conftest import tiny  # noqa: E402

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def controls_of(cell):
    return harness.load_entrypoint(cell.traffic["entry"]).CONTROLS


CONTROL_CASES = [(w, name) for w in CELLS
                 for name in controls_of(harness.resolve(BENCH, w))]


@pytest.mark.parametrize("workload,control", CONTROL_CASES)
def test_control_comes_out_not_correct(workload, control):
    cell = tiny(harness.resolve(BENCH, workload), 80)
    seeds = (1, 2 ** 31 + 5, 2 ** 33 + 7)
    readings = list(controls.run_controls(cell, seeds, "cpu", [control]))
    assert [r["seed"] for r in readings] == list(seeds)
    for r in readings:
        assert r["correct"] is False
        assert max(c["value"] for c in r["checks"].values()) > 0


def closure_returns_its_state(monkeypatch):
    """A doubling step that hands back its input: every reach is its MR's
    one-step matrix."""
    from repro_torch.kernels import bool_semiring

    def step(r, out=None):
        return r.clone() if out is None else out.copy_(r)
    monkeypatch.setattr(bool_semiring, "closure_step", step)


def half_the_mrs(monkeypatch):
    """The reach of the second half of the MRs left out (all zero)."""
    from repro_torch.core import dense
    real = dense._all_mr_reach

    def reach(A, mrs, n, matmul=None):
        R = real(A, mrs, n, matmul)
        R[len(mrs) // 2:] = 0
        return R
    monkeypatch.setattr(dense, "_all_mr_reach", reach)


def one_reach_bit_flipped(monkeypatch):
    """The reach stack handed back with one cell altered."""
    from repro_torch.core import dense
    real = dense.DenseEngine.build

    def build(*args, **kwargs):
        eng = real(*args, **kwargs)
        eng.reach[0, 0, 1] = not eng.reach[0, 0, 1]
        return eng
    monkeypatch.setattr(dense.DenseEngine, "build", staticmethod(build))


def an_mr_too_many(monkeypatch):
    """The reach handed back with one word more in its MR list, a power
    of a shorter word (no MR), over an all-false slice."""
    from repro_torch.core import dense
    real = dense.DenseEngine.build

    def build(*args, **kwargs):
        eng = real(*args, **kwargs)
        eng.mrs = list(eng.mrs) + [(0, 0)]
        eng.reach = np.concatenate([eng.reach,
                                    np.zeros_like(eng.reach[:1])])
        return eng
    monkeypatch.setattr(dense.DenseEngine, "build", staticmethod(build))


def hub_step_returns_its_state(monkeypatch):
    """A hub batch that adds nothing to the entry stacks."""
    from repro_torch.core import dense
    monkeypatch.setattr(dense, "_hub_batch_step", lambda *a: None)


def half_of_each_hub_batch(monkeypatch):
    """Each hub batch with its second half of hubs left out."""
    from repro_torch.core import dense
    real = dense._hub_batch_step

    def step(OUT, IN, R, aid, hubs):
        real(OUT, IN, R, aid, hubs[:max(1, len(hubs) // 2)])
    monkeypatch.setattr(dense, "_hub_batch_step", step)


def one_entry_altered(monkeypatch):
    """The first ``L_out`` entry of each index recorded at the wrong hub."""
    from repro_torch.core.rlc_index import RLCIndex
    real = RLCIndex.add_out

    def add_out(self, v, hub, mr):
        if not getattr(self, "_altered", False):
            self._altered = True
            hub = (hub + 1) % self.num_vertices
        real(self, v, hub, mr)
    monkeypatch.setattr(RLCIndex, "add_out", add_out)


FAULTS = {
    "dense_engine": [closure_returns_its_state, half_the_mrs,
                     one_reach_bit_flipped, an_mr_too_many],
    "condensed": [closure_returns_its_state, hub_step_returns_its_state,
                  half_of_each_hub_batch, one_entry_altered],
}
FAULT_CASES = [(w, f) for w in CELLS
               for f in FAULTS[harness.resolve(BENCH, w).traffic["entry"]]]


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
