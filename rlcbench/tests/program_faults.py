"""Faults planted in the program underneath a whole run, each breaking
what the check has to catch. An entry point's faults file,
``rlcbench/tests/faults/<entry>.py``, lists under ``FAULTS`` the ones its
cells can have; a fault that only one new entry point can have may sit in
that file instead. Each fault takes pytest's ``monkeypatch`` and patches
the program through its module attributes, which the entry points read
at call time."""
import numpy as np


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
