"""Port build backends vs the JAX package's python reference (Algorithm 2).

The port's ``cuda`` backend, run with ``device="cpu"`` (its frontier
kernel's plain version), must give bit-identical index entries and
pruning counters to ``repro.build``'s sequential python backend across
the PR1/PR2/PR3 ablations, in ``vector`` mode (every hub through the
frontier step) and ``hybrid`` mode (with a low gather threshold, so the
widest hubs take the frontier step and the rest the host tiers).
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro import graphgen as jgen  # noqa: E402
from repro.build import build_rlc_index_with_stats as j_build  # noqa: E402
from repro_torch import graphgen as tgen  # noqa: E402
from repro_torch.build import build_rlc_index_with_stats as t_build  # noqa: E402
from repro_torch.build import get_backend  # noqa: E402
from repro_torch.core.baselines import bibfs_rlc  # noqa: E402
from repro_torch.core.minimum_repeat import minimum_repeat  # noqa: E402
from repro_torch.kernels import KERNELS  # noqa: E402


def entry_sets(idx):
    return tuple(tuple(sorted((v, h, m) for v, d in enumerate(maps)
                              for h, ms in d.items() for m in ms))
                 for maps in (idx.l_out, idx.l_in))


MODES = [dict(mode="vector"), dict(mode="hybrid", gather_threshold=30)]
FLAGS = [dict(), dict(use_pr1=False), dict(use_pr2=False),
         dict(use_pr3=False), dict(use_pr1=False, use_pr2=False,
                                   use_pr3=False)]


def assert_cuda_matches_python(name, args, k, flags, mode):
    jg = getattr(jgen, name)(*args)
    tg = getattr(tgen, name)(*args)
    want_idx, want_stats = j_build(jg, k, backend="python", **flags)
    got_idx, got_stats = t_build(tg, k, backend="cuda", device="cpu",
                                 **flags, **mode)
    assert got_stats.backend == "cuda"
    assert entry_sets(got_idx) == entry_sets(want_idx)
    assert got_stats.counters() == want_stats.counters()
    return tg, got_idx


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m["mode"])
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(f) or "all")
def test_cuda_backend_matches_python_ablations(flags, mode):
    assert_cuda_matches_python(
        "random_labeled_graph", (14, 50, 2, 7, 0.2), 2, flags, mode)


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m["mode"])
@pytest.mark.parametrize("name,args,k", [
    ("random_labeled_graph", (12, 40, 3, 1, 0.1), 3),
    ("erdos_renyi", (30, 3.0, 4, 2), 2),
    ("barabasi_albert", (40, 3, 3, 3), 2),
])
def test_cuda_backend_matches_python_families(name, args, k, mode):
    tg, idx = assert_cuda_matches_python(name, args, k, {}, mode)
    rng = np.random.default_rng(k)
    for _ in range(100):
        s, t = (int(x) for x in rng.integers(0, tg.num_vertices, 2))
        L = tuple(int(x) for x in rng.integers(0, tg.num_labels,
                                               int(rng.integers(1, k + 1))))
        L = minimum_repeat(L)
        assert idx.query(s, t, L) == bibfs_rlc(tg, s, t, L)


def test_cuda_backend_on_cpu_never_launches_and_auto_is_numpy():
    before = {k: v.launches for k, v in KERNELS.items()}
    g = tgen.random_labeled_graph(12, 40, 2, seed=0)
    t_build(g, 2, backend="cuda", device="cpu", mode="vector")
    assert {k: v.launches for k, v in KERNELS.items()} == before
    assert get_backend("auto").name == "numpy"


def test_cuda_backend_without_a_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        get_backend("cuda")
