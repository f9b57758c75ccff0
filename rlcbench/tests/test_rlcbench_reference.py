"""The frozen generator and the plain reference against the program's plain
paths (``device="cpu"``) on small graphs of the benchmark's recipe."""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rlcbench.gen.graphs import make_edges  # noqa: E402
from rlcbench.reference import plain  # noqa: E402

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
SIZES = [(40, 2, 11), (40, 3, 12), (120, 2, 2 ** 31 + 3), (120, 3, 7),
         (200, 2, 5), (200, 3, 2 ** 33 + 1)]


def recipe(n):
    cfg = json.loads((CONFIGS / "advogato-k2.json").read_text())
    return dict(cfg["graph"], num_vertices=n)


def program_graph(edges, n):
    from repro_torch.core.graph import LabeledGraph
    return LabeledGraph.from_edges(n, 3, edges)


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 9])
def test_frozen_generator_matches_the_programs(seed):
    from repro_torch.graphgen.generators import barabasi_albert
    got = make_edges(recipe(150), seed)
    want = barabasi_albert(150, 5, 3, seed=seed).edges
    assert np.array_equal(np.unique(got, axis=0), want)
    assert len(np.unique(got, axis=0)) == len(got)   # no duplicate rows


def test_generator_is_a_function_of_the_seed():
    a, b = make_edges(recipe(100), 42), make_edges(recipe(100), 42)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, make_edges(recipe(100), 43))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_minimum_repeats_match_the_programs(k):
    from repro_torch.core.minimum_repeat import enumerate_mrs
    got = plain.minimum_repeats(3, k)
    assert len(got) == len(set(got))
    assert set(got) == set(enumerate_mrs(3, k))


@pytest.mark.parametrize("n,k,seed", SIZES)
def test_reach_equals_the_dense_engine(n, k, seed):
    from repro_torch.core.dense import DenseEngine
    edges = make_edges(recipe(n), seed)
    mrs, R = plain.reach(edges, n, 3, k, "cpu")
    eng = DenseEngine.build(program_graph(edges, n), k, device="cpu")
    ids = plain.mr_index(mrs)
    assert len(eng.mrs) == len(mrs)
    for c, word in enumerate(eng.mrs):
        assert np.array_equal(eng.reach[c], R[ids[tuple(word)]].numpy())
    assert R.any()


@pytest.mark.parametrize("n", [40, 200])
def test_access_order_equals_the_programs(n):
    edges = make_edges(recipe(n), 3)
    want = program_graph(edges, n).access_order()
    assert np.array_equal(plain.access_order(edges, n), want)


@pytest.mark.parametrize("hub_batch", [1, 8])
@pytest.mark.parametrize("n,k,seed", SIZES)
def test_labeling_equals_the_condensed_build(n, k, seed, hub_batch):
    from repro_torch.core.dense import build_condensed_device
    from rlcbench.entries import index_keys
    edges = make_edges(recipe(n), seed)
    mrs, R = plain.reach(edges, n, 3, k, "cpu")
    OUT, IN = plain.condensed(R, plain.access_order(edges, n), hub_batch)
    want = plain.entry_keys(OUT, IN)
    idx, _ = build_condensed_device(program_graph(edges, n), k,
                                    hub_batch=hub_batch, device="cpu")
    got = index_keys(idx, mrs, n)
    assert len(want) > 0
    assert np.array_equal(got, want)


def test_short_closure_and_no_case1_break_their_guarantees():
    n = 120
    edges = make_edges(recipe(n), 4)
    _, R = plain.reach(edges, n, 3, 2, "cpu")
    _, Rs = plain.reach(edges, n, 3, 2, "cpu", short_closure=True)
    assert (R != Rs).any() and not (Rs & ~R).any()   # only paths lost
    order = plain.access_order(edges, n)
    full = plain.entry_keys(*plain.condensed(R, order, 8))
    loose = plain.entry_keys(*plain.condensed(R, order, 8, case1=False))
    assert set(full) < set(loose)                      # only entries added


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys
    root = Path(__file__).resolve().parents[2]
    code = ("import sys; sys.path[0:0] = [%r]; "
            "import rlcbench.reference.plain, rlcbench.gen.graphs; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('repro', 'repro_torch', 'jax', 'benchmarks')))" % str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"
