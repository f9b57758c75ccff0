"""Port vs reference: package boundary and the host core.

The PyTorch port (``repro_torch``) must import without JAX, never import
the JAX package, and reproduce its host-side core exactly: the same seed
gives the same graph, access ids, MR spaces, oracle answers and frozen
CSR arrays.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import graphgen as jgen  # noqa: E402
from repro.build import build_rlc_index as j_build  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.core import minimum_repeat as jmr  # noqa: E402
from repro.core import queries as jq  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import graphgen as tgen  # noqa: E402
from repro_torch.build import build_rlc_index as t_build  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import minimum_repeat as tmr  # noqa: E402
from repro_torch.core import queries as tq  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import repro_torch.service, repro_torch.build, "
            "repro_torch.kernels, repro_torch.convert, "
            "repro_torch.core.device_index, repro_torch.graphgen\n"
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


GRAPHS = [
    ("erdos_renyi", (40, 3.0, 3), {"seed": 1}),
    ("barabasi_albert", (60, 3, 3), {"seed": 2}),
    ("random_labeled_graph", (20, 70, 2), {"seed": 3,
                                           "self_loop_frac": 0.2}),
]


@pytest.mark.parametrize("name,args,kw", GRAPHS, ids=[g[0] for g in GRAPHS])
def test_same_seed_same_graph(name, args, kw):
    a = getattr(jgen, name)(*args, **kw)
    b = getattr(tgen, name)(*args, **kw)
    np.testing.assert_array_equal(a.edges, b.edges)
    np.testing.assert_array_equal(a.access_ids(), b.access_ids())
    np.testing.assert_array_equal(a.access_order(), b.access_order())


@pytest.mark.parametrize("num_labels,k", [(2, 2), (3, 2), (3, 3), (4, 2)])
def test_mr_spaces_equal(num_labels, k):
    assert tmr.enumerate_mrs(num_labels, k) == \
        jmr.enumerate_mrs(num_labels, k)
    assert tmr.mr_id_space(num_labels, k) == jmr.mr_id_space(num_labels, k)


@pytest.mark.parametrize("seed", range(3))
def test_oracle_and_queries_equal(seed):
    jg = jgen.random_labeled_graph(25, 80, 2, seed=seed, self_loop_frac=0.1)
    tg = tgen.random_labeled_graph(25, 80, 2, seed=seed, self_loop_frac=0.1)
    rng = np.random.default_rng(seed)
    mrs = jmr.enumerate_mrs(2, 2)
    for _ in range(200):
        s, t = (int(x) for x in rng.integers(0, 25, 2))
        L = mrs[int(rng.integers(len(mrs)))]
        assert tbase.bibfs_rlc(tg, s, t, L) == jbase.bibfs_rlc(jg, s, t, L)
    for gen, args in (("generate_queries", (2, 10, 10)),
                      ("biased_true_queries", (2, 20))):
        got = getattr(tq, gen)(tg, *args, seed=seed)
        want = getattr(jq, gen)(jg, *args, seed=seed)
        assert got.true_queries == want.true_queries
        assert got.false_queries == want.false_queries


FREEZE_FIELDS = ("aid", "out_indptr", "out_hub", "out_mr", "in_indptr",
                 "in_hub", "in_mr")


@pytest.mark.parametrize("seed", range(2))
def test_freeze_arrays_equal(seed):
    jg = jgen.erdos_renyi(40, 3.0, 3, seed=seed)
    tg = tgen.erdos_renyi(40, 3.0, 3, seed=seed)
    ids = jmr.mr_id_space(3, 2)
    jidx = j_build(jg, 2, backend="python")
    want = jidx.freeze(ids)
    built = t_build(tg, 2, backend="numpy").freeze(ids)
    carried = convert.index_from_entries(
        jidx.num_vertices, 2, jidx.aid, jidx.l_out, jidx.l_in).freeze(ids)
    for got in (built, carried):
        for f in FREEZE_FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert got.max_row == want.max_row
    ref_frozen = convert.frozen_from_arrays(
        want.num_vertices, want.k, *(getattr(want, f)
                                     for f in FREEZE_FIELDS))
    cut = ref_frozen.slice_rows(10, 30)
    jcut = want.slice_rows(10, 30)
    for f in FREEZE_FIELDS:
        np.testing.assert_array_equal(getattr(cut, f), getattr(jcut, f))
    s = np.arange(40).repeat(40)
    t = np.tile(np.arange(40), 40)
    m = (s + t) % len(ids)
    np.testing.assert_array_equal(ref_frozen.query_batch(s, t, m),
                                  want.query_batch(s, t, m))


def test_frozen_from_arrays_rejects_inconsistent_csr():
    with pytest.raises(ValueError):
        convert.frozen_from_arrays(2, 2, np.array([1, 2]),
                                   np.array([0, 1, 3]), np.zeros(2),
                                   np.zeros(2), np.array([0, 0, 0]),
                                   np.zeros(0), np.zeros(0))
