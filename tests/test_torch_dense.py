"""Port vs reference: the dense semiring engine and the condensed build.

The same seed gives both packages the same graph; the port's
``DenseEngine.reach`` and its ``build_condensed_device`` entries must
equal the JAX package's element for element (OR-AND over 0/1 values is
exact in float32). The JAX side runs its plain path, or its Pallas
``bool_matmul`` in interpret mode as the ``matmul`` hook. Card tests
(kernels on the CUDA device against the CPU path) skip, with a reason,
where no CUDA device is present.
"""
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.core import dense as tdense  # noqa: E402
from repro_torch.core.baselines import bibfs_rlc  # noqa: E402
from repro_torch.core.minimum_repeat import enumerate_mrs  # noqa: E402
from repro_torch.graphgen import random_labeled_graph  # noqa: E402
from repro_torch.kernels import KERNELS  # noqa: E402
from repro_torch.service import RLCService, ServiceConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# decided at test setup (a string condition), never at import time
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")

G12 = dict(num_vertices=12, num_edges=36, num_labels=3,
           self_loop_frac=0.1)
G12_BUILD = dict(num_vertices=12, num_edges=34, num_labels=2,
                 self_loop_frac=0.15)


def graphs(seed, spec):
    """(JAX package graph, port graph) from one seed."""
    jgen = pytest.importorskip("repro.graphgen")
    return (jgen.random_labeled_graph(seed=seed, **spec),
            random_labeled_graph(seed=seed, **spec))


def entries(idx):
    return tuple(tuple(sorted((v, h, m) for v, d in enumerate(maps)
                              for h, ms in d.items() for m in ms))
                 for maps in (idx.l_out, idx.l_in))


def test_dense_modules_import_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import repro_torch.core.dense, repro_torch.kernels.ops\n"
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("seed", range(3))
def test_dense_reach_matches_jax(seed, k):
    jdense = pytest.importorskip("repro.core.dense")
    jg, tg = graphs(seed, G12)
    want = jdense.DenseEngine.build(jg, k)
    got = tdense.DenseEngine.build(tg, k, device="cpu")
    assert got.reach.dtype == bool
    np.testing.assert_array_equal(got.reach, want.reach)
    assert got.mrs == want.mrs and got.mr_ids == want.mr_ids
    assert got.num_true_pairs() == want.num_true_pairs()
    for u in range(0, 12, 5):
        for v in range(12):
            assert got.s_k(u, v) == want.s_k(u, v)


def test_dense_reach_matches_jax_pallas_hook_and_own_hook():
    jdense = pytest.importorskip("repro.core.dense")
    from repro.kernels import ops as jops
    jg, tg = graphs(6, dict(num_vertices=10, num_edges=30, num_labels=2))
    want = jdense.DenseEngine.build(
        jg, 2, matmul=partial(jops.bool_matmul, interpret=True))
    got = tdense.DenseEngine.build(tg, 2, device="cpu")
    np.testing.assert_array_equal(got.reach, want.reach)
    hooked = tdense.DenseEngine.build(tg, 2, matmul=tdense.bool_matmul,
                                      device="cpu")
    np.testing.assert_array_equal(hooked.reach, want.reach)


@pytest.mark.parametrize("k", [1, 2])
def test_dense_engine_bf16_stack_matches_jax(k, monkeypatch):
    """With no ``matmul`` the engine's operands are bf16 (exact for 0/1)
    and a caller-given ``matmul`` keeps float32; either way the reach is
    one bool stack, equal to the JAX package's float32 reach."""
    jdense = pytest.importorskip("repro.core.dense")
    jg, tg = graphs(7 + k, G12)
    seen = []
    real = tdense._all_mr_reach

    def spy(A, mrs, n, matmul=None):
        seen.append(A.dtype)
        R = real(A, mrs, n, matmul)
        seen.append(R.dtype)
        return R

    monkeypatch.setattr(tdense, "_all_mr_reach", spy)
    got = tdense.DenseEngine.build(tg, k, device="cpu")
    assert seen == [torch.bfloat16, torch.bool]
    np.testing.assert_array_equal(got.reach,
                                  jdense.DenseEngine.build(jg, k).reach)
    seen.clear()
    tdense.DenseEngine.build(tg, k, matmul=tdense.bool_matmul,
                             device="cpu")
    assert seen == [torch.float32, torch.bool]
    A = tdense.label_adjacency(tg, "cpu", torch.bfloat16)
    assert A.dtype == torch.bfloat16 and A.shape[1] % 128 == 0
    np.testing.assert_array_equal(
        A[:, :12, :12].float().numpy() > 0,
        tdense.label_adjacency(tg, "cpu")[:, :12, :12].numpy() > 0)


def test_dense_engine_queries_fig2():
    from repro_torch.graphgen import fig2_graph
    g, names = fig2_graph()
    eng = tdense.DenseEngine.build(g, 2, device="cpu")
    assert eng.query(names["v3"], names["v6"], (1, 0))
    assert not eng.query(names["v1"], names["v3"], (0,))
    assert not eng.query(0, 1, (0, 0))         # not a minimum repeat


@pytest.mark.parametrize("hub_batch", [1, 4, 8])
@pytest.mark.parametrize("seed", range(2))
def test_condensed_build_matches_jax(seed, hub_batch):
    jdense = pytest.importorskip("repro.core.dense")
    jg, tg = graphs(seed, G12_BUILD)
    jeng = jdense.DenseEngine.build(jg, 2)
    want, _ = jdense.build_condensed_device(jg, 2, hub_batch=hub_batch,
                                            reach=jeng.reach)
    teng = convert.dense_engine_from_arrays(tg, 2, jeng.reach)
    got, eng = tdense.build_condensed_device(
        tg, 2, hub_batch=hub_batch, reach=teng.reach, device="cpu")
    assert entries(got) == entries(want)
    np.testing.assert_array_equal(got.aid, want.aid)
    np.testing.assert_array_equal(eng.reach, jeng.reach)


@pytest.mark.parametrize("hub_batch", [1, 8])
def test_condensed_index_serves_the_oracle(hub_batch):
    g = random_labeled_graph(seed=2, **G12_BUILD)
    idx, eng = tdense.build_condensed_device(g, 2, hub_batch=hub_batch,
                                             device="cpu")
    svc = RLCService(g, idx, ServiceConfig(k=2, device="cpu"))
    mrs = enumerate_mrs(g.num_labels, 2)
    queries = [(s, t, mr) for s in range(g.num_vertices)
               for t in range(g.num_vertices) for mr in mrs]
    got = [a.value for a in svc.query_batch(queries)]
    assert got == [bibfs_rlc(g, s, t, mr) for s, t, mr in queries]
    assert got == [eng.query(s, t, mr) for s, t, mr in queries]


def test_dense_engine_checks_its_arguments():
    g = random_labeled_graph(seed=0, **G12_BUILD)
    with pytest.raises(ValueError):
        tdense.build_condensed_device(g, 2, hub_batch=0, device="cpu")
    with pytest.raises(ValueError):
        convert.dense_engine_from_arrays(g, 2, np.zeros((2, 12, 12), bool))
    with pytest.raises(ValueError):
        tdense.build_condensed_device(g, 2, reach=np.zeros((6, 11, 11),
                                                           bool),
                                      device="cpu")


def test_cpu_dense_path_never_launches():
    assert "hub_cover" in KERNELS       # the condensed build's kernel
    before = {k: v.launches for k, v in KERNELS.items()}
    g = random_labeled_graph(seed=1, **G12_BUILD)
    tdense.build_condensed_device(g, 2, hub_batch=4, device="cpu")
    assert {k: v.launches for k, v in KERNELS.items()} == before


def test_dense_entry_points_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g = random_labeled_graph(seed=0, **G12_BUILD)
    with pytest.raises(RuntimeError):
        tdense.DenseEngine.build(g, 2)
    with pytest.raises(RuntimeError):
        tdense.build_condensed_device(g, 2, hub_batch=8)


# ------------------------------------------------------------------ #
# On the card: the kernels' path against the CPU path
# ------------------------------------------------------------------ #
@needs_cuda
@pytest.mark.parametrize("k", [1, 2])
def test_cuda_dense_engine_matches_cpu(k):
    g = random_labeled_graph(num_vertices=300, num_edges=700, num_labels=3,
                             seed=k)
    before = {n: KERNELS[n].launches for n in ("bool_matmul",
                                               "closure_step")}
    got = tdense.DenseEngine.build(g, k)
    mrs = enumerate_mrs(3, k)
    steps = sum(len(mr) - 1 for mr in mrs)
    assert KERNELS["bool_matmul"].launches == before["bool_matmul"] + steps
    assert KERNELS["closure_step"].launches == \
        before["closure_step"] + 9 * len(mrs)        # ceil(log2 300) = 9
    want = tdense.DenseEngine.build(g, k, device="cpu")
    np.testing.assert_array_equal(got.reach, want.reach)


@needs_cuda
@pytest.mark.parametrize("hub_batch", [1, 8, 40])
def test_cuda_condensed_build_matches_cpu(hub_batch):
    """The card's build (bit-packed stacks, two ``hub_cover`` launches a
    hub batch) gives the CPU build's entries exactly."""
    g = random_labeled_graph(num_vertices=150, num_edges=400, num_labels=2,
                             seed=4)
    eng = tdense.DenseEngine.build(g, 2)
    before = KERNELS["hub_cover"].launches
    got, _ = tdense.build_condensed_device(g, 2, hub_batch=hub_batch,
                                           reach=eng.reach)
    assert KERNELS["hub_cover"].launches == \
        before + 2 * -(-150 // hub_batch)
    want, _ = tdense.build_condensed_device(g, 2, hub_batch=hub_batch,
                                            reach=eng.reach, device="cpu")
    assert entries(got) == entries(want)
