"""Port vs reference: the distributed dense engine (``core/distributed``).

The port is SPMD over ``torch.distributed``; on the CPU its mesh is a
gloo world and its products the ``bool_matmul`` kernel's plain version.
On one rank its reach stack, condensed entries and query answers must
equal ``repro``'s on one JAX CPU device, the port's ``DenseEngine`` and
the BFS oracle; on four spawned gloo ranks (``pod=2, data=2``, a
``FileStore``), every rank's results must equal the one-rank results.
The process group is torn down after each test.
"""
import multiprocessing as mp
import os
import pickle
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core.baselines import bfs_rlc  # noqa: E402
from repro_torch.core.dense import DenseEngine, device_reach  # noqa: E402
from repro_torch.core.device_index import DeviceIndex  # noqa: E402
from repro_torch.core.minimum_repeat import mr_id_space  # noqa: E402
from repro_torch.graphgen import random_labeled_graph  # noqa: E402
from repro_torch.kernels.ref import bool_matmul_ref  # noqa: E402

G11 = dict(num_vertices=11, num_edges=30, num_labels=2, seed=2,
           self_loop_frac=0.1)
G10 = dict(num_vertices=10, num_edges=28, num_labels=2, seed=4)
G13 = dict(num_vertices=13, num_edges=40, num_labels=2, seed=9,
           self_loop_frac=0.1)


@pytest.fixture
def mesh():
    """A one-rank gloo mesh, torn down after the test."""
    if dist.is_initialized():
        dist.destroy_process_group()
    m = tdist.make_rlc_mesh(device="cpu")
    try:
        yield m
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def entries(idx):
    return tuple(tuple(sorted((v, h, m) for v, d in enumerate(maps)
                              for h, ms in d.items() for m in ms))
                 for maps in (idx.l_out, idx.l_in))


def all_queries(g, k):
    """Every (s, t, MR id) of ``g`` and the BFS oracle's answers."""
    qs, qt, qm, want = [], [], [], []
    for L, c in mr_id_space(g.num_labels, k).items():
        for s in range(g.num_vertices):
            for t in range(g.num_vertices):
                qs.append(s)
                qt.append(t)
                qm.append(c)
                want.append(bfs_rlc(g, s, t, L))
    return np.array(qs), np.array(qt), np.array(qm), np.array(want)


def run_rank(g, k, m, hub_batch=4):
    """(reach, condensed entries, answers to every query, answers to all
    but the last) on this rank; the second batch is one query shorter,
    so the batch padding is exercised whatever the mesh size."""
    mm = tdist.shmap_bool_matmul(m)
    R = tdist.distributed_all_mr_reach(g, k, m, matmul=mm)
    idx, _ = tdist.distributed_build(g, k, m, hub_batch=hub_batch)
    dev = DeviceIndex.from_index(idx, g.num_labels, device="cpu")
    qs, qt, qm, _ = all_queries(g, k)
    got = tdist.distributed_query_batch(dev, qs, qt, qm, m)
    short = tdist.distributed_query_batch(dev, qs[:-1], qt[:-1], qm[:-1],
                                          m)
    return R, entries(idx), got, short, mm


# ------------------------------------------------------------------ #
# One rank
# ------------------------------------------------------------------ #
def test_distributed_reach_single_rank(mesh):
    from repro.core.distributed import distributed_all_mr_reach as j_reach
    from repro.core.distributed import make_rlc_mesh as j_mesh
    from repro.graphgen import random_labeled_graph as j_graph
    g = random_labeled_graph(**G11)
    mm = tdist.shmap_bool_matmul(mesh)
    R = tdist.distributed_all_mr_reach(g, 2, mesh, matmul=mm)
    assert R.dtype == bool and R.shape == (4, 11, 11)
    assert np.array_equal(R, DenseEngine.build(g, 2, device="cpu").reach)
    assert np.array_equal(R, j_reach(j_graph(**G11), 2, j_mesh()))
    # one gather a product (2 chain + 4 MRs x 4 doubling steps) and one
    # for the whole stack
    assert mm.all_gathers == 2 + 4 * 4 + 1
    assert mm.gathered_bytes == (18 * 128 * 128 + 4 * 128 * 128) * 2


@pytest.mark.parametrize("k", [1, 2, 3])
def test_the_three_reaches_are_one(mesh, k):
    """``DenseEngine.build``, ``device_reach`` and the distributed reach on
    a one-rank mesh give the same stack, equal to ``repro``'s."""
    from repro.core.dense import DenseEngine as JDense
    from repro.graphgen import random_labeled_graph as j_graph
    g = random_labeled_graph(**G11)
    want = JDense.build(j_graph(**G11), k).reach
    mrs, R = device_reach(g, k, device="cpu")
    eng = DenseEngine.build(g, k, device="cpu")
    assert tuple(mrs) == tuple(eng.mrs) and R.dtype == torch.bool
    for got in (eng.reach, R.numpy(),
                tdist.distributed_all_mr_reach(g, k, mesh)):
        assert got.dtype == bool and np.array_equal(got, want)


def test_distributed_build_and_query_single_rank(mesh):
    from repro.core.device_index import DeviceIndex as JDeviceIndex
    from repro.core.distributed import distributed_build as j_build
    from repro.core.distributed import distributed_query_batch as j_query
    from repro.core.distributed import make_rlc_mesh as j_mesh
    from repro.graphgen import random_labeled_graph as j_graph
    g = random_labeled_graph(**G10)
    R, ents, got, short, _ = run_rank(g, 2, mesh)
    jg = j_graph(**G10)
    jm = j_mesh()
    jidx, jeng = j_build(jg, 2, jm, hub_batch=4)
    assert np.array_equal(R, jeng.reach)
    assert ents == entries(jidx)
    qs, qt, qm, want = all_queries(g, 2)
    assert got.dtype == bool and got.tolist() == want.tolist()
    assert short.tolist() == want[:-1].tolist()
    jdev = JDeviceIndex.from_index(jidx, jg.num_labels)
    assert got.tolist() == j_query(jdev, qs, qt, qm, jm).tolist()


def test_row_parallel_product_equals_plain_version(mesh):
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy((rng.random((256, 256)) < 0.02)
                             .astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    mm = tdist.shmap_bool_matmul(mesh)
    assert torch.equal(mm(a, b), bool_matmul_ref(a, b))
    R = tdist.distributed_plus_closure(a, mesh, matmul=mm)
    want = a
    for _ in range(8):
        want = torch.maximum(want, bool_matmul_ref(want, want))
    assert torch.equal(R, want) and mm.all_gathers == 9


def test_mesh_shape_must_cover_the_world(mesh):
    assert tuple(mesh.mesh_dim_names) == ("pod", "data")
    assert tuple(mesh.shape) == (1, 1)
    assert tdist.mesh_device(mesh) == torch.device("cpu")
    with pytest.raises(ValueError, match="does not cover"):
        tdist.make_rlc_mesh(data=2, device="cpu")


def test_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.make_rlc_mesh(device="cuda")
    assert not dist.is_initialized()


# ------------------------------------------------------------------ #
# Four spawned gloo ranks
# ------------------------------------------------------------------ #
def _rank_main(rank, world, store_path, out_path):
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
        m = tdist.make_rlc_mesh(data=2, pod=2, device="cpu")
        g = random_labeled_graph(**G13)
        R, ents, got, short, mm = run_rank(g, 2, m)
        with open(out_path, "wb") as f:
            pickle.dump(dict(reach=R, ents=ents, got=got, short=short,
                             gathers=mm.all_gathers,
                             coord=tuple(m.get_coordinate())), f)
        dist.destroy_process_group()
    except BaseException:
        with open(out_path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def test_distributed_four_gloo_ranks(tmp_path, mesh):
    from repro.core.dense import DenseEngine as JDense
    from repro.graphgen import random_labeled_graph as j_graph
    world = 4
    ctx = mp.get_context("spawn")
    outs = [str(tmp_path / f"rank{r}.pkl") for r in range(world)]
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, str(tmp_path / "store"), outs[r])) for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=120)
        assert not any(p.is_alive() for p in procs), "a rank hung"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    for r, path in enumerate(outs):
        err = path + ".err"
        assert not os.path.exists(err), open(err).read()
        assert procs[r].exitcode == 0
    g = random_labeled_graph(**G13)
    R1, ents1, got1, short1, _ = run_rank(g, 2, mesh)
    _, _, _, want = all_queries(g, 2)
    assert np.array_equal(R1, JDense.build(j_graph(**G13), 2).reach)
    assert got1.tolist() == want.tolist()
    coords = set()
    for path in outs:
        with open(path, "rb") as f:      # written by the ranks above
            res = pickle.load(f)
        coords.add(res["coord"])
        assert np.array_equal(res["reach"], R1)
        assert res["ents"] == ents1
        assert np.array_equal(res["got"], got1)
        assert np.array_equal(res["short"], short1)
        # the same count of products and gathers on every rank
        assert int(res["gathers"]) == 2 + 4 * 4 + 1
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}
