"""``device_reach`` (the all-MR reach kept on the device) and the condensed
build over it, against the benchmark's plain references, on the CPU.

* ``device_reach`` equals ``rlcbench/reference/plain.py``'s reach;
* ``build_condensed_device`` handed that tensor gives the entries and
  counters of the numpy path, and the labeling of ``reference/blocked.py``
  (the plain reference MR by MR), which equals ``plain.condensed``;
* the ``rlc_build_host_bytes`` counter: ``up`` 0 on the tensor path and
  ``C n^2`` on the numpy path, ``down`` 24 bytes an entry on the CPU and
  ``8 + 8 ceil(C / 64)`` bytes a ``(vertex, hub)`` key on the card.

Eight labels at k = 2 (64 MRs), one case of 3 labels at k = 3 (33 MRs),
three seeds. The card cases skip without CUDA; on the card they compare
the two paths at the Advogato k = 2 size, bound ``DenseEngine.build``'s
peak there (one MR's closure at a time), and count the entries that
the card's download (``entry_masks`` and one ``torch.nonzero``) finds in
a stack of 2**34 cells (the Soc-Epinions cell's size) against a popcount
of its words.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = str(Path(__file__).resolve().parents[1])   # for ``rlcbench``
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from repro_torch import obs  # noqa: E402
from repro_torch.core import dense  # noqa: E402
from repro_torch.core.graph import LabeledGraph  # noqa: E402
from rlcbench.entries import index_keys  # noqa: E402
from rlcbench.gen.graphs import barabasi_albert  # noqa: E402
from rlcbench.reference import blocked, plain  # noqa: E402

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device: run on the card")

# (vertices, labels, k, seed): the Soc-Epinions recipe's shape
CASES = [(60, 8, 2, 1), (100, 8, 2, 2 ** 31 + 5), (160, 8, 2, 2 ** 33 + 7),
         (80, 3, 3, 11)]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the test run puts several workers on the
    machine, and these small products gain nothing from more."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def graph_of(n, labels, seed, m_attach=4, reverse_edge_p=0.675):
    edges = barabasi_albert(n, m_attach, labels, seed=seed,
                            reverse_edge_p=reverse_edge_p)
    return edges, LabeledGraph.from_edges(n, labels, edges)


def counted():
    """The process registry's condensed-build runs, entries and host bytes
    (up, down)."""
    reg = obs.process_obs().registry

    def value(name, **labels):
        series = reg.get(name)
        return series.value(backend="device_condensed", **labels) \
            if series else 0.0
    return np.array([value("rlc_build_runs", context="full"),
                     value("rlc_build_entries", side="out"),
                     value("rlc_build_entries", side="in"),
                     value("rlc_build_host_bytes", direction="up"),
                     value("rlc_build_host_bytes", direction="down")])


def build_counted(g, k, hub_batch, reach, device="cpu"):
    before = counted()
    idx, eng = dense.build_condensed_device(g, k, hub_batch=hub_batch,
                                            reach=reach, device=device)
    return idx, eng, counted() - before


@pytest.mark.parametrize("n,labels,k,seed", CASES)
def test_device_reach_equals_the_plain_reach(n, labels, k, seed):
    edges, g = graph_of(n, labels, seed)
    mrs, R = dense.device_reach(g, k, device="cpu")
    ref_mrs, ref_R = plain.reach(edges, n, labels, k, "cpu")
    assert R.dtype == torch.bool and R.is_contiguous()
    assert R.shape == (len(ref_mrs), n, n)
    assert sorted(mrs) == sorted(ref_mrs)
    at = plain.mr_index(ref_mrs)
    for c, word in enumerate(mrs):
        assert torch.equal(R[c], ref_R[at[tuple(word)]]), word
    assert R.any()
    assert np.array_equal(R.numpy(),
                          dense.DenseEngine.build(g, k, device="cpu").reach)


@pytest.mark.parametrize("hub_batch", [1, 8])
@pytest.mark.parametrize("n,labels,k,seed", CASES)
def test_tensor_path_equals_numpy_path_and_blocked(n, labels, k, seed,
                                                   hub_batch):
    edges, g = graph_of(n, labels, seed)
    mrs, R = dense.device_reach(g, k, device="cpu")
    on_dev, eng, got = build_counted(g, k, hub_batch, R)
    assert eng.reach is R
    host, _, want = build_counted(g, k, hub_batch, R.numpy().copy())
    ref_mrs = plain.minimum_repeats(labels, k)
    keys = index_keys(on_dev, ref_mrs, n)
    assert np.array_equal(keys, index_keys(host, ref_mrs, n))
    C, entries = len(mrs), on_dev.num_entries()
    assert entries == len(keys) > 0
    # runs, entries a side, host bytes up and down
    assert got.tolist() == [1, *want[1:3], 0, 24 * entries]
    assert want.tolist() == [1, *got[1:3], C * n * n, 24 * entries]
    assert np.array_equal(keys, blocked.condensed_keys(
        blocked.mr_reaches(edges, n, labels, k, "cpu"), edges, n, C,
        hub_batch))


@pytest.mark.parametrize("hub_batch", [1, 8])
@pytest.mark.parametrize("n,labels,k,seed", CASES)
def test_blocked_equals_plain_condensed(n, labels, k, seed, hub_batch):
    edges = graph_of(n, labels, seed)[0]
    mrs, R = plain.reach(edges, n, labels, k, "cpu")
    want = plain.entry_keys(*plain.condensed(
        R, plain.access_order(edges, n), hub_batch))
    got = blocked.condensed_keys(
        blocked.mr_reaches(edges, n, labels, k, "cpu"), edges, n, len(mrs),
        hub_batch)
    assert len(want) > 0 and np.array_equal(got, want)
    bmrs, bR = blocked.reach(edges, n, labels, k, "cpu")
    assert bmrs == mrs and torch.equal(bR, R)
    assert np.array_equal(got, blocked.condensed_keys(
        blocked.stack_reaches(bR, bmrs, edges, n), edges, n, len(mrs),
        hub_batch))


def test_blocked_controls_break_their_guarantees():
    n, labels, k = 120, 8, 2
    edges = graph_of(n, labels, 4)[0]
    _, R = blocked.reach(edges, n, labels, k, "cpu")
    _, Rs = blocked.reach(edges, n, labels, k, "cpu", short_closure=True)
    assert (R != Rs).any() and not (Rs & ~R).any()   # only paths lost
    C = len(plain.minimum_repeats(labels, k))
    full, loose = (blocked.condensed_keys(
        blocked.mr_reaches(edges, n, labels, k, "cpu"), edges, n, C, 8,
        case1=case1) for case1 in (True, False))
    assert set(full) < set(loose)                      # only entries added


def test_pack_rows_and_popcount():
    gen = torch.Generator().manual_seed(3)
    B = torch.rand((37, 61), generator=gen) < 0.3
    P = blocked.pack_rows(B)
    assert P.shape == (37, 8) and P.dtype == torch.uint8
    assert blocked.popcount(P) == int(B.sum())
    unpacked = ((P.unsqueeze(-1) >> torch.arange(8, dtype=torch.uint8)) & 1)
    assert torch.equal(unpacked.reshape(37, 64)[:, :61].bool(), B)
    flip = B.clone()
    flip[5, 60] = ~flip[5, 60]
    assert blocked.popcount(P ^ blocked.pack_rows(flip)) == 1


@pytest.mark.parametrize("bad", ["float", "strided", "shape"])
def test_a_reach_tensor_must_be_a_contiguous_bool_stack(bad):
    n, labels, k = 40, 8, 2
    _, g = graph_of(n, labels, 8)
    _, R = dense.device_reach(g, k, device="cpu")
    R = {"float": R.float(), "strided": R.transpose(1, 2),
         "shape": R[:, :-1]}[bad]
    with pytest.raises(ValueError, match="reach"):
        dense.build_condensed_device(g, k, hub_batch=8, reach=R,
                                     device="cpu")


@needs_cuda
def test_cuda_tensor_and_numpy_paths_at_the_advogato_k2_size():
    n, labels, k = 6541, 3, 2
    edges, g = graph_of(n, labels, 1, m_attach=5, reverse_edge_p=0.5)
    mrs, R = dense.device_reach(g, k)
    assert R.is_cuda and R.dtype == torch.bool
    eng = dense.DenseEngine.build(g, k)
    assert tuple(eng.mrs) == tuple(mrs)
    assert np.array_equal(R.cpu().numpy(), eng.reach)
    on_dev, _, got = build_counted(g, k, 8, R, "cuda")
    host, _, want = build_counted(g, k, 8, eng.reach, "cuda")
    ref_mrs = plain.minimum_repeats(labels, k)
    keys = index_keys(on_dev, ref_mrs, n)
    assert np.array_equal(keys, index_keys(host, ref_mrs, n))
    # down: one int32 vertex, one int32 hub and one int64 mask a key
    down = 16 * sum(map(len, on_dev.l_out + on_dev.l_in))
    assert down < 24 * len(keys)
    assert got.tolist() == [1, *want[1:3], 0, down]
    assert want.tolist() == [1, *got[1:3], len(mrs) * n * n, down]


@needs_cuda
def test_cuda_dense_build_holds_one_mr_at_a_time():
    """At the Advogato k = 2 size, ``DenseEngine.build``'s peak on the card
    stays under the bool reach, the padded bf16 adjacency and four padded
    bf16 planes: the MRs' closures are never held all at once."""
    from repro_torch.kernels.bool_semiring import TILE
    n, labels, k = 6541, 3, 2
    _, g = graph_of(n, labels, 1, m_attach=5, reverse_edge_p=0.5)
    dense.DenseEngine.build(g, k)            # the kernels built and warm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = dense.DenseEngine.build(g, k)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    n_pad = -(-n // TILE) * TILE
    C = len(eng.mrs)
    assert C == 9
    assert peak < C * n * n + (labels + 4) * n_pad * n_pad * 2


@needs_cuda
def test_cuda_download_of_2_to_the_34_cells_counts_every_entry():
    """A packed (64, 16384, 512) stack, 2**34 cells once unpacked, with two
    million random bits: the build's download of a side (``entry_masks``
    and one ``torch.nonzero``) finds as many entries as the words hold
    bits, each at its bit."""
    from repro_torch.kernels import hub_cover
    C, n = 64, 16384
    W = hub_cover.stack_words(n)
    gen = torch.Generator(device="cuda").manual_seed(7)
    words = torch.zeros((C, n, W), dtype=torch.int32, device="cuda")
    m = 2_000_000
    at = torch.randint(0, C * n * W, (m,), device="cuda", generator=gen)
    bit = torch.randint(0, 31, (m,), device="cuda", generator=gen)
    words.view(-1)[at] = torch.ones_like(bit, dtype=torch.int32) << bit.int()
    bits = sum(blocked.popcount(words[c:c + 8].reshape(-1).view(torch.uint8))
               for c in range(0, C, 8))
    ys, xs, masks = dense._entry_pairs(words)
    mask_bits = np.unpackbits(masks.view(np.uint8), axis=1,
                              bitorder="little")
    pair, cs = np.nonzero(mask_bits)
    assert len(cs) == bits > 1_900_000
    cs, ys, xs = (torch.from_numpy(a).cuda().long()
                  for a in (cs, ys[pair], xs[pair]))
    word = words[cs, ys, xs // 32]
    assert bool(((word >> (xs % 32).int()) & 1).all())
