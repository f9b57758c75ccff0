"""The condensed build's download and index fill on the card path.

On a card the build turns each packed entry stack into one MR mask per
``(vertex, hub)`` cell (``hub_cover.entry_masks``), downloads the cells
that hold an entry (``dense._entry_pairs``) and fills each vertex's row in
one step (``RLCIndex.fill_rows``). On the CPU:

* the masks' plain version equals the stack unpacked bit by bit, with
  ``n`` not a multiple of 32, one and two mask words, and MR 63 in the
  sign bit;
* the bulk fill equals the per-entry ``add_out`` / ``add_in`` fill (the
  CPU build's own), on CPU-built labelings at k = 2 and 3 and with 8
  labels, and on random pairs at 64 and 81 MRs; its entry and pair counts
  equal ``num_entries()`` and the ``(vertex, hub)`` keys; every pair gets
  a fresh mutable set.

The card cases skip without CUDA. On the card the kernel equals the plain
version at the Advogato k = 2 and 3 shapes and at Soc-Epinions'
``(64, 16384, 512)``, and the card's build equals the CPU build row for
row, with its counters.
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
from repro_torch.core.minimum_repeat import enumerate_mrs  # noqa: E402
from repro_torch.core.rlc_index import RLCIndex  # noqa: E402
from repro_torch.kernels import KERNELS, hub_cover, ref  # noqa: E402
from rlcbench.entries import index_keys  # noqa: E402
from rlcbench.gen.graphs import barabasi_albert  # noqa: E402
from rlcbench.reference import plain  # noqa: E402

# decided at test setup (a string condition), never at import time
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device: run on the card")

# (vertices, labels, k): 9, 33 and 64 MRs
LABELINGS = [(200, 3, 2), (120, 3, 3), (100, 8, 2)]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the test run puts several workers on the
    machine, and these small products gain nothing from more."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def random_stack(C, n, density, seed):
    gen = torch.Generator().manual_seed(seed)
    return hub_cover.pack_stack(torch.rand((C, n, n), generator=gen)
                                < density)


def mask_bit(masks, c):
    """Bit ``c`` of every mask, as bool."""
    return ((masks[..., c // 64] >> (c % 64)) & 1).bool()


@pytest.mark.parametrize("C,n", [(9, 37), (33, 70), (64, 45), (81, 100)])
def test_entry_masks_ref_equals_the_unpacked_stack(C, n):
    words = random_stack(C, n, 0.3, seed=C + n)
    W = words.shape[-1]
    masks = ref.entry_masks_ref(words)
    assert masks.shape == (n, 32 * W, -(-C // 64))
    assert masks.dtype == torch.int64
    bits = ref.unpack_bits(words, torch.bool)              # (C, n, 32 W)
    for c in range(C):
        assert torch.equal(mask_bit(masks, c), bits[c]), c
    if C >= 64:
        assert (masks[..., 0] < 0).any()                   # MR 63 set
    assert not masks[:, n:].any()                          # padding
    assert torch.equal(masks.ne(0).any(-1), bits.any(0))
    ys, xs = torch.nonzero(masks.ne(0).any(-1), as_tuple=True)
    cs, ty, tx = torch.nonzero(bits, as_tuple=True)
    assert torch.equal(torch.unique(ty * 32 * W + tx), ys * 32 * W + xs)
    assert torch.equal(hub_cover.entry_masks(words), masks)


def graph_of(n, labels, seed=1):
    edges = barabasi_albert(n, 4, labels, seed=seed, reverse_edge_p=0.675)
    return LabeledGraph.from_edges(n, labels, edges)


def side_stack(maps, mr_at, C, n):
    """The packed entry stack of one side of an index."""
    dense_bits = torch.zeros((C, n, n), dtype=torch.bool)
    for y, row in enumerate(maps):
        for hub, words in row.items():
            for word in words:
                dense_bits[mr_at[word], y, hub] = True
    return hub_cover.pack_stack(dense_bits)


def assert_fresh_rows(maps, pairs):
    """Rows of plain dicts with int hubs ascending, and one fresh mutable
    set a key."""
    sets = [s for row in maps for s in row.values()]
    assert len(sets) == pairs
    assert all(type(s) is set and s for s in sets)
    assert len({id(s) for s in sets}) == pairs
    for row in maps:
        assert type(row) is dict
        assert all(type(h) is int for h in row)
        assert list(row) == sorted(row)


@pytest.mark.parametrize("n,labels,k", LABELINGS)
def test_fill_rows_equals_the_per_entry_fill(n, labels, k):
    g = graph_of(n, labels)
    want, eng = dense.build_condensed_device(g, k, hub_batch=8,
                                             device="cpu")
    C = len(eng.mrs)
    mr_at = {w: c for c, w in enumerate(eng.mrs)}
    got = RLCIndex(n, k, g.access_ids())
    counted = {}
    for side, maps in (("out", want.l_out), ("in", want.l_in)):
        ys, xs, masks = dense._entry_pairs(side_stack(maps, mr_at, C, n))
        assert ys.dtype == xs.dtype == np.int32 and masks.dtype == np.int64
        assert masks.shape == (len(ys), -(-C // 64))
        counted[side] = got.fill_rows(side, ys, xs, masks, eng.mrs)
    assert got.l_out == want.l_out and got.l_in == want.l_in
    for side, maps in (("out", got.l_out), ("in", got.l_in)):
        entries, pairs = counted[side]
        assert entries == sum(len(s) for row in maps for s in row.values())
        assert pairs == sum(map(len, maps))
        assert_fresh_rows(maps, pairs)
    assert sum(e for e, _ in counted.values()) == want.num_entries() > 0
    assert counted["out"][1] < counted["out"][0]     # MRs a key: > 1
    # the sets are the index's own and mutable
    y, hub = next((y, h) for y, row in enumerate(got.l_out) for h in row)
    got.l_out[y][hub].add(("x",))
    assert got.l_out != want.l_out
    got.l_out[y][hub].discard(("x",))
    assert got.l_out == want.l_out


def random_pairs(n, C, P, seed):
    """Sorted distinct ``(y, x)`` cells, each with a random non-empty set
    of MR ids (MR ``C - 1`` in every tenth), as triples and as the int64
    masks of those cells, built apart from any kernel."""
    rng = np.random.default_rng(seed)
    flat = np.sort(rng.choice(n * n, P, replace=False))
    ys, xs = flat // n, flat % n
    per = rng.geometric(0.4, P)
    trip = [(c, y, x) for y, x, m in zip(ys.tolist(), xs.tolist(), per)
            for c in sorted(set(rng.choice(C, m).tolist()))]
    trip += [(C - 1, y, x) for y, x in zip(ys[::10].tolist(),
                                           xs[::10].tolist())]
    cs, ty, tx = np.array(sorted(set(trip))).T
    cell = np.searchsorted(flat, ty * n + tx)
    masks = np.zeros((P, -(-C // 64)), np.uint64)
    np.bitwise_or.at(masks, (cell, cs // 64),
                     np.left_shift(np.uint64(1), (cs % 64).astype(np.uint64)))
    return (cs, ty, tx), (ys.astype(np.int32), xs.astype(np.int32),
                          masks.view(np.int64))


@pytest.mark.parametrize("labels", [8, 9])     # 64 and 81 MRs at k = 2
def test_fill_rows_on_random_pairs(labels):
    n, k = 300, 2
    mrs = enumerate_mrs(labels, k)
    C = len(mrs)
    (cs, ty, tx), (ys, xs, masks) = random_pairs(n, C, 4000, seed=labels)
    if C == 64:
        assert (masks[:, 0] < 0).sum() >= 400                # the sign bit
    else:
        assert masks.shape[1] == 2 and (masks[:, 1] != 0).sum() >= 400
    want = RLCIndex(n, k, np.arange(1, n + 1))
    got = RLCIndex(n, k, np.arange(1, n + 1))
    for c, y, x in zip(cs.tolist(), ty.tolist(), tx.tolist()):
        want.add_in(y, x, mrs[c])
    entries, pairs = got.fill_rows("in", ys, xs, masks, mrs)
    assert got.l_in == want.l_in and got.l_out == want.l_out
    assert (entries, pairs) == (len(cs), len(ys)) == (
        want.num_entries(), sum(map(len, want.l_in)))
    assert_fresh_rows(got.l_in, pairs)


def test_fill_rows_checks_its_input():
    n, mrs = 40, enumerate_mrs(2, 2)                     # 4 MRs
    ys = np.array([0, 0, 3], np.int32)
    xs = np.array([1, 5, 2], np.int32)
    masks = np.array([[1], [6], [8]], np.int64)

    def fill(idx=None, **change):
        args = dict(ys=ys, hubs=xs, masks=masks)
        args.update(change)
        idx = idx or RLCIndex(n, 2, np.arange(1, n + 1))
        return idx.fill_rows("out", mrs=mrs, **args)

    assert fill() == (4, 3)
    for bad in (dict(ys=ys[::-1].copy()),                    # unsorted
                dict(hubs=np.array([5, 1, 2], np.int32)),
                dict(hubs=np.array([1, 1, 2], np.int32)),   # twice
                dict(masks=np.array([[1], [0], [8]], np.int64)),
                dict(masks=np.array([[1], [16], [8]], np.int64))):
        with pytest.raises(ValueError):
            fill(**bad)
    full = RLCIndex(n, 2, np.arange(1, n + 1))
    full.add_out(3, 9, mrs[0])
    with pytest.raises(ValueError, match="not empty"):
        fill(full)
    mirrored = RLCIndex(n, 2, np.arange(1, n + 1))
    mirrored.attach_bit_mirror({w: c for c, w in enumerate(mrs)})
    with pytest.raises(ValueError, match="mirror"):
        fill(mirrored)
    empty = np.zeros(0, np.int32)
    assert fill(ys=empty, hubs=empty, masks=np.zeros((0, 1), np.int64)) \
        == (0, 0)


# ------------------------------------------------------------------ #
# On the card
# ------------------------------------------------------------------ #
@needs_cuda
@pytest.mark.parametrize("C,n,bits", [(9, 6541, 0.002), (33, 6541, 0.002),
                                      (64, 16384, 2_000_000)])
def test_cuda_entry_masks_equals_the_plain_version(C, n, bits):
    """Random stacks at the Advogato k = 2 and 3 shapes (a density) and at
    Soc-Epinions' (64, 16384, 512) (two million random bits)."""
    W = hub_cover.stack_words(n)
    gen = torch.Generator(device="cuda").manual_seed(C)
    if bits < 1:
        words = hub_cover.pack_stack(
            torch.rand((C, n, n), generator=gen, device="cuda") < bits)
    else:
        words = torch.zeros((C, n, W), dtype=torch.int32, device="cuda")
        at = torch.randint(0, C * n * W, (bits,), device="cuda",
                           generator=gen)
        bit = torch.randint(0, 32, (bits,), device="cuda", generator=gen)
        words.view(-1)[at] = torch.ones_like(bit, dtype=torch.int32) \
            << bit.int()
    before = KERNELS["entry_masks"].launches
    got = hub_cover.entry_masks(words)
    torch.cuda.synchronize()
    assert KERNELS["entry_masks"].launches == before + 1
    want = ref.entry_masks_ref(words)
    assert got.shape == want.shape == (n, 32 * W, -(-C // 64))
    assert torch.equal(got, want) and bool(want.ne(0).any())


def counted():
    """The process registry's condensed-build entries, pairs and down
    bytes."""
    reg = obs.process_obs().registry

    def value(name, **labels):
        series = reg.get(name)
        return series.value(backend="device_condensed", **labels) \
            if series else 0.0
    return np.array([value("rlc_build_entries", side="out"),
                     value("rlc_build_entries", side="in"),
                     value("rlc_build_pairs", side="out"),
                     value("rlc_build_pairs", side="in"),
                     value("rlc_build_host_bytes", direction="down")])


@needs_cuda
@pytest.mark.parametrize("n,labels,k", [(1000, 3, 2), (500, 3, 3),
                                        (400, 8, 2), (300, 9, 2)])
def test_cuda_build_rows_equal_the_cpu_build(n, labels, k):
    g = graph_of(n, labels, seed=n)
    R = torch.from_numpy(dense.DenseEngine.build(g, k, device="cpu").reach)
    before = counted()
    got, eng = dense.build_condensed_device(g, k, hub_batch=8,
                                            reach=R.cuda(), device="cuda")
    c = counted() - before
    want, _ = dense.build_condensed_device(g, k, hub_batch=8,
                                           reach=R.numpy(), device="cpu")
    assert got.l_out == want.l_out and got.l_in == want.l_in
    ref_mrs = plain.minimum_repeats(labels, k)
    assert np.array_equal(index_keys(got, ref_mrs, n),
                          index_keys(want, ref_mrs, n))
    pairs = [sum(map(len, maps)) for maps in (got.l_out, got.l_in)]
    out_entries = sum(len(s) for row in got.l_out for s in row.values())
    M = -(-len(eng.mrs) // 64)
    assert c.tolist() == [out_entries, got.num_entries() - out_entries,
                          *pairs, sum(pairs) * (8 + 8 * M)]
    for maps, p in zip((got.l_out, got.l_in), pairs):
        assert_fresh_rows(maps, p)
