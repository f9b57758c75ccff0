"""Port kernels: plain versions vs the JAX package's Pallas kernels, and
the CUDA kernels vs their plain versions.

Inputs come from numpy with a seed. Every comparison is exact equality
(OR-AND over 0/1 values and integer compares). The JAX side runs the
Pallas kernels in interpret mode; it is imported inside the tests that
need it, so the card tests of this file also run where JAX is absent.
The card tests skip, with a reason, where no CUDA device is present.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.devices import resolve_device  # noqa: E402
from repro_torch.kernels import KERNELS, bitpack, label_frontier  # noqa: E402
from repro_torch.kernels import mergejoin, ref  # noqa: E402

# decided at test setup (a string condition), never at import time
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")


def rand_bool(rng, shape, density):
    return (rng.random(shape) < density).astype(np.float32)


def rand_rows(rng, n, E, num_mrs=6):
    hub = rng.integers(-1, n, size=(n, E)).astype(np.int32)
    mr = rng.integers(0, num_mrs, size=(n, E)).astype(np.int32)
    mr[hub == -1] = -1
    return hub, mr


def mergejoin_case(n, E, Q, lo, hi, seed, layout="random"):
    """Full-height rows plus queries whose ids lie in ``[lo, hi)``.

    layout: ``random`` (PAD slots, 6 MRs), ``all_mr`` (every slot holds
    an entry with the one MR that every query asks for), ``mr_missing``
    (MR 5 is in no row, and a third of the queries ask for it) or
    ``case2_only`` (sources below the middle of ``[lo, hi)``, targets
    above it, other hubs out of the id range and apart: no shared hub, so
    every hit is a Case-2 hit)."""
    rng = np.random.default_rng(seed)
    oh, om = rand_rows(rng, n, E)
    ih, im = rand_rows(rng, n, E)
    s = rng.integers(lo, hi, Q).astype(np.int32)
    t = rng.integers(lo, hi, Q).astype(np.int32)
    mr = rng.integers(0, 6, Q).astype(np.int32)
    if layout == "all_mr":
        oh, ih = (rng.integers(0, E * n, size=(n, E)).astype(np.int32)
                  for _ in range(2))
        om, im, mr = np.zeros_like(om), np.zeros_like(im), np.zeros_like(mr)
    elif layout == "mr_missing":
        om[om == 5], im[im == 5] = 4, 4
        mr[::3] = 5
    elif layout == "case2_only":
        mid = (lo + hi) // 2
        s, t = s % (mid - lo) + lo, t % (hi - mid) + mid
        oh[oh >= 0] += 2 * n
        ih[ih >= 0] += 4 * n
    # plant Case-2 hits so both cases are exercised
    oh[s[::3], 0] = t[::3]
    om[s[::3], 0] = mr[::3]
    if layout == "case2_only":   # ... from both sides
        ih[t[1::3], -1] = s[1::3]
        im[t[1::3], -1] = mr[1::3]
    return oh, om, ih, im, s, t, mr


def torch_mergejoin(oh, om, ih, im, s, t, mr, lo, hi, device="cpu"):
    rows = [torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(device)
            for a in (oh, om, ih, im)]
    return mergejoin.query_batch(*rows, s, t, mr, row_base_out=lo,
                                 row_base_in=lo).cpu().numpy()


MJ_SHAPES = [(32, 8, 17), (64, 24, 64), (128, 64, 3)]
# the earlier shapes keep their ids; the new ones name their row layout
MJ_CASES = [pytest.param(n, E, Q, "random", id=f"{n}-{E}-{Q}")
            for n, E, Q in MJ_SHAPES] + [
    pytest.param(n, E, Q, layout, id=f"{n}-{E}-{Q}-{layout}")
    for n, E, Q in [(96, 40, 50), (80, 72, 33), (64, 80, 40)]
    for layout in ("random", "all_mr", "mr_missing", "case2_only")]


@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("n,E,Q,layout", MJ_CASES)
def test_plain_mergejoin_matches_pallas(n, E, Q, layout, window):
    ops = pytest.importorskip("repro.kernels.ops")
    import jax.numpy as jnp
    lo, hi = (n // 4, 3 * n // 4) if window else (0, n)
    oh, om, ih, im, s, t, mr = mergejoin_case(n, E, Q, lo, hi, n + E + Q,
                                              layout)
    want = ops.mergejoin_query(
        *(jnp.asarray(a[lo:hi]) for a in (oh, om, ih, im)),
        jnp.asarray(s), jnp.asarray(t), jnp.asarray(mr), interpret=True,
        row_base_out=lo, row_base_in=lo)
    got = torch_mergejoin(oh, om, ih, im, s, t, mr, lo, hi)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("R,V,L", [(6, 128, 3), (9, 256, 4)])
def test_plain_frontier_matches_pallas(R, V, L):
    pytest.importorskip("repro.kernels.label_frontier")
    import jax.numpy as jnp
    from repro.kernels.bitpack import pack_bits as j_pack_bits
    from repro.kernels.label_frontier import frontier_step_many as j_step

    rng = np.random.default_rng(R + V + L)
    f = rand_bool(rng, (R, V), 0.08)
    A = rand_bool(rng, (L, V, V), 0.04)
    labels = rng.integers(0, L, R).astype(np.int32)
    G = j_step(jnp.asarray(f), jnp.asarray(A), jnp.asarray(labels),
               interpret=True)
    words = label_frontier.frontier_step_many(
        torch.from_numpy(f), ref.pack_bits(torch.from_numpy(A)), labels)
    np.testing.assert_array_equal(ref.unpack_bits(words).numpy(),
                                  np.asarray(G))
    np.testing.assert_array_equal(
        words.numpy(), np.asarray(j_pack_bits(G)).view(np.int32))


def test_pack_bits_matches_jax_and_roundtrips():
    pytest.importorskip("repro.kernels.bitpack")
    import jax.numpy as jnp
    from repro.kernels.bitpack import pack_bits as j_pack_bits

    rng = np.random.default_rng(1)
    x = rand_bool(rng, (16, 256), 0.5)
    x[:, 31::32] = 1                      # the sign bit of every word
    words = ref.pack_bits(torch.from_numpy(x))
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(
        words.numpy(), np.asarray(j_pack_bits(jnp.asarray(x))).view(np.int32))
    np.testing.assert_array_equal(ref.unpack_bits(words).numpy(), x)
    np.testing.assert_array_equal(bitpack.unpack_rows(words.numpy(), 250),
                                  x[:, :250].astype(bool))


def test_pack_adjacency_equals_packed_dense_stack():
    rng = np.random.default_rng(5)
    V, Vp, L, m = 90, 128, 3, 400
    src = rng.integers(0, V, m)
    dst = rng.integers(0, V, m)
    lab = rng.integers(0, L, m)
    dense = np.zeros((L, Vp, Vp), np.float32)
    dense[lab, src, dst] = 1
    got = bitpack.pack_adjacency(src, lab, dst, L, Vp, "cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  ref.pack_bits(torch.from_numpy(dense)))


def test_cpu_tensors_never_launch():
    before = {k: v.launches for k, v in KERNELS.items()}
    oh, om, ih, im, s, t, mr = mergejoin_case(16, 8, 9, 0, 16, 0)
    torch_mergejoin(oh, om, ih, im, s, t, mr, 0, 16)
    rng = np.random.default_rng(0)
    label_frontier.frontier_step_many(
        torch.from_numpy(rand_bool(rng, (3, 64), 0.2)),
        torch.zeros((2, 64, 2), dtype=torch.int32), [0, 1, 1])
    assert {k: v.launches for k, v in KERNELS.items()} == before


def test_wrappers_reject_ids_outside_the_rows():
    oh, om, ih, im, s, t, mr = mergejoin_case(16, 8, 9, 0, 16, 0)
    with pytest.raises(IndexError):
        torch_mergejoin(oh, om, ih, im, s, t, mr, 4, 12)   # s < row_base
    with pytest.raises(IndexError):
        label_frontier.frontier_step_many(
            torch.zeros((2, 64)), torch.zeros((2, 64, 2), dtype=torch.int32),
            [0, 2])
    with pytest.raises(ValueError):
        label_frontier.frontier_step_many(
            torch.zeros((2, 64)), torch.zeros((2, 64, 3), dtype=torch.int32),
            [0, 1])


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


# ------------------------------------------------------------------ #
# CUDA kernels vs their plain versions (on the card)
# ------------------------------------------------------------------ #
@needs_cuda
@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("n,E,Q", MJ_SHAPES + [(6541, 40, 65_536),
                                               (300, 72, 1001)])
def test_cuda_mergejoin_matches_plain(n, E, Q, window):
    lo, hi = (n // 4, 3 * n // 4) if window else (0, n)
    case = mergejoin_case(n, E, Q, lo, hi, n + E + Q)
    before = mergejoin.KERNEL.launches
    got = torch_mergejoin(*case, lo, hi, device="cuda")
    torch.cuda.synchronize()
    assert mergejoin.KERNEL.launches == before + 1
    np.testing.assert_array_equal(got, torch_mergejoin(*case, lo, hi))


def chunked_mergejoin_ref(rows, ids, lo):
    """``ref.mergejoin_ref`` in slices of queries, so that its ``(Q, E,
    E)`` join stays small at large ``E``."""
    E = rows[0].shape[1]
    step = max(1, 2 ** 24 // (E * E))
    return torch.cat([ref.mergejoin_ref(*rows, *ids[:, i:i + step], lo, lo)
                      for i in range(0, ids.shape[1], step)])


@needs_cuda
@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("Q", [1, 31, 32, 33, 65_536])
@pytest.mark.parametrize("E", [8, 18, 40, 72, 80, 256, 1000])
def test_cuda_mergejoin_row_lengths_and_batches(E, Q, window):
    """Every lane-group width, rows of one to eight turns, partial groups
    and blocks at the batch's end, windowed layouts; E = 18 takes the
    kernel's 4-byte loads (its rows are not 16-byte aligned)."""
    n = 512
    lo, hi = (n // 4, 3 * n // 4) if window else (0, n)
    layout = ("random", "all_mr", "mr_missing", "case2_only")[Q % 4]
    oh, om, ih, im, s, t, mr = mergejoin_case(n, E, Q, lo, hi, E + Q,
                                              layout)
    rows = [torch.from_numpy(np.ascontiguousarray(a[lo:hi])).cuda()
            for a in (oh, om, ih, im)]
    before = mergejoin.KERNEL.launches
    got = mergejoin.query_batch(*rows, s, t, mr, row_base_out=lo,
                                row_base_in=lo)
    torch.cuda.synchronize()
    assert mergejoin.KERNEL.launches == before + 1
    ids = torch.from_numpy(np.stack([s, t, mr]).astype(np.int32)).cuda()
    assert torch.equal(got, chunked_mergejoin_ref(rows, ids, lo))


@needs_cuda
@pytest.mark.parametrize("density", [0.0, 0.01, 1.0])
@pytest.mark.parametrize("R", [1, 15, 150, 300])
def test_cuda_frontier_wave_at_path_shapes(R, density):
    rng = np.random.default_rng(R)
    V = 6656
    f = torch.from_numpy(rand_bool(rng, (R, V), density)).cuda()
    A = ref.pack_bits(torch.from_numpy(
        rand_bool(rng, (3, V, V), 0.002)).cuda())
    labels = rng.integers(0, 3, R).astype(np.int32)
    got = label_frontier.frontier_step_many(f, A, labels)
    want = ref.frontier_step_many_ref(f, A, torch.from_numpy(labels))
    assert torch.equal(got, want)


@needs_cuda
@pytest.mark.parametrize("R", [1, 15, 150])
def test_cuda_frontier_wave_odd_word_count(R):
    """W = 209 words a row: the kernel's one-word loads."""
    rng = np.random.default_rng(R)
    V = 6688
    f = torch.from_numpy(rand_bool(rng, (R, V), 0.01)).cuda()
    A = ref.pack_bits(torch.from_numpy(
        rand_bool(rng, (2, V, V), 0.002)).cuda())
    labels = rng.integers(0, 2, R).astype(np.int32)
    got = label_frontier.frontier_step_many(f, A, labels)
    assert torch.equal(got, ref.frontier_step_many_ref(
        f, A, torch.from_numpy(labels)))


@needs_cuda
@pytest.mark.parametrize("T", [1, 2, 3])
@pytest.mark.parametrize("R,density", [(1, 0.01), (15, 0.01), (150, 0.01),
                                       (300, 0.01), (15, 0.0), (15, 1.0)])
def test_cuda_frontier_steps_at_path_shapes(R, density, T):
    """V = 6541 (not a multiple of 32), labels naming two of three
    slices."""
    rng = np.random.default_rng(R + T)
    V = 6541
    f = torch.from_numpy(rand_bool(rng, (R, V), density)).cuda()
    A = torch.from_numpy(rand_bool(rng, (3, V, V), 0.002)).cuda()
    labels = rng.choice([0, 2], (T, R))
    dst = np.stack([rng.permutation(R) for _ in range(T)])
    before = label_frontier.STEPS_KERNEL.launches
    got = label_frontier.frontier_steps(f, A, labels, dst)
    torch.cuda.synchronize()
    assert label_frontier.STEPS_KERNEL.launches == before + T
    want = ref.frontier_steps_ref(f, A, torch.from_numpy(labels),
                                  torch.from_numpy(dst))
    assert torch.equal(got, want)


@needs_cuda
@pytest.mark.parametrize("K,n", [(6656, 6656), (6541, 6560)])
def test_cuda_bitpack_matmul_at_the_bfs_shape(K, n):
    rng = np.random.default_rng(K)
    a = torch.from_numpy(rand_bool(rng, (150, K), 0.01)).cuda()
    b = ref.pack_bits(torch.from_numpy(rand_bool(rng, (K, n), 0.01)).cuda())
    got = ops.bitpack_matmul(a, b)
    assert torch.equal(got, ref.bitpack_matmul_ref(a, b))


@needs_cuda
@pytest.mark.parametrize("R,V,L,density", [
    (6, 128, 3, 0.08), (9, 256, 4, 0.08), (300, 6656, 3, 0.01),
    (15, 6656, 3, 0.3), (4, 8192, 2, 0.5)])
def test_cuda_frontier_matches_plain(R, V, L, density):
    rng = np.random.default_rng(R + V + L)
    f = torch.from_numpy(rand_bool(rng, (R, V), density)).cuda()
    A = ref.pack_bits(torch.from_numpy(
        rand_bool(rng, (L, V, V), 0.002)).cuda())
    labels = rng.integers(0, L, R).astype(np.int32)
    before = label_frontier.KERNEL.launches
    got = label_frontier.frontier_step_many(f, A, labels)
    torch.cuda.synchronize()
    assert label_frontier.KERNEL.launches == before + 1
    want = ref.frontier_step_many_ref(f, A, torch.from_numpy(labels))
    assert torch.equal(got, want)


# ------------------------------------------------------------------ #
# The dense engine's kernels and the rest of the kernel surface
# ------------------------------------------------------------------ #
from repro_torch.kernels import bool_semiring, ops  # noqa: E402

BM_SHAPES = [(128, 128, 128), (64, 64, 64), (100, 130, 90), (8, 8, 8)]


def _jax_ops():
    jops = pytest.importorskip("repro.kernels.ops")
    import jax.numpy as jnp
    return jops, jnp


def _as_np(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", BM_SHAPES)
def test_plain_bool_matmul_matches_pallas(m, k, n, dtype):
    jops, jnp = _jax_ops()
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    a, b = rand_bool(rng, (m, k), 0.2), rand_bool(rng, (k, n), 0.2)
    want = jops.bool_matmul(jnp.asarray(a, dtype), jnp.asarray(b, dtype),
                            interpret=True)
    tdt = getattr(torch, dtype)
    got = ops.bool_matmul(torch.from_numpy(a).to(tdt),
                          torch.from_numpy(b).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(_as_np(got),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [64, 200])
def test_plain_closure_step_matches_pallas(n, dtype):
    jops, jnp = _jax_ops()
    r = rand_bool(np.random.default_rng(n), (n, n), 0.05)
    want = np.asarray(jops.closure_step(jnp.asarray(r, dtype),
                                        interpret=True), np.float32)
    tr = torch.from_numpy(r).to(getattr(torch, dtype))
    got = ops.closure_step(tr)
    assert got.dtype == tr.dtype
    np.testing.assert_array_equal(_as_np(got), want)
    out = torch.full((n, n), 7.0, dtype=tr.dtype)
    assert ops.closure_step(tr, out=out) is out
    np.testing.assert_array_equal(_as_np(out), want)


def test_plain_bitpack_matmul_matches_pallas():
    jops, jnp = _jax_ops()
    from repro.kernels.bitpack import pack_bits as j_pack_bits
    m, k, n = 32, 100, 512
    rng = np.random.default_rng(m + k + n)
    a, b = rand_bool(rng, (m, k), 0.15), rand_bool(rng, (k, n), 0.15)
    b[:, 31::32] = 1                      # the sign bit of every word
    want = jops.bitpack_matmul(jnp.asarray(a), j_pack_bits(jnp.asarray(b)),
                               interpret=True)
    got = ops.bitpack_matmul(torch.from_numpy(a),
                             ops.pack_bits(torch.from_numpy(b)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).view(np.int32))


def test_plain_frontier_step_matches_pallas():
    jops, jnp = _jax_ops()
    B, V, L = 64, 200, 2
    rng = np.random.default_rng(B + V + L)
    f, A = rand_bool(rng, (B, V), 0.1), rand_bool(rng, (L, V, V), 0.05)
    for lab in range(L):
        want = jops.frontier_step(jnp.asarray(f), jnp.asarray(A),
                                  jnp.asarray(lab), interpret=True)
        got = ops.frontier_step(torch.from_numpy(f), torch.from_numpy(A),
                                np.int32(lab))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def frontier_steps_case():
    """The inputs of tests/test_kernels.py's frontier_steps test."""
    rng = np.random.default_rng(42)
    R, V, L, T = 5, 128, 3, 4
    f = rand_bool(rng, (R, V), 0.08)
    A = rand_bool(rng, (L, V, V), 0.04)
    labels = rng.integers(0, L, (T, R)).astype(np.int32)
    dst = np.stack([rng.permutation(R) for _ in range(T)]).astype(np.int32)
    return f, A, labels, dst


def test_plain_frontier_steps_matches_pallas():
    pytest.importorskip("repro.kernels.label_frontier")
    import jax.numpy as jnp
    from repro.kernels.label_frontier import frontier_steps as j_steps
    f, A, labels, dst = frontier_steps_case()
    want = j_steps(jnp.asarray(f), jnp.asarray(A), jnp.asarray(labels),
                   jnp.asarray(dst), interpret=True)
    got = label_frontier.frontier_steps(torch.from_numpy(f),
                                        torch.from_numpy(A), labels, dst)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("T,subset", [(3, False), (3, True), (2, True),
                                      (1, True)])
def test_plain_frontier_steps_schedules_match_pallas(T, subset):
    """More waves than two, and schedules that name only some slices."""
    pytest.importorskip("repro.kernels.label_frontier")
    import jax.numpy as jnp
    from repro.kernels.label_frontier import frontier_steps as j_steps
    rng = np.random.default_rng(10 * T + subset)
    R, V, L = 7, 100, 4
    f = rand_bool(rng, (R, V), 0.1)
    A = rand_bool(rng, (L, V, V), 0.05)
    pick = [1, 3] if subset else list(range(L))
    labels = rng.choice(pick, (T, R)).astype(np.int32)
    dst = np.stack([rng.permutation(R) for _ in range(T)]).astype(np.int32)
    want = j_steps(jnp.asarray(f), jnp.asarray(A), jnp.asarray(labels),
                   jnp.asarray(dst), interpret=True)
    got = label_frontier.frontier_steps(torch.from_numpy(f),
                                        torch.from_numpy(A), labels, dst)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_packed_slices_names_only_the_schedules_labels():
    labels = np.array([[3, 1, 3], [1, 1, 3]])
    used, local = label_frontier.packed_slices(labels, 5)
    np.testing.assert_array_equal(used, [1, 3])
    np.testing.assert_array_equal(used[local], labels)
    assert local.dtype == np.int32 and local.shape == labels.shape
    with pytest.raises(IndexError):
        label_frontier.packed_slices(labels, 3)
    used, local = label_frontier.packed_slices(np.zeros((0, 4), int), 2)
    assert used.size == 0 and local.shape == (0, 4)


@pytest.mark.parametrize("V,Vp", [(100, 128), (128, 128), (250, 384)])
def test_pack_slices_equals_pack_bits_of_the_padded_slices(V, Vp):
    rng = np.random.default_rng(V)
    A = torch.from_numpy(rand_bool(rng, (3, V, V), 0.3))
    A[:, :, V - 1] = 1                    # a sign bit where V % 32 == 0
    got = bitpack.pack_slices(A, np.array([2, 0]), Vp)
    pad = torch.nn.functional.pad(A, (0, Vp - V, 0, Vp - V))
    assert got.dtype == torch.int32 and got.shape == (2, Vp, Vp // 32)
    assert torch.equal(got, ref.pack_bits(pad[[2, 0]]))
    with pytest.raises(ValueError):
        bitpack.pack_slices(A, np.array([0]), V + 1)


@pytest.mark.parametrize("E,group", [(1, (8, 1)), (8, (8, 1)), (32, (8, 1)),
                                     (33, (8, 2)), (40, (8, 2)),
                                     (64, (8, 2)), (65, (32, 1)),
                                     (72, (32, 1)), (80, (32, 1)),
                                     (1000, (32, 1))])
def test_lane_group_from_row_length(E, group):
    lanes, chunks = mergejoin.lane_group(E)
    assert (lanes, chunks) == group
    # the group holds the whole row at once up to E = 128, else a turn of
    # a whole warp
    assert 4 * lanes * chunks >= min(E, 128)


def test_vector_rows_needs_whole_aligned_units():
    rows = torch.zeros((16, 40), dtype=torch.int32)
    assert mergejoin.vector_rows(40, [rows] * 4)
    odd = torch.zeros((16, 18), dtype=torch.int32)
    assert not mergejoin.vector_rows(18, [odd] * 4)
    # a window that starts one row in: 72 bytes past a 16-byte boundary
    assert not mergejoin.vector_rows(18, [odd[1:]] * 4)
    assert mergejoin.vector_rows(40, [rows[1:]] * 4)
    assert not mergejoin.vector_rows(40, [rows.view(-1)[1:161].view(4, 40)]
                                     + [rows] * 3)


def test_query_ids_are_one_checked_array():
    s, t, mr = np.array([5, 6, 9]), np.array([7, 5, 5]), np.array([0, 2, 1])
    ids = mergejoin.query_ids(s, t, mr, 5, 4, row_base_out=5,
                              row_base_in=5)
    assert ids.dtype == np.int32 and ids.shape == (3, 3)
    assert ids.flags.c_contiguous
    np.testing.assert_array_equal(ids, np.stack([s, t, mr]))
    with pytest.raises(IndexError):                # 9 - 5 >= 4 in rows
        mergejoin.query_ids(s, s, mr, 5, 4, 5, 5)
    with pytest.raises(IndexError):                # 4 < row_base_out
        mergejoin.query_ids(s - 1, t, mr, 5, 4, 5, 5)
    with pytest.raises(ValueError):
        mergejoin.query_ids(s, t, mr[:2], 5, 4, 5, 5)
    none = np.zeros(0, np.int64)
    assert mergejoin.query_ids(none, none, none, 1, 1).shape == (3, 0)


def test_plain_mergejoin_query_surface_matches_pallas():
    jops, jnp = _jax_ops()
    oh, om, ih, im, s, t, mr = mergejoin_case(64, 24, 64, 0, 64, 3)
    want = jops.mergejoin_query(*(jnp.asarray(a) for a in
                                  (oh, om, ih, im, s, t, mr)),
                                interpret=True)
    got = ops.mergejoin_query(*(torch.from_numpy(a) for a in
                                (oh, om, ih, im)), s, t, mr)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_new_wrappers_on_cpu_never_launch():
    before = {k: v.launches for k, v in KERNELS.items()}
    f, A, labels, dst = (torch.from_numpy(x) if x.dtype == np.float32
                         else x for x in frontier_steps_case())
    ops.bool_matmul(f, A[0])
    ops.closure_step(A[1])
    ops.bitpack_matmul(f, ops.pack_bits(A[2]))
    ops.frontier_step(f, A, 2)
    label_frontier.frontier_steps(f, A, labels, dst)
    assert {k: v.launches for k, v in KERNELS.items()} == before


def test_new_wrappers_check_their_arguments():
    f, A, labels, dst = frontier_steps_case()
    f, A = torch.from_numpy(f), torch.from_numpy(A)
    with pytest.raises(IndexError):
        ops.frontier_step(f, A, 3)
    with pytest.raises(IndexError):
        label_frontier.frontier_steps(f, A, labels + 1, dst)
    with pytest.raises(ValueError):               # dst[t] not a permutation
        label_frontier.frontier_steps(f, A, labels, np.zeros_like(dst))
    with pytest.raises(ValueError):               # inner dimensions
        ops.bool_matmul(f, A[0, :64])
    with pytest.raises(ValueError):               # mixed dtypes
        ops.bool_matmul(f, A[0].to(torch.bfloat16))
    with pytest.raises(ValueError):               # out aliases r
        ops.closure_step(A[0], out=A[1])
    with pytest.raises(ValueError):               # K of b_packed
        ops.bitpack_matmul(f, torch.zeros((7, 4), dtype=torch.int32))


@needs_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", BM_SHAPES + [(300, 6656, 6656),
                                               (6541, 6541, 131),
                                               (129, 33, 257)])
def test_cuda_bool_matmul_matches_plain(m, k, n, dtype):
    rng = np.random.default_rng(m + k + n)
    tdt = getattr(torch, dtype)
    a = torch.from_numpy(rand_bool(rng, (m, k), 0.01)).to("cuda", tdt)
    b = torch.from_numpy(rand_bool(rng, (k, n), 0.01)).to("cuda", tdt)
    before = bool_semiring.MATMUL_KERNEL.launches
    got = ops.bool_matmul(a, b)
    torch.cuda.synchronize()
    assert bool_semiring.MATMUL_KERNEL.launches == before + 1
    assert torch.equal(got, ref.bool_matmul_ref(a, b))


@needs_cuda
@pytest.mark.parametrize("n", [64, 200, 1000, 6541])
def test_cuda_closure_step_matches_plain(n):
    r = torch.from_numpy(rand_bool(np.random.default_rng(n), (n, n),
                                   2.0 / n)).cuda()
    before = bool_semiring.CLOSURE_KERNEL.launches
    got = ops.closure_step(r)
    torch.cuda.synchronize()
    assert bool_semiring.CLOSURE_KERNEL.launches == before + 1
    assert torch.equal(got, ref.fused_closure_step_ref(r))


@needs_cuda
@pytest.mark.parametrize("m,k,n,density", [(32, 100, 512, 0.15),
                                           (6656, 6656, 6656, 0.001),
                                           (7, 5000, 96, 0.5)])
def test_cuda_bitpack_matmul_matches_plain(m, k, n, density):
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rand_bool(rng, (m, k), density)).cuda()
    b = ref.pack_bits(torch.from_numpy(rand_bool(rng, (k, n), 0.01)).cuda())
    before = bitpack.KERNEL.launches
    got = ops.bitpack_matmul(a, b)
    torch.cuda.synchronize()
    assert bitpack.KERNEL.launches == before + 1
    assert torch.equal(got, ref.bitpack_matmul_ref(a, b))


@needs_cuda
@pytest.mark.parametrize("B,V,L", [(64, 200, 2), (300, 6656, 3)])
def test_cuda_frontier_step_matches_plain(B, V, L):
    rng = np.random.default_rng(B + V + L)
    f = torch.from_numpy(rand_bool(rng, (B, V), 0.01)).cuda()
    A = torch.from_numpy(rand_bool(rng, (L, V, V), 0.002)).cuda()
    before = label_frontier.STEP_KERNEL.launches
    for lab in range(L):
        got = ops.frontier_step(f, A, lab)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.frontier_step_ref(f, A, lab))
    assert label_frontier.STEP_KERNEL.launches == before + L


@needs_cuda
@pytest.mark.parametrize("R,V,T", [(5, 128, 4), (300, 6541, 2)])
def test_cuda_frontier_steps_matches_plain(R, V, T):
    rng = np.random.default_rng(R + V + T)
    f = torch.from_numpy(rand_bool(rng, (R, V), 0.01)).cuda()
    A = torch.from_numpy(rand_bool(rng, (3, V, V), 0.002)).cuda()
    labels = rng.integers(0, 3, (T, R))
    dst = np.stack([rng.permutation(R) for _ in range(T)])
    before = label_frontier.STEPS_KERNEL.launches
    got = label_frontier.frontier_steps(f, A, labels, dst)
    torch.cuda.synchronize()
    assert label_frontier.STEPS_KERNEL.launches == before + T
    want = ref.frontier_steps_ref(f, A, torch.from_numpy(labels),
                                  torch.from_numpy(dst))
    assert torch.equal(got, want)


# ------------------------------------------------------------------ #
# The router between the semiring's two kernels (a CPU function)
# ------------------------------------------------------------------ #
def _pitches(cols_a, cols_b, dtype):
    size = torch.tensor([], dtype=dtype).element_size()
    return (cols_a * size, cols_b * size)


@pytest.mark.parametrize("M,kernel", [(1, "splitk"), (150, "splitk"),
                                      (300, "splitk"), (6656, "wgmma")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_by_rows_at_the_engine_width(M, kernel, dtype):
    tdt = getattr(torch, dtype)
    f32 = tdt == torch.float32
    rt = bool_semiring.route(M, 6656, 6656, tdt, _pitches(6656, 6656, tdt))
    assert rt.kernel == kernel
    if kernel == "splitk":
        # the right operand (the adjacency slice) streams as it is, in
        # float32 or bf16; the left one (the few rows) is read as bf16
        assert (rt.stage_a, rt.stage_b) == (f32, False)
    else:
        # the wgmma kernel reads only bf16: float32 goes through staging
        assert (rt.stage_a, rt.stage_b) == (f32, f32)


@pytest.mark.parametrize("case,want", [
    # n = 6541 bf16: a 13,082-byte pitch, not a multiple of 16
    ((6541, 6541, 6541, "bfloat16", None), ("wgmma", True, True)),
    ((6656, 6656, 6656, "float32", None), ("wgmma", True, True)),
    ((6656, 6656, 6656, "bfloat16", None), ("wgmma", False, False)),
    ((6656, 6656, 6656, "bfloat16", (0, 8)), ("wgmma", False, True)),
    ((300, 6541, 6541, "float32", None), ("splitk", True, True)),
    ((300, 6541, 6541, "bfloat16", None), ("splitk", True, True)),
])
def test_route_stages_what_the_kernel_cannot_read(case, want):
    M, K, N, dtype, bases = case
    tdt = getattr(torch, dtype)
    rt = bool_semiring.route(M, N, K, tdt, _pitches(K, N, tdt),
                             bases or (0, 0))
    assert (rt.kernel, rt.stage_a, rt.stage_b) == want
    assert bool_semiring.staged_pitch(6541) == 6544


@pytest.mark.parametrize("delta,kernel", [(-1, "splitk"), (0, "wgmma")])
def test_route_tile_count_boundary(delta, kernel):
    # 2 waves of 132 SMs = 264 output tiles of 128 x 128: 24 x 11 = 264
    bf = torch.bfloat16
    N = 11 * 128
    M = 24 * 128 + (delta * 128 if delta else 0)
    rt = bool_semiring.route(M, N, 512, bf, _pitches(512, N, bf))
    assert rt.kernel == kernel
    assert bool_semiring.route(1, 1, 0, bf, (2, 2)).kernel == "splitk"


# ------------------------------------------------------------------ #
# Both kernels on the card, at the shapes that stress each
# ------------------------------------------------------------------ #
ROUTE_CASES = [
    # (m, k, n, density, kernel)
    (300, 6656, 6656, 1.0, "splitk"),     # all ones: the largest sums
    (6656, 6656, 6656, 1.0, "wgmma"),
    (1, 6656, 6656, 0.01, "splitk"),      # several K chunks at few rows
    (150, 6656, 6656, 0.01, "splitk"),
    (300, 6541, 6656, 0.01, "splitk"),    # K not a multiple of 64
    (2048, 33, 4096, 0.3, "wgmma"),       # K = 33
    (4096, 6541, 2048, 0.001, "wgmma"),
]


@needs_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,density,kernel", ROUTE_CASES)
def test_cuda_semiring_routes_match_plain(m, k, n, density, kernel, dtype):
    rng = np.random.default_rng(m + k + n)
    tdt = getattr(torch, dtype)
    a = torch.from_numpy(rand_bool(rng, (m, k), density)).to("cuda", tdt)
    b = torch.from_numpy(rand_bool(rng, (k, n), density)).to("cuda", tdt)
    size = a.element_size()
    rt = bool_semiring.route(m, n, k, tdt, (k * size, n * size),
                             (a.data_ptr(), b.data_ptr()))
    assert rt.kernel == kernel
    before = bool_semiring.MATMUL_KERNEL.launches
    got = ops.bool_matmul(a, b)
    torch.cuda.synchronize()
    assert bool_semiring.MATMUL_KERNEL.launches == before + 1
    assert torch.equal(got, ref.bool_matmul_ref(a, b))


@needs_cuda
@pytest.mark.parametrize("n,dtype,stage", [(6541, "float32", True),
                                           (6541, "bfloat16", True),
                                           (6656, "bfloat16", False),
                                           (6656, "float32", True),
                                           (300, "float32", True),
                                           (300, "bfloat16", True),
                                           (304, "bfloat16", False)])
def test_cuda_closure_step_routes_match_plain(n, dtype, stage):
    tdt = getattr(torch, dtype)
    r = torch.from_numpy(rand_bool(np.random.default_rng(n), (n, n),
                                   2.0 / n)).to("cuda", tdt)
    size = r.element_size()
    rt = bool_semiring.route(n, n, n, tdt, (n * size,) * 2,
                             (r.data_ptr(),) * 2)
    assert rt.kernel == ("wgmma" if n > 1000 else "splitk")
    assert rt.stage_a == stage
    before = bool_semiring.CLOSURE_KERNEL.launches
    got = ops.closure_step(r)
    torch.cuda.synchronize()
    assert bool_semiring.CLOSURE_KERNEL.launches == before + 1
    assert torch.equal(got, ref.fused_closure_step_ref(r))


@needs_cuda
@pytest.mark.parametrize("B", [1, 150, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_frontier_step_split_k_matches_plain(B, dtype):
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(B)
    f = torch.from_numpy(rand_bool(rng, (B, 6656), 0.05)).to("cuda", tdt)
    A = torch.from_numpy(rand_bool(rng, (2, 6656, 6656), 0.002)).to(
        "cuda", tdt)
    # 52 column tiles of 104 K steps over one block an SM: every block's
    # run crosses a tile, so each tile is split across K
    assert bool_semiring.route(B, 6656, 6656, tdt,
                               (6656 * f.element_size(),) * 2).kernel \
        == "splitk"
    before = label_frontier.STEP_KERNEL.launches
    got = ops.frontier_step(f, A, 1)
    torch.cuda.synchronize()
    assert label_frontier.STEP_KERNEL.launches == before + 1
    assert torch.equal(got, ref.frontier_step_ref(f, A, 1))
