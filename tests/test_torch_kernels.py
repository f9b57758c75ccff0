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


def mergejoin_case(n, E, Q, lo, hi, seed):
    """Full-height rows plus queries whose ids lie in ``[lo, hi)``."""
    rng = np.random.default_rng(seed)
    oh, om = rand_rows(rng, n, E)
    ih, im = rand_rows(rng, n, E)
    s = rng.integers(lo, hi, Q).astype(np.int32)
    t = rng.integers(lo, hi, Q).astype(np.int32)
    mr = rng.integers(0, 6, Q).astype(np.int32)
    # plant Case-2 hits so both cases are exercised
    oh[s[::3], 0] = t[::3]
    om[s[::3], 0] = mr[::3]
    return oh, om, ih, im, s, t, mr


def torch_mergejoin(oh, om, ih, im, s, t, mr, lo, hi, device="cpu"):
    rows = [torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(device)
            for a in (oh, om, ih, im)]
    return mergejoin.query_batch(*rows, s, t, mr, row_base_out=lo,
                                 row_base_in=lo).cpu().numpy()


MJ_SHAPES = [(32, 8, 17), (64, 24, 64), (128, 64, 3)]


@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("n,E,Q", MJ_SHAPES)
def test_plain_mergejoin_matches_pallas(n, E, Q, window):
    ops = pytest.importorskip("repro.kernels.ops")
    import jax.numpy as jnp
    lo, hi = (n // 4, 3 * n // 4) if window else (0, n)
    oh, om, ih, im, s, t, mr = mergejoin_case(n, E, Q, lo, hi, n + E + Q)
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
