"""The condensed build's hub loop on bit-packed stacks.

On the CPU, the plain packed step (:func:`repro_torch.kernels.ref.
hub_cover_ref`, two sides a batch through :mod:`repro_torch.kernels.
hub_cover`) must leave, after every hub batch, exactly the bits of the
float32 step :func:`repro_torch.core.dense._hub_batch_step` packed. On the
card, the kernel must equal the plain packed step. Every comparison is
exact (OR-AND over 0/1 values and integer compares). Card tests skip, with
a reason, where no CUDA device is present; this file does not import JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dense  # noqa: E402
from repro_torch.graphgen import random_labeled_graph  # noqa: E402
from repro_torch.kernels import KERNELS, hub_cover, ref  # noqa: E402

# decided at test setup (a string condition), never at import time
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")

SIZES = [37, 70, 100]
HUB_BATCHES = [1, 3, 8, 40]


def build_inputs(n, k, seed=0, device="cpu"):
    """The reach of a random graph (3 labels at k = 2, 2 at k = 3), its
    access ids and order, as the condensed build uploads them."""
    g = random_labeled_graph(num_vertices=n, num_edges=3 * n,
                             num_labels=3 if k == 2 else 2, seed=seed)
    eng = dense.DenseEngine.build(g, k, device="cpu")
    R = torch.from_numpy(eng.reach).to(device)
    aid = torch.from_numpy(g.access_ids().astype(np.int64)).to(device)
    order = torch.from_numpy(g.access_order().astype(np.int64)).to(device)
    return R, aid, order


def packed_loop(R, aid, order, hub_batch, each=None):
    """The packed hub loop batch by batch on R's device; ``each(i, OUT,
    IN)`` after every batch."""
    C, n, _ = R.shape
    OUT, IN = (hub_cover.zero_stack(C, n, R.device) for _ in range(2))
    RT = R.transpose(1, 2).contiguous()
    for i in range(0, n, hub_batch):
        hub_cover.hub_batch_step(OUT, IN, R, RT, aid, order, i,
                                 min(hub_batch, n - i))
        if each:
            each(i, OUT, IN)
    return OUT, IN


@pytest.mark.parametrize("hub_batch", HUB_BATCHES)
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("n", SIZES)
def test_plain_packed_step_equals_hub_batch_step(n, k, hub_batch):
    R, aid, order = build_inputs(n, k, seed=n + k)
    C = R.shape[0]
    Rf = R.float()
    OUTf = torch.zeros((C, n, n))
    INf = torch.zeros((C, n, n))
    batches = []

    def each(i, OUT, IN):
        dense._hub_batch_step(OUTf, INf, Rf, aid, order[i:i + hub_batch])
        batches.append(i)
        assert torch.equal(OUT, hub_cover.pack_stack(OUTf)), i
        assert torch.equal(IN, hub_cover.pack_stack(INf)), i

    OUT, IN = packed_loop(R, aid, order, hub_batch, each)
    assert batches == list(range(0, n, hub_batch))   # last batch partial
    assert OUTf.sum() > 0 and INf.sum() > 0


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 130])
def test_pack_unpack_round_trip(n):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.random((3, n, n)) < 0.3)
    words = hub_cover.pack_stack(x)
    W = hub_cover.stack_words(n)
    assert words.shape == (3, n, W) and words.dtype == torch.int32
    assert W % 4 == 0 and 32 * W >= n > 32 * (W - 4)
    bits = ref.unpack_bits(words, torch.bool)
    assert bits.dtype == torch.bool and bits.shape == (3, n, 32 * W)
    assert torch.equal(bits[:, :, :n], x)
    assert not bits[:, :, n:].any()
    assert torch.equal(words, ref.pack_bits(bits))


def test_cpu_build_runs_the_float_step_and_launches_nothing(monkeypatch):
    g = random_labeled_graph(num_vertices=30, num_edges=90, num_labels=2,
                             seed=3)
    seen = []
    real = dense._hub_batch_step

    def step(OUT, IN, R, aid, hubs):
        seen.append((OUT.dtype, len(hubs)))
        real(OUT, IN, R, aid, hubs)
    monkeypatch.setattr(dense, "_hub_batch_step", step)
    before = KERNELS["hub_cover"].launches
    dense.build_condensed_device(g, 2, hub_batch=8, device="cpu")
    assert seen == [(torch.float32, 8)] * 3 + [(torch.float32, 6)]
    assert KERNELS["hub_cover"].launches == before


def test_plain_hub_loop_equals_the_batches():
    R, aid, order = build_inputs(50, 2, seed=5)
    C, n, _ = R.shape
    want = packed_loop(R, aid, order, 8)
    OUT, IN = (hub_cover.zero_stack(C, n, "cpu") for _ in range(2))
    before = KERNELS["hub_cover"].launches
    hub_cover.hub_loop(OUT, IN, R, R.transpose(1, 2).contiguous(), aid,
                       order, 8)
    assert torch.equal(OUT, want[0]) and torch.equal(IN, want[1])
    assert KERNELS["hub_cover"].launches == before


def test_hub_cover_checks_its_arguments():
    R, aid, order = build_inputs(20, 2)
    C, n, _ = R.shape
    OUT, IN = (hub_cover.zero_stack(C, n, "cpu") for _ in range(2))
    ok = (OUT, IN, R, aid, order)
    bad = [
        (OUT.float(), IN, R, aid, order),
        (OUT[:, :, :-4].contiguous(), IN, R, aid, order),
        (OUT, IN[:, :-1].contiguous(), R, aid, order),
        (OUT, IN, R[:, :, :-1].contiguous(), aid, order),
        (OUT, IN, R.float(), aid, order),
        (OUT, IN, R, aid.int(), order),
        (OUT, IN, R, aid, order[:-1]),
        (OUT, OUT, R, aid, order),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            hub_cover.hub_cover(*args, 0, 4)
    for offset, B in ((0, 0), (-1, 2), (n - 3, 4)):
        with pytest.raises(ValueError):
            hub_cover.hub_cover(*ok, offset, B)
    with pytest.raises(ValueError):
        hub_cover.hub_loop(OUT, IN, R, R, aid, order, 0)
    hub_cover._check_smem(8, hub_cover.stack_words(6541))   # AD, k = 2
    with pytest.raises(ValueError):        # a block's shared memory
        hub_cover._check_smem(40_000, hub_cover.stack_words(40_000))


# ------------------------------------------------------------------ #
# On the card: the kernel against the plain packed step
# ------------------------------------------------------------------ #
@needs_cuda
@pytest.mark.parametrize("hub_batch", HUB_BATCHES)
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("n", SIZES + [300])
def test_cuda_hub_loop_matches_plain(n, k, hub_batch):
    R, aid, order = build_inputs(n, k, seed=n + k)
    want = packed_loop(R, aid, order, hub_batch)
    Rc, aidc, orderc = R.cuda(), aid.cuda(), order.cuda()
    C = R.shape[0]
    OUT, IN = (hub_cover.zero_stack(C, n, "cuda") for _ in range(2))
    before = KERNELS["hub_cover"].launches
    hub_cover.hub_loop(OUT, IN, Rc, Rc.transpose(1, 2).contiguous(), aidc,
                       orderc, hub_batch)
    torch.cuda.synchronize()
    assert KERNELS["hub_cover"].launches == \
        before + 2 * -(-n // hub_batch)
    assert torch.equal(OUT.cpu(), want[0])
    assert torch.equal(IN.cpu(), want[1])


@needs_cuda
@pytest.mark.parametrize("density", [0.002, 0.02])
def test_cuda_hub_batch_at_the_advogato_k2_shape(density):
    """One batch of 8 hubs at C = 9, n = 6541 over random stacks (a build
    half done) and a random reach: the kernel equals the plain packed step
    run on the card."""
    C, n, B = 9, 6541, 8
    gen = torch.Generator(device="cuda").manual_seed(7)
    R = torch.rand((C, n, n), generator=gen, device="cuda") < 0.3
    RT = R.transpose(1, 2).contiguous()
    aid = torch.randperm(n, generator=gen, device="cuda")
    order = torch.argsort(aid)
    stacks = [hub_cover.pack_stack(
        torch.rand((C, n, n), generator=gen, device="cuda") < density)
        for _ in range(2)]
    before_batch = [s.clone() for s in stacks]
    want = [s.clone() for s in stacks]
    for rows, other, reach in ((0, 1, RT), (1, 0, R)):
        ref.hub_cover_ref(want[rows], want[other], reach, aid,
                          order[4000:4000 + B])
    before = KERNELS["hub_cover"].launches
    hub_cover.hub_batch_step(stacks[0], stacks[1], R, RT, aid, order, 4000,
                             B)
    torch.cuda.synchronize()
    assert KERNELS["hub_cover"].launches == before + 2
    assert torch.equal(stacks[0], want[0]) and torch.equal(stacks[1],
                                                           want[1])
    assert not torch.equal(want[0], before_batch[0])   # the batch added
    assert not torch.equal(want[1], before_batch[1])
