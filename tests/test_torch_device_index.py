"""Port DeviceIndex vs the JAX package's DeviceIndex on one carried index.

One reference-built frozen index is carried across with
``frozen_from_arrays``; both packages lay it out at the default row
length (a shorter one truncates rows in both) and must give identical
answers in every query mode — dense, sorted and kernel (the Pallas kernel
interpreted, the port's plain version on CPU tensors) — full-height and
row-windowed.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.build import build_rlc_index as j_build  # noqa: E402
from repro.core.device_index import DeviceIndex as JDeviceIndex  # noqa: E402
from repro.core.minimum_repeat import mr_id_space  # noqa: E402
from repro.graphgen import erdos_renyi  # noqa: E402
from repro_torch.convert import frozen_from_arrays  # noqa: E402
from repro_torch.core.device_index import DeviceIndex  # noqa: E402

FIELDS = ("aid", "out_indptr", "out_hub", "out_mr", "in_indptr", "in_hub",
          "in_mr")


@pytest.fixture(scope="module")
def carried():
    g = erdos_renyi(48, 3.5, 3, seed=4)
    ids = mr_id_space(3, 2)
    jfrozen = j_build(g, 2, backend="numpy").freeze(ids)
    tfrozen = frozen_from_arrays(jfrozen.num_vertices, jfrozen.k,
                                 *(getattr(jfrozen, f) for f in FIELDS))
    return jfrozen, tfrozen, ids


def queries(n, lo, hi, Q, C, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(lo, hi, Q), rng.integers(lo, hi, Q),
            rng.integers(0, C, Q))


@pytest.mark.parametrize("rows", [None, (12, 36)], ids=["full", "window"])
def test_layout_equal(carried, rows):
    jfrozen, tfrozen, ids = carried
    if rows is not None:
        jfrozen, tfrozen = (f.slice_rows(*rows) for f in (jfrozen, tfrozen))
    j = JDeviceIndex.from_frozen(jfrozen, ids, rows=rows)
    t = DeviceIndex.from_frozen(tfrozen, ids, rows=rows, device="cpu")
    assert (t.row_len, t.num_mrs, t.row_lo) == (j.row_len, j.num_mrs,
                                                j.row_lo)
    for f in ("out_hub", "out_mr", "in_hub", "in_mr", "out_key", "in_key"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)))


@pytest.mark.parametrize("rows", [None, (12, 36)], ids=["full", "window"])
@pytest.mark.parametrize("mode", ["dense", "sorted", "kernel"])
def test_answers_equal(carried, mode, rows):
    jfrozen, tfrozen, ids = carried
    n = jfrozen.num_vertices
    lo, hi = (0, n) if rows is None else rows
    if rows is not None:
        jfrozen, tfrozen = (f.slice_rows(*rows) for f in (jfrozen, tfrozen))
    j = JDeviceIndex.from_frozen(jfrozen, ids, rows=rows)
    t = DeviceIndex.from_frozen(tfrozen, ids, rows=rows, device="cpu")
    # the interpreted Pallas kernel takes one grid step per query
    Q = 64 if mode == "kernel" else 2000
    s, tt, m = queries(n, lo, hi, Q, len(ids), seed=Q + lo)
    if mode == "kernel":
        want = j.query_batch(s, tt, m, use_pallas=True)
        got = t.query_batch(s, tt, m, use_kernel=True)
    else:
        want = j.query_batch(s, tt, m, method=mode)
        got = t.query_batch(s, tt, m, method=mode)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, tfrozen.query_batch(s, tt, m))


def test_row_digests_equal(carried):
    jfrozen, tfrozen, ids = carried
    j = JDeviceIndex.from_frozen(jfrozen, ids)
    t = DeviceIndex.from_frozen(tfrozen, ids, device="cpu")
    v = np.array([0, 5, 47, 5])
    for a, b in ((t.gather_out_rows(v), j.gather_out_rows(v)),
                 (t.gather_in_rows(v), j.gather_in_rows(v))):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert t.query(3, 7, (0,)) == j.query(3, 7, (0,))


@pytest.mark.parametrize("method", ["dense", "sorted"])
@pytest.mark.parametrize("side", ["s", "t"])
@pytest.mark.parametrize("ids", [range(0, 20), range(40, 60)],
                         ids=["below", "above"])
def test_windowed_joins_reject_ids_outside_the_rows(method, side, ids):
    """A row-windowed layout raises ``IndexError`` for an id outside its
    window in the dense and sorted joins, as the kernel's wrapper does
    (``test_torch_kernels.py::test_wrappers_reject_ids_outside_the_rows``),
    instead of reading another vertex's row or faulting on the card."""
    from repro_torch.build import build_rlc_index as t_build
    from repro_torch.graphgen import erdos_renyi as t_er
    g = t_er(60, 3.0, 2, seed=1)
    ids_ = mr_id_space(2, 2)
    frozen = t_build(g, 2, backend="numpy").freeze(ids_)
    d = DeviceIndex.from_frozen(frozen.slice_rows(20, 40), ids_,
                                rows=(20, 40), device="cpu")
    inside = np.full(1, 30)
    for v in ids:
        q = dict(s=inside, t=inside, mr=np.zeros(1, np.int64))
        q[side] = np.array([v])
        with pytest.raises(IndexError):
            d.query_batch(q["s"], q["t"], q["mr"], method=method)
    # ids inside the window still answer as the CSR join does
    s = np.arange(20, 40)
    t = np.full(20, 30)
    mr = np.zeros(20, np.int64)
    np.testing.assert_array_equal(d.query_batch(s, t, mr, method=method),
                                  frozen.query_batch(s, t, mr))
