"""Batched RLC query join (Algorithm 1 on the padded device rows).

The CUDA kernel (``csrc/mergejoin.cu``) replaces the Pallas kernel
``repro/kernels/mergejoin.py::query_batch``. A group of
lanes (:func:`lane_group`) answers one query ``(s, t, mr)``: its
lanes load the four rows into registers (16-byte loads where
:func:`vector_rows` allows them), drop the entries whose MR differs, test
Case 2 (a direct entry) with one compare per register, and test Case 1
(a shared hub) by broadcasting each surviving out hub to the group. It
is bound by the bytes of the gathered rows (four ``E``-word rows per
query), not by its compares.

Query ids arrive from the host. The Pallas kernel never range-checks
``s - row_base``; this wrapper does (:func:`query_ids`), and copies the
ids to the device as one ``(3, Q)`` int32 array, so the kernel never
reads outside the row arrays.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ._build import Kernel
from .ref import mergejoin_ref

KERNEL = Kernel("mergejoin", "rlc_mergejoin",
                [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                + [ctypes.c_void_p])


def lane_group(E: int) -> Tuple[int, int]:
    """``(lanes, chunks)``: a query's group of lanes and the 16-byte chunks
    (4 entries) of each row that a lane holds. Eight lanes hold a row of
    up to 64 entries at once (one chunk a lane up to E = 32, two above);
    longer rows get the whole warp, one chunk a lane, in turns of 128
    entries beyond E = 128. The split was chosen by timing the
    alternatives on the H100 at the path's row lengths, E = 40 and 80
    (PERF.md)."""
    if E > 64:
        return 32, 1
    return 8, 1 if E <= 32 else 2


def vector_rows(E: int, arrays) -> bool:
    """Whether the kernel may read the rows with 16-byte loads: every row
    starts on a 16-byte boundary."""
    return E % 4 == 0 and all(a.data_ptr() % 16 == 0 for a in arrays)


def _rows(x, name: str, n_rows: int, base: int) -> np.ndarray:
    x = np.asarray(x)
    if x.ndim != 1 or x.dtype.kind not in "iu":
        raise ValueError(f"{name} must be a 1-D integer array")
    if x.size and not (x.min() - base >= 0 and x.max() - base < n_rows):
        raise IndexError(
            f"{name} - row_base outside the stored rows [0, {n_rows})")
    return x


def query_ids(s, t, mr, n_out: int, n_in: int, row_base_out: int = 0,
              row_base_in: int = 0) -> np.ndarray:
    """``(3, Q)`` int32 rows ``s, t, mr``, one host array for one copy.
    ``s - row_base_out`` must lie in ``[0, n_out)`` and ``t -
    row_base_in`` in ``[0, n_in)`` (IndexError otherwise)."""
    s = _rows(s, "s", n_out, row_base_out)
    t = _rows(t, "t", n_in, row_base_in)
    mr = np.asarray(mr)
    if mr.ndim != 1 or not (len(s) == len(t) == len(mr)):
        raise ValueError("s, t and mr must have one length")
    ids = np.empty((3, len(s)), np.int32)
    ids[0], ids[1], ids[2] = s, t, mr
    return ids


def query_batch(out_hub: torch.Tensor, out_mr: torch.Tensor,
                in_hub: torch.Tensor, in_mr: torch.Tensor, s, t, mr, *,
                row_base_out: int = 0, row_base_in: int = 0
                ) -> torch.Tensor:
    """``(Q,)`` bool answers on the rows' device.

    ``out_hub/out_mr`` and ``in_hub/in_mr`` are ``(rows, E)`` int32 padded
    rows (PAD = -1); ``s``, ``t``, ``mr`` are host integer arrays of
    global ids. Storage row = id - ``row_base_*``. On a CPU device this
    runs :func:`repro_torch.kernels.ref.mergejoin_ref`; on a CUDA device
    it launches the kernel or raises.
    """
    dev = out_hub.device
    arrays = (out_hub, out_mr, in_hub, in_mr)
    E = out_hub.shape[1]
    for a in arrays:
        if a.device != dev or a.dtype != torch.int32 or a.dim() != 2 \
                or a.shape[1] != E or not a.is_contiguous():
            raise ValueError("row arrays must be contiguous (rows, E) int32 "
                             "tensors on one device")
    if out_mr.shape != out_hub.shape or in_mr.shape != in_hub.shape:
        raise ValueError("hub and mr rows must have the same shape")
    ids = torch.from_numpy(query_ids(s, t, mr, out_hub.shape[0],
                                     in_hub.shape[0], row_base_out,
                                     row_base_in)).to(dev)
    if dev.type == "cpu":
        return mergejoin_ref(out_hub, out_mr, in_hub, in_mr, *ids,
                             row_base_out, row_base_in)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(ids.shape[1], dtype=torch.bool, device=dev)
    if out.numel():
        launch(arrays, ids, out, row_base_out, row_base_in)
    return out


def launch(arrays, ids: torch.Tensor, out: torch.Tensor,
           row_base_out: int = 0, row_base_in: int = 0) -> None:
    """One kernel launch on checked CUDA tensors: the four row arrays,
    the ``(3, Q)`` int32 ids and the ``(Q,)`` bool answers."""
    E = arrays[0].shape[1]
    dev = out.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL(*(a.data_ptr() for a in arrays), *(r.data_ptr() for r in ids),
               out.data_ptr(), ids.shape[1], E, int(row_base_out),
               int(row_base_in), *lane_group(E), int(vector_rows(E, arrays)),
               stream)
