"""Batched RLC query join (Algorithm 1 on the padded device rows).

The CUDA kernel (``csrc/mergejoin.cu``) replaces the Pallas kernel
``repro/kernels/mergejoin.py::query_batch``. One warp answers one query
``(s, t, mr)``: it stages ``L_in(t)`` in shared memory, its lanes stride
over ``L_out(s)`` and the warp votes with ``__any_sync``. Case 2 (a
direct entry) and Case 1 (a shared hub) are decided in the same pass.
It is bound by the bytes of the gathered rows (four ``E``-word rows per
query), not by its ``E x E`` compares.

Query ids arrive from the host. The Pallas kernel never range-checks
``s - row_base``; this wrapper does, before the ids are copied to the
device, so the kernel never reads outside the row arrays.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import Kernel
from .ref import mergejoin_ref

KERNEL = Kernel("mergejoin", "rlc_mergejoin",
                [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                + [ctypes.c_void_p])
_WARPS = 8  # queries per block (kWarps in csrc/mergejoin.cu)


def _rows(x, name: str, n_rows: int, base: int) -> np.ndarray:
    x = np.asarray(x)
    if x.ndim != 1 or x.dtype.kind not in "iu":
        raise ValueError(f"{name} must be a 1-D integer array")
    if x.size and not (x.min() - base >= 0 and x.max() - base < n_rows):
        raise IndexError(
            f"{name} - row_base outside the stored rows [0, {n_rows})")
    return x.astype(np.int32)


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
    s = _rows(s, "s", out_hub.shape[0], row_base_out)
    t = _rows(t, "t", in_hub.shape[0], row_base_in)
    mr = np.asarray(mr).astype(np.int32)
    if not (len(s) == len(t) == len(mr)):
        raise ValueError("s, t and mr must have one length")
    s, t, mr = (torch.from_numpy(a).to(dev) for a in (s, t, mr))
    if dev.type == "cpu":
        return mergejoin_ref(out_hub, out_mr, in_hub, in_mr, s, t, mr,
                             row_base_out, row_base_in)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    Q = len(s)
    out = torch.empty(Q, dtype=torch.bool, device=dev)
    if Q == 0:
        return out
    smem = 4 * 2 * E * _WARPS
    if smem > 48 * 1024:
        raise ValueError(f"row length E={E} exceeds the kernel's shared "
                         "memory")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL(*(a.data_ptr() for a in arrays), s.data_ptr(), t.data_ptr(),
               mr.data_ptr(), out.data_ptr(), Q, E, int(row_base_out),
               int(row_base_in), stream)
    return out
