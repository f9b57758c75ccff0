"""OR-AND (boolean semiring) matrix products of the dense engine.

The CUDA kernel (``csrc/bool_semiring.cu``) replaces the Pallas kernels
``repro/kernels/bool_semiring.py::bool_matmul`` and ``::closure_step``:

    bool_matmul(a, b)  = (a @ b) > 0               in a's dtype
    closure_step(r)    = max(r, (r @ r) > 0)       fused, one launch

Operands are 0/1 values in float32 or bfloat16 on bf16 tensor cores with
float32 accumulation (exact for 0/1 operands). The kernel masks ragged
edges itself, so nothing is padded or sliced per call; rows whose pitch
is a multiple of 16 bytes load as 16-byte vectors, so callers that issue
many products (the dense engine) pad their matrices once to a multiple
of :data:`TILE`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._build import Kernel
from .ref import bool_matmul_ref, fused_closure_step_ref

_ARGS_MM = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
            + [ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_void_p])
MATMUL_KERNEL = Kernel("bool_semiring", "rlc_bool_matmul", _ARGS_MM)
CLOSURE_KERNEL = Kernel("bool_semiring", "rlc_closure_step",
                        [ctypes.c_void_p] * 2 + [ctypes.c_int]
                        + [ctypes.c_int64] * 2
                        + [ctypes.c_int, ctypes.c_void_p])
TILE = 128             # the kernel's output tile (kBM = kBN)
_MAX_ROW_TILES = 65535  # grid.y limit
_DTYPES = (torch.float32, torch.bfloat16)


def _check_matrix(x: torch.Tensor, name: str, dev: torch.device,
                  dtype: torch.dtype) -> None:
    if x.dim() != 2 or x.device != dev or x.dtype != dtype \
            or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D {dtype} tensor "
                         f"on {dev}")


def _check_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype not in _DTYPES:
        raise ValueError(f"operands must be float32 or bfloat16, not "
                         f"{a.dtype}")
    _check_matrix(a, "a", a.device, a.dtype)
    _check_matrix(b, "b", a.device, a.dtype)
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dimensions differ: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")


def _check_rows(M: int) -> None:
    if (M + TILE - 1) // TILE > _MAX_ROW_TILES:
        raise ValueError(f"{M} rows exceed the kernel's grid")


def launch_matmul(kernel: Kernel, a: torch.Tensor, b: torch.Tensor,
                  out: torch.Tensor) -> None:
    """Launch ``out = (a @ b) > 0`` through ``kernel`` (an entry point of
    ``rlc_bool_matmul``) on CUDA tensors the caller has checked; ``b`` may
    be a contiguous slice of a larger tensor (read in place)."""
    M, K = a.shape
    N = b.shape[1]
    if M == 0 or N == 0:
        return
    _check_rows(M)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        kernel(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
               a.stride(0), b.stride(0), out.stride(0),
               int(a.dtype == torch.bfloat16), stream)


def bool_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a @ b) > 0`` over OR-AND for 0/1 ``(M, K)`` and ``(K, N)``
    matrices of one dtype (float32 or bfloat16); the result has that
    dtype. On a CPU device this runs :func:`repro_torch.kernels.ref.
    bool_matmul_ref`; on a CUDA device it launches the kernel or raises."""
    _check_operands(a, b)
    if a.device.type == "cpu":
        return bool_matmul_ref(a, b)
    out = torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype,
                      device=a.device)
    launch_matmul(MATMUL_KERNEL, a, b, out)
    return out


def closure_step(r: torch.Tensor, out: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """One fused log-doubling step ``R | R @ R`` of a square 0/1 matrix.

    ``out`` (optional) receives the result and must not share storage
    with ``r``: every block of the kernel still reads ``r`` while others
    write. On a CPU device this runs :func:`repro_torch.kernels.ref.
    fused_closure_step_ref`; on a CUDA device it launches the kernel or
    raises."""
    _check_operands(r, r)
    n = r.shape[0]
    if r.shape != (n, n):
        raise ValueError(f"r must be square, not {tuple(r.shape)}")
    if out is None:
        out = torch.empty_like(r)
    else:
        _check_matrix(out, "out", r.device, r.dtype)
        if out.shape != r.shape:
            raise ValueError(f"out must be {tuple(r.shape)}")
        if out.untyped_storage().data_ptr() == \
                r.untyped_storage().data_ptr():
            raise ValueError("out shares storage with r")
    if r.device.type == "cpu":
        return out.copy_(fused_closure_step_ref(r))
    if n == 0:
        return out
    _check_rows(n)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        CLOSURE_KERNEL(r.data_ptr(), out.data_ptr(), n, r.stride(0),
                       out.stride(0), int(r.dtype == torch.bfloat16),
                       stream)
    return out
