"""OR-AND (boolean semiring) matrix products of the dense engine.

The CUDA kernels (``csrc/bool_semiring.cu``) replace the Pallas kernels
``repro/kernels/bool_semiring.py::bool_matmul`` and ``::closure_step``:

    bool_matmul(a, b)  = (a @ b) > 0               in a's dtype
    closure_step(r)    = max(r, (r @ r) > 0)       fused, one launch

Operands are 0/1 values in float32 or bfloat16, multiplied on bf16 tensor
cores with float32 accumulation (exact for 0/1 operands). Two kernels
share the entry points, and :func:`route` picks one from the shape:

* ``"wgmma"`` — TMA loads and ``wgmma`` in 128 x 256 output tiles, for
  products with many output tiles (the engine's square ``n = 6656``
  products); it reads bf16 operands whose base and row pitch are
  multiples of 16 bytes, so any other operand (float32, or an odd bf16
  pitch) first goes through a staging pass into a bf16 copy.
* ``"splitk"`` — 320 x 128 output tiles whose K steps are dealt out
  evenly to one block on each SM, for products with few output tiles
  (``frontier_step``'s 300 x 6656 rows); it streams the right operand as
  it is, float32 or bf16, when it is 16-byte aligned, and reads the left
  one (the few rows) as bf16, staged when it is float32 or
  unaligned.

Both kernels mask ragged edges themselves, so nothing is padded or
sliced per call.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ._build import Kernel
from .ref import bool_matmul_ref, fused_closure_step_ref

_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGS_MM = ([_PTR] * 3 + [_INT] * 3 + [_I64] * 3 + [_INT] * 2
            + [_PTR, _I64, _PTR, _I64, _PTR])
MATMUL_KERNEL = Kernel("bool_semiring", "rlc_bool_matmul", _ARGS_MM)
CLOSURE_KERNEL = Kernel("bool_semiring", "rlc_closure_step",
                        [_PTR] * 2 + [_INT] + [_I64] * 2 + [_INT] * 2
                        + [_PTR, _PTR, _I64, _PTR])
TILE = 128             # the output tile that the routing rule counts
SMS = 132              # streaming multiprocessors of an H100 SXM
_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL_IDS = {"wgmma": 0, "splitk": 1}


@dataclass(frozen=True)
class Route:
    """How one product runs: ``kernel`` (``"wgmma"`` or ``"splitk"``) and
    whether the left (``stage_a``) and right (``stage_b``) operands first
    go through the bf16 staging pass."""

    kernel: str
    stage_a: bool
    stage_b: bool


def route(M: int, N: int, K: int, dtype: torch.dtype,
          pitches: Sequence[int], bases: Sequence[int] = (0, 0)) -> Route:
    """Pick the kernel for an ``(M, K) @ (K, N)`` product of ``dtype``
    operands whose row pitches (``pitches``) and base addresses
    (``bases``) are given in bytes.

    The split-K kernel takes products with fewer ``TILE x TILE`` output
    tiles than two waves of the card's :data:`SMS` (and any ``K = 0``);
    the wgmma kernel takes the rest. An operand is staged where the chosen
    kernel cannot read it as it is: TMA needs a 16-byte-aligned base and
    row pitch, the wgmma kernel bf16 operands, and the split-K kernel a
    bf16 left operand."""
    ok_a, ok_b = (int(p) % 16 == 0 and int(b) % 16 == 0
                  for p, b in zip(pitches, bases))
    not_bf16 = dtype != torch.bfloat16
    tiles = math.ceil(M / TILE) * math.ceil(N / TILE)
    if tiles < 2 * SMS or K == 0:
        return Route("splitk", not_bf16 or not ok_a, not ok_b)
    return Route("wgmma", not_bf16 or not ok_a, not_bf16 or not ok_b)


def staged_pitch(cols: int) -> int:
    """Row pitch (elements) of an operand's bf16 staging copy: a multiple
    of 8 elements, 16 bytes."""
    return -(-cols // 8) * 8


def _staging(rows: int, cols: int, dev: torch.device) -> torch.Tensor:
    return torch.empty((rows, staged_pitch(cols)), dtype=torch.bfloat16,
                       device=dev)


def route_of(a: torch.Tensor, b: torch.Tensor) -> Route:
    """The :func:`route` of the product ``a @ b``."""
    size = a.element_size()
    return route(a.shape[0], b.shape[1], a.shape[1], a.dtype,
                 (a.stride(0) * size, b.stride(0) * size),
                 (a.data_ptr(), b.data_ptr()))


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


def _check_dims(M: int, N: int, K: int) -> None:
    if max(M, N, K) >= 2 ** 31:
        raise ValueError(f"a ({M}, {K}) @ ({K}, {N}) product exceeds the "
                         f"kernels' 32-bit sizes")


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def launch_matmul(kernel: Kernel, a: torch.Tensor, b: torch.Tensor,
                  out: torch.Tensor) -> None:
    """Launch ``out = (a @ b) > 0`` through ``kernel`` (an entry point of
    ``rlc_bool_matmul``) on CUDA tensors the caller has checked, by the
    :func:`route` of their shape; ``b`` may be a contiguous slice of a
    larger tensor (read in place unless the route stages it)."""
    M, K = a.shape
    N = b.shape[1]
    if M == 0 or N == 0:
        return
    _check_dims(M, N, K)
    rt = route_of(a, b)
    sa = _staging(M, K, a.device) if rt.stage_a else None
    sb = _staging(K, N, a.device) if rt.stage_b else None
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        kernel(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
               a.stride(0), b.stride(0), out.stride(0),
               int(a.dtype == torch.bfloat16), _KERNEL_IDS[rt.kernel],
               _ptr(sa), staged_pitch(K), _ptr(sb), staged_pitch(N), stream)


def bool_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a @ b) > 0`` over OR-AND for 0/1 ``(M, K)`` and ``(K, N)``
    matrices of one dtype (float32 or bfloat16); the result has that
    dtype. On a CPU device this runs :func:`repro_torch.kernels.ref.
    bool_matmul_ref`; on a CUDA device it launches the kernel that
    :func:`route` picks, or raises."""
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
    fused_closure_step_ref`; on a CUDA device it launches the kernel that
    :func:`route` picks (staging ``r`` once, where it stages), or
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
    _check_dims(n, n, n)
    rt = route_of(r, r)
    sr = _staging(n, n, r.device) if rt.stage_a or rt.stage_b else None
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        CLOSURE_KERNEL(r.data_ptr(), out.data_ptr(), n, r.stride(0),
                       out.stride(0), int(r.dtype == torch.bfloat16),
                       _KERNEL_IDS[rt.kernel],
                       _ptr(sr) if rt.stage_a else None,
                       _ptr(sr) if rt.stage_b else None, staged_pitch(n),
                       stream)
    return out
