"""One label-guided frontier wave of the index build, bit-packed output.

The CUDA kernel (``csrc/label_frontier.cu``) replaces the Pallas kernel
``repro/kernels/label_frontier.py::frontier_step_many`` and fuses the
``pack_bits`` hand-off that followed it in the build:

    out[r] = pack_bits(OR_u F[r, u] & A[labels[r], u, :])

The adjacency is held bit-packed (:func:`repro_torch.kernels.bitpack.
pack_adjacency`), so a wave reads only the packed rows of the frontier's
vertices and ORs whole words. The kernel is bound by those bytes; one
block per frontier row compacts the row's non-zeros and keeps its result
words in shared memory.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import Kernel
from .ref import frontier_step_many_ref

KERNEL = Kernel("label_frontier", "rlc_frontier_step_many",
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                + [ctypes.c_void_p])
_CHUNK = 4096  # frontier columns compacted per pass (kChunk in the source)


def frontier_step_many(frontier: torch.Tensor, A_packed: torch.Tensor,
                       labels) -> torch.Tensor:
    """``(R, Vp // 32)`` int32 words of the next frontier.

    frontier: ``(R, Vp)`` float32 0/1 (the reference's input contract);
    A_packed: ``(|L|, Vp, Vp // 32)`` int32 on the same device; labels:
    host integer array of ``R`` label ids, range-checked before the copy.
    On a CPU device this runs
    :func:`repro_torch.kernels.ref.frontier_step_many_ref`; on a CUDA
    device it launches the kernel or raises.
    """
    dev = frontier.device
    if frontier.dtype != torch.float32 or frontier.dim() != 2 \
            or not frontier.is_contiguous():
        raise ValueError("frontier must be a contiguous (R, Vp) float32 "
                         "tensor")
    R, Vp = frontier.shape
    nl = A_packed.shape[0]
    W = Vp // 32
    if A_packed.device != dev or A_packed.dtype != torch.int32 \
            or A_packed.shape != (nl, Vp, W) or Vp % 32 \
            or not A_packed.is_contiguous():
        raise ValueError(f"A_packed must be a contiguous ({nl}, {Vp}, {W}) "
                         "int32 tensor on the frontier's device")
    labels = np.asarray(labels)
    if labels.shape != (R,) or labels.dtype.kind not in "iu":
        raise ValueError(f"labels must be {R} integers")
    if R and not (labels.min() >= 0 and labels.max() < nl):
        raise IndexError(f"labels outside [0, {nl})")
    labels = torch.from_numpy(labels.astype(np.int32)).to(dev)
    if dev.type == "cpu":
        return frontier_step_many_ref(frontier, A_packed, labels)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((R, W), dtype=torch.int32, device=dev)
    if R == 0:
        return out
    if 4 * (W + _CHUNK) > 48 * 1024:
        raise ValueError(f"Vp={Vp} exceeds the kernel's shared memory")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL(frontier.data_ptr(), A_packed.data_ptr(), labels.data_ptr(),
               out.data_ptr(), R, Vp, W, stream)
    return out
