"""Label-guided frontier waves: the index build's, and the JAX surface's.

The CUDA kernel (``csrc/label_frontier.cu``) replaces the Pallas kernel
``repro/kernels/label_frontier.py::frontier_step_many`` and fuses the
``pack_bits`` hand-off that followed it in the build:

    out[r] = pack_bits(OR_u F[r, u] & A[labels[r], u, :])

The adjacency is held bit-packed (:func:`repro_torch.kernels.bitpack.
pack_adjacency`), so a wave reads only the packed rows of the frontier's
vertices and ORs whole words. The kernel is bound by those bytes: blocks
compact a frontier row's non-zeros from 16-byte loads with one block-wide
prefix sum, and a row's output words are split over several blocks when
there are few rows, so the card stays full.

Two more functions of ``repro/kernels/label_frontier.py`` keep its dense
float32 layout at their signatures:

* :func:`frontier_step` — one label for the whole batch, ``(F @ A[label])
  > 0``; it goes through the router of ``bool_matmul``
  (:func:`repro_torch.kernels.bool_semiring.route`: the split-K kernel at
  a few hundred rows) on the ``A[label]`` slice in place, with a launch
  count of its own.
* :func:`frontier_steps` — ``T`` chained waves with a row permutation
  after each; it packs the slices of ``A`` that ``labels`` names once and
  runs one wave of the kernel above per step, through an entry point that
  stores row ``r``'s result at row ``dst[t, r]``: packed between waves
  (the next wave compacts the words' set bits), unpacked into float32
  rows by the last wave only.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ._build import Kernel
from .bitpack import pack_slices
from .bool_semiring import _ARGS_MM, _check_operands, launch_matmul
from .ref import (frontier_step_many_ref, frontier_step_ref,
                  frontier_steps_ref)

KERNEL = Kernel("label_frontier", "rlc_frontier_step_many",
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                + [ctypes.c_void_p])
STEP_KERNEL = Kernel("bool_semiring", "rlc_bool_matmul", _ARGS_MM)
STEPS_KERNEL = Kernel("label_frontier", "rlc_frontier_wave_dst",
                      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                      + [ctypes.c_void_p])


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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL(frontier.data_ptr(), A_packed.data_ptr(), labels.data_ptr(),
               out.data_ptr(), R, Vp, W, stream)
    return out


def _label(label, num_labels: int) -> int:
    lab = int(label)
    if not 0 <= lab < num_labels:
        raise IndexError(f"label {lab} outside [0, {num_labels})")
    return lab


def frontier_step(frontier: torch.Tensor, A: torch.Tensor, label
                  ) -> torch.Tensor:
    """``next[b, v] = OR_u frontier[b, u] & A[label, u, v]``.

    frontier: ``(B, V)`` 0/1; A: ``(|L|, V, V)`` dense 0/1 of the same
    dtype (float32 or bfloat16) and device; label: an integer, range-
    checked. On a CPU device this runs :func:`repro_torch.kernels.ref.
    frontier_step_ref`; on a CUDA device it launches the kernel that
    ``bool_semiring.route`` picks on ``A[label]`` (no copy unless the
    route stages it) or raises."""
    if A.dim() != 3 or A.shape[1:] != (frontier.shape[-1],) * 2:
        raise ValueError(f"A must be (|L|, V, V) with V = "
                         f"{frontier.shape[-1]}")
    lab = _label(label, A.shape[0])
    _check_operands(frontier, A[lab])
    if frontier.device.type == "cpu":
        return frontier_step_ref(frontier, A, lab)
    out = torch.empty_like(frontier)
    launch_matmul(STEP_KERNEL, frontier, A[lab], out)
    return out


def _schedule(x, name: str, shape) -> np.ndarray:
    x = np.asarray(x)
    if x.shape != shape or x.dtype.kind not in "iu":
        raise ValueError(f"{name} must be {shape} integers")
    return x.astype(np.int32)


def packed_slices(labels: np.ndarray, num_labels: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The slices of ``A`` that a schedule names, and the schedule's
    labels renumbered into them: ``(used, local)`` with ``used`` the
    sorted distinct labels and ``used[local] == labels``."""
    used, local = np.unique(labels, return_inverse=True)
    if used.size and not (used[0] >= 0 and used[-1] < num_labels):
        raise IndexError(f"labels outside [0, {num_labels})")
    return used, local.reshape(np.shape(labels)).astype(np.int32)


def frontier_steps(frontier: torch.Tensor, A: torch.Tensor, labels, dst
                   ) -> torch.Tensor:
    """``T`` chained waves: after wave ``t``, row ``r``'s expansion along
    ``A[labels[t, r]]`` lands in row ``dst[t, r]``. No pruning between
    waves.

    frontier: ``(R, V)`` float32 0/1; A: ``(|L|, V, V)`` float32 0/1 on
    the same device; labels, dst: ``(T, R)`` host integer arrays, labels
    range-checked and each ``dst[t]`` checked to be a permutation. On a
    CPU device this runs :func:`repro_torch.kernels.ref.
    frontier_steps_ref`; on a CUDA device it packs the slices of ``A``
    that ``labels`` names and launches the kernel ``T`` times (frontiers
    bit-packed between waves), or raises."""
    dev = frontier.device
    if frontier.dtype != torch.float32 or frontier.dim() != 2:
        raise ValueError("frontier must be an (R, V) float32 tensor")
    R, V = frontier.shape
    if A.dtype != torch.float32 or A.device != dev or A.dim() != 3 \
            or A.shape[1:] != (V, V):
        raise ValueError(f"A must be an (|L|, {V}, {V}) float32 tensor on "
                         "the frontier's device")
    nl = A.shape[0]
    labels = np.asarray(labels)
    T = labels.shape[0] if labels.ndim == 2 else -1
    labels = _schedule(labels, "labels", (T, R))
    dst = _schedule(dst, "dst", (T, R))
    used, local = packed_slices(labels, nl)
    if (np.sort(dst, axis=1) != np.arange(R)).any():
        raise ValueError("each dst[t] must be a permutation of the rows")
    if dev.type == "cpu":
        return frontier_steps_ref(frontier, A, torch.from_numpy(labels),
                                  torch.from_numpy(dst))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if T == 0 or R == 0:
        return frontier.clone()
    Vp = -(-V // 128) * 128   # whole 16-byte units of words
    W = Vp // 32
    if Vp == V and frontier.is_contiguous() \
            and frontier.data_ptr() % 16 == 0:
        F = frontier          # the first wave only reads it
    else:
        F = frontier.new_zeros((R, Vp))
        F[:, :V] = frontier
    A_packed = pack_slices(A, used, Vp)
    sched = torch.from_numpy(np.stack([local, dst])).to(dev)
    words = [torch.empty((R, W), dtype=torch.int32, device=dev)
             for _ in range(min(T - 1, 2))]
    out = torch.empty((R, Vp), dtype=torch.float32, device=dev)
    src = F
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for t in range(T):
            last = t == T - 1
            nxt = out if last else words[t % 2]
            STEPS_KERNEL(src.data_ptr(), A_packed.data_ptr(),
                         sched[0, t].data_ptr(), sched[1, t].data_ptr(),
                         nxt.data_ptr(), R, Vp, W, int(t > 0), int(last),
                         stream)
            src = nxt
    return out if Vp == V else out[:, :V].contiguous()
