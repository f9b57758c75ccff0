"""Bit-packed layouts (32 vertices per int32 word) and the packed product.

The build's device waves never hold a dense adjacency stack: the label-
sliced adjacency is stored with its rows bit-packed, ``(|L|, Vp, Vp // 32)``
int32 words, and the frontier kernel writes its result in the same word
layout (:mod:`repro_torch.kernels.label_frontier`). Bit ``j`` of word
``w`` is column ``32 * w + j`` throughout — the layout of
``repro.kernels.bitpack.pack_bits``, with its uint32 words viewed as
int32. The torch ``pack_bits``/``unpack_bits`` live in
:mod:`repro_torch.kernels.ref`.

:func:`bitpack_matmul` replaces the Pallas kernel
``repro/kernels/bitpack.py::bitpack_matmul``: an OR-AND product whose right
operand and output are packed words, launched from the frontier kernel's
source (``csrc/label_frontier.cu``, entry point ``rlc_bitpack_matmul``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import Kernel
from .ref import bitpack_matmul_ref

__all__ = ["bitpack_matmul", "pack_adjacency", "pack_slices",
           "unpack_rows"]

KERNEL = Kernel("label_frontier", "rlc_bitpack_matmul",
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                + [ctypes.c_void_p])


def pack_adjacency(src: np.ndarray, lab: np.ndarray, dst: np.ndarray,
                   num_labels: int, Vp: int, device) -> torch.Tensor:
    """``(num_labels, Vp, Vp // 32)`` int32 words with bit ``dst`` of row
    ``(lab, src)`` set for every edge — ``pack_bits`` of the dense 0/1
    stack ``A[lab, src, dst] = 1`` (:func:`repro_torch.kernels.ref.
    pack_bits`), built from the edge list on the host
    (a few MB where the dense float32 stack would take ``4 |L| Vp^2``
    bytes) and copied to ``device`` once."""
    if Vp % 32:
        raise ValueError(f"Vp={Vp} is not a multiple of 32")
    words = np.zeros((num_labels, Vp, Vp // 32), dtype=np.uint32)
    dst = np.asarray(dst, dtype=np.int64)
    np.bitwise_or.at(words, (np.asarray(lab, dtype=np.int64),
                             np.asarray(src, dtype=np.int64), dst >> 5),
                     np.left_shift(np.uint32(1), (dst & 31).astype(np.uint32)))
    return torch.from_numpy(words.view(np.int32)).to(device)


def pack_slices(A: torch.Tensor, labels: np.ndarray, Vp: int
                ) -> torch.Tensor:
    """``(len(labels), Vp, Vp // 32)`` int32 words: ``pack_bits`` of the
    ``(V, V)`` float32 0/1 slices ``A[labels]`` zero-padded to ``(Vp,
    Vp)`` (:func:`repro_torch.kernels.ref.pack_bits`'s layout), on
    ``A``'s device.

    Each slice is packed by the OR-AND product with the packed identity,
    ``bitpack_matmul(A[lab], I)``: row ``u`` ORs the identity rows of its
    non-zero columns, which sets exactly their bits. On a card that is
    one launch of the packed-product kernel a slice, reading the slice
    once (and counted as ``bitpack_matmul`` launches)."""
    V = A.shape[-1]
    if Vp % 32 or Vp < V:
        raise ValueError(f"Vp={Vp} must be a multiple of 32 and >= {V}")
    k = torch.arange(V, device=A.device)
    bit = torch.ones_like(k) << (k & 31)
    eye = torch.zeros((V, Vp // 32), dtype=torch.int32, device=A.device)
    eye[k, k >> 5] = torch.where(bit >= 2 ** 31, bit - 2 ** 32,
                                 bit).to(torch.int32)
    out = torch.zeros((len(labels), Vp, Vp // 32), dtype=torch.int32,
                      device=A.device)
    for i, lab in enumerate(np.asarray(labels).tolist()):
        out[i, :V] = bitpack_matmul(A[lab].contiguous(), eye)
    return out


def unpack_rows(words: np.ndarray, V: int) -> np.ndarray:
    """Host-side unpack of ``(R, W)`` int32 words to an ``(R, V)`` bool
    array (the first ``V`` of the ``32 W`` columns)."""
    u = np.ascontiguousarray(words).view(np.uint32)
    bits = (u[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(len(u), -1)[:, :V].astype(bool)


def bitpack_matmul(a: torch.Tensor, b_packed: torch.Tensor) -> torch.Tensor:
    """``out[m, w] = OR_k (a[m, k] > 0 ? b_packed[k, w] : 0)``, bitwise:
    the OR-AND product with the right operand and the output bit-packed.

    a: ``(M, K)`` float32; b_packed: ``(K, W)`` int32 words on the same
    device, K and W independent; out: ``(M, W)`` int32 words. On a CPU
    device this runs :func:`repro_torch.kernels.ref.bitpack_matmul_ref`;
    on a CUDA device it launches the kernel (``rlc_bitpack_matmul`` in
    ``csrc/label_frontier.cu``: blocks compact a row of ``a``'s positive
    columns and OR the selected words of ``b_packed``, a row's words split
    over several blocks when ``M`` is small) or raises."""
    dev = a.device
    if a.dtype != torch.float32 or a.dim() != 2 or not a.is_contiguous():
        raise ValueError("a must be a contiguous (M, K) float32 tensor")
    M, K = a.shape
    if b_packed.dtype != torch.int32 or b_packed.device != dev \
            or b_packed.dim() != 2 or b_packed.shape[0] != K \
            or not b_packed.is_contiguous():
        raise ValueError(f"b_packed must be a contiguous ({K}, W) int32 "
                         "tensor on a's device")
    W = b_packed.shape[1]
    if dev.type == "cpu":
        return bitpack_matmul_ref(a, b_packed)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((M, W), dtype=torch.int32, device=dev)
    if M == 0 or W == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL(a.data_ptr(), b_packed.data_ptr(), out.data_ptr(), M, K, W,
               stream)
    return out
