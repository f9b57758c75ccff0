"""Bit-packed frontier and adjacency layouts (32 vertices per int32 word).

The build's device waves never hold a dense adjacency stack: the label-
sliced adjacency is stored with its rows bit-packed, ``(|L|, Vp, Vp // 32)``
int32 words, and the frontier kernel writes its result in the same word
layout (:mod:`repro_torch.kernels.label_frontier`). Bit ``j`` of word
``w`` is column ``32 * w + j`` throughout — the layout of
``repro.kernels.bitpack.pack_bits``, with its uint32 words viewed as
int32. The torch ``pack_bits``/``unpack_bits`` live in
:mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["pack_adjacency", "unpack_rows"]


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


def unpack_rows(words: np.ndarray, V: int) -> np.ndarray:
    """Host-side unpack of ``(R, W)`` int32 words to an ``(R, V)`` bool
    array (the first ``V`` of the ``32 W`` columns)."""
    u = np.ascontiguousarray(words).view(np.uint32)
    bits = (u[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(len(u), -1)[:, :V].astype(bool)
