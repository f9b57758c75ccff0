"""Plain PyTorch versions of the hand-written kernels.

Each function is the semantic ground truth of one kernel in this package:
the wrappers run it for tensors that lie on the CPU, and the comparisons
on the card hold each kernel against it bit for bit (everything here is
OR-AND over 0/1 values or integer compares, so equality is exact).

Packed words are int32 bit patterns: bit ``j`` of word ``w`` is column
``32 * w + j``, the layout of ``repro.kernels.bitpack.pack_bits`` with its
uint32 words viewed as int32.
"""
from __future__ import annotations

import torch

from repro_torch.core.constants import PAD

_SHIFTS = torch.arange(32, dtype=torch.int64)


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """``(..., N)`` 0/1 -> ``(..., N // 32)`` int32 words."""
    n = x.shape[-1]
    if n % 32:
        raise ValueError(f"last dimension {n} is not a multiple of 32")
    bits = (x > 0).to(torch.int64).reshape(*x.shape[:-1], n // 32, 32)
    words = (bits << _SHIFTS.to(x.device)).sum(dim=-1)
    # the sum of distinct bits is their OR; fold bit 31 into the sign
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def unpack_bits(xp: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``(..., W)`` int32 words -> ``(..., 32 * W)`` 0/1 of ``dtype``."""
    bits = (xp.to(torch.int64)[..., None] >> _SHIFTS.to(xp.device)) & 1
    return bits.reshape(*xp.shape[:-1], xp.shape[-1] * 32).to(dtype)


def mergejoin_ref(out_hub, out_mr, in_hub, in_mr, s, t, mr,
                  row_base_out: int = 0, row_base_in: int = 0
                  ) -> torch.Tensor:
    """Batched Algorithm 1 (Case 2 + Case 1 join) -> ``(Q,)`` bool.

    Rows are gathered at storage row ``id - row_base``; compares use the
    global ids in ``s``/``t``."""
    so = s.long() - row_base_out
    ti = t.long() - row_base_in
    oh, om = out_hub[so], out_mr[so]
    ih, im = in_hub[ti], in_mr[ti]
    q_mr = mr[:, None]
    case2 = ((oh == t[:, None]) & (om == q_mr)).any(dim=1) | \
        ((ih == s[:, None]) & (im == q_mr)).any(dim=1)
    o_ok = (om == q_mr) & (oh != PAD)
    i_ok = (im == q_mr) & (ih != PAD)
    join = (oh[:, :, None] == ih[:, None, :]) & \
        o_ok[:, :, None] & i_ok[:, None, :]
    return case2 | join.any(dim=(1, 2))


def frontier_step_many_ref(frontier: torch.Tensor, A_packed: torch.Tensor,
                           labels: torch.Tensor) -> torch.Tensor:
    """``pack_bits((frontier @ A[labels]) > 0)`` row by row, with ``A``
    the dense unpacking of ``A_packed``.

    frontier: ``(R, Vp)`` float32 0/1; A_packed: ``(|L|, Vp, Vp // 32)``
    int32; labels: ``(R,)`` int. Rows that share a label go through one
    float32 matrix product against that label's dense slice (exact: the
    sums are integers far below 2**24)."""
    R, Vp = frontier.shape
    out = torch.zeros((R, Vp // 32), dtype=torch.int32,
                      device=frontier.device)
    labels = labels.to(frontier.device).long()
    for lab in torch.unique(labels).tolist():
        rows = torch.nonzero(labels == lab).flatten()
        dense = unpack_bits(A_packed[lab])
        out[rows] = pack_bits(frontier[rows] @ dense)
    return out
