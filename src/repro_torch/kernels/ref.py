"""Plain PyTorch versions of the hand-written kernels.

Each function is the semantic ground truth of one kernel in this package,
ported from ``repro/kernels/ref.py``: the wrappers run it for tensors that
lie on the CPU, and the comparisons on the card hold each kernel against
it bit for bit (everything here is OR-AND over 0/1 values or integer
compares, so equality is exact). The float32 products sum 0/1 values, so
they are exact with or without TF32 (0 and 1 are exact in it, and the
sums stay far below 2**24); PyTorch's default, TF32 off, is assumed.

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


def bool_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """OR-AND semiring product of 0/1 matrices, in ``a``'s dtype
    (float32 accumulation, as ``preferred_element_type`` in the JAX
    reference)."""
    return (torch.matmul(a.float(), b.float()) > 0).to(a.dtype)


def fused_closure_step_ref(r: torch.Tensor) -> torch.Tensor:
    """One log-doubling step ``R | R @ R``."""
    return torch.maximum(r, bool_matmul_ref(r, r))


def bitpack_matmul_ref(a: torch.Tensor, b_packed: torch.Tensor
                       ) -> torch.Tensor:
    """``out[m, w] = OR_k (a[m, k] > 0 ? b_packed[k, w] : 0)``, bitwise.

    a: ``(M, K)`` float32; b_packed: ``(K, W)`` int32 words. The reference
    ORs the masked words over K through an ``(M, K, W)`` intermediate; this
    computes the same bits as one float32 product of the 0/1 mask with the
    unpacked words (a bit is set iff some selected row has it), which
    needs ``(K, 32 W)`` instead of ``(M, K, W)`` elements."""
    mask = (a > 0).float()
    return pack_bits(mask @ unpack_bits(b_packed))


def frontier_step_ref(frontier: torch.Tensor, A: torch.Tensor,
                      label: int) -> torch.Tensor:
    """Product-automaton step: ``next[b, v] = OR_u frontier[b, u] &
    A[label, u, v]``."""
    return bool_matmul_ref(frontier, A[label])


def frontier_steps_ref(frontier: torch.Tensor, A: torch.Tensor,
                       labels: torch.Tensor, dst: torch.Tensor
                       ) -> torch.Tensor:
    """``T`` chained waves: wave ``t`` advances row ``r`` along
    ``A[labels[t, r]]`` and its result lands in row ``dst[t, r]`` (each
    ``dst[t]`` a permutation), as ``lax.scan`` over ``frontier_step_many``
    in the JAX package.

    frontier: ``(R, V)``; A: ``(|L|, V, V)``; labels, dst: ``(T, R)``."""
    F = frontier
    for labs, d in zip(labels.long().tolist(), dst.long().tolist()):
        G = torch.empty_like(F)
        labs = torch.tensor(labs)
        for lab in torch.unique(labs).tolist():
            rows = torch.nonzero(labs == lab).flatten().to(F.device)
            G[rows] = bool_matmul_ref(F[rows], A[lab])
        F = torch.zeros_like(G)
        F[torch.tensor(d, device=F.device)] = G
    return F


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


def _bit(words: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Bit ``pos & 31`` of int32 ``words``, as bool (broadcasting)."""
    return ((words >> (pos & 31).to(torch.int32)) & 1).bool()


def hub_cover_ref(rows: torch.Tensor, other: torch.Tensor,
                  reach: torch.Tensor, aid: torch.Tensor, hubs: torch.Tensor
                  ) -> None:
    """One side of a hub batch of the condensed build on bit-packed entry
    stacks, updating ``rows`` in place.

    rows, other: ``(C, n, W)`` int32 words (bit ``j`` of word ``w`` is
    column ``32 * w + j``); reach: ``(C, n, n)`` 0/1, read at ``[c, h,
    y]``; aid: ``(n,)`` access ids; hubs: ``(B,)`` distinct vertex ids.
    For every row ``(c, y)`` and hub ``h``, every test against the rows as
    they were before the batch::

        cov1 = OR_x rows[c, y, x] & other[c, h, x]
        cov2 = bit h of rows[c, y];  cov3 = bit y of other[c, h]
        add  = reach[c, h, y] & aid[h] <= aid[y] & ~(cov1 | cov2 | cov3)

    and bit ``h`` of ``rows[c, y]`` is set where ``add`` holds. With
    ``(rows, other, reach) = (OUT, IN, R transposed)`` this is the backward
    side of :func:`repro_torch.core.dense._hub_batch_step`, with ``(IN,
    OUT, R)`` its forward side."""
    n = rows.shape[1]
    hubs = hubs.long()
    oh = other[:, hubs, :]                                   # (C, B, W)
    cov1 = torch.stack([(rows & oh[:, b:b + 1, :]).ne(0).any(-1)
                        for b in range(len(hubs))], dim=-1)  # (C, n, B)
    cov2 = _bit(rows[:, :, hubs >> 5], hubs)                 # (C, n, B)
    y = torch.arange(n, device=rows.device)
    cov3 = _bit(oh[:, :, y >> 5], y).transpose(1, 2)         # (C, n, B)
    to_h = reach[:, hubs, :].transpose(1, 2) != 0            # (C, n, B)
    pr2 = aid[hubs][None, :] <= aid[:, None]                 # (n, B)
    add = to_h & pr2[None] & ~(cov1 | cov2 | cov3)
    for b, h in enumerate(hubs.tolist()):
        bit = 1 << (h & 31)
        rows[:, :, h >> 5] |= torch.where(
            add[:, :, b], bit - 2 ** 32 if bit >= 2 ** 31 else bit,
            0).to(torch.int32)


def entry_masks_ref(words: torch.Tensor) -> torch.Tensor:
    """The MR masks of a bit-packed entry stack, one ``(vertex, hub)`` cell
    each.

    words: ``(C, n, W)`` int32 words (bit ``j`` of word ``w`` is column
    ``32 * w + j``). Returns ``(n, 32 W, ceil(C / 64))`` int64 masks: bit
    ``c % 64`` of word ``c // 64`` of ``masks[y, x]`` is bit ``x`` of
    ``words[c, y]``, bit 63 the sign bit. One MR's plane of bits at a
    time."""
    C, n, W = words.shape
    masks = torch.zeros((n, 32 * W, -(-C // 64)), dtype=torch.int64,
                        device=words.device)
    for c in range(C):
        bit = 1 << (c % 64)
        masks[:, :, c // 64] |= torch.where(
            unpack_bits(words[c], torch.bool),
            bit - 2 ** 64 if bit >= 2 ** 63 else bit, 0)
    return masks
