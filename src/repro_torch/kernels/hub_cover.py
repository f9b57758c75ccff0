"""The condensed build's hub loop on bit-packed entry stacks.

:func:`repro_torch.core.dense.build_condensed_device` keeps its entry
stacks ``OUT`` and ``IN`` on a CUDA device as ``(C, n, W)`` int32 words
(bit ``j`` of word ``w`` is column ``32 * w + j``, the layout of
:func:`repro_torch.kernels.ref.pack_bits`; ``W`` is ``ceil(n / 32)``
padded to a multiple of 4, so that rows load as 16-byte vectors), and runs
each hub batch as two launches of one kernel (``csrc/hub_cover.cu``, entry
point ``rlc_hub_cover``): the backward side updates ``OUT`` from ``IN`` and
the transposed reach, then the forward side updates ``IN`` from the new
``OUT`` and the reach. Each launch computes the batch's coverage products,
its masks and its new bits at once, reading one bit an entry where the
float32 ``torch.bmm`` of :func:`repro_torch.core.dense._hub_batch_step`
read 32. It replaces no Pallas kernel: the JAX package leaves these
products to XLA.

The plain version of one side is :func:`repro_torch.kernels.ref.
hub_cover_ref`; :func:`hub_cover` runs it for CPU tensors and launches the
kernel for CUDA tensors (or raises).

After the hub loop, :func:`entry_masks` (entry point ``rlc_entry_masks`` of
the same source, plain version :func:`repro_torch.kernels.ref.
entry_masks_ref`) turns a stack into one MR bit mask per ``(vertex,
hub)`` cell, so that the build downloads the non-zero cells, not one
coordinate triple per entry.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import Kernel
from .ref import entry_masks_ref, hub_cover_ref, pack_bits

__all__ = ["entry_masks", "hub_batch_step", "hub_cover", "hub_loop",
           "pack_stack", "stack_words", "zero_stack"]

KERNEL = Kernel("hub_cover", "rlc_hub_cover",
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                + [ctypes.c_void_p])
MASKS_KERNEL = Kernel("hub_cover", "rlc_entry_masks",
                      [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                      + [ctypes.c_void_p])

#: rows a block of the kernel owns (a multiple of its 32 rows at once;
#: timed on the H100 against 32 and 128)
ROWS_PER_BLOCK = 64
_HUBS = 8                  # hubs a pass of the kernel
_MAX_SMEM = 232_448        # shared memory a block may use on the H100


def stack_words(n: int) -> int:
    """Words a row of an ``n``-column packed stack: ``ceil(n / 32)``
    rounded up to a multiple of 4."""
    return -(-n // 128) * 4


def zero_stack(C: int, n: int, device) -> torch.Tensor:
    """An empty ``(C, n, stack_words(n))`` int32 entry stack."""
    return torch.zeros((C, n, stack_words(n)), dtype=torch.int32,
                       device=device)


def pack_stack(x: torch.Tensor) -> torch.Tensor:
    """``(C, n, n)`` 0/1 -> ``(C, n, stack_words(n))`` int32 words."""
    n = x.shape[-1]
    pad = 32 * stack_words(n) - n
    return pack_bits(torch.nn.functional.pad((x > 0).to(torch.uint8),
                                             (0, pad)))


def entry_masks(words: torch.Tensor) -> torch.Tensor:
    """``(C, n, W)`` int32 words -> ``(n, 32 W, ceil(C / 64))`` int64 MR
    masks: bit ``c % 64`` of word ``c // 64`` of ``masks[y, x]`` is bit
    ``x`` of ``words[c, y]`` (bit 63 is the sign bit). Columns at and past
    ``n`` are the padding's, zero for an entry stack. On a CPU device this
    runs the plain version; on a CUDA device it launches the kernel once
    or raises."""
    if words.dtype != torch.int32 or words.dim() != 3 \
            or not words.is_contiguous():
        raise ValueError("words must be a contiguous (C, n, W) int32 tensor")
    dev = words.device
    if dev.type == "cpu":
        return entry_masks_ref(words)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    C, n, W = words.shape
    masks = torch.empty((n, 32 * W, -(-C // 64)), dtype=torch.int64,
                        device=dev)
    if masks.numel():
        with torch.cuda.device(dev):
            MASKS_KERNEL(words.data_ptr(), masks.data_ptr(), C, n, W,
                         torch.cuda.current_stream(dev).cuda_stream)
    return masks


def _check_smem(B: int, W: int) -> None:
    """A block stages 8 hub rows and holds the new bits of its rows: the
    kernel's ``smem_bytes``, which must fit in one SM's shared memory."""
    if 12 * _HUBS + 4 * W * _HUBS + 4 * ROWS_PER_BLOCK * (-(-B // 32)) \
            > _MAX_SMEM:
        raise ValueError(f"a batch of {B} hubs over {W} words a row needs "
                         "more shared memory than a block has")


def _check(rows, other, reach, aid, order) -> None:
    dev = rows.device
    if rows.dtype != torch.int32 or rows.dim() != 3 \
            or not rows.is_contiguous():
        raise ValueError("rows must be a contiguous (C, n, W) int32 tensor")
    C, n, W = rows.shape
    if W != stack_words(n):
        raise ValueError(f"rows must have {stack_words(n)} words a row")
    if other.shape != rows.shape or other.dtype != torch.int32 \
            or other.device != dev or not other.is_contiguous():
        raise ValueError("other must be a contiguous int32 tensor shaped "
                         "and placed like rows")
    if reach.shape != (C, n, n) or reach.dtype not in (torch.bool,
                                                       torch.uint8) \
            or reach.device != dev or not reach.is_contiguous():
        raise ValueError(f"reach must be a contiguous ({C}, {n}, {n}) bool "
                         "or uint8 tensor on rows' device")
    for name, t in (("aid", aid), ("order", order)):
        if t.shape != (n,) or t.dtype != torch.int64 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({n},) int64 "
                             "tensor on rows' device")
    if rows.data_ptr() == other.data_ptr():
        raise ValueError("rows and other must be different stacks")


def hub_cover(rows: torch.Tensor, other: torch.Tensor, reach: torch.Tensor,
              aid: torch.Tensor, order: torch.Tensor, offset: int,
              B: int) -> None:
    """One side of the hub batch ``order[offset:offset + B]``, updating
    ``rows`` in place (see :func:`repro_torch.kernels.ref.hub_cover_ref`).
    On a CPU device this runs the plain version; on a CUDA device it
    launches the kernel once or raises."""
    _check(rows, other, reach, aid, order)
    n = rows.shape[1]
    if not (0 <= offset and 1 <= B and offset + B <= n):
        raise ValueError(f"hubs [{offset}, {offset + B}) outside [0, {n})")
    if rows.device.type == "cpu":
        hub_cover_ref(rows, other, reach, aid, order[offset:offset + B])
        return
    with torch.cuda.device(rows.device):
        _launcher(rows, other, reach, aid, order, B)(offset, B)


def hub_batch_step(OUT: torch.Tensor, IN: torch.Tensor, R: torch.Tensor,
                   RT: torch.Tensor, aid: torch.Tensor, order: torch.Tensor,
                   offset: int, B: int) -> None:
    """The packed counterpart of :func:`repro_torch.core.dense.
    _hub_batch_step` for hubs ``order[offset:offset + B]``: the backward
    side (``OUT`` from ``IN`` and ``RT``, the reach transposed), then the
    forward side (``IN`` from the updated ``OUT`` and ``R``)."""
    hub_cover(OUT, IN, RT, aid, order, offset, B)
    hub_cover(IN, OUT, R, aid, order, offset, B)


def hub_loop(OUT: torch.Tensor, IN: torch.Tensor, R: torch.Tensor,
             RT: torch.Tensor, aid: torch.Tensor, order: torch.Tensor,
             hub_batch: int) -> None:
    """Every hub batch of ``hub_batch`` hubs in ``order``, as
    :func:`hub_batch_step` each. The arguments are checked once; on a CUDA
    device each batch is then two launches and no torch operator."""
    _check(OUT, IN, RT, aid, order)
    _check(IN, OUT, R, aid, order)
    n = OUT.shape[1]
    if hub_batch < 1:
        raise ValueError(f"hub_batch must be >= 1, not {hub_batch}")
    if OUT.device.type == "cpu":
        for i in range(0, n, hub_batch):
            hub_batch_step(OUT, IN, R, RT, aid, order, i,
                           min(hub_batch, n - i))
        return
    with torch.cuda.device(OUT.device):
        max_B = min(hub_batch, n)
        backward = _launcher(OUT, IN, RT, aid, order, max_B)
        forward = _launcher(IN, OUT, R, aid, order, max_B)
        for i in range(0, n, hub_batch):
            B = min(hub_batch, n - i)
            backward(i, B)
            forward(i, B)


def _launcher(rows, other, reach, aid, order, max_B: int):
    """``launch(offset, B)``, ``B <= max_B``: one kernel launch on checked
    CUDA tensors, with the pointers, the stream and the block size taken
    once."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    C, n, W = rows.shape
    if rows.data_ptr() % 16 or other.data_ptr() % 16:
        raise ValueError("stacks must start on 16-byte boundaries")
    _check_smem(max_B, W)
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (rows.data_ptr(), other.data_ptr(), reach.data_ptr(),
            aid.data_ptr(), order.data_ptr())

    def launch(offset: int, B: int) -> None:
        KERNEL(*head, offset, B, C, n, W, ROWS_PER_BLOCK, stream)
    return launch
