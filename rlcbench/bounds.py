"""Peaks of the card and the work each roofline counts.

The work comes from the algorithm's shapes alone, never from the dtype or
the kernels a version of the program happens to use, so that every
implementation of the same build is held to the same bound.

Peaks: NVIDIA H100 SXM data sheet, dense rates without sparsity, at its
700 W power limit. ``TENSOR_OPS_PER_S`` is the card's highest published
dense tensor rate (fp8 / int8), so that no tensor-core implementation of
a 0/1 product can read over 100 %; against the bf16 rate (989 TFLOP/s) a
share reads twice as high.
"""
from __future__ import annotations

import math
from typing import Iterable, Tuple

HBM_BYTES_PER_S = 3.35e12      # device memory rate
TENSOR_OPS_PER_S = 1979e12     # fp8 / int8 dense tensor-core rate


def bound_s(nbytes: float, ops: float,
            ops_per_s: float = TENSOR_OPS_PER_S) -> Tuple[float, str]:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over ``ops_per_s``, with which of
    the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "ops")


def doubling_steps(n: int) -> int:
    """Squarings that close a reach over ``n`` vertices: ``ceil(log2 n)``
    (a shortest ``L+`` path repeats ``L`` at most ``n`` times)."""
    return max(1, math.ceil(math.log2(max(n, 2))))


def reach_ops(mr_lengths: Iterable[int], n: int) -> float:
    """Operations of the all-MR reach over ``n`` vertices: for an MR of
    length ``m``, ``m - 1`` chain products and ``ceil(log2 n)`` doubling
    products, each ``2 n^3``."""
    products = sum(m - 1 + doubling_steps(n) for m in mr_lengths)
    return 2.0 * n ** 3 * products


def reach_bound_s(mr_lengths: Iterable[int], n: int) -> float:
    """The reach's products at the tensor rate (operations bound them: each
    product reads ``n^2`` bits twice and writes ``n^2``)."""
    return bound_s(0.0, reach_ops(mr_lengths, n))[0]


def hub_loop_bound_s(C: int, n: int, hub_batch: int) -> Tuple[float, str]:
    """The condensed build's coverage products over all hub batches. Each
    batch of ``B`` hubs reads the two ``(C, n, n)`` entry stacks once and
    its ``(C, n, B)`` operands, at one bit per 0/1 entry, and computes two
    ``(C, n, n) x (C, n, B)`` products of ``2 C n^2 B`` operations each."""
    nbytes = ops = 0.0
    for start in range(0, n, hub_batch):
        B = min(hub_batch, n - start)
        nbytes += 2 * C * n * n / 8 + 2 * C * n * B / 8
        ops += 2 * (2.0 * C * n * n * B)
    return bound_s(nbytes, ops)
