"""The kernel surface of ``repro/kernels/ops.py``, on torch tensors.

The same functions and arguments as the JAX package's padded-dispatch
wrappers, less ``interpret`` and the block sizes: each CUDA kernel masks
its own ragged edges and has its tile fixed at compile time, so nothing
is padded or sliced here. CPU tensors go to the plain versions
(:mod:`repro_torch.kernels.ref`); CUDA tensors go to the kernels, or the
call raises. Packed words are int32 bit patterns where the JAX package
has uint32.
"""
from __future__ import annotations

from .bitpack import bitpack_matmul
from .bool_semiring import bool_matmul, closure_step
from .label_frontier import frontier_step
from .mergejoin import query_batch
from .ref import pack_bits, unpack_bits

__all__ = ["bitpack_matmul", "bool_matmul", "closure_step", "frontier_step",
           "mergejoin_query", "pack_bits", "unpack_bits"]


def mergejoin_query(out_hub, out_mr, in_hub, in_mr, s, t, mr,
                    row_base_out: int = 0, row_base_in: int = 0):
    """Batched Algorithm 1: :func:`repro_torch.kernels.mergejoin.
    query_batch` (``s``, ``t``, ``mr`` are host integer arrays)."""
    return query_batch(out_hub, out_mr, in_hub, in_mr, s, t, mr,
                       row_base_out=row_base_out, row_base_in=row_base_in)
