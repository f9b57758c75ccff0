"""Distributed RLC index build + query serving over a device mesh (the
JAX package's ``repro/core/distributed.py``, DESIGN §3/§5).

The reference runs one JAX controller over a ``("pod", "data")`` mesh;
the port is SPMD over :mod:`torch.distributed`: every rank runs the same
calls on its own device, and the mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` over the world's
ranks.

Layout
------
* adjacency / reachability matrices: rows (source vertices) sharded over
  the ``data`` mesh axis, columns whole; ``n`` is padded to a multiple of
  ``TILE x data`` (zero rows and columns add no paths), so every rank
  holds an equal, kernel-tile-aligned row block and the padding is cut
  away before a result leaves.
* semiring products: row-parallel — each rank holds a row block of the
  left operand, all-gathers the right operand's row blocks along ``data``
  once a product, and computes its row block of the product with the
  ``bool_matmul`` kernel (:mod:`repro_torch.kernels.bool_semiring`; its
  plain version on the CPU), in bf16 as :class:`~.dense.DenseEngine`
  keeps its stacks (exact for 0/1 operands accumulated in float32).
* queries: embarrassingly parallel — each rank answers its contiguous
  shard of the batch over every mesh axis through its replica of the
  frozen index (the merge-join kernel on a card), and the answers are
  all-gathered.

Every rank returns the same full result, as the reference's controller
returns it.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.kernels import bool_semiring, mergejoin

from .dense import (DenseEngine, _n_iters, build_condensed_device,
                    mr_step_matrix, plus_closure)
from .devices import resolve_device
from .graph import LabeledGraph
from .minimum_repeat import enumerate_mrs
from .rlc_index import RLCIndex

__all__ = ["RowParallelMatmul", "distributed_all_mr_reach",
           "distributed_build", "distributed_plus_closure",
           "distributed_query_batch", "init_world", "make_rlc_mesh",
           "mesh_device", "shmap_bool_matmul"]


def init_world(device="cuda") -> bool:
    """Start a world of one rank over a ``HashStore`` when no process
    group is initialised — NCCL on a CUDA device (after
    ``torch.cuda.set_device``), gloo on the CPU — and say whether it did.
    A failed NCCL start raises; nothing carries on over gloo."""
    if dist.is_initialized():
        return False
    dev = resolve_device(device)
    store = dist.HashStore()
    if dev.type == "cuda":
        index = (dev.index if dev.index is not None
                 else torch.cuda.current_device())
        torch.cuda.set_device(index)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                device_id=torch.device("cuda", index))
    else:
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    return True


def make_rlc_mesh(data: Optional[int] = None, pod: int = 1,
                  device="cuda") -> DeviceMesh:
    """A ``(pod, data)`` mesh over the world's ranks, axes ``("pod",
    "data")``; ``data`` defaults to ``world // pod``.

    With no process group initialised this starts a world of one rank
    over a ``HashStore`` — NCCL on a CUDA device (after
    ``torch.cuda.set_device``), gloo on the CPU — as JAX makes a mesh
    over the devices there are. Asking for ``cuda`` without a card
    raises, and so does a failed NCCL start: nothing carries on over
    gloo or on the CPU. In a world started by the caller, each rank must
    have set its CUDA device first. Tear down with
    ``torch.distributed.destroy_process_group()``."""
    dev = resolve_device(device)
    init_world(dev)
    world = dist.get_world_size()
    data = data or world // pod
    if pod < 1 or data < 1 or pod * data != world:
        raise ValueError(f"a ({pod}, {data}) mesh does not cover the "
                         f"world's {world} ranks")
    return init_device_mesh(dev.type, (pod, data),
                            mesh_dim_names=("pod", "data"))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``: its current CUDA device, or the
    CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# ------------------------------------------------------------------ #
# Row-parallel semiring matmul (manual collectives)
# ------------------------------------------------------------------ #
class RowParallelMatmul:
    """The OR-AND product with left rows sharded over ``axis``: called
    on this rank's row blocks ``a_blk`` (rows, K) and ``b_blk`` (K / p,
    N) of the two operands, it all-gathers ``b``'s blocks along ``axis``
    and returns this rank's row block of ``(a @ b) > 0`` from the
    ``bool_matmul`` kernel. Counts its all-gathers and the bytes they
    brought in (:attr:`all_gathers`, :attr:`gathered_bytes`)."""

    def __init__(self, mesh: DeviceMesh, axis: str = "data"):
        self.group = mesh.get_group(axis)
        self.size = mesh.size(mesh.mesh_dim_names.index(axis))
        self.rank = mesh.get_local_rank(axis)
        self.all_gathers = 0
        self.gathered_bytes = 0

    def gather_rows(self, blk: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The whole operand from every rank's equal block along
        ``dim``."""
        blk = blk.contiguous()
        parts: List[torch.Tensor] = [torch.empty_like(blk)
                                     for _ in range(self.size)]
        dist.all_gather(parts, blk, group=self.group)
        self.all_gathers += 1
        self.gathered_bytes += blk.numel() * blk.element_size() * self.size
        return parts[0] if self.size == 1 else torch.cat(parts, dim=dim)

    def __call__(self, a_blk: torch.Tensor, b_blk: torch.Tensor
                 ) -> torch.Tensor:
        return bool_semiring.bool_matmul(a_blk.contiguous(),
                                         self.gather_rows(b_blk))


def shmap_bool_matmul(mesh: DeviceMesh, axis: str = "data"
                      ) -> RowParallelMatmul:
    """The row-parallel OR-AND product over ``axis`` (the reference's
    ``shard_map`` product)."""
    return RowParallelMatmul(mesh, axis)


def distributed_plus_closure(M: torch.Tensor, mesh: DeviceMesh,
                             axis: str = "data",
                             n_iters: Optional[int] = None,
                             matmul: Optional[RowParallelMatmul] = None
                             ) -> torch.Tensor:
    """Log-doubling closure ``R = R | R @ R`` of this rank's row block
    ``M`` (rows, n): :func:`~.dense.plus_closure` with the row-parallel
    product; returns the block of ``M^+``. ``n_iters`` defaults to the
    reference's count for ``n``."""
    return plus_closure(M, n_iters,
                        matmul=matmul or shmap_bool_matmul(mesh, axis))


def _label_rows(graph: LabeledGraph, n_pad: int, lo: int, rows: int,
                dev: torch.device) -> torch.Tensor:
    """Rows ``[lo, lo + rows)`` of the zero-padded (|L|, n_pad, n_pad)
    label adjacency stack, in bf16 on ``dev``."""
    A = torch.zeros((graph.num_labels, rows, n_pad), dtype=torch.bfloat16,
                    device=dev)
    e = np.asarray(graph.edges, np.int64)
    e = e[(e[:, 0] >= lo) & (e[:, 0] < lo + rows)] if len(e) else e
    if len(e):
        e = torch.from_numpy(e).to(dev)
        A[e[:, 1], e[:, 0] - lo, e[:, 2]] = 1
    return A


def distributed_all_mr_reach(graph: LabeledGraph, k: int, mesh: DeviceMesh,
                             axis: str = "data",
                             matmul: Optional[RowParallelMatmul] = None
                             ) -> np.ndarray:
    """(C, n, n) numpy bool ``R_L`` stack computed with row-sharded
    semiring products; every rank returns the whole stack. ``matmul``
    (a :func:`shmap_bool_matmul` over ``axis``) lets the caller read its
    all-gather counts."""
    mm = matmul or shmap_bool_matmul(mesh, axis)
    dev = mesh_device(mesh)
    mrs = enumerate_mrs(graph.num_labels, k)
    n = graph.num_vertices
    step = bool_semiring.TILE * mm.size
    n_pad = -(-max(n, 1) // step) * step
    rows = n_pad // mm.size
    A = _label_rows(graph, n_pad, mm.rank * rows, rows, dev)
    blocks = [distributed_plus_closure(mr_step_matrix(A, mr, mm), mesh,
                                       axis, n_iters=_n_iters(n), matmul=mm)
              for mr in mrs]
    del A
    R = mm.gather_rows(torch.stack(blocks), dim=1)
    return (R[:, :n, :n] > 0).cpu().numpy()


def distributed_build(graph: LabeledGraph, k: int, mesh: DeviceMesh,
                      hub_batch: int = 8) -> Tuple[RLCIndex, DenseEngine]:
    """Distributed condensed build: ``R_L`` on the mesh, then the
    hub-batched pruned labeling (:func:`~.dense.build_condensed_device`)
    on this rank's device."""
    R = distributed_all_mr_reach(graph, k, mesh)
    return build_condensed_device(graph, k, hub_batch=hub_batch, reach=R,
                                  device=mesh_device(mesh))


# ------------------------------------------------------------------ #
# Distributed query serving
# ------------------------------------------------------------------ #
def distributed_query_batch(dev_index, s: np.ndarray, t: np.ndarray,
                            mr: np.ndarray, mesh: DeviceMesh) -> np.ndarray:
    """Shard the query batch over every mesh axis; index replicated.

    The batch is padded to a multiple of the mesh size with ``(0, 0, 0)``
    queries; each rank answers its contiguous shard through its replica
    ``dev_index`` (a :class:`~.device_index.DeviceIndex` holding every
    row; the merge-join kernel on a card, its plain version on the CPU),
    the shards are all-gathered over the mesh's ranks, and the padding is
    cut away. Every rank returns the ``(Q,)`` bool answers."""
    nshard = dist.get_world_size()
    if mesh.mesh.flatten().tolist() != list(range(nshard)):
        raise ValueError("distributed_query_batch needs a mesh over the "
                         "whole world in rank order")
    shard = dist.get_rank()     # the rank's place over every mesh axis
    Q = len(s)
    per = -(-Q // nshard) if Q else 0
    pad = per * nshard - Q

    def mine(x):
        x = np.asarray(x, np.int64)
        if pad:
            x = np.concatenate([x, np.zeros(pad, np.int64)])
        return x[shard * per:(shard + 1) * per]

    out = mergejoin.query_batch(
        dev_index.out_hub, dev_index.out_mr, dev_index.in_hub,
        dev_index.in_mr, mine(s), mine(t), mine(mr),
        row_base_out=dev_index.row_lo, row_base_in=dev_index.row_lo)
    out = out.to(device=mesh_device(mesh), dtype=torch.uint8)
    parts = [torch.empty_like(out) for _ in range(nshard)]
    dist.all_gather(parts, out)
    return torch.cat(parts)[:Q].cpu().numpy().astype(bool)
