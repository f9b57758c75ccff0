"""Sharded RLC serving.

Scales the single-process :class:`repro_torch.service.RLCService` past
one device's memory and batch rate by partitioning the frozen index into
horizontal shards:

* :mod:`~repro_torch.service.sharded.plan` — contiguous vertex-id ranges,
  balanced by *entry count* so hub-heavy vertices don't pile one shard;
* :mod:`~repro_torch.service.sharded.router` — the two-sided router;
* :mod:`~repro_torch.service.sharded.replica` — N replicas per shard,
  round-robin reads, rebuilt slices prepared beside the serving ones;
* :mod:`~repro_torch.service.sharded.fanout` — the scatter/gather batch
  executor regrouping micro-batches into per-``(shard_s, shard_t)``
  sub-batches, each batch on one generation of every shard (a hot swap
  or delta publishes all shards at once);
* :mod:`~repro_torch.service.sharded.service` — the
  :class:`ShardedRLCService` facade (drop-in ``query`` / ``query_batch``
  / ``submit`` / ``stats``).

The two-sided routing invariant
-------------------------------
The paper answers ``query(s, t, MR+)`` by intersecting ``L_out(s)`` with
``L_in(t)`` (Algorithm 1). Under sharding those two sides live on
``shard(s)`` and ``shard(t)`` respectively, so the subsystem maintains one
invariant: **every query executes on shard(t)**, which always reads
``L_in(t)`` locally. ``L_out(s)`` is local too iff ``shard(s) ==
shard(t)`` (the single-host path over the shard's slice: on a card, the
merge-join kernel over the shard's row window); otherwise ``shard(s)``
*scatters* s's out-row digest to ``shard(t)`` — one hop, one padded row
per query — and the join runs against the local in-rows. No query ever
needs more than one inter-shard hop, and no shard ever needs another
shard's in-side.

Two transports serve the same contracts. ``transport="inproc"``
(default) keeps the shard replicas in this process, each shard's layout
on its own device (round-robin over the visible cards; all on
``cuda:0`` with one card), and the digest ship is a ``Tensor.to`` copy
when two shards sit on different cards. ``transport="rpc"`` runs one
shard-host *worker process* per (shard, replica), each holding only its
shard's slice and answering from the host, driven over the message-based
RPC plane in :mod:`repro_torch.service.rpc` — the digest hand-off
serializes out-rows over the wire, and answers stay bit-identical to the
in-process path.
"""
from .fanout import RpcScatterGatherExecutor, ScatterGatherExecutor
from .plan import ShardPlan, plan_shards
from .replica import (ShardReplica, ShardReplicaSet, build_device_layout,
                      build_replica, dict_index_slice)
from .router import Route, TwoSidedRouter
from .service import ShardedRLCService, ShardedServiceConfig

__all__ = [
    "Route", "RpcScatterGatherExecutor", "ScatterGatherExecutor",
    "ShardPlan", "ShardReplica", "ShardReplicaSet", "ShardedRLCService",
    "ShardedServiceConfig", "TwoSidedRouter", "build_device_layout",
    "build_replica", "dict_index_slice", "plan_shards",
]
