"""Multi-process shard serving: the RPC plane under ``transport="rpc"``.

This package is the process boundary of sharded serving: a controller
talks to one shard-host *worker process* per (shard, replica) over
length-prefixed msgpack-or-JSON frames, each worker holding only its shard's
:meth:`FrozenRLCIndex.slice_rows` view plus a locally reconstructed
dict-index slice — never the global python fallback — and cross-shard
queries ship out-row digests over the wire instead of a device copy.

Layers, bottom up:

* :mod:`~repro_torch.service.rpc.wire` — self-describing byte frames
  (msgpack preferred, JSON fallback; numpy arrays as dtype+shape+raw
  bytes).
* :mod:`~repro_torch.service.rpc.transport` — framed request/response
  endpoints over :mod:`multiprocessing.connection` (HMAC-authed
  loopback sockets), :class:`WorkerGone` / :class:`RemoteError`
  taxonomy.
* :mod:`~repro_torch.service.rpc.worker` — the shard-host process,
  serving its slice from the host (numpy; no device layout, no CUDA tensor):
  ``execute`` / ``gather_digest`` / ``join_digest`` / ``swap`` (stage
  a generation) / ``commit`` (serve it) handlers over shard-local state.
* :mod:`~repro_torch.service.rpc.controller` — :class:`RpcShardCluster`:
  elastic membership (join/leave/rejoin with epochs), round-robin
  replica routing with died-mid-call retry, staged swaps committed on
  every worker at once, and the ``rlc_rpc_*`` metric family.

``ShardedServiceConfig(transport="rpc")`` wires a cluster under the
normal fan-out; answers stay bit-identical to the in-process path.
"""
from __future__ import annotations

from .controller import RpcShardCluster, RpcWorkerHandle, WorkerLost
from .transport import (RemoteError, RpcEndpoint, RpcError, RpcListener,
                        WorkerGone, connect)
from .wire import codec_name, decode, encode
from .worker import ShardWorker, worker_main

__all__ = [
    "RpcShardCluster", "RpcWorkerHandle", "WorkerLost",
    "RpcEndpoint", "RpcListener", "RpcError", "RemoteError",
    "WorkerGone", "connect", "codec_name", "decode", "encode",
    "ShardWorker", "worker_main",
]
