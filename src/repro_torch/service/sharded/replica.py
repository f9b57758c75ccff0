"""Per-shard replica sets with round-robin reads and atomic hot-swap.

Each shard holds ``num_replicas`` interchangeable :class:`ShardReplica`
objects — a frozen slice, its device layout, and a :class:`BatchExecutor`
over them. Read traffic round-robins across replicas
(:meth:`ShardReplicaSet.acquire`). A rebuild is two steps:
:meth:`ShardReplicaSet.prepare` fully constructs the replacements
(device transfer + executor) while the old replicas keep serving, and
:meth:`ShardReplicaSet.publish` installs them with one reference
assignment. The facade prepares every shard first and publishes them
all under the fan-out's generation gate, so no batch sees two
generations. The old replicas keep their layouts alive for as long as
a batch holds them, and every launch runs on the device's current
stream, so no tensor is freed under a kernel that reads it.

Each replica is pinned to an explicit ``torch.device`` (the facade deals
CUDA shards round-robin over the visible cards). A layout that cannot be
built or placed raises on every device: no shard quietly serves from the
host in place of its card.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device_index import DeviceIndex
from repro_torch.core.devices import resolve_device
from repro_torch.core.minimum_repeat import LabelSeq
from repro_torch.core.rlc_index import FrozenRLCIndex, RLCIndex

from ..executor import BatchExecutor


def dict_index_slice(frozen_slice: FrozenRLCIndex, lo: int, hi: int,
                     id_to_mr: Sequence[LabelSeq]) -> RLCIndex:
    """Shard-local dict-layout index reconstructed from a frozen slice.

    The python-fallback twin of :meth:`FrozenRLCIndex.slice_rows`: entry
    dicts populated only for rows ``[lo, hi)``, global vertex ids and
    ``aid`` kept. This is what a shard-host *worker process* serves its
    python path from — a host never materializes the global dict index
    (:mod:`repro_torch.service.rpc.worker`); the routing invariant
    guarantees every locally executed query has both endpoints in range.
    """
    n = frozen_slice.num_vertices
    l_out: List[dict] = [dict() for _ in range(n)]
    l_in: List[dict] = [dict() for _ in range(n)]

    def fill(maps, indptr, hub, mr):
        for v in range(lo, hi):
            a, b = int(indptr[v]), int(indptr[v + 1])
            d = maps[v]
            for h, m in zip(hub[a:b], mr[a:b]):
                d.setdefault(int(h), set()).add(tuple(id_to_mr[int(m)]))

    fill(l_out, frozen_slice.out_indptr, frozen_slice.out_hub,
         frozen_slice.out_mr)
    fill(l_in, frozen_slice.in_indptr, frozen_slice.in_hub,
         frozen_slice.in_mr)
    return RLCIndex(n, frozen_slice.k,
                    np.asarray(frozen_slice.aid, dtype=np.int64),
                    l_in=l_in, l_out=l_out)


@dataclasses.dataclass
class ShardReplica:
    """One serveable copy of a shard: frozen slice + device layout +
    executor."""

    shard_id: int
    replica_id: int
    generation: int
    frozen: FrozenRLCIndex          # slice view: rows [lo, hi) populated
    device_index: Optional[DeviceIndex]   # None only with use_device=False
    executor: BatchExecutor
    device: torch.device            # where this replica's layout lives


_LAYOUT_TENSORS = ("out_hub", "out_mr", "in_hub", "in_mr", "out_key",
                   "in_key")


def _pin(device_index: DeviceIndex, device) -> DeviceIndex:
    """``device_index`` with its six tensors on ``device``. A device that
    is absent, or a copy that fails, raises."""
    dev = resolve_device(device)
    return dataclasses.replace(device_index, **{
        f: getattr(device_index, f).to(dev) for f in _LAYOUT_TENSORS})


def build_device_layout(frozen_slice: FrozenRLCIndex, mr_ids,
                        rows: Optional[Tuple[int, int]] = None,
                        device="cuda") -> DeviceIndex:
    """Row-windowed device layout for one shard slice: packed on the host,
    then pinned to ``device``. Built once per (shard, generation, device)
    and shared by every replica pinned to that device — the tensors are
    immutable. A failure raises on every device."""
    return _pin(DeviceIndex.from_frozen(frozen_slice, mr_ids, rows=rows,
                                        device="cpu"), device)


def build_replica(shard_id: int, replica_id: int, generation: int,
                  frozen_slice: FrozenRLCIndex, mr_ids,
                  index: RLCIndex, id_to_mr: Sequence[LabelSeq],
                  backend: str = "auto", use_device: bool = True,
                  device="cuda",
                  rows: Optional[Tuple[int, int]] = None,
                  shared_device_index=None, obs=None) -> ShardReplica:
    """Fully construct one replica (the unit hot-swap publishes).

    ``rows=(lo, hi)`` is the shard's vertex range: the device layout packs
    only that row window, so per-shard device memory shrinks ~1/S. Pass
    ``shared_device_index`` (from :func:`build_device_layout`) to reuse one
    immutable layout across a shard's replicas instead of re-packing it
    per replica. ``index``/``id_to_mr`` are the global dict-layout
    reference — the python backend of a CPU layout; the in-process shards
    share it, a real deployment would ship each shard a slice of it.
    """
    device_index = None
    if use_device:
        device_index = (shared_device_index
                        if shared_device_index is not None
                        else build_device_layout(frozen_slice, mr_ids,
                                                 rows=rows, device=device))
    executor = BatchExecutor(index, frozen_slice, device_index,
                             id_to_mr, backend=backend, obs=obs,
                             shard=str(shard_id))
    return ShardReplica(shard_id, replica_id, generation, frozen_slice,
                        device_index, executor, torch.device(device))


class ShardReplicaSet:
    """All replicas of one shard; round-robin reads, prepare-then-publish
    swaps."""

    def __init__(self, shard_id: int, lo: int, hi: int,
                 replicas: List[ShardReplica], obs=None):
        if not replicas:
            raise ValueError(f"shard {shard_id} needs >= 1 replica")
        self.shard_id = shard_id
        self.lo = lo
        self.hi = hi
        self.replicas = replicas
        self._rr = itertools.count()
        self.swaps = 0
        self.last_build_backend: Optional[str] = None
        self.obs = obs
        # Executors are rebuilt on every hot-swap; publish() banks the
        # outgoing replicas' counts here so per-shard attribution
        # survives the generation.
        self._carried_fallbacks = 0
        self._carried_batches: dict = {}
        self._carried_queries: dict = {}

    @property
    def num_replicas(self) -> int:
        return len(self.replicas)

    @property
    def generation(self) -> int:
        return min(r.generation for r in self.replicas)

    @property
    def on_cuda(self) -> bool:
        """Whether this shard serves from layouts on a CUDA device."""
        return any(r.executor.on_cuda for r in self.replicas)

    def acquire(self) -> ShardReplica:
        """Round-robin pick; the returned replica stays valid for the whole
        batch (a publish replaces the list, not the replica)."""
        return self.replicas[next(self._rr) % len(self.replicas)]

    def prepare(self, generation: int, frozen_slice: FrozenRLCIndex,
                mr_ids, index: RLCIndex, id_to_mr: Sequence[LabelSeq],
                backend: str = "auto", use_device: bool = True
                ) -> List[ShardReplica]:
        """Build a replacement for every replica, on the same devices,
        without touching the serving ones. One device pack per (shard,
        generation, device): replicas on one device share the immutable
        layout."""
        layouts = {}
        if use_device:
            for old in self.replicas:
                if old.device not in layouts:
                    layouts[old.device] = build_device_layout(
                        frozen_slice, mr_ids, rows=(self.lo, self.hi),
                        device=old.device)
        return [build_replica(
                    self.shard_id, old.replica_id, generation, frozen_slice,
                    mr_ids, index, id_to_mr, backend=backend,
                    use_device=use_device, device=old.device,
                    rows=(self.lo, self.hi),
                    shared_device_index=layouts.get(old.device),
                    obs=self.obs)
                for old in self.replicas]

    def publish(self, fresh: List[ShardReplica],
                build_backend: Optional[str] = None) -> None:
        """Install replicas from :meth:`prepare`. ``build_backend``
        records which :mod:`repro_torch.build` backend produced the
        incoming index (surfaced in :meth:`stats`)."""
        # bank the outgoing replicas' counters: the fresh executors start
        # at zero, the set-level totals must not
        for old in self.replicas:
            self._carried_fallbacks += old.executor.fallbacks
            for b, rec in old.executor.recorders.items():
                if rec.batches:
                    self._carried_batches[b] = (
                        self._carried_batches.get(b, 0) + rec.batches)
                    self._carried_queries[b] = (
                        self._carried_queries.get(b, 0) + rec.queries)
        # single reference assignment = the publish point
        self.replicas = list(fresh)
        self.last_build_backend = build_backend
        self.swaps += 1

    @property
    def fallbacks(self) -> int:
        """Fallback batches attributed to this shard across *all*
        generations: counts banked at swap time plus the live replicas'."""
        return self._carried_fallbacks + sum(
            r.executor.fallbacks for r in self.replicas)

    def backend_totals(self) -> dict:
        """Per-backend ``{batches, queries}`` across generations."""
        out = {b: dict(batches=n, queries=self._carried_queries.get(b, 0))
               for b, n in self._carried_batches.items()}
        for r in self.replicas:
            for b, rec in r.executor.recorders.items():
                if rec.batches:
                    d = out.setdefault(b, dict(batches=0, queries=0))
                    d["batches"] += rec.batches
                    d["queries"] += rec.queries
        return out

    def stats(self) -> dict:
        r0 = self.replicas[0]
        return dict(
            shard=self.shard_id,
            lo=self.lo, hi=self.hi,
            vertices=self.hi - self.lo,
            entries=r0.frozen.num_entries(),
            size_bytes=r0.frozen.size_bytes(),
            replicas=self.num_replicas,
            generation=self.generation,
            swaps=self.swaps,
            fallbacks=self.fallbacks,
            backends=self.backend_totals(),
            build_backend=self.last_build_backend,
            device=(str(r0.device_index.device)
                    if r0.device_index is not None else None),
            row_len=(r0.device_index.row_len
                     if r0.device_index is not None else None),
        )
