"""Two-sided query router.

Every query ``(s, t, MR+)`` maps to the shard pair
``(shard(s), shard(t))``. The routing invariant:

    a query always *executes* on ``shard(t)`` — the owner of t's in-rows —
    reading ``L_in(t)`` locally; ``L_out(s)`` arrives either locally
    (same-shard query, full Algorithm 1 on the shard's slice) or as a
    one-hop *digest* shipped from ``shard(s)`` (cross-shard query, the
    paper's s-out ∩ t-in intersection becomes a scatter of s's out-row
    followed by a local merge-join).

Anchoring on the in-side is the cheaper direction for RLC indexes: the
digest is one padded out-row per query, while the join state (t's in-row
plus the merge machinery) never moves. The router only *decides*; moving
rows and running joins is :mod:`repro_torch.service.sharded.fanout`'s job.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from repro_torch.obs import NULL_OBS

from .plan import ShardPlan


@dataclass(frozen=True)
class Route:
    """Where one query lives: executes on ``home`` (= ``shard_t``)."""

    shard_s: int
    shard_t: int

    @property
    def home(self) -> int:
        return self.shard_t

    @property
    def local(self) -> bool:
        return self.shard_s == self.shard_t


class TwoSidedRouter:
    """Maps admitted queries to shard pairs and keeps traffic counters."""

    def __init__(self, plan: ShardPlan, obs=None):
        self.plan = plan
        self.local_routes = 0
        self.remote_routes = 0
        self.pair_counts: Dict[Tuple[int, int], int] = {}
        self.obs = obs or NULL_OBS
        routes = self.obs.registry.counter(
            "rlc_router_routes", desc="query routing decisions",
            labelnames=("kind",))
        self._m_local = routes.labels(kind="local")
        self._m_remote = routes.labels(kind="remote")

    def route(self, s: int, t: int) -> Route:
        r = Route(self.plan.shard_of(s), self.plan.shard_of(t))
        if r.local:
            self.local_routes += 1
            self._m_local.inc()
        else:
            self.remote_routes += 1
            self._m_remote.inc()
        key = (r.shard_s, r.shard_t)
        self.pair_counts[key] = self.pair_counts.get(key, 0) + 1
        return r

    @property
    def total_routes(self) -> int:
        return self.local_routes + self.remote_routes

    @property
    def local_ratio(self) -> float:
        n = self.total_routes
        return self.local_routes / n if n else 0.0

    def stats(self) -> dict:
        return dict(
            local=self.local_routes,
            remote=self.remote_routes,
            local_ratio=round(self.local_ratio, 4),
            pairs={f"{a}->{b}": c
                   for (a, b), c in sorted(self.pair_counts.items())})
