"""Latency / throughput accounting for the serving path.

Backed by :class:`repro_torch.obs.metrics.Reservoir`, so memory stays
bounded under sustained traffic. Percentiles are exact below the
reservoir cap and reservoir-sampled estimates above it; ``queries`` /
``batches`` / ``total_s`` stay exact forever.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.obs.metrics import Reservoir

#: per-recorder sample bound: exact percentiles below, reservoir above.
DEFAULT_SAMPLE_CAP = 4096


class LatencyRecorder:
    """Per-backend wall-clock samples with percentile summaries.

    One sample = one executed batch; ``queries`` tracks the real
    (unpadded) queries answered so throughput reflects useful work.
    Memory is bounded by ``sample_cap``.
    """

    def __init__(self, name: str, sample_cap: int = DEFAULT_SAMPLE_CAP):
        self.name = name
        self._reservoir = Reservoir(sample_cap)
        self.queries = 0
        self.batches = 0

    def record(self, seconds: float, n_queries: int) -> None:
        self._reservoir.add(float(seconds))
        self.queries += int(n_queries)
        self.batches += 1

    @property
    def samples_s(self) -> List[float]:
        """The *stored* samples (bounded; all of them while under the
        cap). Kept for callers that eyeball distributions."""
        return list(self._reservoir.samples)

    @property
    def total_s(self) -> float:
        return self._reservoir.total

    def percentile(self, p: float) -> float:
        """p in [0, 100]; seconds per batch. 0.0 when empty. Exact while
        ``batches <= sample_cap``, a reservoir estimate beyond."""
        return self._reservoir.percentile(p)

    @property
    def qps(self) -> float:
        return self.queries / self.total_s if self.total_s > 0 else 0.0

    def summary(self) -> Dict[str, float]:
        return dict(
            batches=self.batches,
            queries=self.queries,
            total_s=self.total_s,
            p50_ms=self.percentile(50) * 1e3,
            p99_ms=self.percentile(99) * 1e3,
            qps=self.qps,
        )
