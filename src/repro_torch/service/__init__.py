"""Online RLC query serving: one host, sharded, or over RPC.

* :mod:`repro_torch.service.expr` — textual ``(l1 l2 ...)+`` constraint
  parser with alphabet / ``k`` validation and minimum-repeat
  canonicalization;
* :mod:`repro_torch.service.cache` — LRU result cache (positive and
  negative answers) with hit/miss accounting;
* :mod:`repro_torch.service.scheduler` — micro-batching scheduler that
  packs requests into batches bucketed by MR length;
* :mod:`repro_torch.service.executor` — multi-backend batch executor
  (cuda kernel / torch sorted / numpy CSR / python): the kernel alone on
  a CUDA layout, a counted fallback chain on a CPU layout;
* :mod:`repro_torch.service.control` — the closed-loop control plane:
  SLO-aware per-MR-length batching, admission control with explicit
  ``SHED`` answers, and frequency-sketch-prioritized cache warming;
* :mod:`repro_torch.service.answer` — the typed :class:`Answer` result
  (value + disposition + backend attribution) and the :data:`SHED`
  sentinel;
* :mod:`repro_torch.service.lifecycle` — async admission: ``submit()``
  futures behind the ``start()``/``close()`` protocol;
* :mod:`repro_torch.service.stats` — the versioned
  ``repro.service.stats/1`` stats schema, with :func:`validate_stats`;
* :mod:`repro_torch.service.service` — the :class:`RLCService` facade
  wiring build -> freeze -> device transfer -> serve;
* :mod:`repro_torch.service.sharded` — sharded serving: shard planner,
  two-sided router, replica sets with hot-swap, scatter/gather fan-out
  behind the drop-in :class:`ShardedRLCService` facade, each shard's
  row-windowed layout on its own device;
* :mod:`repro_torch.service.rpc` — multi-process serving: shard-host
  worker processes, answering from the host, behind a message-based
  RPC transport (``ShardedServiceConfig(transport="rpc")``).
"""
from .answer import DISPOSITIONS, SHED, Answer
from .cache import CacheStats, ResultCache
from .control import (AdmissionController, CacheWarmer, ControlPlane,
                      FrequencySketch, SLOBatchController, VirtualClock)
from .executor import BACKENDS, BatchExecutor, ExecutorError
from .expr import ExpressionError, PathExpression, parse_expression
from .lifecycle import AsyncEngine
from .metrics import LatencyRecorder
from .scheduler import Batch, MicroBatcher, Request
from .service import RLCService, ServiceConfig
from .sharded import ShardedRLCService, ShardedServiceConfig
from .stats import STATS_SCHEMA, validate_stats

__all__ = [
    "Answer", "BACKENDS", "AdmissionController", "AsyncEngine", "Batch",
    "BatchExecutor", "CacheStats", "CacheWarmer", "ControlPlane",
    "DISPOSITIONS", "ExecutorError", "ExpressionError", "FrequencySketch",
    "LatencyRecorder", "MicroBatcher", "PathExpression", "RLCService",
    "Request", "ResultCache", "SHED", "SLOBatchController",
    "STATS_SCHEMA", "ServiceConfig", "ShardedRLCService",
    "ShardedServiceConfig", "VirtualClock", "parse_expression",
    "validate_stats",
]
