"""Online RLC query serving (the synchronous path).

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
* :mod:`repro_torch.service.answer` — the typed :class:`Answer` result
  (value + disposition + backend attribution);
* :mod:`repro_torch.service.service` — the :class:`RLCService` facade
  wiring build -> freeze -> device transfer -> serve.
"""
from .answer import DISPOSITIONS, Answer
from .cache import CacheStats, ResultCache
from .executor import BACKENDS, BatchExecutor, ExecutorError
from .expr import ExpressionError, PathExpression, parse_expression
from .metrics import LatencyRecorder
from .scheduler import Batch, MicroBatcher, Request
from .service import RLCService, ServiceConfig

__all__ = [
    "Answer", "BACKENDS", "Batch", "BatchExecutor", "CacheStats",
    "DISPOSITIONS", "ExecutorError", "ExpressionError", "LatencyRecorder",
    "MicroBatcher", "PathExpression", "RLCService", "Request",
    "ResultCache", "ServiceConfig", "parse_expression",
]
