"""Straggler detection.

**StragglerMonitor** — per-step wall times; a step slower than
``factor x`` the rolling median flags a straggler. The RPC shard
cluster (:mod:`repro_torch.service.rpc.controller`) keeps one per worker
over its request round trips, so a slow host is visible before it is
gone.

The reference module also holds an elastic mesh manager and a resilient
training loop; they belong to the language-model substrate, which the
port does not have yet.
"""
from __future__ import annotations

from collections import deque
from typing import List, Tuple

import numpy as np


class StragglerMonitor:
    def __init__(self, window: int = 16, factor: float = 2.0):
        self.window = window
        self.factor = factor
        self.times: deque = deque(maxlen=window)
        self.flagged: List[Tuple[int, float]] = []

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        is_out = False
        if len(self.times) >= max(4, self.window // 2):
            med = float(np.median(self.times))
            if seconds > self.factor * med:
                self.flagged.append((step, seconds))
                is_out = True
        self.times.append(seconds)
        return is_out
