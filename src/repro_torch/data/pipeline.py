"""Deterministic synthetic LM data pipeline (host-sharded, restart-safe;
``repro.data.pipeline`` as it is, numpy only).

The interface is the contract: ``batch_at(step)`` is a pure function of
(seed, step, process_index), so (a) restarts resume bit-identically
mid-epoch without data state in checkpoints, (b) each host materialises
only its shard (B / num_processes), and (c) elastic re-meshes
re-partition cleanly. The arrays are ``repro``'s, bit for bit, for every
(seed, step, process_index); they stay on the host, and the caller moves
them to the device.

The token stream is a mixture of Zipfian unigrams + local n-gram
structure, so smoke training shows a real loss curve.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    num_processes: int = 1
    process_index: int = 0


class SyntheticLMData:
    def __init__(self, cfg: ArchConfig, dc: DataConfig):
        if dc.global_batch % dc.num_processes:
            raise ValueError(f"global batch {dc.global_batch} does not "
                             f"split over {dc.num_processes} processes")
        self.cfg = cfg
        self.dc = dc
        self.local_batch = dc.global_batch // dc.num_processes
        # fixed Zipfian unigram table + a per-token shift
        rng = np.random.default_rng(dc.seed)
        V = cfg.vocab_size
        ranks = np.arange(1, V + 1, dtype=np.float64)
        self._p = ranks ** -1.1
        self._p /= self._p.sum()
        self._shift = rng.integers(1, max(V - 1, 2))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        dc = self.dc
        rng = np.random.default_rng(
            (dc.seed * 1_000_003 + step) * 4096 + dc.process_index)
        B, S, V = self.local_batch, dc.seq_len, self.cfg.vocab_size
        base = rng.choice(V, size=(B, S + 1), p=self._p)
        # n-gram structure: half the positions copy-shift the predecessor
        copy = rng.random((B, S + 1)) < 0.5
        shifted = (np.roll(base, 1, axis=1) + self._shift) % V
        tokens = np.where(copy, shifted, base).astype(np.int32)
        out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        if self.cfg.frontend != "none":
            out["frontend"] = rng.standard_normal(
                (B, self.cfg.frontend_len, self.cfg.frontend_dim)
            ).astype(np.float32)
        return out
