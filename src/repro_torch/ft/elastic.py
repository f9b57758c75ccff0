"""Fault tolerance: straggler detection, elastic re-mesh, resilient loop
(``repro.ft.elastic`` over ``torch.distributed`` and torch tensors).

* **StragglerMonitor** — per-step wall times; a step slower than
  ``factor x`` the rolling median flags a straggler. The training loop
  records every step; the RPC shard cluster
  (:mod:`repro_torch.service.rpc.controller`) keeps one per worker over
  its request round trips.
* **ElasticMeshManager** — on rank loss, rebuild the largest valid
  ("data", "model") ``DeviceMesh`` from the survivors (shrink ``data``,
  keep ``model`` intact: TP groups must stay whole) and re-shard the
  train state onto it, as the reference's ``device_put`` does: a leaf
  placed on the old mesh is gathered there (a collective of the old
  mesh's ranks, those the shrink drops included, which then leave) and
  placed on the new one; replay from the last checkpoint, which restores
  onto any layout, if the failure hit mid-step.
* **resilient_loop** — checkpoint/restart driver: runs ``train_step``,
  checkpoints every N steps (async), restores after injected failures;
  a restarted run ends bit-identical to an uninterrupted one.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.devices import resolve_device
from repro_torch.core.distributed import init_world
from repro_torch.models.builder import tree_flatten, tree_unflatten
from repro_torch.sharding.partition import NamedSharding

PyTree = Any


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


class ElasticMeshManager:
    """Builds the largest (data, model) mesh from surviving ranks."""

    def __init__(self, model_parallel: int = 1,
                 axis_names=("data", "model"), device="cuda"):
        self.model_parallel = model_parallel
        self.axis_names = tuple(axis_names)
        self.device = resolve_device(device)

    def build(self, ranks: Optional[List[int]] = None) -> DeviceMesh:
        """A mesh over ``ranks`` (default: the world's, starting a world
        of one rank when none exists), cut to whole TP groups; raises
        ``RuntimeError`` with fewer ranks than one TP group."""
        if ranks is None:
            init_world(self.device)
            ranks = list(range(dist.get_world_size()))
        mp = self.model_parallel
        usable = (len(ranks) // mp) * mp
        if usable == 0:
            raise RuntimeError(
                f"need >= {mp} ranks for a whole TP group; "
                f"have {len(ranks)}")
        init_world(self.device)
        grid = torch.tensor(ranks[:usable]).reshape(usable // mp, mp)
        return DeviceMesh(self.device.type, grid,
                          mesh_dim_names=self.axis_names)

    def shrink(self, mesh: DeviceMesh, lost: int) -> DeviceMesh:
        """Lose the last ``lost`` ranks: drop whole data rows."""
        ranks = mesh.mesh.reshape(-1).tolist()
        return self.build(ranks[:len(ranks) - lost])

    def reshard(self, tree: PyTree, shardings: PyTree,
                dtensor: bool = False) -> PyTree:
        """``tree`` re-placed as ``shardings`` (from
        :func:`repro_torch.sharding.tree_shardings`, on any mesh) say,
        with the same values: what ``place_tree(full values, shardings,
        dtensor)`` gives (a plain tensor on a one-rank mesh unless
        ``dtensor``). A DTensor leaf already on the target mesh is
        redistributed; one on another mesh is gathered on its own mesh
        first (``full_tensor()``, a collective): every rank of the old
        mesh calls this, those the shrink drops included, and a dropped
        rank then leaves, its result unused. A plain leaf is placed as
        it is."""
        sh = [s for _, s in tree_flatten(
            shardings, is_leaf=lambda s: isinstance(s, NamedSharding))]
        out = []
        for (_, x), s in zip(tree_flatten(tree), sh):
            keep = dtensor or s.mesh.size() > 1
            if isinstance(x, DTensor):
                if keep and x.device_mesh == s.mesh:
                    out.append(x.redistribute(s.mesh, s.placements))
                    continue
                x = x.full_tensor()
            out.append(s.place(x, dtensor))
        return tree_unflatten(tree, out)


@dataclass
class LoopReport:
    steps_run: int = 0
    restarts: int = 0
    straggler_steps: List[int] = field(default_factory=list)
    final_metrics: Dict = field(default_factory=dict)


def _sync(state: PyTree) -> None:
    """Wait for the device work behind ``state``'s first leaf (the
    reference's ``jax.block_until_ready``)."""
    leaf = next((x for _, x in tree_flatten(state)), None)
    if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


def resilient_loop(train_step: Callable, state: PyTree,
                   batch_at: Callable[[int], Dict], num_steps: int,
                   ckpt_dir: str, ckpt_every: int = 10,
                   fail_at: Optional[Dict[int, BaseException]] = None,
                   monitor: Optional[StragglerMonitor] = None
                   ) -> Tuple[PyTree, LoopReport]:
    """Checkpoint/restart training driver.

    ``fail_at``: {step: exception} injected AFTER the step computes but
    BEFORE its checkpoint would land — the worst-case window; restart
    resumes from the last durable checkpoint (restored onto the devices
    ``state`` lives on) and replays.
    """
    fail_at = dict(fail_at or {})
    mgr = CheckpointManager(ckpt_dir)
    monitor = monitor or StragglerMonitor()
    report = LoopReport()

    restored = mgr.restore_latest(state)
    start = 0
    if restored is not None:
        start, state, _ = restored

    step = start
    while step < num_steps:
        try:
            t0 = time.perf_counter()
            state, metrics = train_step(state, batch_at(step))
            _sync(state)
            dt = time.perf_counter() - t0
            if monitor.record(step, dt):
                report.straggler_steps.append(step)
            if step in fail_at:
                raise fail_at.pop(step)
            step += 1
            report.steps_run += 1
            if step % ckpt_every == 0 or step == num_steps:
                mgr.save_async(step, state, extra={"step": step})
            report.final_metrics = {k: float(v) for k, v in metrics.items()}
        except Exception:
            # restart path: restore the last durable step and replay
            report.restarts += 1
            mgr.wait()
            restored = mgr.restore_latest(state)
            if restored is None:
                step = 0
            else:
                step, state, _ = restored
    mgr.wait()
    return state, report
