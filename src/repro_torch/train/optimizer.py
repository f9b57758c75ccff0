"""AdamW (from scratch) with low-precision moment options + LR schedule
(``repro.train.optimizer`` on torch tensor trees).

The arithmetic is the reference's, in its order, not ``torch.optim.
AdamW``'s: float32 math whatever the parameter dtype; clipping by the
global norm; bias correction as ``mhat / (sqrt(vhat) + eps)``; decoupled
weight decay only where ``p.ndim >= 2``; cosine schedule with linear
warmup. Moments live in ``m_dtype`` / ``v_dtype`` and are rounded once a
step, so bf16 moments round as ``repro``'s do. The update writes the
parameters and moments in place (the reference donates them to ``jit``)
and returns ``(params, state, metrics)`` as the reference does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.builder import tree_leaves, tree_map

PyTree = Any
f32 = torch.float32


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    m_dtype: str = "bfloat16"
    v_dtype: str = "bfloat16"
    # gradients cross the data-parallel reduction in this dtype
    grad_dtype: str = "bfloat16"


def dtype_of(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def lr_schedule(oc: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), in float32."""
    step = torch.as_tensor(step).to(f32)
    warm = torch.clamp(step / max(oc.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - oc.warmup_steps)
                    / max(oc.total_steps - oc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = oc.min_lr_frac + (1 - oc.min_lr_frac) * cos
    return oc.lr * warm * frac


def adamw_init(params: PyTree, oc: OptConfig) -> Dict:
    """Zero moments beside each parameter (on its device, ``meta`` for an
    abstract tree) and a zero int32 step."""
    def zeros(dt):
        return lambda p: torch.zeros(p.shape, dtype=dtype_of(dt),
                                     device=p.device)
    dev = next(leaf for _, leaf in tree_leaves(params)).device
    return {"m": tree_map(zeros(oc.m_dtype), params),
            "v": tree_map(zeros(oc.v_dtype), params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: PyTree) -> torch.Tensor:
    """The norm of every leaf together, a plain float32 scalar: over
    DTensor leaves the sum of squares reduces across their shards."""
    total = sum(torch.sum(leaf.to(f32) ** 2)
                for _, leaf in tree_leaves(tree))
    if isinstance(total, DTensor):
        total = total.full_tensor()
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: PyTree, state: Dict, params: PyTree,
                 oc: OptConfig) -> Tuple[PyTree, Dict, Dict]:
    """One AdamW step, written into ``params`` and ``state`` in place.
    Returns (params, state, metrics)."""
    state["step"] += 1
    step = state["step"].to(f32)
    gnorm = global_norm(grads)
    scale = (torch.clamp(oc.clip_norm / (gnorm + 1e-9), max=1.0)
             if oc.clip_norm else torch.ones((), dtype=f32,
                                             device=gnorm.device))
    lr = lr_schedule(oc, state["step"])
    b1 = torch.tensor(oc.b1, dtype=f32, device=gnorm.device)
    b2 = torch.tensor(oc.b2, dtype=f32, device=gnorm.device)
    c1 = 1 - b1 ** step
    c2 = 1 - b2 ** step
    g_leaves = dict(tree_leaves(grads))
    m_leaves = dict(tree_leaves(state["m"]))
    v_leaves = dict(tree_leaves(state["v"]))
    for path, p in tree_leaves(params):
        m, v = m_leaves[path], v_leaves[path]
        g = g_leaves[path].to(f32) * scale
        m32 = b1 * m.to(f32) + (1 - b1) * g
        v32 = b2 * v.to(f32) + (1 - b2) * g * g
        mhat = m32 / c1
        vhat = v32 / c2
        delta = mhat / (torch.sqrt(vhat) + oc.eps)
        if oc.weight_decay and p.ndim >= 2:   # no decay on norms/bias
            delta = delta + oc.weight_decay * p.to(f32)
        p.copy_(p.to(f32) - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    return params, state, {"grad_norm": gnorm, "lr": lr}
