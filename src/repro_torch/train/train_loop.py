"""train_step assembly: grad accumulation, clipping, AdamW, metrics
(``repro.train.train_loop`` in eager torch).

``make_train_step(cfg, oc)`` returns ``train_step(state, batch)``, which
updates ``state`` in place (the reference donates it to ``jit``) and
returns ``(state, metrics)``. Gradients come from ``torch.autograd.grad``
of :func:`~repro_torch.models.loss_fn` over the parameter leaves; a loop
over microbatches stands in for the reference's ``lax.scan``, with a
float32 accumulator.

Placement (FSDP/TP): on a mesh of more than one rank the state's
leaves are DTensors placed by ``tree_shardings(..., PARAM_RULES)`` —
``fsdp`` dimensions over ``data``, ``heads``/``kv``/``ff``/``vocab``/
``experts`` over ``model`` — and a plain leaf is taken as replicated.
Each microbatch of the global batch is split by ``("act_batch", ...)``;
the gradients take their parameters' placements (the reference's
``_shard_like_params``), so the data-parallel reduction of a sharded
parameter is a reduce-scatter in ``oc.grad_dtype``; the float32
accumulator and AdamW's moments keep those placements, and the update
runs on the shards in place. On one rank, or without a mesh, every leaf
is a plain tensor and nothing is redistributed — unless the state was
placed as DTensors all the same (``place_tree(..., dtensor=True)``),
which takes the placed path on a mesh of one rank.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import ArchConfig
from repro_torch.models import init_model, loss_fn
from repro_torch.models.builder import tree_from_leaves, tree_leaves, tree_map
from repro_torch.sharding.partition import (ACT_RULES, logical_to_sharding,
                                            mesh_context)
from .optimizer import OptConfig, adamw_init, adamw_update, dtype_of

PyTree = Any
f32 = torch.float32


@dataclass
class TrainState:
    """Parameters, optimizer state and step. The field order is the
    reference's pytree order, so checkpoint keys are ``0__...`` (params),
    ``1__m__...``, ``1__v__...``, ``1__step`` and ``2``."""
    params: PyTree
    opt: Dict
    step: torch.Tensor


def _state_axes(axes: PyTree) -> TrainState:
    return TrainState(axes, {"m": axes, "v": axes, "step": ()}, ())


def init_train_state(cfg: ArchConfig, oc: OptConfig,
                     generator: Optional[torch.Generator] = None,
                     abstract: bool = False, device="cuda"
                     ) -> Tuple[TrainState, TrainState]:
    """(state, logical axes of the state). Parameters are drawn from
    ``generator`` as :func:`~repro_torch.models.init_model` draws them;
    ``abstract=True`` puts everything on the ``meta`` device."""
    params, axes = init_model(cfg, generator, abstract=abstract,
                              device=device)
    opt = adamw_init(params, oc)
    step = torch.zeros((), dtype=torch.int32, device=opt["step"].device)
    return TrainState(params, opt, step), _state_axes(axes)


def train_state_axes(cfg: ArchConfig) -> TrainState:
    return _state_axes(init_model(cfg, abstract=True)[1])


def _placed(tree, mesh):
    """``tree``'s leaves as DTensors on ``mesh``: a DTensor stays as it
    is (placed by :func:`~repro_torch.sharding.place_tree`); a plain
    tensor becomes a replicated DTensor over the same storage, so the
    in-place update still lands in it."""
    return tree_map(lambda x: x if isinstance(x, DTensor) else
                    DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False), tree)


def make_train_step(cfg: ArchConfig, oc: OptConfig, microbatches: int = 1,
                    mesh=None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    ``batch`` leaves (numpy arrays or tensors) are the global (B, ...),
    B divisible by ``microbatches``; grads are cast to ``oc.grad_dtype``
    and take their parameter's placements, accumulate in float32 across
    microbatches, then one AdamW update runs in place. The metrics are
    the last microbatch's, as in the reference, as plain tensors.

    On a mesh of more than one rank, or when the state's leaves are
    DTensors, the step is placed (see the module docstring): every
    microbatch is placed by ``("act_batch", ...)`` and the step runs
    under :func:`mesh_context`."""
    gdt = dtype_of(oc.grad_dtype)

    def shard_like(g, p):
        """The reference's ``_shard_like_params``: ``g`` in ``p``'s
        placements (a reduce-scatter of a partial sum over ``data``)."""
        if not isinstance(p, DTensor):
            return g
        return g.redistribute(p.device_mesh, p.placements)

    def place_batch(mb, like):
        """``mb`` split by ``act_batch`` when the parameters (``like``,
        one of them) are placed."""
        if not isinstance(like, DTensor):
            return mb
        return {k: logical_to_sharding(
            v.shape, ("act_batch",) + (None,) * (v.ndim - 1), mesh,
            ACT_RULES).place(v, dtensor=True) for k, v in mb.items()}

    def single_grads(pairs, mb):
        live = [p.detach().requires_grad_() for _, p in pairs]
        tree = tree_from_leaves(
            (path, p) for (path, _), p in zip(pairs, live))
        with torch.enable_grad():
            loss, metrics = loss_fn(tree, cfg, place_batch(mb, pairs[0][1]))
            grads = torch.autograd.grad(loss, live, allow_unused=True,
                                        materialize_grads=True)
        grads = [(path, shard_like(g.to(gdt), p))
                 for (path, p), g in zip(pairs, grads)]
        return grads, {k: _full(v.detach()) for k, v in metrics.items()}

    def step(state: TrainState, batch: Dict, placed: bool
             ) -> Tuple[TrainState, Dict]:
        params = _placed(state.params, mesh) if placed else state.params
        opt = (dict(state.opt, m=_placed(state.opt["m"], mesh),
                    v=_placed(state.opt["v"], mesh)) if placed
               else state.opt)
        pairs = list(tree_leaves(params))
        dev = pairs[0][1].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if microbatches == 1:
            grads, metrics = single_grads(pairs, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{microbatches} microbatches")
            n = B // microbatches
            acc = [torch.zeros_like(p, dtype=f32) for _, p in pairs]
            for i in range(microbatches):
                g, metrics = single_grads(
                    pairs, {k: v[i * n:(i + 1) * n]
                            for k, v in batch.items()})
                for a, (_, gg) in zip(acc, g):
                    a += gg.to(f32)
            grads = [(path, (a / microbatches).to(gdt))
                     for (path, _), a in zip(pairs, acc)]
        _, _, opt_metrics = adamw_update(tree_from_leaves(grads), opt,
                                         params, oc)
        state.step += 1
        return state, dict(metrics, **{k: _full(v)
                                       for k, v in opt_metrics.items()})

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        placed = mesh is not None and (
            mesh.size() > 1
            or isinstance(next(tree_leaves(state.params))[1], DTensor))
        with mesh_context(mesh) if placed else contextlib.nullcontext():
            return step(state, batch, placed)

    return train_step


def _full(x: torch.Tensor) -> torch.Tensor:
    """A metric as a plain tensor (a DTensor's global value)."""
    return x.full_tensor() if isinstance(x, DTensor) else x
