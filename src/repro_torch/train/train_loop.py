"""train_step assembly: grad accumulation, clipping, AdamW, metrics
(``repro.train.train_loop`` in eager torch).

``make_train_step(cfg, oc)`` returns ``train_step(state, batch)``, which
updates ``state`` in place (the reference donates it to ``jit``) and
returns ``(state, metrics)``. Gradients come from ``torch.autograd.grad``
of :func:`~repro_torch.models.loss_fn` over the parameter leaves; a loop
over microbatches stands in for the reference's ``lax.scan``, with a
float32 accumulator.

Data parallelism: on a mesh whose ``data`` axis spans more than one rank,
each rank takes its slice of the (global) batch, and its gradients are
all-reduced (mean) over the ``data`` group in ``oc.grad_dtype``; the
parameters stay replicated plain tensors, so the reference's
``constrain`` calls on the batch and the gradients have nothing to do
here. FSDP/TP placement of parameters is not done yet (``ROADMAP.md``,
queue A), so a ``model`` axis above 1 raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.models import init_model, loss_fn
from repro_torch.models.builder import tree_from_leaves, tree_leaves
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


def _data_group(mesh):
    """(group, rank in it, size) of the mesh's ``data`` axis; ``(None, 0,
    1)`` without a mesh or with a one-rank axis."""
    if mesh is None:
        return None, 0, 1
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if sizes.get("model", 1) > 1:
        raise NotImplementedError(
            "a model axis above 1 needs tensor-parallel placement of the "
            "parameters, which the port does not have yet (ROADMAP.md, "
            "queue A: FSDP/TP placement of parameters)")
    if sizes.get("data", 1) == 1:
        return None, 0, 1
    return (mesh.get_group("data"), mesh.get_local_rank("data"),
            sizes["data"])


def make_train_step(cfg: ArchConfig, oc: OptConfig, microbatches: int = 1,
                    mesh=None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    ``batch`` leaves (numpy arrays or tensors) are (B, ...), B divisible
    by ``microbatches`` (and by the ``data`` axis of ``mesh``); grads
    are cast to ``oc.grad_dtype``, accumulate in float32 across
    microbatches, then one AdamW update runs in place. The metrics are
    the last microbatch's, as in the reference (averaged over the
    ``data`` ranks)."""
    gdt = dtype_of(oc.grad_dtype)
    group, rank, ranks = _data_group(mesh)

    def single_grads(pairs, mb):
        live = [p.detach().requires_grad_() for _, p in pairs]
        tree = tree_from_leaves(
            (path, p) for (path, _), p in zip(pairs, live))
        with torch.enable_grad():
            loss, metrics = loss_fn(tree, cfg, mb)
            grads = torch.autograd.grad(loss, live, allow_unused=True,
                                        materialize_grads=True)
        grads = [(path, g.to(gdt)) for (path, _), g in zip(pairs, grads)]
        return grads, {k: v.detach() for k, v in metrics.items()}

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        pairs = list(tree_leaves(state.params))
        dev = pairs[0][1].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if ranks > 1:
            B = next(iter(batch.values())).shape[0]
            if B % ranks:
                raise ValueError(f"batch {B} does not split over "
                                 f"{ranks} data ranks")
            lo = rank * (B // ranks)
            batch = {k: v[lo:lo + B // ranks] for k, v in batch.items()}
        if microbatches == 1:
            grads, metrics = single_grads(pairs, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{microbatches} microbatches")
            n = B // microbatches
            acc = [torch.zeros(p.shape, dtype=f32, device=dev)
                   for _, p in pairs]
            for i in range(microbatches):
                g, metrics = single_grads(
                    pairs, {k: v[i * n:(i + 1) * n]
                            for k, v in batch.items()})
                for a, (_, gg) in zip(acc, g):
                    a += gg.to(f32)
            grads = [(path, (a / microbatches).to(gdt))
                     for (path, _), a in zip(pairs, acc)]
        if group is not None:
            for _, g in grads:
                dist.all_reduce(g, group=group)
                g /= ranks
            # the token count adds up; the losses average
            names = sorted(metrics)
            vals = torch.stack([metrics[k].to(f32) for k in names])
            dist.all_reduce(vals, group=group)
            metrics = {k: (v if k == "tokens" else v / ranks).to(
                metrics[k].dtype) for k, v in zip(names, vals)}
        _, _, opt_metrics = adamw_update(tree_from_leaves(grads), state.opt,
                                         state.params, oc)
        state.step += 1
        return state, dict(metrics, **opt_metrics)

    return train_step
