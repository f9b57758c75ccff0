"""Logical-axis sharding rules (``repro.sharding.partition`` over a
``torch.distributed`` ``DeviceMesh``).

Every parameter carries a tuple of *logical axis names*; rules map
logical names to mesh axes. ``logical_to_spec`` drops any assignment
whose dimension is not divisible by the mesh-axis size (e.g.
whisper-tiny's 6 heads on a 16-way ``model`` axis fall back to
replication), so one rule set serves every architecture on every mesh.
The rules and the spec they give are the reference's, element for
element: ``None``, a mesh axis name, or a tuple of names.

Parallelism mapping (train):
  * DP/FSDP — ``batch`` over ("pod","data"); params' ``fsdp`` (largest
    non-TP dim) over "data";
  * TP — ``heads``/``kv``/``ff``/``vocab`` over "model";
  * EP — ``experts`` over "model";
  * SP — activation ``act_seq`` over "model" between blocks.

A spec becomes DTensor placements (``Shard(d)`` / ``Replicate()`` per
mesh dimension) on a ``DeviceMesh``. The train step keeps parameters
replicated so far (``ROADMAP.md`` queues FSDP/TP placement); ``constrain``
is the identity except on a DTensor inside :func:`mesh_context`.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.core.distributed import mesh_device
from repro_torch.models.builder import tree_flatten, tree_unflatten

Axes = Tuple[Optional[Union[str, Tuple[str, ...]]], ...]
Spec = Tuple[Optional[Union[str, Tuple[str, ...]]], ...]

# parameter logical axes
PARAM_RULES: Dict[str, Optional[Union[str, Tuple[str, ...]]]] = {
    "vocab": "model",
    "heads": "model",      # fused heads*head_dim output dims
    "kv": "model",
    "ff": "model",
    "experts": "model",
    "fsdp": "data",        # ZeRO-3 shard of the non-TP major dim
    "embed": None,
    "layers": None,        # stacked layer axis
    "conv": None,
    "state": None,
    "lora": None,
    None: None,
}

# activation logical axes
ACT_RULES: Dict[str, Optional[Union[str, Tuple[str, ...]]]] = {
    "act_batch": ("pod", "data"),
    "act_batch_nopod": "data",
    "act_seq": "model",     # sequence parallelism between blocks
    "act_embed": None,
    "act_heads": "model",
    "cache_seq": "model",   # KV cache length dim for decode
    "act_experts": "model",
    None: None,
}

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` the ambient mesh of :func:`constrain` (the
    reference's ``jax.set_mesh``)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def _mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size, for a ``DeviceMesh`` or any object with the
    reference's ``axis_names`` and ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def _filter_assignment(mesh, assignment):
    """Drop mesh axes absent from this mesh (e.g. 'pod' on single-pod);
    returns (normalized assignment or None, product of axis sizes)."""
    if assignment is None:
        return None, 1
    sizes = _mesh_axes(mesh)
    axes = (assignment,) if isinstance(assignment, str) else tuple(assignment)
    present = tuple(a for a in axes if a in sizes)
    if not present:
        return None, 1
    size = 1
    for a in present:
        size *= sizes[a]
    return (present[0] if len(present) == 1 else present), size


def logical_to_spec(shape: Sequence[int], axes: Axes, mesh,
                    rules: Dict) -> Spec:
    """The partition spec from logical axes, with divisibility fallback:
    one entry a dimension."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} vs axes {tuple(axes)}")
    parts = []
    for dim, ax in zip(shape, axes):
        assignment, size = _filter_assignment(mesh, rules.get(ax, None))
        if assignment is None or size == 1 or dim % size != 0:
            parts.append(None)
        else:
            parts.append(assignment)
    return tuple(parts)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh``, with its DTensor placements."""
    mesh: object
    spec: Spec

    @property
    def placements(self) -> tuple:
        """``Shard(d)`` on each mesh dimension that a tensor dimension
        ``d`` is split over, ``Replicate()`` on the others."""
        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [d for d, part in enumerate(self.spec)
                    if part == name or (isinstance(part, tuple)
                                        and name in part)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def place(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` on this rank's device of the mesh: a plain tensor where
        every placement replicates (a one-rank mesh: onto the card),
        else a DTensor."""
        x = x.to(mesh_device(self.mesh))
        placements = self.placements
        if all(isinstance(p, Replicate) for p in placements):
            return x
        return distribute_tensor(x, self.mesh, placements)


def logical_to_sharding(shape: Sequence[int], axes: Axes, mesh,
                        rules: Optional[Dict] = None) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(shape, axes, mesh,
                                               rules or PARAM_RULES))


def constrain(x: torch.Tensor, axes: Axes, rules: Optional[Dict] = None
              ) -> torch.Tensor:
    """Redistribute a DTensor as ``axes`` say under the ambient mesh; the
    identity on a plain tensor or with no mesh set (the reference's
    no-op on one device)."""
    mesh = _MESH.get()
    if mesh is None or not isinstance(x, DTensor):
        return x
    sharding = NamedSharding(mesh, logical_to_spec(x.shape, axes, mesh,
                                                   rules or ACT_RULES))
    return x.redistribute(mesh, sharding.placements)


def tree_shardings(tree, axes_tree, mesh, rules: Optional[Dict] = None):
    """A tree of tensors (or a ``TrainState`` of them) + its matching
    logical-axes tree -> the same structure of :class:`NamedSharding`."""
    axes = dict(tree_flatten(axes_tree,
                             is_leaf=lambda a: isinstance(a, tuple)))
    return tree_unflatten(tree, [
        logical_to_sharding(leaf.shape, axes[key], mesh, rules)
        for key, leaf in tree_flatten(tree)])


def place_tree(tree, shardings):
    """``tree`` with each leaf placed as its :class:`NamedSharding` in
    ``shardings`` (from :func:`tree_shardings`) says."""
    sh = [s for _, s in tree_flatten(
        shardings, is_leaf=lambda s: isinstance(s, NamedSharding))]
    return tree_unflatten(tree, [s.place(x) for (_, x), s in zip(
        tree_flatten(tree), sh)])
