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
mesh dimension) on a ``DeviceMesh``. On a mesh of more than one rank
:func:`place_tree` makes every leaf a DTensor (replicated leaves too),
and the model runs on them under :func:`mesh_context`, which also lets
plain constants (positions, masks) stand in as replicated DTensors.
``constrain`` redistributes a DTensor over its own mesh, as the
reference's ``with_sharding_constraint``; it is the identity on a plain
tensor. Where DTensor has no sharding strategy for an op, or the op is
independent along the split dimensions, the model runs it on the local
shards through :func:`local_apply` / :func:`per_group`, and splits or
merges heads through :func:`whole_pieces` / :func:`regroup`; each
redistributes its inputs explicitly, and the dry run counts those
collectives. Code that works on a local shard finds where it lies
through :func:`shard_range`.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.core.distributed import mesh_device

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

_DEPTH = [0]      # open mesh_context blocks (implicit replication is global)


@contextlib.contextmanager
def mesh_context(mesh):
    """Run code on ``mesh``'s DTensors (the reference's ``jax.set_mesh``):
    plain tensors made inside (positions, masks, scalars) stand in as
    replicated DTensors. Blocks nest; the outermost one switches that
    on and off. :func:`constrain` and :func:`local_apply` take each
    DTensor's own mesh."""
    ctx = implicit_replication() if _DEPTH[0] == 0 else contextlib.nullcontext()
    _DEPTH[0] += 1
    try:
        with ctx:
            yield mesh
    finally:
        _DEPTH[0] -= 1


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

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """One rank's shard of a ``shape`` tensor (the spec divides it)."""
        out = list(shape)
        for name, p in zip(self.mesh.mesh_dim_names, self.placements):
            if isinstance(p, Shard):
                out[p.dim] //= _mesh_axes(self.mesh)[name]
        return tuple(out)

    def place(self, x: torch.Tensor, dtensor: bool = False) -> torch.Tensor:
        """``x``, the same full value on every rank, on this rank's
        device of the mesh: a plain tensor on a one-rank mesh (onto the
        card) unless ``dtensor``, else a DTensor of this rank's shard
        (cut locally, no collective), replicated leaves included."""
        if x.device.type not in (self.mesh.device_type, "meta"):
            x = x.to(mesh_device(self.mesh))
        if self.mesh.size() == 1 and not dtensor:
            return x
        return distribute_tensor(x, self.mesh, self.placements,
                                 src_data_rank=None)


def logical_to_sharding(shape: Sequence[int], axes: Axes, mesh,
                        rules: Optional[Dict] = None) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(shape, axes, mesh,
                                               rules or PARAM_RULES))


def constrain(x: torch.Tensor, axes: Axes, rules: Optional[Dict] = None
              ) -> torch.Tensor:
    """Redistribute a DTensor over its mesh as ``axes`` say; the identity
    on a plain tensor (the reference's no-op on one device). The mesh is
    the DTensor's own, not the ambient one, so a recompute in the
    backward (``torch.utils.checkpoint``), which may run outside
    :func:`mesh_context`, constrains alike."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    sharding = NamedSharding(mesh, logical_to_spec(x.shape, axes, mesh,
                                                   rules or ACT_RULES))
    return x.redistribute(mesh, sharding.placements)


def whole_pieces(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` ready to split dimension ``dim`` into ``n`` pieces (heads):
    on a DTensor, every mesh axis that splits ``dim`` into a number of
    shards that does not divide ``n`` is gathered first (an explicit
    collective; DTensor refuses a view that would cut a piece). The
    identity on a plain tensor."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    mesh = x.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim
          and n % mesh.size(i) else p for i, p in enumerate(x.placements)]
    return x if pl == list(x.placements) else x.redistribute(mesh, pl)


def shard_range(x: DTensor, dim: int) -> Tuple[int, int]:
    """(first index, length) along ``dim`` of this rank's shard of
    ``x``, as DTensor lays the shards out (uneven splits included)."""
    size, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return offset[dim], size[dim]


def on_shards(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` on each rank's shard of ``x``, the result keeping ``x``'s
    placements: for an op along trailing dimensions whose local result is
    this rank's shard of the global one, linear in it (heads regrouped,
    KV heads repeated within a rank's group). The backward's gradient is first
    brought to those placements: DTensor's own view and repeat refuse, or
    get wrong, a gradient split otherwise. ``fn(x)`` on a plain tensor."""
    if not isinstance(x, DTensor):
        return fn(x)
    mesh, pl = x.device_mesh, x.placements
    # a partial sum's gradient is the whole upstream one on every rank
    grad_pl = [Replicate() if p.is_partial() else p for p in pl]
    return DTensor.from_local(fn(x.to_local(grad_placements=grad_pl)), mesh,
                              pl, run_check=False)


def regroup(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.reshape(*shape)`` for a reshape that splits or merges trailing
    dimensions (heads and head width), keeping every split where it is
    (a split of the first reshaped dimension stays on the first new one;
    :func:`whole_pieces` makes it divide), through :func:`on_shards`."""
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    sizes = list(shape)
    for d, p in enumerate(x.placements):
        if isinstance(p, Shard):
            sizes[p.dim] //= x.device_mesh.size(d)
    return on_shards(lambda t: t.reshape(*sizes), x)


def local_apply(fn, args, in_axes, out_like: int = 0):
    """``fn(*args)`` on this rank's shards, for a computation that is
    independent along the split dimensions (attention per batch row and
    head; MoE routing per group) where DTensor has no strategy for an op
    (``scatter_``, ``sort``, a row ``gather``) or would need a strided
    split to merge two split dimensions (an einsum's batched matmul).

    Each DTensor argument is redistributed as its logical ``in_axes``
    entry says under ``ACT_RULES`` (an explicit collective where it is
    laid out otherwise, which the dry run counts); ``fn`` runs on the
    local shards; each tensor result comes back as a DTensor with the
    placements of argument ``out_like``. A ``None`` entry passes its
    argument as it is (a plain tensor, the same on every rank). With no
    DTensor argument it is ``fn(*args)``; the mesh is the arguments'."""
    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    mesh = dts[0].device_mesh
    placements = [
        NamedSharding(mesh, logical_to_spec(a.shape, axes, mesh,
                                            ACT_RULES)).placements
        if isinstance(a, DTensor) and axes is not None else None
        for a, axes in zip(args, in_axes)]
    out_pl = placements[out_like]
    local = []
    for a, pl in zip(args, placements):
        if pl is None:
            local.append(a)
            continue
        # an argument replicated on a mesh axis that splits the work gets
        # only this rank's part of its gradient there: a partial sum
        grad_pl = [Partial() if isinstance(p, Replicate)
                   and isinstance(q, Shard) else p
                   for p, q in zip(pl, out_pl)]
        local.append(a.redistribute(mesh, pl).to_local(
            grad_placements=grad_pl))
    out = fn(*local)
    wrap = lambda o: DTensor.from_local(  # noqa: E731
        o, mesh, out_pl, run_check=False)
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def per_group(fn, *args):
    """:func:`local_apply` for tensors that are all ``(G, ...)`` with
    independent groups: each split over ``G`` as ``act_batch`` says and
    replicated on the other mesh axes, results too."""
    return local_apply(fn, args, [("act_batch",) + (None,) * (a.ndim - 1)
                                  for a in args])


def tree_shardings(tree, axes_tree, mesh, rules: Optional[Dict] = None):
    """A tree of tensors (or a ``TrainState`` of them) + its matching
    logical-axes tree -> the same structure of :class:`NamedSharding`."""
    from repro_torch.models.builder import tree_flatten, tree_unflatten
    axes = dict(tree_flatten(axes_tree,
                             is_leaf=lambda a: isinstance(a, tuple)))
    return tree_unflatten(tree, [
        logical_to_sharding(leaf.shape, axes[key], mesh, rules)
        for key, leaf in tree_flatten(tree)])


def place_tree(tree, shardings, dtensor: bool = False):
    """``tree`` with each leaf placed as its :class:`NamedSharding` in
    ``shardings`` (from :func:`tree_shardings`) says; ``dtensor`` makes
    DTensors of them on a one-rank mesh too."""
    from repro_torch.models.builder import tree_flatten, tree_unflatten
    sh = [s for _, s in tree_flatten(
        shardings, is_leaf=lambda s: isinstance(s, NamedSharding))]
    return tree_unflatten(tree, [s.place(x, dtensor) for (_, x), s in zip(
        tree_flatten(tree), sh)])
