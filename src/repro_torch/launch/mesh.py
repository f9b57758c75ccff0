"""Mesh construction over the ranks of a ``torch.distributed`` world
(``repro.launch.mesh``).

Functions, not module-level constants: importing this module starts no
process group. Meshes are ``DeviceMesh`` objects with the reference's
axis names and shapes; a mesh larger than the world raises.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.core.devices import resolve_device
from repro_torch.core.distributed import init_world
from repro_torch.sharding.partition import mesh_context

__all__ = ["make_host_mesh", "make_production_mesh", "make_elastic_mesh",
           "mesh_context"]


def _make_mesh(shape, axes, device) -> DeviceMesh:
    """A mesh of ``shape`` over every rank of the world, which must have
    exactly ``prod(shape)`` ranks (checked before any world starts). On a
    world of the ``fake`` backend (the dry run's) a CUDA mesh needs no
    card: nothing is allocated there."""
    fake = dist.is_initialized() and dist.get_backend() == "fake"
    dev = torch.device(device) if fake else resolve_device(device)
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if need != world:
        raise RuntimeError(f"a {tuple(shape)} mesh {tuple(axes)} needs "
                           f"{need} ranks; the world has {world}")
    init_world(dev)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"
                         ) -> DeviceMesh:
    """(16, 16) = 256 ranks ("data", "model"); multi-pod adds the leading
    ("pod",) axis: (2, 16, 16) = 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device)


def make_elastic_mesh(data: int, model: int = 16, pod: int = 1,
                      device="cuda") -> DeviceMesh:
    """Degraded-operation meshes after failures: whole TP groups only
    (shrink 'data'; 'model' stays intact — see ft/elastic.py)."""
    shape = (pod, data, model) if pod > 1 else (data, model)
    axes = ("pod", "data", "model") if pod > 1 else ("data", "model")
    return _make_mesh(shape, axes, device)


def make_host_mesh(model: int = 1, device="cuda") -> DeviceMesh:
    """A ("data", "model") mesh over the world's ranks; starts a world of
    one rank when none exists (tear it down with
    ``torch.distributed.destroy_process_group()``)."""
    init_world(device)
    n = dist.get_world_size()
    return _make_mesh((max(1, n // model), model), ("data", "model"),
                      device)
