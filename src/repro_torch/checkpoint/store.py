"""Sharded, async, restart-safe checkpointing (``repro.checkpoint.store``
for torch tensor trees, on the same disk layout).

Layout: ``<dir>/step_<N>/`` holding one ``.npy`` per tree leaf, named
``<key>.p<proc>.npy`` with the key joined from the leaf's path by
``__`` (a ``TrainState`` gives ``0__...``, ``1__m__...``, ``1__step``,
``2``), plus a ``manifest.json`` (keys, shapes, dtype names, process
count, extra) written LAST: a step directory without a manifest is
incomplete and ignored, so a killed writer never corrupts a restore
(atomicity via rename). Either package restores the other's files.

bfloat16: numpy has no such dtype. ``repro`` writes a bfloat16 leaf
(``ml_dtypes.bfloat16``) as an ``.npy`` of descr ``'<V2'`` and names it
``"bfloat16"`` in the manifest; the port writes the same bytes under the
same header and reads such a file back through a 16-bit integer view.

Async: ``CheckpointManager.save_async`` copies the tree to host memory
synchronously (device -> numpy) and writes on a background thread, so
training resumes at once.

Several ranks (a ``torch.distributed`` world of more than one process):
each rank writes its own files, ``<key>.p<rank>.npy`` — a DTensor leaf's
local shard, a plain leaf whole — into one shared temporary directory.
The step is committed at the manager's next ``wait()``: every rank
reports whether its write succeeded and which block of each leaf its
file holds (global offset and shape, from
``compute_local_shape_and_global_offset``), rank 0 writes the manifest
(global shapes and, under ``"blocks"``, ``[rank, offset, shape]`` of
every file) and renames the directory, and no rank returns before the
step is visible. A single-process step has whole arrays and no
``"blocks"`` (the manifest ``repro`` writes).

Restore onto any layout: every leaf is checked against the manifest's
global shape and dtype (``ValueError`` naming the key on a mismatch) and
comes back as the template leaf asks — a plain leaf whole, a DTensor leaf
as this rank's shard of the template's mesh and placements — read from the
one file that holds exactly that block (a replicated leaf, the same
layout) or assembled from the files that cover it. So a step written on
2 ranks restores on 1 or 4, and one written by one process (``repro``'s
included) onto a placed template. A multi-rank step written without
``"blocks"`` (before they were recorded) restores only on its own
layout and raises on another.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.models.builder import tree_flatten, tree_unflatten

PyTree = Any
_SEP = "__"
_BF16_DESCR = "<V2"     # the header ml_dtypes' bfloat16 gets from numpy


def _world() -> Tuple[int, int]:
    """(this process's rank, number of processes) of the world; (0, 1)
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _host(leaf) -> Tuple[np.ndarray, str, list, list]:
    """(host copy, manifest dtype name, global shape, global offset of the
    copy) of one leaf: of a DTensor, this rank's shard. A bfloat16 leaf
    is its bits as uint16. A copy even of a host tensor, since the train
    step updates its state in place."""
    if isinstance(leaf, torch.Tensor):
        shape = list(leaf.shape)
        offset = [0] * len(shape)
        t = leaf.detach()
        if isinstance(t, DTensor):
            offset = list(compute_local_shape_and_global_offset(
                t.shape, t.device_mesh, t.placements)[1])
            t = t.to_local()
        t = t.clone() if t.device.type == "cpu" else t.cpu()
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16).numpy().view(np.uint16), "bfloat16",
                    shape, offset)
        return t.numpy(), str(t.numpy().dtype), shape, offset
    arr = np.array(leaf)
    return arr, str(arr.dtype), list(arr.shape), [0] * arr.ndim


def _host_snapshot(tree: PyTree) -> Dict[str, Tuple]:
    """key -> (host array, dtype name, global shape, offset) for every
    leaf, copied off the device now."""
    return {_SEP.join(path): _host(leaf)
            for path, leaf in tree_flatten(tree)}


def _save_npy(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    arr = np.ascontiguousarray(arr, dtype="<u2")
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": _BF16_DESCR, "fortran_order": False,
            "shape": arr.shape})
        f.write(arr.tobytes())


def _load(path: str, dtype: str, mmap: bool = False) -> np.ndarray:
    """One file's array (C order, as written); a bfloat16 one as int16."""
    arr = np.load(path, mmap_mode="r" if mmap else None)
    return arr.view(np.int16) if dtype == "bfloat16" else arr


def _to_torch(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr).view(torch.bfloat16)
    return torch.from_numpy(arr.astype(dtype))


def _blocks_held(flat: Dict) -> Dict[str, list]:
    """key -> [offset, shape] of the block this process's file holds."""
    return {k: [off, list(arr.shape)]
            for k, (arr, _, _, off) in flat.items()}


def _write_files(tmp: str, flat: Dict, process_index: int) -> None:
    for key, (arr, dtype, _, _) in flat.items():
        _save_npy(os.path.join(tmp, f"{key}.p{process_index}.npy"), arr,
                  dtype)


def _commit(directory: str, step: int, tmp: str, flat: Dict,
            extra: Optional[Dict], num_processes: int,
            blocks: Optional[Dict] = None) -> str:
    """Write the manifest into ``tmp`` and rename it to the step's
    directory (replacing an older one). ``blocks``: key -> ``[rank,
    offset, shape]`` of every file, for a step of several processes."""
    final = os.path.join(directory, f"step_{step:08d}")
    manifest = {
        "step": step,
        "keys": sorted(flat),
        "shapes": {k: v[2] for k, v in flat.items()},
        "dtypes": {k: v[1] for k, v in flat.items()},
        "num_processes": num_processes,
        "extra": extra or {},
    }
    if blocks is not None:
        manifest["blocks"] = blocks
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _write(directory: str, step: int, flat: Dict, extra: Optional[Dict],
           process_index: int, num_processes: int) -> str:
    """One process's whole step: its files and the commit."""
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=f".tmp_step{step}_")
    try:
        _write_files(tmp, flat, process_index)
        return _commit(directory, step, tmp, flat, extra, num_processes)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _shared_tmp(directory: str, step: int) -> str:
    """The temporary directory that every rank of a world writes one
    step's files into (a name each rank derives alone)."""
    return os.path.join(directory, f".tmp_step{step}_shared")


def save_pytree(directory: str, step: int, tree: PyTree,
                extra: Optional[Dict] = None,
                process_index: int = 0, num_processes: int = 1) -> str:
    """Write one checkpoint step (atomic via tmp-dir rename)."""
    return _write(directory, step, _host_snapshot(tree), extra,
                  process_index, num_processes)


def _complete_steps(directory: str):
    return sorted(int(n.split("_")[1]) for n in os.listdir(directory)
                  if n.startswith("step_") and os.path.exists(
                      os.path.join(directory, n, "manifest.json")))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _complete_steps(directory)
    return steps[-1] if steps else None


def _file_blocks(manifest: Dict, key: str) -> Optional[list]:
    """``[rank, offset, shape]`` of each file of ``key``: whole arrays in
    a single-process step; None for a multi-rank step written before the
    manifest recorded them."""
    if "blocks" in manifest:
        return manifest["blocks"][key]
    if manifest.get("num_processes", 1) == 1:
        shape = manifest["shapes"][key]
        return [[0, [0] * len(shape), shape]]
    return None


def _read_block(d: str, key: str, dtype: str, blocks: list,
                offset, shape) -> np.ndarray:
    """The block of ``key`` at global ``offset`` and of ``shape``: one
    file's whole array if a file holds exactly it, else cut from the
    files that cover it (each distinct block once)."""
    path = lambda r: os.path.join(d, f"{key}.p{r}.npy")  # noqa: E731
    want = (list(offset), list(shape))
    for rank, off, shp in blocks:
        if (list(off), list(shp)) == want:
            arr = _load(path(rank), dtype)
            if list(arr.shape) != list(shp):
                raise ValueError(f"{key}: file of process {rank} holds "
                                 f"{arr.shape}, the manifest {shp}")
            return arr
    out = np.empty(shape, np.int16 if dtype == "bfloat16" else dtype)
    covered, seen = 0, set()
    for rank, off, shp in blocks:
        if (tuple(off), tuple(shp)) in seen:
            continue
        seen.add((tuple(off), tuple(shp)))
        lo = [max(a, b) for a, b in zip(off, offset)]
        hi = [min(a + n, b + m) for a, n, b, m in zip(off, shp, offset,
                                                       shape)]
        if any(h <= low for low, h in zip(lo, hi)):
            continue
        arr = _load(path(rank), dtype, mmap=True)
        if list(arr.shape) != list(shp):
            raise ValueError(f"{key}: file of process {rank} holds "
                             f"{arr.shape}, the manifest {shp}")
        out[tuple(slice(a - b, h - b) for a, h, b in zip(lo, hi, offset))] \
            = arr[tuple(slice(a - b, h - b) for a, h, b in zip(lo, hi, off))]
        covered += int(np.prod([h - a for a, h in zip(lo, hi)]))
    if covered != out.size:
        raise ValueError(f"{key}: the checkpoint's files cover {covered} of "
                         f"the {out.size} elements asked for")
    return out


def _dtype_name(leaf) -> Optional[str]:
    """The manifest's name for a template leaf's dtype (``"bfloat16"``,
    else numpy's); None for a leaf that is not an array."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    if isinstance(leaf, (np.ndarray, np.generic)):
        return str(leaf.dtype)
    return None


def restore_pytree(directory: str, step: int, template: PyTree,
                   process_index: int = 0) -> Tuple[PyTree, Dict]:
    """Restore into the structure of ``template`` (values ignored), on any
    layout (see the module docstring): each leaf a tensor of the
    manifest's dtype, on the template leaf's device (the CPU where the
    template leaf is not a tensor); a DTensor leaf is ``process_index``'s
    shard of the template leaf's mesh and placements. Raises
    ``ValueError`` naming the key where a template leaf's shape or dtype
    is not the checkpoint's global shape or dtype, and where a file does
    not hold what the manifest says."""
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    for path, leaf in tree_flatten(template):
        key = _SEP.join(path)
        dtype, shape = manifest["dtypes"][key], manifest["shapes"][key]
        if list(np.shape(leaf)) != list(shape):
            raise ValueError(f"{key}: the checkpoint holds shape "
                             f"{tuple(shape)}, the template "
                             f"{tuple(np.shape(leaf))}")
        held = _dtype_name(leaf)
        if held is not None and held != dtype:
            raise ValueError(f"{key}: the checkpoint holds dtype {dtype}, "
                             f"the template {held}")
        want_shape, want_off = shape, [0] * len(shape)
        if isinstance(leaf, DTensor):
            want_shape, want_off = compute_local_shape_and_global_offset(
                leaf.shape, leaf.device_mesh, leaf.placements)
        blocks = _file_blocks(manifest, key)
        if blocks is None:     # its own layout: this process's own file
            if process_index >= manifest["num_processes"]:
                raise ValueError(
                    f"{key}: written by {manifest['num_processes']} "
                    f"processes without block offsets, read by process "
                    f"{process_index}")
            arr = _load(os.path.join(d, f"{key}.p{process_index}.npy"),
                        dtype)
            if list(arr.shape) != list(want_shape):
                raise ValueError(
                    f"{key}: the checkpoint holds a block of shape "
                    f"{tuple(arr.shape)} for process {process_index}, the "
                    f"template {tuple(want_shape)}: written on another "
                    f"layout, without block offsets")
        else:
            arr = _read_block(d, key, dtype, blocks, want_off, want_shape)
        t = _to_torch(arr, dtype)
        if isinstance(leaf, DTensor):
            t = DTensor.from_local(
                t.to(leaf.to_local().device), leaf.device_mesh,
                leaf.placements, run_check=False, shape=leaf.shape,
                stride=leaf.stride())
        elif isinstance(leaf, torch.Tensor):
            t = t.to(leaf.device)
        leaves.append(t)
    return tree_unflatten(template, leaves), manifest["extra"]


class CheckpointManager:
    """Keeps the last ``keep`` steps; async background writes. In a world
    of several ranks every rank makes one and calls it alike (see the
    module docstring)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self.rank, self.ranks = _world()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending: Optional[Tuple] = None    # written, not committed

    def wait(self):
        """Join the writer (and, on several ranks, commit its step);
        re-raise the error it met, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if self._pending is not None:
            err = self._commit_shared(err)
        if err is not None:
            raise err

    def _commit_shared(self, err: Optional[BaseException]
                       ) -> Optional[BaseException]:
        """Every rank has written its files of the pending step (or
        failed): rank 0 commits it when all succeeded. Collective."""
        step, tmp, flat, extra = self._pending
        self._pending = None
        failed, held = _failed_ranks(err, self.ranks, _blocks_held(flat))
        if not failed and self.rank == 0:
            blocks = {k: [[r, *held[r][k]] for r in range(self.ranks)]
                      for k in flat}
            try:
                _commit(self.directory, step, tmp, flat, extra, self.ranks,
                        blocks)
                self._gc()
            except BaseException as e:       # told to every rank below
                err = e
        failed, _ = _failed_ranks(err, self.ranks)
        if failed and err is None:
            err = RuntimeError(f"checkpoint step {step}: ranks {failed} "
                               f"failed to write or commit it")
        return err

    def save_async(self, step: int, tree: PyTree,
                   extra: Optional[Dict] = None):
        self.wait()
        flat = _host_snapshot(tree)
        if self.ranks == 1:
            def write():
                _write(self.directory, step, flat, extra, 0, 1)
                self._gc()
        else:
            tmp = _shared_tmp(self.directory, step)
            self._pending = (step, tmp, flat, extra)

            def write():
                os.makedirs(tmp, exist_ok=True)
                _write_files(tmp, flat, self.rank)

        def work():
            try:
                write()
            except BaseException as e:   # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save(self, step: int, tree: PyTree, extra: Optional[Dict] = None):
        self.save_async(step, tree, extra)
        self.wait()

    def _gc(self):
        for s in _complete_steps(self.directory)[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, template: PyTree
                       ) -> Optional[Tuple[int, PyTree, Dict]]:
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None
        tree, extra = restore_pytree(self.directory, step, template,
                                     self.rank)
        return step, tree, extra


def _failed_ranks(err: Optional[BaseException], ranks: int,
                  payload: Any = None) -> Tuple[list, list]:
    """The ranks whose ``err`` is set, agreed by all ranks, and every
    rank's ``payload`` (collective)."""
    got = [None] * ranks
    dist.all_gather_object(got, (err is not None, payload))
    return [r for r, (f, _) in enumerate(got) if f], [p for _, p in got]
