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

from repro_torch.models.builder import tree_flatten, tree_unflatten

PyTree = Any
_SEP = "__"
_BF16_DESCR = "<V2"     # the header ml_dtypes' bfloat16 gets from numpy


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(host copy, manifest dtype name) of one leaf; a bfloat16 leaf is
    its bits as uint16. A copy even of a host tensor, since the train step
    updates its state in place."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = t.clone() if t.device.type == "cpu" else t.cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _host_snapshot(tree: PyTree) -> Dict[str, Tuple[np.ndarray, str]]:
    """key -> (host array, dtype name) for every leaf, copied off the
    device now."""
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


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)          # C order, as written
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.astype(dtype))


def _write(directory: str, step: int, flat: Dict, extra: Optional[Dict],
           process_index: int, num_processes: int) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=f".tmp_step{step}_")
    try:
        for key, (arr, dtype) in flat.items():
            _save_npy(os.path.join(tmp, f"{key}.p{process_index}.npy"),
                      arr, dtype)
        manifest = {
            "step": step,
            "keys": sorted(flat),
            "shapes": {k: list(a.shape) for k, (a, _) in flat.items()},
            "dtypes": {k: dt for k, (_, dt) in flat.items()},
            "num_processes": num_processes,
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


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


def restore_pytree(directory: str, step: int, template: PyTree,
                   process_index: int = 0) -> Tuple[PyTree, Dict]:
    """Restore into the structure of ``template`` (values ignored): each
    leaf a tensor of the manifest's dtype, on the template leaf's device
    (the CPU where the template leaf is not a tensor)."""
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    for path, leaf in tree_flatten(template):
        key = _SEP.join(path)
        t = _load_leaf(os.path.join(d, f"{key}.p{process_index}.npy"),
                       manifest["dtypes"][key])
        leaves.append(t.to(leaf.device) if isinstance(leaf, torch.Tensor)
                      else t)
    return tree_unflatten(template, leaves), manifest["extra"]


class CheckpointManager:
    """Keeps the last ``keep`` steps; async background writes."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        """Join the writer; re-raise the error it met, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: PyTree,
                   extra: Optional[Dict] = None):
        self.wait()
        flat = _host_snapshot(tree)

        def work():
            try:
                _write(self.directory, step, flat, extra, 0, 1)
                self._gc()
            except BaseException as e:   # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save(self, step: int, tree: PyTree, extra: Optional[Dict] = None):
        self.wait()
        save_pytree(self.directory, step, tree, extra)
        self._gc()

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
        tree, extra = restore_pytree(self.directory, step, template)
        return step, tree, extra
