"""Build and bind the hand-written CUDA kernels of :mod:`repro_torch.kernels`.

Each ``csrc/<name>.cu`` exposes a plain C entry point. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library and bound
with :mod:`ctypes`; nothing includes PyTorch's headers, so one build takes
seconds. Libraries land in ``<checkout>/.torch_kernels/`` (listed in
``.gitignore``), named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / ".torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(source: str) -> Path:
    src = (CSRC / f"{source}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{source}-{digest[:16]}.so"


def _start(source: str):
    """Start one ``nvcc`` for ``source`` (or return None when its library
    is already built). Output goes to a temporary name, renamed into
    place on success, so a concurrent or interrupted build never leaves
    a half-written library behind."""
    out = _target(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{source}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(source: str, started) -> str:
    """Wait for one build started by :func:`_start`; returns the compiler
    log (``-Xptxas -v`` register and shared-memory report)."""
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {source}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build(sources: Iterable[str]) -> Dict[str, str]:
    """Build every named source, one ``nvcc`` each, all started together.
    Returns ``{source: compiler log}``."""
    sources = list(sources)
    with _lock:
        started = {s: _start(s) for s in sources}
        return {s: _finish(s, started[s]) for s in sources}


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            _finish(source, _start(source))
            lib = _libs[source] = ctypes.CDLL(str(_target(source)))
        return lib


class Kernel:
    """One C entry point of a kernel library, with its launch count.

    ``launches`` grows by one for every launch the entry point accepted,
    and nowhere else; a run reads it to show which kernels its path went
    through. The count is kept under a lock, because the service launches
    from more than one thread (the async engine's batches, the caller's
    builds and warm batches). A non-zero ``cudaError_t`` from the entry
    point (which returns ``cudaGetLastError()`` right after the launch)
    raises.
    """

    def __init__(self, source: str, symbol: str,
                 argtypes: Sequence[type]):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._count_lock = threading.Lock()

    def _bind(self):
        if self._fn is None:
            fn = getattr(library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, *args) -> None:
        err = self._bind()(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol} failed to launch: cudaError_t {err}")
        with self._count_lock:
            self.launches += 1
