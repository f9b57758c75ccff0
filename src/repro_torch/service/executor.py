"""Multi-backend batch executor for RLC query batches.

One interface over four engines:

* ``cuda``   — the CUDA merge-join kernel on the :class:`DeviceIndex`
  (its plain version when the index lies on the CPU);
* ``sorted`` — torch sorted-key intersection on the padded device layout
  (:meth:`DeviceIndex.query_batch` with ``method="sorted"``);
* ``numpy``  — frozen CSR merge-join (:meth:`FrozenRLCIndex.query_batch`);
* ``python`` — dict-layout Algorithm 1 (:meth:`RLCIndex.query`), the
  always-available reference.

Where the device layout lies on a CUDA device, the kernel is the only
backend: ``auto`` resolves to ``cuda``, naming another backend raises,
and a failure of the kernel propagates to the caller. Where the layout
lies on the CPU (or is absent), a backend that raises hands the batch
down a fallback chain toward ``python``; each step counts in
``fallbacks`` and the answering backend is recorded.
Per-backend latency/throughput lands in
:class:`repro_torch.service.metrics.LatencyRecorder` and in the shared
metrics registry (labeled by backend and shard), with per-attempt spans
when the batch rides a sampled trace.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.minimum_repeat import LabelSeq
from repro_torch.core.rlc_index import FrozenRLCIndex, RLCIndex
from repro_torch.obs import NULL_OBS

from .metrics import LatencyRecorder

# Every backend, in the order a failed batch walks them on a CPU layout.
BACKENDS = ("cuda", "sorted", "numpy", "python")
# What ``auto`` picks on a CPU layout, where the kernel's plain version
# is the slow (Q, E, E) broadcast.
CPU_ORDER = ("sorted", "numpy", "cuda", "python")


class ExecutorError(RuntimeError):
    """Raised when no backend (including the fallbacks) can run a batch."""


class BatchExecutor:
    def __init__(self, index: RLCIndex,
                 frozen: Optional[FrozenRLCIndex] = None,
                 device_index=None,
                 id_to_mr: Optional[Sequence[LabelSeq]] = None,
                 backend: str = "auto", obs=None, shard: str = "-"):
        if backend != "auto" and backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r}; choose from "
                f"{('auto',) + BACKENDS}")
        self.index = index
        self.frozen = frozen
        self.device_index = device_index
        self.id_to_mr = list(id_to_mr) if id_to_mr is not None else None
        self.backend = backend
        if self.on_cuda:
            self.resolve()          # refuses any backend but the kernel
        self.recorders: Dict[str, LatencyRecorder] = {
            b: LatencyRecorder(b) for b in BACKENDS}
        self.fallbacks = 0
        self.obs = obs or NULL_OBS
        reg = self.obs.registry
        lat = reg.histogram(
            "rlc_executor_batch_seconds",
            desc="wall time of one executed batch, by answering backend",
            unit="s", labelnames=("backend", "shard"))
        bat = reg.counter("rlc_executor_batches",
                          desc="batches answered, by backend",
                          labelnames=("backend", "shard"))
        qry = reg.counter("rlc_executor_queries",
                          desc="real (unpadded) queries answered",
                          labelnames=("backend", "shard"))
        self._m_lat = {b: lat.labels(backend=b, shard=shard)
                       for b in BACKENDS}
        self._m_bat = {b: bat.labels(backend=b, shard=shard)
                       for b in BACKENDS}
        self._m_qry = {b: qry.labels(backend=b, shard=shard)
                       for b in BACKENDS}
        self._m_fallback = reg.counter(
            "rlc_executor_fallbacks",
            desc="batches not answered by the first-choice backend",
            labelnames=("from", "to", "shard"))
        self._shard = shard

    @property
    def on_cuda(self) -> bool:
        """Whether the device layout (repointed by ``apply_delta``) lies
        on a CUDA device."""
        return (self.device_index is not None
                and self.device_index.device.type == "cuda")

    # ------------------------------------------------------------------ #
    def available(self, backend: str) -> bool:
        if backend in ("cuda", "sorted"):
            return self.device_index is not None
        if backend == "numpy":
            return self.frozen is not None
        if backend == "python":
            return self.id_to_mr is not None
        return False

    def resolve(self, backend: Optional[str] = None) -> str:
        """Map ``auto`` (or None) to the best available backend: the
        kernel alone when the device layout lies on a CUDA device."""
        b = backend or self.backend
        if self.on_cuda:
            if b not in ("auto", "cuda"):
                raise ValueError(f"backend {b!r} does not serve a layout on "
                                 f"{self.device_index.device}")
            return "cuda"
        if b == "auto":
            for cand in CPU_ORDER:
                if self.available(cand):
                    return cand
            raise ExecutorError("no backend available")
        return b

    # ------------------------------------------------------------------ #
    def execute(self, s: np.ndarray, t: np.ndarray, mr_id: np.ndarray,
                n_real: Optional[int] = None,
                backend: Optional[str] = None,
                trace=None) -> Tuple[np.ndarray, str]:
        """Answer a batch; returns ``(answers[:n_real], backend)``.

        On a CUDA layout only the kernel runs and its failure raises.
        Otherwise tries the requested backend, then every remaining
        backend in ``BACKENDS`` order; each step past the first counts in
        ``fallbacks``. ``trace``: optional
        :class:`repro_torch.obs.tracing.Trace`; each attempt gets an
        ``exec:<backend>`` span, so a fallback chain is visible as
        consecutive spans.
        """
        first = self.resolve(backend)
        chain = [first]
        if not self.on_cuda:
            chain += [b for b in BACKENDS
                      if b != first and self.available(b)]
        n = len(s) if n_real is None else int(n_real)
        last_err: Optional[Exception] = None
        for i, b in enumerate(chain):
            if not self.available(b):
                continue
            try:
                t0 = time.perf_counter()
                ans = self._run(b, s, t, mr_id, n)
                dt = time.perf_counter() - t0
                self.recorders[b].record(dt, n)
                self._m_lat[b].observe(dt)
                self._m_bat[b].inc()
                self._m_qry[b].inc(n)
                if trace is not None:
                    trace.add(f"exec:{b}", trace.tracer._now() - dt, dt,
                              cat="executor", n=n, fallback=i > 0)
                if i > 0:
                    self.fallbacks += 1
                    self._m_fallback.labels(
                        **{"from": first, "to": b,
                           "shard": self._shard}).inc()
                return np.asarray(ans[:n], dtype=bool), b
            except Exception as e:  # noqa: BLE001 — fall through the chain
                last_err = e
                if trace is not None:
                    dt = time.perf_counter() - t0
                    trace.add(f"exec:{b}", trace.tracer._now() - dt, dt,
                              cat="executor", error=type(e).__name__)
                if self.on_cuda:
                    raise
        raise ExecutorError(
            f"all backends failed for batch of {n} queries") from last_err

    def explain_batch(self, s: np.ndarray, t: np.ndarray,
                      mr_id: np.ndarray, n_real: Optional[int] = None,
                      backend: Optional[str] = None,
                      max_hubs: int = 8) -> Tuple[list, str]:
        """Witness mode of :meth:`execute`: per-query derivations instead
        of bare booleans; returns ``(witnesses[:n_real], backend)``.

        The backend is resolved as ``execute`` resolves it, so the
        witness reflects the layout the serving path joins — device
        backends explain over the padded device rows, ``numpy`` over the
        frozen CSR, ``python`` over the dict layout. On a CUDA layout a
        failure of the device rows raises; on a CPU layout it falls back
        to the CSR rows, as ``execute`` falls back.
        """
        first = self.resolve(backend)
        n = len(s) if n_real is None else int(n_real)
        if first in ("cuda", "sorted") and self.device_index is not None:
            try:
                ws = self.device_index.explain_batch(s[:n], t[:n],
                                                     mr_id[:n],
                                                     max_hubs=max_hubs)
                return ws, first
            except Exception:  # noqa: BLE001 — degrade like execute()
                if self.on_cuda:
                    raise
        if self.frozen is not None:
            ws = [self.frozen.explain(int(s[q]), int(t[q]),
                                      int(mr_id[q]), max_hubs=max_hubs)
                  for q in range(n)]
            return ws, "numpy"
        if self.id_to_mr is None:
            raise ExecutorError("no backend can explain this batch")
        ws = []
        for q in range(n):
            mr = self.id_to_mr[int(mr_id[q])]
            ws.append(self.index.explain(int(s[q]), int(t[q]), mr,
                                         mr_id=int(mr_id[q]),
                                         max_hubs=max_hubs))
        return ws, "python"

    def _run(self, backend: str, s, t, mr_id, n: int) -> np.ndarray:
        # torch runs eagerly: no backend needs the batch padded to a
        # fixed shape set, so every backend runs exactly the real slots
        if backend == "cuda":
            return self.device_index.query_batch(s[:n], t[:n], mr_id[:n],
                                                 use_kernel=True)
        if backend == "sorted":
            return self.device_index.query_batch(s[:n], t[:n], mr_id[:n],
                                                 method="sorted")
        if backend == "numpy":
            return self.frozen.query_batch(s[:n], t[:n], mr_id[:n])
        if backend == "python":
            out = np.zeros(n, dtype=bool)
            for q in range(n):
                out[q] = self.index.query(int(s[q]), int(t[q]),
                                          self.id_to_mr[int(mr_id[q])])
            return out
        raise ExecutorError(f"unknown backend {backend!r}")

    # ------------------------------------------------------------------ #
    def stats(self) -> Dict[str, Dict[str, float]]:
        """Summaries for every backend that actually served a batch."""
        return {b: r.summary() for b, r in self.recorders.items()
                if r.batches}
