"""The profiler's trace, reduced to plain intervals, and the arithmetic the
per-layer metrics and the breakdown read from it.

``Trace`` holds seconds from the start of the trace:

* ``ranges``: the benchmark's own ``record_function`` ranges on the
  thread that ran the window (``rlcbench.window``, ``rlcbench.build``);
* ``cpu``: the operators that thread ran, to name what the host did while
  the card sat idle;
* ``device``: every kernel, copy and fill that ran on the card, as
  ``(name, kind, start, end)`` with ``kind`` one of ``kernel``,
  ``memcpy``, ``memset``. Annotations that the profiler mirrors onto the
  device's timeline are not device work and are left out.
"""
from __future__ import annotations

import re
from collections import defaultdict
from functools import lru_cache
from dataclasses import dataclass, field
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

WINDOW = "rlcbench.window"
BUILD = "rlcbench.build"

Span = Tuple[str, float, float]
DeviceOp = Tuple[str, str, float, float]


@dataclass
class Trace:
    ranges: List[Span] = field(default_factory=list)
    cpu: List[Span] = field(default_factory=list)
    device: List[DeviceOp] = field(default_factory=list)
    _starts: List[float] = field(default_factory=list, repr=False)

    def spans(self, name: str) -> List[Tuple[float, float]]:
        return sorted((s, e) for n, s, e in self.ranges if n == name)

    def window(self) -> Optional[Tuple[float, float]]:
        w = self.spans(WINDOW)
        return w[0] if w else None

    def builds(self) -> List[Tuple[float, float]]:
        return self.spans(BUILD)

    def device_between(self, lo: float, hi: float) -> List[DeviceOp]:
        """Device operations that start in ``[lo, hi)``."""
        if len(self._starts) != len(self.device):
            self.device.sort(key=lambda op: op[2])
            self._starts = [op[2] for op in self.device]
        return self.device[bisect_left(self._starts, lo):
                           bisect_left(self._starts, hi)]


def device_kind(name: str) -> str:
    """``memcpy`` / ``memset`` / ``kernel`` for an operation on the card,
    by the names the profiler gives copies (``Memcpy ...``) and fills
    (``Memset ...``)."""
    if name.startswith("Memcpy"):
        return "memcpy"
    return "memset" if name.startswith("Memset") else "kernel"


def from_events(events) -> Trace:
    """Reduce the profiler's events (``name()``, ``device_type()``,
    ``start_ns()``, ``duration_ns()``, ``start_thread_id()``, as
    ``torch.profiler``'s kineto events have them) to a :class:`Trace`.

    An event on the card whose name is also the name of a host event is
    the profiler's mirror of a host range (a ``record_function`` of the
    benchmark or of the program) and no device work: it is left out, so
    a range added to the program moves no device metric. Of the host's
    events, those of the thread that ran the window are kept: the
    benchmark's ranges as ``ranges``, the rest as ``cpu``."""
    names = [e.name() for e in events]
    on_device = [not str(e.device_type()).endswith("CPU") for e in events]
    host_names = {n for n, dev in zip(names, on_device) if not dev}
    t0 = min((e.start_ns() for e in events), default=0)
    main = next((e.start_thread_id()
                 for e, n, dev in zip(events, names, on_device)
                 if not dev and n == WINDOW), None)
    tr = Trace()
    for e, name, dev in zip(events, names, on_device):
        if dev and name in host_names:
            continue
        if not dev and e.start_thread_id() != main:
            continue
        start = (e.start_ns() - t0) * 1e-9
        end = start + e.duration_ns() * 1e-9
        if dev:
            tr.device.append((name, device_kind(name), start, end))
        elif name in (WINDOW, BUILD):
            tr.ranges.append((name, start, end))
        else:
            tr.cpu.append((name, start, end))
    return tr


def from_profiler(prof) -> Trace:
    """Reduce a finished ``torch.profiler.profile`` to a :class:`Trace`."""
    return from_events(prof.profiler.kineto_results.events())


def merged(intervals: Sequence[Tuple[float, float]], lo: float, hi: float
           ) -> List[Tuple[float, float]]:
    """The union of ``intervals`` clipped to ``[lo, hi]``, as sorted
    disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(tr: Trace, lo: float, hi: float) -> float:
    """Seconds of ``[lo, hi]`` in which some kernel, copy or fill ran."""
    return sum(e - s for s, e in merged(
        [(s, e) for _, _, s, e in tr.device], lo, hi))


def idle_gaps(tr: Trace, lo: float, hi: float
              ) -> List[Tuple[float, float]]:
    """The intervals of ``[lo, hi]`` with nothing on the card."""
    gaps, at = [], lo
    for s, e in merged([(s, e) for _, _, s, e in tr.device], lo, hi):
        if s > at:
            gaps.append((at, s))
        at = e
    if hi > at:
        gaps.append((at, hi))
    return gaps


def device_in(tr: Trace, span: Tuple[float, float],
              kinds: Sequence[str] = ("kernel", "memcpy", "memset")
              ) -> List[DeviceOp]:
    """Device operations of ``kinds`` that start inside ``span``."""
    return [op for op in tr.device_between(*span) if op[1] in kinds]


def seconds_in_builds(tr: Trace, kinds: Sequence[str]) -> float:
    """Summed device time of operations of ``kinds`` in every build."""
    return sum(e - s for b in tr.builds()
               for _, _, s, e in device_in(tr, b, kinds))


def host_tails(tr: Trace) -> List[float]:
    """For each build with device work, the seconds from the end of its
    last device operation to the end of the build."""
    tails = []
    for b in tr.builds():
        ops = device_in(tr, b)
        if ops:
            tails.append(max(0.0, b[1] - max(e for _, _, _, e in ops)))
    return tails


@lru_cache(maxsize=None)
def _label(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:-]", "_", name)[:64]


def host_doing(tr: Trace, points: Sequence[float]) -> List[str]:
    """For each time in ``points``, the innermost range or operator of the
    window's thread that covers it: ``build_host`` inside a build but
    outside any operator, ``harness`` inside the window between builds,
    ``outside`` elsewhere. The thread's spans nest, so a stack sweep
    finds each."""
    spans = sorted(tr.ranges + tr.cpu, key=lambda x: (x[1], -x[2]))
    names = {WINDOW: "harness", BUILD: "build_host"}
    order = sorted(range(len(points)), key=lambda i: points[i])
    out = ["outside"] * len(points)
    stack: List[Span] = []
    j = 0
    for i in order:
        p = points[i]
        while j < len(spans) and spans[j][1] <= p:
            while stack and stack[-1][2] <= spans[j][1]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][2] < p:
            stack.pop()
        if stack:
            out[i] = names.get(stack[-1][0], _label(stack[-1][0]))
    return out


def breakdown(tr: Trace, top: int = 10) -> Optional[Dict[str, list]]:
    """The device operations that took most time in the window, and the
    idle time of the window by what the host was doing."""
    w = tr.window()
    if w is None:
        return None
    by_op: Dict[str, float] = defaultdict(float)
    for name, _, s, e in tr.device:
        if w[0] <= s < w[1]:
            by_op[_label(name)] += e - s
    gaps = idle_gaps(tr, *w)
    by_host: Dict[str, float] = defaultdict(float)
    for (s, e), what in zip(gaps, host_doing(tr, [(s + e) / 2
                                                   for s, e in gaps])):
        by_host[what] += e - s

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:top]
    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_host)}
