"""Per-query span tracing with sampling and a Chrome ``trace_event`` export.

A :class:`Tracer` hands out :class:`Trace` handles — one per sampled unit
of work (a ``query_batch`` admission on the serving path). Call sites ask
``tracer.maybe_trace()`` once and get ``None`` when the unit is not
sampled, so the un-sampled hot path pays a single comparison; every span
call is guarded by ``if tr is not None``.

Spans are flat records ``(name, cat, tid, ts, dur, args)`` — the tree
structure is implied by interval containment on one ``tid`` (exactly the
Chrome ``trace_event`` model, so the export is a direct mapping and
``chrome://tracing`` / Perfetto render the timeline without any
massaging). :func:`span_tree` rebuilds the nesting for tests and
programmatic analysis.

The event buffer is bounded: past ``max_events`` new spans are dropped
and counted (``tracer.dropped``) — tracing must never become the memory
leak it exists to diagnose.

:func:`region` puts a named range on ``torch.profiler``'s timeline (the
device trace's clock) while the profiler records on the calling thread,
and costs one flag check otherwise. The dense builds open their phases
through it (``repro_torch.dense.*``, ``repro_torch.condensed.*``), and a
sampled :meth:`Trace.span` opens ``repro_torch.service.<name>`` beside
its own record, so a profiler trace shows both.
"""
from __future__ import annotations

import contextlib
import random
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

__all__ = ["SpanEvent", "Trace", "Tracer", "region", "span_tree"]

#: prefix of every range the program opens on the profiler's timeline
REGION_PREFIX = "repro_torch."

_NO_RANGE = contextlib.nullcontext()
_profiler_on: Optional[Callable[[], bool]] = None


def region(name: str):
    """``with region("condensed.hub_loop"): ...``: a
    ``torch.profiler.record_function`` range named ``repro_torch.<name>``
    while the profiler records on this thread, else a shared no-op
    context (a ``record_function`` costs tens of microseconds even with
    the profiler off; the check costs well under one)."""
    global _profiler_on
    if _profiler_on is None:
        import torch
        _profiler_on = torch._C._autograd._profiler_enabled
    if not _profiler_on():
        return _NO_RANGE
    import torch.profiler
    return torch.profiler.record_function(REGION_PREFIX + name)


@dataclass(frozen=True)
class SpanEvent:
    """One completed span, timestamps in seconds since the tracer epoch."""

    name: str
    cat: str
    tid: int
    ts: float
    dur: float
    args: Optional[dict] = None


class _SpanCtx:
    """Context manager recording one span on exit, inside the profiler
    range ``repro_torch.service.<name>`` (see :func:`region`)."""

    __slots__ = ("_trace", "_name", "_cat", "_args", "_t0", "_range")

    def __init__(self, trace: "Trace", name: str, cat: str, args):
        self._trace = trace
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self) -> "_SpanCtx":
        self._range = region("service." + self._name)
        self._range.__enter__()
        self._t0 = self._trace.tracer._now()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        tr = self._trace
        t1 = tr.tracer._now()
        self._range.__exit__(exc_type, exc, tb)
        if exc_type is not None:
            args = dict(self._args or ())
            args["error"] = exc_type.__name__
            self._args = args
        tr.tracer._emit(SpanEvent(self._name, self._cat, tr.tid,
                                  self._t0, t1 - self._t0, self._args))
        return False


class Trace:
    """Handle for one sampled unit of work (one ``tid`` in the export)."""

    __slots__ = ("tracer", "tid")

    def __init__(self, tracer: "Tracer", tid: int):
        self.tracer = tracer
        self.tid = tid

    def span(self, name: str, cat: str = "", **args) -> _SpanCtx:
        """``with tr.span("execute", backend="numpy"): ...``"""
        return _SpanCtx(self, name, cat, args or None)

    def add(self, name: str, ts: float, dur: float, cat: str = "",
            **args) -> None:
        """Record a span with explicit (tracer-epoch) timestamps."""
        self.tracer._emit(SpanEvent(name, cat, self.tid, ts, dur,
                                    args or None))

    def add_ending_now(self, name: str, dur: float, cat: str = "",
                       **args) -> None:
        """Record a span of ``dur`` seconds that ends at the current
        instant — for waits measured on a different clock (e.g. the
        micro-batcher's queue wait), where only the duration is
        trustworthy across clocks."""
        now = self.tracer._now()
        self.tracer._emit(SpanEvent(name, cat, self.tid,
                                    now - dur, dur, args or None))


class Tracer:
    """Sampling span recorder.

    ``sample_rate`` in [0, 1] decides per :meth:`maybe_trace` call
    whether the unit of work records spans (0 = tracing off, the
    default; 1 = trace everything). The RNG is deterministically seeded
    so replayed workloads sample identically.
    """

    def __init__(self, sample_rate: float = 0.0, max_events: int = 50_000,
                 clock: Callable[[], float] = time.perf_counter,
                 seed: int = 0):
        if not (0.0 <= sample_rate <= 1.0):
            raise ValueError(
                f"sample_rate must be in [0, 1], got {sample_rate}")
        self.sample_rate = float(sample_rate)
        self.max_events = int(max_events)
        self.clock = clock
        self.epoch = clock()
        self.events: List[SpanEvent] = []
        self.dropped = 0
        self.traces_started = 0
        self.traces_skipped = 0
        self._rng = random.Random(seed)
        self._next_tid = 0

    # ------------------------------------------------------------------ #
    @property
    def enabled(self) -> bool:
        return self.sample_rate > 0.0

    def _now(self) -> float:
        return self.clock() - self.epoch

    def _emit(self, ev: SpanEvent) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def maybe_trace(self) -> Optional[Trace]:
        """A :class:`Trace` when this unit of work is sampled, else None."""
        if self.sample_rate <= 0.0:
            return None
        if self.sample_rate < 1.0 and self._rng.random() >= self.sample_rate:
            self.traces_skipped += 1
            return None
        self.traces_started += 1
        self._next_tid += 1
        return Trace(self, self._next_tid)

    def clear(self) -> None:
        self.events.clear()
        self.dropped = 0

    # ------------------------------------------------------------------ #
    def chrome_trace(self, process_name: str = "rlc-service") -> dict:
        """The buffer as a Chrome ``trace_event`` JSON object.

        Each span becomes one complete ("X") event; ``ts``/``dur`` are
        microseconds per the spec. Load the dump in ``chrome://tracing``
        or https://ui.perfetto.dev to inspect the timeline.
        """
        events: List[dict] = [dict(
            name="process_name", ph="M", pid=0, tid=0,
            args=dict(name=process_name))]
        for ev in sorted(self.events, key=lambda e: (e.ts, -e.dur)):
            rec = dict(name=ev.name, cat=ev.cat or "rlc", ph="X", pid=0,
                       tid=ev.tid, ts=round(ev.ts * 1e6, 3),
                       dur=round(ev.dur * 1e6, 3))
            if ev.args:
                rec["args"] = dict(ev.args)
            events.append(rec)
        return dict(traceEvents=events, displayTimeUnit="ms",
                    otherData=dict(dropped=self.dropped,
                                   traces=self.traces_started))

    def stats(self) -> dict:
        return dict(sample_rate=self.sample_rate,
                    traces=self.traces_started,
                    skipped=self.traces_skipped,
                    events=len(self.events),
                    dropped=self.dropped)


# --------------------------------------------------------------------- #
@dataclass
class SpanNode:
    """One node of a rebuilt span tree (tests / programmatic analysis)."""

    event: SpanEvent
    children: List["SpanNode"] = field(default_factory=list)


def span_tree(events: List[SpanEvent], tid: int) -> List[SpanNode]:
    """Rebuild the nesting of one ``tid``'s spans by interval containment.

    Returns the forest of top-level spans. Spans on one tid are expected
    to be properly nested (a child's interval inside its parent's) — the
    well-formedness property the test suite asserts; a span that
    partially overlaps a sibling is attached at top level, never
    silently clipped.
    """
    spans = sorted((e for e in events if e.tid == tid),
                   key=lambda e: (e.ts, -e.dur))
    roots: List[SpanNode] = []
    stack: List[SpanNode] = []
    eps = 1e-9
    for ev in spans:
        node = SpanNode(ev)
        while stack:
            top = stack[-1].event
            if (ev.ts >= top.ts - eps
                    and ev.ts + ev.dur <= top.ts + top.dur + eps):
                stack[-1].children.append(node)
                break
            stack.pop()
        else:
            roots.append(node)
        stack.append(node)
    return roots
