"""The program's own spans and counters, as the condensed build's
per-layer metrics read them.

The program opens its phases as ``torch.profiler`` ranges named
``repro_torch.<layer>.<phase>`` (``repro_torch.obs.region``);
``tracing.from_events`` keeps them among the window thread's host spans
(``Trace.cpu``), on the device trace's clock. Its counters live in the
registry of ``repro_torch.obs.process_obs()``.

Every reader says nothing (``None``) where the window's builds ran no
device work, or where the program carries no such spans and counters (a
program older than them); otherwise it gives a number, ``0.0`` where the
program opened no such span or counted no build.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from rlcbench import tracing

PREPARE = "repro_torch.condensed.prepare"
HUB_LOOP = "repro_torch.condensed.hub_loop"
DOWNLOAD = "repro_torch.condensed.download"
INDEX_FILL = "repro_torch.condensed.index_fill"
BACKEND = "device_condensed"


def program_obs():
    """The program's process-wide ``Observability``, or ``None`` where
    the program has none."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    make = getattr(obs, "process_obs", None)
    return None if make is None else make()


def builds_with_device_work(tr: tracing.Trace
                            ) -> Optional[List[Tuple[float, float]]]:
    """The window's builds, or ``None`` where none ran device work or
    the program has no spans and counters to read."""
    builds = tr.builds()
    if not any(tracing.device_in(tr, b) for b in builds):
        return None
    return builds if program_obs() is not None else None


def spans_in(tr: tracing.Trace, name: str,
             builds: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The host spans called ``name`` that lie inside one of ``builds``."""
    return sorted((s, e) for n, s, e in tr.cpu if n == name
                  and any(lo <= s and e <= hi for lo, hi in builds))


def ms_per_build(tr: tracing.Trace, name: str) -> Optional[float]:
    """Milliseconds the builds spent in spans called ``name``, over the
    builds."""
    builds = builds_with_device_work(tr)
    if builds is None:
        return None
    return 1e3 * sum(e - s for s, e in spans_in(tr, name, builds)) \
        / len(builds)


def idle_ms_per_build(tr: tracing.Trace, name: str) -> Optional[float]:
    """Milliseconds with nothing on the card inside spans called
    ``name``, over the builds."""
    builds = builds_with_device_work(tr)
    if builds is None:
        return None
    idle = sum(e - s for span in spans_in(tr, name, builds)
               for s, e in tracing.idle_gaps(tr, *span))
    return 1e3 * idle / len(builds)


def entries_per_build() -> float:
    """Entries the program's condensed builds handed to the index (both
    sides), over the builds it counted (every build of the process, the
    set-up's among them: one graph a run, so one count a build); ``0.0``
    where it counted none."""
    registry = program_obs().registry
    runs = registry.get("rlc_build_runs")
    n = runs.value(context="full", backend=BACKEND) if runs else 0.0
    if not n:
        return 0.0
    entries = registry.get("rlc_build_entries")
    return sum(entries.value(backend=BACKEND, side=side)
               for side in ("out", "in")) / n


def fill_us_per_entry(tr: tracing.Trace) -> Optional[float]:
    """Microseconds the window's builds spent in ``index_fill`` spans an
    entry handed to the index; ``0.0`` where the program opened no such
    span or counted no entry."""
    fill_ms = ms_per_build(tr, INDEX_FILL)
    if fill_ms is None:
        return None
    entries = entries_per_build()
    return 1e3 * fill_ms / entries if entries else 0.0
