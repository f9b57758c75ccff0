"""Metrics registry: counters, gauges, bounded-reservoir histograms.

One registry per serving/build stack (see :class:`repro_torch.obs.Observability`)
is the single sink every layer reports into — ``RLCService``,
``ShardedRLCService``, ``BatchExecutor``, ``ResultCache``,
``MicroBatcher``, the router/fanout/replica layers, and the build/delta
engines. The design constraints, in order:

* **off-hot-path cheap** — the read/serve path takes no locks: all
  mutation is single ``+=`` / list-append operations on pre-bound cells
  (GIL-atomic for our counters; the only writers that can interleave are
  the deadline-ticker thread and the caller, and a lost increment under
  that interleaving is an acceptable telemetry error, never a serving
  error). Call sites bind their label cells once at construction time
  (:meth:`Metric.labels`), so the per-event cost is one attribute add —
  no dict lookup, no string formatting.
* **bounded memory** — histograms store at most ``reservoir_cap``
  samples (:class:`Reservoir`): exact percentiles below the cap,
  uniform reservoir sampling (Algorithm R, deterministically seeded)
  above it, while ``count``/``sum``/``min``/``max`` stay exact forever.
  This is what replaces the grow-forever ``samples_s`` list the old
  ``LatencyRecorder`` kept.
* **labeled series** — a metric is a family; concrete series carry
  label values (backend, shard, cache outcome, MR-length bucket, ...)
  fixed per call site.

Naming convention (see ``src/repro/obs/README.md`` for the taxonomy):
``rlc_<layer>_<what>[_<unit>]``, snake_case, Prometheus-safe as-is.
"""
from __future__ import annotations

import random
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "Metric", "MetricsRegistry",
    "NullRegistry", "Reservoir", "NULL_REGISTRY",
]

_QUANTILES = (0.5, 0.9, 0.99)


class Reservoir:
    """Bounded sample store with exact-below-cap percentiles.

    Up to ``cap`` observations are stored verbatim, so percentiles are
    exact. Past the cap, Algorithm-R uniform reservoir sampling keeps a
    statistically representative ``cap``-sized subset (percentiles become
    estimates); ``count`` / ``total`` / ``vmin`` / ``vmax`` are always
    exact. The RNG is seeded deterministically so two identical runs
    produce identical snapshots.
    """

    __slots__ = ("cap", "count", "total", "vmin", "vmax", "samples", "_rng")

    def __init__(self, cap: int = 2048, seed: int = 0):
        if cap < 1:
            raise ValueError(f"reservoir cap must be >= 1, got {cap}")
        self.cap = int(cap)
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.samples: List[float] = []
        self._rng = random.Random(seed)

    def add(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if len(self.samples) < self.cap:
            self.samples.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < self.cap:
                self.samples[j] = v

    @property
    def exact(self) -> bool:
        """True while no observation has been dropped (percentiles exact)."""
        return self.count <= self.cap

    def percentile(self, p: float) -> float:
        """p in [0, 100]; 0.0 when empty (matching the old recorder)."""
        if not self.samples:
            return 0.0
        xs = sorted(self.samples)
        if len(xs) == 1:
            return xs[0]
        # linear interpolation between closest ranks (numpy default)
        rank = (p / 100.0) * (len(xs) - 1)
        lo = int(rank)
        hi = min(lo + 1, len(xs) - 1)
        frac = rank - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    def summary(self) -> dict:
        empty = self.count == 0
        return dict(
            count=self.count,
            sum=self.total,
            min=0.0 if empty else self.vmin,
            max=0.0 if empty else self.vmax,
            p50=self.percentile(50),
            p90=self.percentile(90),
            p99=self.percentile(99),
            stored=len(self.samples),
            exact=self.exact,
        )


# --------------------------------------------------------------------- #
# Cells: the pre-bound per-series handles call sites mutate.
# --------------------------------------------------------------------- #
class CounterCell:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class GaugeCell:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class HistogramCell:
    __slots__ = ("reservoir",)

    def __init__(self, cap: int, seed: int):
        self.reservoir = Reservoir(cap, seed)

    def observe(self, v: float) -> None:
        self.reservoir.add(v)


_CELL_FACTORY = {
    "counter": lambda m: CounterCell(),
    "gauge": lambda m: GaugeCell(),
    "histogram": lambda m: HistogramCell(
        m._reservoir_cap, len(m._series)),
}


class Metric:
    """One named metric family; concrete series are keyed by label values.

    ``labels(**kv)`` binds (get-or-create) the cell for one label
    combination — call it once at construction time and keep the cell.
    The label-free shorthand mutators (:meth:`inc` / :meth:`set` /
    :meth:`observe`) accept inline labels for cold paths.
    """

    __slots__ = ("name", "kind", "desc", "unit", "labelnames", "_series",
                 "_reservoir_cap", "_default")

    def __init__(self, name: str, kind: str, desc: str = "",
                 unit: str = "", labelnames: Tuple[str, ...] = (),
                 reservoir_cap: int = 2048):
        self.name = name
        self.kind = kind
        self.desc = desc
        self.unit = unit
        self.labelnames = tuple(labelnames)
        self._series: Dict[Tuple[str, ...], object] = {}
        self._reservoir_cap = reservoir_cap
        self._default = None        # cached cell for the no-label case

    def labels(self, **kv):
        """The cell for one label-value combination (created on first use).
        Every declared label name must be supplied, no extras."""
        if tuple(kv) != self.labelnames and set(kv) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(kv)}")
        key = tuple(str(kv[n]) for n in self.labelnames)
        cell = self._series.get(key)
        if cell is None:
            cell = self._series[key] = _CELL_FACTORY[self.kind](self)
        return cell

    def _cell(self, kv: dict):
        if not kv and not self.labelnames:
            if self._default is None:
                self._default = self.labels()
            return self._default
        return self.labels(**kv)

    # -- cold-path conveniences ----------------------------------------- #
    def inc(self, n: float = 1.0, **kv) -> None:
        self._cell(kv).inc(n)

    def set(self, v: float, **kv) -> None:
        self._cell(kv).set(v)

    def observe(self, v: float, **kv) -> None:
        self._cell(kv).observe(v)

    # -- introspection --------------------------------------------------- #
    def series(self) -> Iterable[Tuple[Tuple[str, ...], object]]:
        return self._series.items()

    def value(self, **kv) -> float:
        """Counter/gauge read-back (0.0 for a never-touched series)."""
        key = tuple(str(kv[n]) for n in self.labelnames)
        cell = self._series.get(key)
        return cell.value if cell is not None else 0.0

    def as_dict(self) -> dict:
        out = dict(type=self.kind, desc=self.desc, unit=self.unit,
                   labels=list(self.labelnames), series=[])
        for key, cell in sorted(self._series.items()):
            lab = dict(zip(self.labelnames, key))
            if self.kind == "histogram":
                out["series"].append(dict(labels=lab,
                                          **cell.reservoir.summary()))
            else:
                out["series"].append(dict(labels=lab, value=cell.value))
        return out


# kind-specific aliases so registrations read naturally
class Counter(Metric):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)


class Gauge(Metric):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)


class Histogram(Metric):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)


class MetricsRegistry:
    """Name -> :class:`Metric` with idempotent get-or-create registration.

    Re-registering an existing name returns the existing metric when kind
    and labels agree, and raises otherwise (two call sites silently
    writing incompatible series to one name is how taxonomies rot).
    """

    def __init__(self, reservoir_cap: int = 2048):
        self.reservoir_cap = int(reservoir_cap)
        self._metrics: Dict[str, Metric] = {}

    def _register(self, name: str, kind: str, desc: str, unit: str,
                  labelnames: Tuple[str, ...]) -> Metric:
        m = self._metrics.get(name)
        if m is not None:
            if m.kind != kind or m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind} with "
                    f"labels {m.labelnames}; cannot re-register as {kind} "
                    f"with {tuple(labelnames)}")
            return m
        m = Metric(name, kind, desc, unit, tuple(labelnames),
                   self.reservoir_cap)
        self._metrics[name] = m
        return m

    def counter(self, name: str, desc: str = "", unit: str = "1",
                labelnames: Tuple[str, ...] = ()) -> Metric:
        return self._register(name, "counter", desc, unit, labelnames)

    def gauge(self, name: str, desc: str = "", unit: str = "1",
              labelnames: Tuple[str, ...] = ()) -> Metric:
        return self._register(name, "gauge", desc, unit, labelnames)

    def histogram(self, name: str, desc: str = "", unit: str = "s",
                  labelnames: Tuple[str, ...] = ()) -> Metric:
        return self._register(name, "histogram", desc, unit, labelnames)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def metrics(self) -> Dict[str, Metric]:
        return dict(self._metrics)

    def as_dict(self) -> dict:
        return {name: m.as_dict()
                for name, m in sorted(self._metrics.items())}


# --------------------------------------------------------------------- #
# Null objects: telemetry-off mode keeps every call site branch-free.
# --------------------------------------------------------------------- #
class _NullCell:
    __slots__ = ()
    value = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NULL_CELL = _NullCell()


class _NullMetric:
    __slots__ = ()
    name = ""
    kind = "null"
    labelnames = ()

    def labels(self, **kv):
        return _NULL_CELL

    def inc(self, n: float = 1.0, **kv) -> None:
        pass

    def set(self, v: float, **kv) -> None:
        pass

    def observe(self, v: float, **kv) -> None:
        pass

    def value(self, **kv) -> float:
        return 0.0

    def series(self):
        return ()

    def as_dict(self) -> dict:
        return dict(type="null", series=[])


_NULL_METRIC = _NullMetric()


class NullRegistry:
    """Accepts every registration, records nothing."""

    reservoir_cap = 0

    def counter(self, name, desc="", unit="1", labelnames=()):
        return _NULL_METRIC

    def gauge(self, name, desc="", unit="1", labelnames=()):
        return _NULL_METRIC

    def histogram(self, name, desc="", unit="s", labelnames=()):
        return _NULL_METRIC

    def get(self, name):
        return None

    def metrics(self):
        return {}

    def as_dict(self) -> dict:
        return {}


NULL_REGISTRY = NullRegistry()
