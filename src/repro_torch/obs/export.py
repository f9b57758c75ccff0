"""Telemetry exporters: versioned JSON snapshot + Prometheus text format.

The snapshot schema is a stable contract (``SCHEMA``): benchmark
artifacts embed it, CI parses it, and ``tests/test_obs.py`` freezes its
shape — bump the version string when the shape changes, never mutate it
silently. :func:`validate_snapshot` is the one validator every consumer
(tier-1 guard, ``benchmarks/run.py`` smoke, tests) shares.

Snapshot shape (``repro.obs/1``)::

    {
      "schema": "repro.obs/1",
      "metrics": {
        "<name>": {
          "type": "counter" | "gauge" | "histogram",
          "desc": str, "unit": str, "labels": [str, ...],
          "series": [
            {"labels": {...}, "value": float}                  # counter/gauge
            {"labels": {...}, "count": int, "sum": float,      # histogram
             "min": float, "max": float, "p50": float,
             "p90": float, "p99": float,
             "stored": int, "exact": bool}
          ]
        }, ...
      },
      "tracing": {"sample_rate": float, "traces": int, "skipped": int,
                  "events": int, "dropped": int},      # optional section
      "extra": {...}                                   # optional, free-form
    }

The Prometheus dump follows the text exposition format: counters get a
``_total`` suffix, histograms export as summaries (``{quantile="..."}``
plus ``_sum`` / ``_count``).
"""
from __future__ import annotations

import math
import re
from typing import Optional

__all__ = ["SCHEMA", "snapshot", "validate_snapshot", "to_prometheus",
           "snapshot_to_prometheus"]

SCHEMA = "repro.obs/1"

_HIST_KEYS = {"count", "sum", "min", "max", "p50", "p90", "p99",
              "stored", "exact"}
_TYPES = {"counter", "gauge", "histogram"}


def snapshot(registry, tracer=None, extra: Optional[dict] = None) -> dict:
    """The registry (and optionally tracer/extra) as a schema-versioned,
    JSON-serializable dict."""
    out = dict(schema=SCHEMA, metrics=registry.as_dict())
    if tracer is not None:
        out["tracing"] = tracer.stats()
    if extra is not None:
        out["extra"] = extra
    return out


def validate_snapshot(doc: dict) -> dict:
    """Validate ``doc`` against the ``repro.obs/1`` schema.

    Returns the doc on success; raises ``ValueError`` naming the first
    offending path otherwise. Shared by the tier-1 contract test and the
    benchmark smoke validation — one validator, one truth.
    """
    def fail(path: str, why: str):
        raise ValueError(f"telemetry snapshot invalid at {path}: {why}")

    if not isinstance(doc, dict):
        fail("$", f"expected object, got {type(doc).__name__}")
    if doc.get("schema") != SCHEMA:
        fail("$.schema", f"expected {SCHEMA!r}, got {doc.get('schema')!r}")
    metrics = doc.get("metrics")
    if not isinstance(metrics, dict):
        fail("$.metrics", "expected object")
    for name, m in metrics.items():
        p = f"$.metrics[{name!r}]"
        if not isinstance(m, dict):
            fail(p, "expected object")
        if m.get("type") not in _TYPES:
            fail(f"{p}.type", f"expected one of {sorted(_TYPES)}, "
                 f"got {m.get('type')!r}")
        labels = m.get("labels")
        if not isinstance(labels, list) or not all(
                isinstance(x, str) for x in labels):
            fail(f"{p}.labels", "expected list of strings")
        series = m.get("series")
        if not isinstance(series, list):
            fail(f"{p}.series", "expected list")
        for i, s in enumerate(series):
            sp = f"{p}.series[{i}]"
            if not isinstance(s, dict):
                fail(sp, "expected object")
            slab = s.get("labels")
            if not isinstance(slab, dict) or set(slab) != set(labels):
                fail(f"{sp}.labels",
                     f"expected keys {sorted(labels)}, "
                     f"got {sorted(slab) if isinstance(slab, dict) else slab}")
            if m["type"] == "histogram":
                missing = _HIST_KEYS - set(s)
                if missing:
                    fail(sp, f"histogram series missing {sorted(missing)}")
                for k in ("sum", "min", "max", "p50", "p90", "p99"):
                    v = s[k]
                    # bools are ints in python; NaN/inf serialize to
                    # invalid JSON and poison downstream aggregation —
                    # reject both, not just non-numbers
                    if isinstance(v, bool) or not isinstance(
                            v, (int, float)) or not math.isfinite(v):
                        fail(f"{sp}.{k}", f"expected finite number, "
                             f"got {v!r}")
                for k in ("count", "stored"):
                    v = s[k]
                    if isinstance(v, bool) or not isinstance(v, int) \
                            or v < 0:
                        fail(f"{sp}.{k}",
                             f"expected non-negative int, got {v!r}")
                if s["stored"] > s["count"]:
                    fail(f"{sp}.stored", "stored exceeds count")
                if s["count"] >= 1 and s["stored"] == 0:
                    # a reservoir that observed anything keeps at least
                    # one sample; count>0/stored==0 means the series was
                    # assembled by hand or the reservoir was clobbered
                    fail(f"{sp}.stored",
                         "count >= 1 but no stored samples")
            else:
                v = s.get("value")
                if isinstance(v, bool) or not isinstance(
                        v, (int, float)) or not math.isfinite(v):
                    fail(f"{sp}.value",
                         f"expected finite number, got {v!r}")
    tracing = doc.get("tracing")
    if tracing is not None:
        if not isinstance(tracing, dict):
            fail("$.tracing", "expected object")
        for k in ("sample_rate", "traces", "events", "dropped"):
            if not isinstance(tracing.get(k), (int, float)):
                fail(f"$.tracing.{k}", "expected number")
    return doc


# --------------------------------------------------------------------- #
_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _prom_labels(labels: dict, extra: Optional[dict] = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    parts = []
    for k, v in sorted(items.items()):
        val = str(v).replace("\\", "\\\\").replace('"', '\\"')
        parts.append(f'{_prom_name(k)}="{val}"')
    return "{" + ",".join(parts) + "}"


def to_prometheus(registry) -> str:
    """The registry in the Prometheus text exposition format."""
    lines = []
    for name, m in sorted(registry.metrics().items()):
        pname = _prom_name(name)
        if m.kind == "counter":
            pname += "_total"
        ptype = "summary" if m.kind == "histogram" else m.kind
        if m.desc:
            lines.append(f"# HELP {pname} {m.desc}")
        lines.append(f"# TYPE {pname} {ptype}")
        for key, cell in sorted(m.series()):
            lab = dict(zip(m.labelnames, key))
            if m.kind == "histogram":
                r = cell.reservoir
                for q in ("0.5", "0.9", "0.99"):
                    v = r.percentile(float(q) * 100)
                    lines.append(
                        f"{pname}{_prom_labels(lab, {'quantile': q})} {v:g}")
                lines.append(f"{pname}_sum{_prom_labels(lab)} {r.total:g}")
                lines.append(f"{pname}_count{_prom_labels(lab)} {r.count}")
            else:
                lines.append(f"{pname}{_prom_labels(lab)} {cell.value:g}")
    return "\n".join(lines) + ("\n" if lines else "")


def snapshot_to_prometheus(doc: dict) -> str:
    """Render a ``repro.obs/1`` snapshot *document* as Prometheus text.

    The offline twin of :func:`to_prometheus`: same exposition rules
    (counters get ``_total``, histograms export as summaries), but fed
    from a serialized snapshot instead of a live registry — the
    ``python -m repro_torch.obs prom`` path that converts an archived bench
    artifact without rebuilding the service that produced it. The doc
    is validated first, so malformed artifacts fail loudly.
    """
    validate_snapshot(doc)
    lines = []
    for name, m in sorted(doc["metrics"].items()):
        pname = _prom_name(name)
        if m["type"] == "counter":
            pname += "_total"
        ptype = "summary" if m["type"] == "histogram" else m["type"]
        if m.get("desc"):
            lines.append(f"# HELP {pname} {m['desc']}")
        lines.append(f"# TYPE {pname} {ptype}")
        for s in m["series"]:
            lab = s["labels"]
            if m["type"] == "histogram":
                for q, k in (("0.5", "p50"), ("0.9", "p90"),
                             ("0.99", "p99")):
                    lines.append(
                        f"{pname}{_prom_labels(lab, {'quantile': q})} "
                        f"{s[k]:g}")
                lines.append(f"{pname}_sum{_prom_labels(lab)} "
                             f"{s['sum']:g}")
                lines.append(f"{pname}_count{_prom_labels(lab)} "
                             f"{s['count']}")
            else:
                lines.append(
                    f"{pname}{_prom_labels(lab)} {s['value']:g}")
    return "\n".join(lines) + ("\n" if lines else "")
