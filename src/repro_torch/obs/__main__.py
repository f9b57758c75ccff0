"""``python -m repro_torch.obs`` — offline telemetry artifact tooling.

Benchmark runs leave ``repro.obs/1`` snapshots (embedded in bench JSON
under ``telemetry`` keys or standalone), Chrome ``trace_event`` dumps,
and ``repro.obs.audit/1`` health reports on disk; this CLI inspects
them without rebuilding the service that produced them::

    python -m repro_torch.obs validate benchmarks/artifacts/service.json
    python -m repro_torch.obs dump     snapshot.json
    python -m repro_torch.obs prom     snapshot.json > metrics.prom
    python -m repro_torch.obs chrome   benchmarks/artifacts/service_trace.json
    python -m repro_torch.obs audit    benchmarks/artifacts/sharded.json

``validate`` walks the whole document for embedded snapshots and audit
reports and validates each (exit 0 all valid / 1 any invalid), so one
invocation covers a raw snapshot, a bench artifact, or an audit report.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Tuple

from .audit import AUDIT_SCHEMA, validate_audit_report
from .export import SCHEMA, snapshot_to_prometheus, validate_snapshot

_USAGE_EXIT = 2


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _find_docs(doc, path: str = "$") -> List[Tuple[str, str, dict]]:
    """Every embedded versioned document: ``(json_path, schema, doc)``.

    Bench artifacts nest snapshots several levels deep (e.g.
    ``results.telemetry.snapshot``); walking by schema string finds them
    wherever the artifact shape puts them.
    """
    found = []
    if isinstance(doc, dict):
        schema = doc.get("schema")
        if schema in (SCHEMA, AUDIT_SCHEMA):
            found.append((path, schema, doc))
        for k, v in doc.items():
            found.extend(_find_docs(v, f"{path}.{k}"))
    elif isinstance(doc, list):
        for i, v in enumerate(doc):
            found.extend(_find_docs(v, f"{path}[{i}]"))
    return found


def _is_chrome_trace(doc) -> bool:
    return isinstance(doc, dict) and isinstance(
        doc.get("traceEvents"), list)


def _validate_one(path: str, schema: str, doc: dict) -> Optional[str]:
    try:
        if schema == SCHEMA:
            validate_snapshot(doc)
        else:
            validate_audit_report(doc)
        return None
    except ValueError as e:
        return str(e)


def cmd_validate(args) -> int:
    doc = _load(args.file)
    if _is_chrome_trace(doc):
        bad = [e for e in doc["traceEvents"]
               if not isinstance(e, dict) or "ph" not in e]
        if bad:
            print(f"INVALID chrome trace: {len(bad)} malformed events")
            return 1
        print(f"OK chrome trace: {len(doc['traceEvents'])} events")
        return 0
    docs = _find_docs(doc)
    if not docs:
        print(f"no {SCHEMA!r} snapshots or {AUDIT_SCHEMA!r} reports "
              f"found in {args.file}")
        return 1
    failures = 0
    for path, schema, d in docs:
        err = _validate_one(path, schema, d)
        if err is None:
            print(f"OK {schema} at {path}")
        else:
            failures += 1
            print(f"INVALID {schema} at {path}: {err}")
    return 1 if failures else 0


def _first_snapshot(doc, path: str):
    for p, schema, d in _find_docs(doc):
        if schema == SCHEMA:
            return p, d
    print(f"no {SCHEMA!r} snapshot found in {path}")
    return None, None


def cmd_dump(args) -> int:
    p, snap = _first_snapshot(_load(args.file), args.file)
    if snap is None:
        return 1
    validate_snapshot(snap)
    print(f"snapshot at {p}")
    for name, m in sorted(snap["metrics"].items()):
        print(f"  {name} ({m['type']}, {len(m['series'])} series)")
        for s in m["series"]:
            lab = ",".join(f"{k}={v}" for k, v in
                           sorted(s["labels"].items())) or "-"
            if m["type"] == "histogram":
                print(f"    [{lab}] count={s['count']} sum={s['sum']:g} "
                      f"p50={s['p50']:g} p99={s['p99']:g}")
            else:
                print(f"    [{lab}] value={s['value']:g}")
    tracing = snap.get("tracing")
    if tracing:
        print(f"  tracing: {tracing}")
    extra = snap.get("extra")
    if extra:
        print(f"  extra keys: {sorted(extra)}")
    return 0


def cmd_prom(args) -> int:
    _, snap = _first_snapshot(_load(args.file), args.file)
    if snap is None:
        return 1
    sys.stdout.write(snapshot_to_prometheus(snap))
    return 0


def cmd_chrome(args) -> int:
    doc = _load(args.file)
    if not _is_chrome_trace(doc):
        print(f"{args.file} is not a Chrome trace_event document")
        return 1
    events = doc["traceEvents"]
    cats: dict = {}
    for e in events:
        if e.get("ph") == "X":
            cats[e.get("cat", "-")] = cats.get(e.get("cat", "-"), 0) + 1
    print(f"chrome trace: {len(events)} events")
    for cat, n in sorted(cats.items()):
        print(f"  {cat}: {n} spans")
    return 0


def cmd_audit(args) -> int:
    reports = [(p, d) for p, schema, d in _find_docs(_load(args.file))
               if schema == AUDIT_SCHEMA]
    if not reports:
        print(f"no {AUDIT_SCHEMA!r} report found in {args.file}")
        return 1
    rc = 0
    for p, rep in reports:
        err = _validate_one(p, AUDIT_SCHEMA, rep)
        if err is not None:
            print(f"INVALID audit report at {p}: {err}")
            rc = 1
            continue
        ident = rep["identity"]
        print(f"audit report at {p}")
        print(f"  index: V={ident['num_vertices']} k={ident['k']} "
              f"entries={ident['entries']} "
              f"(out={ident['entries_out']} in={ident['entries_in']}) "
              f"max_row={ident['max_row']}")
        red = rep["redundancy"]
        print(f"  redundancy: {red['violations']}/{red['sampled']} "
              f"violations")
        snd = rep.get("soundness")
        if snd is not None:
            print(f"  soundness: {snd['violations']}/{snd['sampled']} "
                  f"violations")
        by = rep["bytes"]
        parts = ", ".join(f"{k}={v}" for k, v in by.items()
                          if v is not None)
        print(f"  bytes: {parts}")
        print(f"  fingerprint: {rep['fingerprint']['combined']}")
        for sh in rep.get("shards", []):
            print(f"  shard {sh['shard']}: rows [{sh['lo']}, "
                  f"{sh['hi']}) entries={sh['entries']} "
                  f"frozen={sh['frozen_bytes']}B")
    return rc


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="inspect/convert repro_torch.obs telemetry artifacts")
    sub = ap.add_subparsers(dest="cmd")
    for name, fn, help_ in (
            ("validate", cmd_validate,
             "validate every embedded snapshot/audit report"),
            ("dump", cmd_dump, "pretty-print a snapshot's metrics"),
            ("prom", cmd_prom,
             "convert a snapshot to Prometheus text format"),
            ("chrome", cmd_chrome, "summarize a Chrome trace dump"),
            ("audit", cmd_audit, "pretty-print embedded audit reports")):
        p = sub.add_parser(name, help=help_)
        p.add_argument("file", help="JSON artifact to read")
        p.set_defaults(fn=fn)
    args = ap.parse_args(argv)
    if not getattr(args, "fn", None):
        ap.print_help()
        return _USAGE_EXIT
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: {e}")
        return _USAGE_EXIT
    except (json.JSONDecodeError, ValueError) as e:
        print(f"INVALID: {e}")
        return 1


if __name__ == "__main__":
    sys.exit(main())
