"""The versioned ``stats()`` schema shared by both service facades.

``RLCService.stats()`` and ``ShardedRLCService.stats()`` grew
independently and drifted: the same logical sections (served/shed
counts, cache, scheduler, control, build, telemetry, shadow) were
assembled twice, with the sharded facade nesting its executor summary
differently and neither document carrying a version. This module is the
dedup: :func:`base_stats` builds every shared section once, each facade
adds only its transport-specific sections (``executor`` / ``index`` /
``router`` / ``shards``), and the result declares itself as
``repro.service.stats/1``.

:func:`validate_stats` mirrors :func:`repro_torch.obs.export.validate_snapshot`
— one validator shared by the tier-1 contract tests and the benchmark
smoke run, failing loudly at the first offending path.

Schema (``repro.service.stats/1``)::

    {
      "schema": "repro.service.stats/1",
      "facade": "single" | "sharded",
      "transport": "local" | "inproc" | "rpc",
      "queries_served": int, "queries_shed": int, "deltas_applied": int,
      "cache": {...}, "scheduler": {...}, "control": {...},
      "executor": {...},             # facade-specific layout
      "index": {...},
      "build": {...} | null,
      "telemetry": {"enabled": bool, "tracing": {...}},
      "shadow": {...} | null,
      "async": {...} | null,         # AsyncEngine ledger when start()ed
      "router": {...},               # sharded only
      "shards": [...],               # sharded only
      "rpc": {...},                  # sharded only, transport="rpc"
    }
"""
from __future__ import annotations

__all__ = ["STATS_SCHEMA", "base_stats", "validate_stats"]

STATS_SCHEMA = "repro.service.stats/1"

_FACADES = {"single", "sharded"}
_TRANSPORTS = {"local", "inproc", "rpc"}

#: sections every facade must carry (value type enforced where stable)
_REQUIRED = ("queries_served", "queries_shed", "deltas_applied",
             "cache", "scheduler", "control", "executor", "index",
             "telemetry")

_SCHED_KEYS = {"batches_full", "batches_deadline", "batches_drain",
               "coalesced", "pending"}


def base_stats(svc, facade: str, transport: str) -> dict:
    """Every section the two facades share, assembled once. The caller
    merges in its transport-specific sections afterwards."""
    return dict(
        schema=STATS_SCHEMA,
        facade=facade,
        transport=transport,
        queries_served=svc.queries_served,
        queries_shed=svc.queries_shed,
        deltas_applied=svc.deltas_applied,
        cache=svc.cache.stats.as_dict(),
        scheduler=dict(
            batches_full=svc.batcher.batches_full,
            batches_deadline=svc.batcher.batches_deadline,
            batches_drain=svc.batcher.batches_drain,
            coalesced=svc.batcher.coalesced,
            pending=svc.batcher.pending()),
        control=svc.ctl.stats(),
        build=(svc.build_stats.as_dict()
               if svc.build_stats is not None else None),
        telemetry=dict(enabled=svc.obs.enabled,
                       tracing=svc.obs.tracer.stats()),
        shadow=(svc._shadow.stats() if svc._shadow is not None else None),
        **{"async": (svc._engine.stats()
                     if svc._engine is not None else None)},
    )


def validate_stats(doc: dict) -> dict:
    """Validate ``doc`` against ``repro.service.stats/1``.

    Returns the doc on success; raises ``ValueError`` naming the first
    offending path otherwise (same contract as
    :func:`repro_torch.obs.export.validate_snapshot`).
    """
    def fail(path: str, why: str):
        raise ValueError(f"service stats invalid at {path}: {why}")

    def expect_int(path: str, v):
        if isinstance(v, bool) or not isinstance(v, int) or v < 0:
            fail(path, f"expected non-negative int, got {v!r}")

    if not isinstance(doc, dict):
        fail("$", f"expected object, got {type(doc).__name__}")
    if doc.get("schema") != STATS_SCHEMA:
        fail("$.schema",
             f"expected {STATS_SCHEMA!r}, got {doc.get('schema')!r}")
    if doc.get("facade") not in _FACADES:
        fail("$.facade", f"expected one of {sorted(_FACADES)}, "
             f"got {doc.get('facade')!r}")
    if doc.get("transport") not in _TRANSPORTS:
        fail("$.transport", f"expected one of {sorted(_TRANSPORTS)}, "
             f"got {doc.get('transport')!r}")
    for k in _REQUIRED:
        if k not in doc:
            fail(f"$.{k}", "missing required section")
    for k in ("queries_served", "queries_shed", "deltas_applied"):
        expect_int(f"$.{k}", doc[k])
    for k in ("cache", "scheduler", "executor", "index", "telemetry"):
        if not isinstance(doc[k], dict):
            fail(f"$.{k}", f"expected object, got {type(doc[k]).__name__}")
    # the control plane reports null with every loop disabled
    if doc["control"] is not None and not isinstance(doc["control"], dict):
        fail("$.control", "expected object or null")
    sched = doc["scheduler"]
    missing = _SCHED_KEYS - set(sched)
    if missing:
        fail("$.scheduler", f"missing keys {sorted(missing)}")
    for k in _SCHED_KEYS:
        expect_int(f"$.scheduler.{k}", sched[k])
    tel = doc["telemetry"]
    if not isinstance(tel.get("enabled"), bool):
        fail("$.telemetry.enabled", "expected bool")
    if not isinstance(tel.get("tracing"), dict):
        fail("$.telemetry.tracing", "expected object")
    for k in ("build", "shadow", "async"):
        if doc.get(k) is not None and not isinstance(doc[k], dict):
            fail(f"$.{k}", "expected object or null")
    a = doc.get("async")
    if a is not None:
        for k in ("submitted", "completed", "shed", "inflight"):
            expect_int(f"$.async.{k}", a.get(k, -1))
        for k in ("admit_s", "exec_s", "overlap_s"):
            v = a.get(k)
            if isinstance(v, bool) or not isinstance(v, (int, float)) \
                    or v < 0:
                fail(f"$.async.{k}",
                     f"expected non-negative number, got {v!r}")
    if doc["facade"] == "sharded":
        if not isinstance(doc.get("router"), dict):
            fail("$.router", "sharded stats must carry the router section")
        if not isinstance(doc.get("shards"), list):
            fail("$.shards", "sharded stats must carry the shards list")
        for i, s in enumerate(doc["shards"]):
            if not isinstance(s, dict):
                fail(f"$.shards[{i}]", "expected object")
        if doc["transport"] == "rpc":
            rpc = doc.get("rpc")
            if not isinstance(rpc, dict):
                fail("$.rpc", "rpc transport must carry the rpc section")
            for k in ("live_workers", "membership_epoch", "joins",
                      "leaves", "rejoins", "retries"):
                expect_int(f"$.rpc.{k}", rpc.get(k, -1))
            if not isinstance(rpc.get("wire_bytes"), dict):
                fail("$.rpc.wire_bytes", "expected object")
    elif doc["transport"] != "local":
        fail("$.transport",
             f"single facade must be transport 'local', "
             f"got {doc['transport']!r}")
    return doc
