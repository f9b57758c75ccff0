"""Index-health auditor: a versioned report over a live RLC index.

The paper's offline guarantees — soundness of every entry (an entry *is*
a reachability fact), non-redundancy under PR1-PR3 (Definition 5,
"condensed"), and the frozen/device layouts mirroring the dict index
bit-for-bit — are proven at build time and then silently assumed while
deltas, hot swaps, and parallel rebuilds mutate the serving state. The
auditor re-measures them on demand:

* **entry histograms** — entries per hub-rank decile (aid order), per
  MR length, per label, per direction: the shape the shard planner and
  the cache warmers read;
* **redundancy re-verification** — Definition 5 re-checked on a sample
  of frozen rows (a violation means a pruning rule was bypassed, e.g.
  by a buggy delta replay);
* **soundness probes** — entry-derived queries replayed against the
  BiBFS oracle when a graph is supplied;
* **byte accounting** — dict index / frozen CSR / bit mirror / device
  layout, the memory story of one serving stack;
* **drift fingerprints** — a CRC over the frozen layout plus a 64-way
  row-bucket sketch, so "delta-applied equals rebuilt" becomes a
  comparable artifact instead of a test-only assertion, and a drifting
  bucket localizes *which* rows diverged.

Reports are versioned (:data:`AUDIT_SCHEMA`), validated by
:func:`validate_audit_report` (tests, the benchmark smoke gate, and the
``python -m repro_torch.obs audit`` CLI all share it), surfaced through the
``repro.obs/1`` snapshot ``extra`` section, and banked as gauges for
the Prometheus export (:func:`bank_audit_metrics`).
"""
from __future__ import annotations

import zlib
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["AUDIT_SCHEMA", "audit_index", "bank_audit_metrics",
           "device_nbytes", "fingerprint", "frozen_nbytes",
           "validate_audit_report"]

AUDIT_SCHEMA = "repro.obs.audit/1"

_N_BUCKETS = 64     # row-fingerprint sketch width
_N_DECILES = 10


# --------------------------------------------------------------------- #
# byte accounting helpers
# --------------------------------------------------------------------- #
def frozen_nbytes(frozen) -> int:
    """Real allocation of a frozen CSR layout (vs the paper-comparable
    ``size_bytes`` which counts 4 + k bytes per logical entry)."""
    return int(sum(a.nbytes for a in (
        frozen.out_indptr, frozen.out_hub, frozen.out_mr,
        frozen.in_indptr, frozen.in_hub, frozen.in_mr)))


def device_nbytes(device_index) -> Optional[int]:
    """Padded device-layout allocation (hub/mr/sorted-key arrays)."""
    if device_index is None:
        return None
    total = 0
    for name in ("out_hub", "out_mr", "in_hub", "in_mr",
                 "out_key", "in_key"):
        arr = getattr(device_index, name, None)
        if arr is not None:
            total += int(arr.nbytes)
    return total


# --------------------------------------------------------------------- #
# drift fingerprint
# --------------------------------------------------------------------- #
def fingerprint(frozen) -> dict:
    """CRC fingerprint of a frozen layout, with a per-row bucket sketch.

    ``combined`` hashes every entry array (hubs, MR ids, row boundaries
    — byte-identical layouts, and only those, fingerprint equal, which
    is exactly the delta-vs-rebuild bit-identical guarantee). The
    ``row_buckets_*`` sketches XOR each vertex row's CRC into bucket
    ``v % 64``: when two fingerprints drift, the differing buckets name
    the residue classes of the diverging rows, narrowing a full-index
    diff ~64x before anyone has to walk entries.
    """
    def row_crcs(indptr, hub, mr):
        buckets = [0] * _N_BUCKETS
        for v in range(len(indptr) - 1):
            lo, hi = int(indptr[v]), int(indptr[v + 1])
            c = zlib.crc32(hub[lo:hi].tobytes())
            c = zlib.crc32(mr[lo:hi].tobytes(), c)
            buckets[v % _N_BUCKETS] ^= c
        return buckets

    combined = 0
    for a in (frozen.out_indptr, frozen.out_hub, frozen.out_mr,
              frozen.in_indptr, frozen.in_hub, frozen.in_mr):
        combined = zlib.crc32(np.ascontiguousarray(a).tobytes(), combined)
    return dict(
        combined=f"{combined:08x}",
        entries=int(frozen.num_entries()),
        row_buckets_out=row_crcs(frozen.out_indptr, frozen.out_hub,
                                 frozen.out_mr),
        row_buckets_in=row_crcs(frozen.in_indptr, frozen.in_hub,
                                frozen.in_mr),
    )


# --------------------------------------------------------------------- #
# the auditor
# --------------------------------------------------------------------- #
def _hub_rank_deciles(hub: np.ndarray, aid: np.ndarray,
                      num_vertices: int) -> List[int]:
    """Entry counts per aid-rank decile of the entry's hub — the
    hub-concentration profile (paper §V: high-rank hubs should carry
    most entries; a flat profile means the access order degraded)."""
    if len(hub) == 0:
        return [0] * _N_DECILES
    # aid is 1-based; decile by rank fraction of the vertex space
    rank = (np.asarray(aid)[hub] - 1).astype(np.float64)
    dec = np.minimum((rank * _N_DECILES // max(num_vertices, 1)),
                     _N_DECILES - 1).astype(np.int64)
    return np.bincount(dec, minlength=_N_DECILES).tolist()


def _redundant(frozen, s: int, t: int, mr_id: int) -> bool:
    """Definition 5 on frozen rows: the direct fact ``s ~mr+~> t`` is
    also derivable through a third hub."""
    oh, om = frozen.row_out(s)
    ih, im = frozen.row_in(t)
    o = set(oh[om == mr_id].tolist()) - {s, t}
    i = set(ih[im == mr_id].tolist()) - {s, t}
    return bool(o & i)


def audit_index(frozen, id_to_mr: Sequence, index=None, graph=None,
                device_index=None, sample: int = 128,
                seed: int = 0) -> dict:
    """Audit one serving index; returns an :data:`AUDIT_SCHEMA` report.

    ``frozen`` drives everything; ``index`` (dict layout) adds mirror
    byte accounting, ``device_index`` adds device bytes, ``graph`` turns
    on the oracle soundness probes. ``sample`` bounds both the
    redundancy re-check (entries examined) and the soundness probes
    (oracle replays) so an audit stays cheap on big indexes.
    """
    rng = np.random.default_rng(seed)
    n = frozen.num_vertices
    out_n, in_n = len(frozen.out_hub), len(frozen.in_hub)

    # -- histograms ---------------------------------------------------- #
    def mr_len_hist(mr: np.ndarray) -> dict:
        lens = np.array([len(id_to_mr[c]) for c in range(len(id_to_mr))],
                        dtype=np.int64)
        counts = np.bincount(mr, minlength=len(id_to_mr)) \
            if len(mr) else np.zeros(len(id_to_mr), np.int64)
        out = {}
        for ln in range(1, int(frozen.k) + 1):
            out[str(ln)] = int(counts[lens == ln].sum())
        return out

    label_counts: dict = {}
    all_mr = np.concatenate([frozen.out_mr, frozen.in_mr]) \
        if out_n + in_n else np.zeros(0, np.int64)
    mr_counts = np.bincount(all_mr, minlength=len(id_to_mr)) \
        if len(all_mr) else np.zeros(len(id_to_mr), np.int64)
    for c, mr in enumerate(id_to_mr):
        for lab in set(mr):
            key = str(int(lab))
            label_counts[key] = label_counts.get(key, 0) \
                + int(mr_counts[c])

    histograms = dict(
        hub_rank_decile=dict(
            out=_hub_rank_deciles(frozen.out_hub, frozen.aid, n),
            in_=_hub_rank_deciles(frozen.in_hub, frozen.aid, n)),
        mr_len=dict(out=mr_len_hist(frozen.out_mr),
                    in_=mr_len_hist(frozen.in_mr)),
        label=label_counts,
    )

    # -- redundancy re-verification (Definition 5, sampled) ------------- #
    checked = violations = 0
    examples: List[dict] = []
    for v in rng.permutation(n).tolist():
        if checked >= sample:
            break
        ih, im = frozen.row_in(v)
        for h, c in zip(ih.tolist(), im.tolist()):
            if checked >= sample:
                break
            if h == v:
                continue
            checked += 1
            if _redundant(frozen, h, v, c):
                violations += 1
                if len(examples) < 5:
                    examples.append(dict(s=int(h), t=int(v),
                                         mr_id=int(c),
                                         mr=list(id_to_mr[c])))
    redundancy = dict(sampled=checked, violations=violations,
                      examples=examples)

    # -- soundness probes (oracle replay of entry-derived queries) ------ #
    soundness = None
    if graph is not None:
        from repro_torch.core.baselines import bibfs_rlc
        from repro_torch.core.queries import sample_index_queries
        probes = sample_index_queries(frozen, id_to_mr,
                                      n=min(sample, 64), seed=seed)
        bad = [q for q in probes
               if not bibfs_rlc(graph, q[0], q[1], q[2])]
        soundness = dict(
            sampled=len(probes), violations=len(bad),
            examples=[dict(s=s, t=t, mr=list(L)) for s, t, L in bad[:5]])

    # -- byte accounting ------------------------------------------------ #
    mirror = getattr(index, "_mirror", None) if index is not None else None
    bytes_ = dict(
        index=(int(index.size_bytes()) if index is not None
               else int(frozen.size_bytes())),
        frozen=frozen_nbytes(frozen),
        mirror=(int(mirror.size_bytes()) if mirror is not None else None),
        device=device_nbytes(device_index),
    )

    return dict(
        schema=AUDIT_SCHEMA,
        identity=dict(num_vertices=int(n), k=int(frozen.k),
                      num_mrs=len(id_to_mr),
                      entries_out=int(out_n), entries_in=int(in_n),
                      entries=int(out_n + in_n),
                      max_row=int(frozen.max_row)),
        histograms=histograms,
        redundancy=redundancy,
        soundness=soundness,
        bytes=bytes_,
        fingerprint=fingerprint(frozen),
    )


# --------------------------------------------------------------------- #
# validation + metric banking
# --------------------------------------------------------------------- #
def validate_audit_report(doc: dict) -> dict:
    """Validate an audit report against :data:`AUDIT_SCHEMA`; returns the
    doc or raises ``ValueError`` naming the first offending path. The one
    validator tests, the smoke gate, and the CLI share."""
    def fail(path: str, why: str):
        raise ValueError(f"audit report invalid at {path}: {why}")

    def nonneg_int(path, v):
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            fail(path, f"expected non-negative int, got {v!r}")

    if not isinstance(doc, dict):
        fail("$", f"expected object, got {type(doc).__name__}")
    if doc.get("schema") != AUDIT_SCHEMA:
        fail("$.schema",
             f"expected {AUDIT_SCHEMA!r}, got {doc.get('schema')!r}")
    ident = doc.get("identity")
    if not isinstance(ident, dict):
        fail("$.identity", "expected object")
    for k in ("num_vertices", "k", "num_mrs", "entries_out",
              "entries_in", "entries", "max_row"):
        nonneg_int(f"$.identity.{k}", ident.get(k))
    if ident["entries"] != ident["entries_out"] + ident["entries_in"]:
        fail("$.identity.entries", "entries != entries_out + entries_in")
    hist = doc.get("histograms")
    if not isinstance(hist, dict):
        fail("$.histograms", "expected object")
    hrd = hist.get("hub_rank_decile")
    if not isinstance(hrd, dict):
        fail("$.histograms.hub_rank_decile", "expected object")
    for side in ("out", "in_"):
        row = hrd.get(side)
        if not isinstance(row, list) or len(row) != _N_DECILES:
            fail(f"$.histograms.hub_rank_decile.{side}",
                 f"expected list of {_N_DECILES} counts")
        for i, v in enumerate(row):
            nonneg_int(f"$.histograms.hub_rank_decile.{side}[{i}]", v)
    for sec in ("redundancy", "soundness"):
        r = doc.get(sec)
        if r is None and sec == "soundness":
            continue
        if not isinstance(r, dict):
            fail(f"$.{sec}", "expected object")
        nonneg_int(f"$.{sec}.sampled", r.get("sampled"))
        nonneg_int(f"$.{sec}.violations", r.get("violations"))
        if r["violations"] > r["sampled"]:
            fail(f"$.{sec}.violations", "violations exceed sampled")
        if not isinstance(r.get("examples"), list):
            fail(f"$.{sec}.examples", "expected list")
    b = doc.get("bytes")
    if not isinstance(b, dict):
        fail("$.bytes", "expected object")
    for k in ("index", "frozen", "mirror", "device"):
        v = b.get(k)
        if v is not None:
            nonneg_int(f"$.bytes.{k}", v)
    fp = doc.get("fingerprint")
    if not isinstance(fp, dict):
        fail("$.fingerprint", "expected object")
    comb = fp.get("combined")
    if not isinstance(comb, str) or len(comb) != 8 \
            or any(c not in "0123456789abcdef" for c in comb):
        fail("$.fingerprint.combined", f"expected 8-hex digest, got "
             f"{comb!r}")
    for side in ("row_buckets_out", "row_buckets_in"):
        row = fp.get(side)
        if not isinstance(row, list) or len(row) != _N_BUCKETS:
            fail(f"$.fingerprint.{side}",
                 f"expected list of {_N_BUCKETS} bucket CRCs")
    return doc


def bank_audit_metrics(registry, report: dict) -> None:
    """Mirror the latest audit into registry gauges so the Prometheus
    export carries an index-health block alongside the serving series."""
    ent = registry.gauge("rlc_audit_entries",
                         desc="index entries at the last audit",
                         labelnames=("direction",))
    ent.labels(direction="out").set(report["identity"]["entries_out"])
    ent.labels(direction="in").set(report["identity"]["entries_in"])
    registry.gauge(
        "rlc_audit_redundancy_sampled",
        desc="entries re-checked for Definition-5 redundancy "
             "at the last audit").labels().set(
        report["redundancy"]["sampled"])
    registry.gauge(
        "rlc_audit_redundancy_violations",
        desc="redundant entries found at the last audit").labels().set(
        report["redundancy"]["violations"])
    if report.get("soundness") is not None:
        registry.gauge(
            "rlc_audit_soundness_violations",
            desc="entry-derived queries the oracle refuted "
                 "at the last audit").labels().set(
            report["soundness"]["violations"])
    by = registry.gauge("rlc_audit_bytes",
                        desc="index byte accounting at the last audit",
                        unit="By", labelnames=("component",))
    for comp, v in report["bytes"].items():
        if v is not None:
            by.labels(component=comp).set(v)
