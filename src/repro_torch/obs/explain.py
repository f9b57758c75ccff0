"""Query EXPLAIN: witness derivations for Algorithm 1 answers.

The serving stack can say *that* ``(s, t, MR+)`` is true or false; this
module makes it say *why*. A **witness** is a JSON-ready record of the
derivation Algorithm 1 actually performed over one pair of entry rows:

* positive answers cite the index facts used — the direct Case-2 entry
  (``(t, MR) in L_out(s)`` / ``(s, MR) in L_in(t)``) or the Case-1 join
  hubs ``x`` with ``(x, MR)`` on *both* sides (Theorem 3's certificate);
* negative answers cite the pruning-era facts that rule the path out:
  which side has no entries at all, which side carries no entry for the
  queried MR, or — when both sides have candidates — that the two
  aid-sorted candidate hub sets are disjoint (by Theorems 1-2 the index
  is complete for ``|MR| <= k``, so a failed join *is* a proof of
  non-reachability, not a heuristic miss).

:func:`explain_rows` works on any ``(hub, mr_id)`` row pair in the
frozen layout's vocabulary — zero-copy CSR rows
(:meth:`FrozenRLCIndex.explain`), PAD-filtered device digests
(:meth:`DeviceIndex.explain_batch`), or a cross-shard digest joined
against a remote in-row (``ShardedRLCService.explain``) — so one
witness shape covers every backend. :func:`replay_witness` re-runs the
claim under the BiBFS product-automaton oracle, and
:func:`verify_witness_entries` re-checks the cited entries against the
dict-layout index; the property tests drive both.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["WITNESS_SCHEMA", "build_witness", "explain_rows",
           "replay_witness", "verify_witness_entries"]

WITNESS_SCHEMA = "repro.obs.witness/1"

#: negative-witness reasons, in the order they are ruled out
NEGATIVE_REASONS = ("empty_out_row", "empty_in_row", "no_out_candidates",
                    "no_in_candidates", "disjoint_hub_sets")


def build_witness(s: int, t: int, mr_id: Optional[int], *,
                  case2_out: bool, case2_in: bool,
                  out_row: int, in_row: int,
                  out_candidates: Sequence[int],
                  in_candidates: Sequence[int],
                  aid: Optional[np.ndarray] = None,
                  max_hubs: int = 8) -> dict:
    """Assemble one witness from pre-extracted row facts.

    ``out_candidates`` / ``in_candidates``: the hub ids whose row entry
    carries the queried MR (the Case-1 join inputs). ``aid`` orders the
    join hubs by access id when available (the dict layout and device
    digests may not carry it — hubs then sort by vertex id and report
    ``aid: null``).
    """
    out_c = sorted(int(h) for h in set(out_candidates))
    in_c = sorted(int(h) for h in set(in_candidates))
    join = set(out_c) & set(in_c)
    if aid is not None:
        join = sorted(join, key=lambda h: int(aid[h]))
    else:
        join = sorted(join)
    answer = bool(case2_out or case2_in or join)
    kind = ("case2_out" if case2_out else
            "case2_in" if case2_in else
            "case1" if join else "negative")
    hubs = [dict(hub=int(h),
                 aid=(int(aid[h]) if aid is not None else None))
            for h in join[:max_hubs]]
    w = dict(
        schema=WITNESS_SCHEMA,
        s=int(s), t=int(t),
        mr_id=(int(mr_id) if mr_id is not None else None),
        answer=answer, kind=kind,
        case2={"out": bool(case2_out), "in": bool(case2_in)},
        out_row=int(out_row), in_row=int(in_row),
        out_candidates=len(out_c), in_candidates=len(in_c),
        join_hubs=len(join), hubs=hubs,
        truncated=len(join) > max_hubs,
    )
    if not answer:
        if out_row == 0:
            reason = "empty_out_row"
        elif in_row == 0:
            reason = "empty_in_row"
        elif not out_c:
            reason = "no_out_candidates"
        elif not in_c:
            reason = "no_in_candidates"
        else:
            reason = "disjoint_hub_sets"
        w["negative"] = dict(reason=reason,
                             out_candidate_hubs=out_c[:max_hubs],
                             in_candidate_hubs=in_c[:max_hubs])
    return w


def explain_rows(out_hub, out_mr, in_hub, in_mr, s: int, t: int,
                 mr_id: int, aid: Optional[np.ndarray] = None,
                 max_hubs: int = 8, pad: Optional[int] = None) -> dict:
    """Witness for Algorithm 1 over explicit ``(hub, mr_id)`` rows.

    The row-pair twin of :func:`repro_torch.core.rlc_index.merge_join_rows`:
    same inputs (L_out(s) and L_in(t) in the frozen vocabulary), but it
    returns the derivation instead of a bool. ``pad``: hub id marking
    padding slots to drop first (the device layout's ``PAD``), so padded
    digests explain identically to exact CSR rows.
    """
    oh = np.asarray(out_hub)
    om = np.asarray(out_mr)
    ih = np.asarray(in_hub)
    im = np.asarray(in_mr)
    if pad is not None:
        keep = oh != pad
        oh, om = oh[keep], om[keep]
        keep = ih != pad
        ih, im = ih[keep], im[keep]
    case2_out = bool(np.any((oh == t) & (om == mr_id)))
    case2_in = bool(np.any((ih == s) & (im == mr_id)))
    return build_witness(
        s, t, mr_id,
        case2_out=case2_out, case2_in=case2_in,
        out_row=len(oh), in_row=len(ih),
        out_candidates=np.unique(oh[om == mr_id]).tolist(),
        in_candidates=np.unique(ih[im == mr_id]).tolist(),
        aid=aid, max_hubs=max_hubs)


def replay_witness(graph, witness: dict,
                   mr: Optional[Sequence[int]] = None) -> bool:
    """Re-run a witness's claim under the BiBFS product-automaton oracle.

    Accepts either a service EXPLAIN bundle (which carries ``mr``) or a
    raw witness plus an explicit ``mr``. The contract the property tests
    enforce: a positive witness replays to ``True``, a negative one to
    ``False`` (completeness for ``|MR| <= k``, Theorem 2).
    """
    from repro_torch.core.baselines import bibfs_rlc
    L = tuple(mr if mr is not None else witness["mr"])
    return bibfs_rlc(graph, int(witness["s"]), int(witness["t"]), L)


def verify_witness_entries(index, witness: dict,
                           mr: Sequence[int]) -> bool:
    """Re-check the entries a witness cites against a dict-layout
    :class:`repro_torch.core.rlc_index.RLCIndex` — every Case-2 direct entry
    and every listed Case-1 hub must exist on both required sides; a
    negative witness must agree with Algorithm 1."""
    L = tuple(mr)
    s, t = int(witness["s"]), int(witness["t"])
    kind = witness["kind"]
    if kind == "case2_out":
        return index.has_out(s, t, L)
    if kind == "case2_in":
        return index.has_in(t, s, L)
    if kind == "case1":
        hubs = witness["hubs"]
        return bool(hubs) and all(
            index.has_out(s, h["hub"], L) and index.has_in(t, h["hub"], L)
            for h in hubs)
    return not index.query(s, t, L)
