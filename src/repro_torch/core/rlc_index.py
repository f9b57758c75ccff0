"""The RLC index (paper §V, Definition 4) and Algorithm 1 (query).

Index layout
------------
For every vertex ``v`` the index holds two entry sets

    L_in(v)  = {(u, mr) : u ~~mr^+~~> v}      (u reaches v, MR recorded)
    L_out(v) = {(w, mr) : v ~~mr^+~~> w}

Entries are stored per-vertex as ``dict[hub_vertex] -> set[mr tuple]`` for
O(1) membership, and can be *frozen* into aid-sorted flat numpy arrays (the
paper's merge-join layout, also consumed by the batched torch query
engines in :mod:`repro_torch.core.device_index`).

Query semantics (Definition 4 / Theorem 3): ``(s, t, L^+)`` is true iff
  * Case 2: ``(t, L) in L_out(s)`` or ``(s, L) in L_in(t)``; or
  * Case 1: ``exists x: (x, L) in L_out(s) and (x, L) in L_in(t)``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .minimum_repeat import LabelSeq

Entry = Tuple[int, LabelSeq]          # (hub vertex id, minimum repeat)
EntryMap = Dict[int, Set[LabelSeq]]   # hub vertex id -> set of MRs

_BIT = np.left_shift(np.uint8(1), np.arange(8, dtype=np.uint8))


class BitMirror:
    """Bit-packed mirror of the entry sets, keyed per minimum repeat.

    ``out[x, c]`` is a little-endian packed bitset over visited vertices
    ``y`` with bit ``y`` set iff ``(x, mr_c) in L_out(y)`` (``in_`` is the
    symmetric L_in mirror). One row is one hub's footprint for one MR, so
    Algorithm 2's PR1 coverage check for a whole frontier collapses to a
    handful of row ORs + a bit gather (:meth:`RLCIndex.pr1_cover_out`) —
    the numpy twin of the 32-wide packing in
    :mod:`repro_torch.kernels.bitpack`. The hub axis leads so a hub's whole
    footprint (``side[hub]`` — what :meth:`RLCIndex.pr1_cover_all` and
    the delta engine's output diff read) is one contiguous slice.
    """

    def __init__(self, num_mrs: int, num_vertices: int):
        self.num_vertices = num_vertices
        self.words = (num_vertices + 7) // 8
        self.out = np.zeros((num_vertices, num_mrs, self.words), np.uint8)
        self.in_ = np.zeros((num_vertices, num_mrs, self.words), np.uint8)

    def nbytes(self) -> int:
        return self.out.nbytes + self.in_.nbytes

    def size_bytes(self) -> int:
        """Allocation footprint of the mirror (both sides). The dense
        mirror allocates everything up front, so this is also its peak —
        the number `BuildStats.peak_mirror_bytes` reports and the quantity
        the hub-sliced worker mirrors (:mod:`repro_torch.build.parallel.mirror`)
        exist to shrink."""
        return self.nbytes()

    def set1(self, side: np.ndarray, c: int, hub: int, y: int) -> None:
        side[hub, c, y >> 3] |= _BIT[y & 7]

    def set_many(self, side: np.ndarray, c: int, hub: int, ys) -> None:
        if len(ys) <= 16:                      # bulk update doesn't pay
            row = side[hub, c]
            for y in ys:
                row[y >> 3] |= _BIT[y & 7]
            return
        row = np.zeros(self.num_vertices, np.uint8)
        row[np.asarray(ys)] = 1
        side[hub, c] |= np.packbits(row, bitorder="little")[:self.words]


def merge_join_rows(out_hub: np.ndarray, out_mr: np.ndarray,
                    in_hub: np.ndarray, in_mr: np.ndarray,
                    aid: np.ndarray, s: int, t: int, mr_id: int) -> bool:
    """Algorithm 1 on two explicit aid-sorted entry rows.

    ``out_hub/out_mr`` is L_out(s) and ``in_hub/in_mr`` is L_in(t), both in
    the frozen ``(aid(hub), mr_id)`` order. Factored out of
    :meth:`FrozenRLCIndex.query` so a shard that owns only ``t``'s in-side
    can join against an out-row digest shipped from ``s``'s owning shard
    (:mod:`repro_torch.service.sharded`) — the rows don't have to come from the
    same index object, only from the same ``aid`` space.
    """
    # Case 2: direct entries.
    if (np.any((out_hub == t) & (out_mr == mr_id))
            or np.any((in_hub == s) & (in_mr == mr_id))):
        return True
    # Case 1: merge join on aid(hub).
    a, b = 0, 0
    while a < len(out_hub) and b < len(in_hub):
        ka, kb = aid[out_hub[a]], aid[in_hub[b]]
        if ka < kb:
            a += 1
        elif kb < ka:
            b += 1
        else:
            # same hub: scan the equal-aid runs for the queried MR.
            hub_aid = ka
            a2 = a
            found_a = found_b = False
            while a2 < len(out_hub) and aid[out_hub[a2]] == hub_aid:
                found_a |= out_mr[a2] == mr_id
                a2 += 1
            b2 = b
            while b2 < len(in_hub) and aid[in_hub[b2]] == hub_aid:
                found_b |= in_mr[b2] == mr_id
                b2 += 1
            if found_a and found_b:
                return True
            a, b = a2, b2
    return False


@dataclass
class RLCIndex:
    """A (possibly partially built) RLC index for a graph with ``n`` vertices.

    ``aid`` maps vertex -> 1-based access id (IN-OUT order); entries are kept
    in dictionaries during construction and optionally frozen to flat arrays.
    """

    num_vertices: int
    k: int
    aid: np.ndarray  # (n,) int64, 1-based access ids
    l_in: List[EntryMap] = field(default_factory=list)
    l_out: List[EntryMap] = field(default_factory=list)
    # optional packed coverage mirror (attached by the batched builders)
    _mirror: Optional[BitMirror] = field(default=None, repr=False,
                                         compare=False)
    _mr_ids: Optional[Dict[LabelSeq, int]] = field(default=None, repr=False,
                                                   compare=False)

    def __post_init__(self):
        if not self.l_in:
            self.l_in = [dict() for _ in range(self.num_vertices)]
        if not self.l_out:
            self.l_out = [dict() for _ in range(self.num_vertices)]

    # -- construction-time mutation ------------------------------------- #
    def attach_bit_mirror(self, mr_ids: Dict[LabelSeq, int]) -> BitMirror:
        """Attach (and backfill) a :class:`BitMirror` so subsequent
        ``add_out``/``add_in`` calls keep it in sync and the vectorized PR1
        batch queries become available."""
        self._mr_ids = dict(mr_ids)
        self._mirror = BitMirror(len(mr_ids), self.num_vertices)
        for side, maps in ((self._mirror.out, self.l_out),
                           (self._mirror.in_, self.l_in)):
            for y, d in enumerate(maps):
                for hub, mrs in d.items():
                    for mr in mrs:
                        self._mirror.set1(side, self._mr_ids[mr], hub, y)
        return self._mirror

    def add_out(self, v: int, hub: int, mr: LabelSeq) -> None:
        """Record ``(hub, mr)`` in ``L_out(v)`` (v ~~mr^+~~> hub)."""
        self.l_out[v].setdefault(hub, set()).add(mr)
        if self._mirror is not None:
            self._mirror.set1(self._mirror.out, self._mr_ids[mr], hub, v)

    def add_in(self, v: int, hub: int, mr: LabelSeq) -> None:
        """Record ``(hub, mr)`` in ``L_in(v)`` (hub ~~mr^+~~> v)."""
        self.l_in[v].setdefault(hub, set()).add(mr)
        if self._mirror is not None:
            self._mirror.set1(self._mirror.in_, self._mr_ids[mr], hub, v)

    def add_out_many(self, vs: Sequence[int], hub: int, mr: LabelSeq
                     ) -> None:
        """Bulk :meth:`add_out`: one ``(hub, mr)`` entry at every vertex in
        ``vs`` (one batched mirror update instead of |vs| bit pokes)."""
        for v in vs:
            self.l_out[v].setdefault(hub, set()).add(mr)
        if self._mirror is not None and len(vs):
            self._mirror.set_many(self._mirror.out, self._mr_ids[mr], hub,
                                  vs)

    def add_in_many(self, vs: Sequence[int], hub: int, mr: LabelSeq
                    ) -> None:
        """Bulk :meth:`add_in` (see :meth:`add_out_many`)."""
        for v in vs:
            self.l_in[v].setdefault(hub, set()).add(mr)
        if self._mirror is not None and len(vs):
            self._mirror.set_many(self._mirror.in_, self._mr_ids[mr], hub,
                                  vs)

    def has_out(self, v: int, hub: int, mr: LabelSeq) -> bool:
        s = self.l_out[v].get(hub)
        return s is not None and mr in s

    def has_in(self, v: int, hub: int, mr: LabelSeq) -> bool:
        s = self.l_in[v].get(hub)
        return s is not None and mr in s

    # -- Algorithm 1 ------------------------------------------------------ #
    def query(self, s: int, t: int, L: Sequence[int]) -> bool:
        """Algorithm 1. ``L`` must be its own minimum repeat with |L| <= k."""
        L = tuple(L)
        # Case 2: direct entries.
        if self.has_out(s, t, L) or self.has_in(t, s, L):
            return True
        # Case 1: merge join over L_out(s) x L_in(t) on the hub vertex.
        # Dict intersection is semantically identical to the paper's
        # aid-sorted merge join (the frozen/device path uses the sorted
        # layout verbatim); iterate the smaller side.
        out_s, in_t = self.l_out[s], self.l_in[t]
        if len(out_s) > len(in_t):
            for hub, mrs in in_t.items():
                if L in mrs:
                    o = out_s.get(hub)
                    if o is not None and L in o:
                        return True
        else:
            for hub, mrs in out_s.items():
                if L in mrs:
                    i = in_t.get(hub)
                    if i is not None and L in i:
                        return True
        return False

    def explain(self, s: int, t: int, L: Sequence[int],
                mr_id: Optional[int] = None, max_hubs: int = 8) -> dict:
        """Witness-mode Algorithm 1 over the dict layout: the same
        Case-2 / Case-1 decision as :meth:`query`, but returning the
        derivation (see :mod:`repro_torch.obs.explain`). ``mr_id`` only stamps
        the witness — the dict layout joins on MR tuples."""
        from repro_torch.obs.explain import build_witness
        L = tuple(L)
        if mr_id is None and self._mr_ids is not None:
            mr_id = self._mr_ids.get(L)
        return build_witness(
            s, t, mr_id,
            case2_out=self.has_out(s, t, L),
            case2_in=self.has_in(t, s, L),
            out_row=sum(len(ms) for ms in self.l_out[s].values()),
            in_row=sum(len(ms) for ms in self.l_in[t].values()),
            out_candidates=[h for h, ms in self.l_out[s].items()
                            if L in ms],
            in_candidates=[h for h, ms in self.l_in[t].items()
                           if L in ms],
            aid=self.aid, max_hubs=max_hubs)

    # -- vectorized PR1 batch query (Algorithm 2 insert-side) -------------- #
    def pr1_cover_out(self, hub: int, mr: LabelSeq) -> np.ndarray:
        """Packed bitset over ``y`` of ``Query(y, hub, mr^+)`` — the PR1
        predicate a backward KBS of ``hub`` evaluates at every visited
        vertex. Requires an attached bit mirror; a handful of row ORs:
        Case-2 direct rows plus Case-1 through each hub of ``L_in(hub)``.
        """
        m, c = self._mirror, self._mr_ids[mr]
        cov = m.out[hub, c].copy()               # (hub, mr) in L_out(y)
        for x, mrs in self.l_in[hub].items():
            if mr in mrs:
                cov |= m.out[x, c]               # Case 1 via hub x
                cov[x >> 3] |= _BIT[x & 7]       # (y, mr) in L_in(hub)
        return cov

    def pr1_cover_in(self, hub: int, mr: LabelSeq) -> np.ndarray:
        """Symmetric to :meth:`pr1_cover_out`: packed ``Query(hub, y, mr^+)``
        over ``y`` — PR1 for the forward KBS of ``hub``."""
        m, c = self._mirror, self._mr_ids[mr]
        cov = m.in_[hub, c].copy()
        for x, mrs in self.l_out[hub].items():
            if mr in mrs:
                cov |= m.in_[x, c]
                cov[x >> 3] |= _BIT[x & 7]
        return cov

    def pr1_cover_all(self, hub: int, backward: bool = True) -> np.ndarray:
        """(C, W) packed PR1 coverage rows for *every* MR at once — row
        ``c`` equals :meth:`pr1_cover_out` (backward) /
        :meth:`pr1_cover_in` (forward) for ``mr_c``. The batched builders
        fetch this once per (hub, direction) phase; Algorithm 2 guarantees
        the phase's PR1 outcomes depend only on the pre-phase snapshot."""
        m = self._mirror
        side = m.out if backward else m.in_
        row_src = self.l_in[hub] if backward else self.l_out[hub]
        cov = side[hub].copy()
        for x, mrs in row_src.items():
            xb, xbit = x >> 3, _BIT[x & 7]
            for mr in mrs:
                c = self._mr_ids[mr]
                cov[c] |= side[x, c]
                cov[c, xb] |= xbit
        return cov

    def pr1_batch(self, ys: Sequence[int], hub: int, mr: LabelSeq,
                  backward: bool = True) -> np.ndarray:
        """Vectorized PR1: ``[Query(y, hub, mr^+)]`` (backward) or
        ``[Query(hub, y, mr^+)]`` (forward) for every ``y`` in ``ys``.
        Uses the packed mirror when attached, else falls back to per-query
        Algorithm 1."""
        ys = np.asarray(ys, dtype=np.int64)
        if self._mirror is not None:
            cov = (self.pr1_cover_out(hub, mr) if backward
                   else self.pr1_cover_in(hub, mr))
            return (cov[ys >> 3] & _BIT[ys & 7]) != 0
        if backward:
            return np.array([self.query(int(y), hub, mr) for y in ys],
                            dtype=bool)
        return np.array([self.query(hub, int(y), mr) for y in ys],
                        dtype=bool)

    # -- stats & invariants ------------------------------------------------ #
    def num_entries(self) -> int:
        return (sum(len(m) for d in self.l_in for m in d.values())
                + sum(len(m) for d in self.l_out for m in d.values()))

    def size_bytes(self) -> int:
        """Paper-comparable size: each entry = 4B vid + k bytes of labels."""
        per_entry = 4 + self.k
        return self.num_entries() * per_entry

    def is_condensed(self) -> bool:
        """Definition 5: no direct entry is also derivable via a 2-hop pair."""
        for t in range(self.num_vertices):
            for s, mrs in self.l_in[t].items():
                if s == t:
                    continue
                for L in mrs:
                    for hub, o_mrs in self.l_out[s].items():
                        if hub in (s, t):
                            continue
                        if L in o_mrs and L in self.l_in[t].get(hub, ()):
                            return False
        for s in range(self.num_vertices):
            for t, mrs in self.l_out[s].items():
                if s == t:
                    continue
                for L in mrs:
                    for hub, i_mrs in self.l_in[t].items():
                        if hub in (s, t):
                            continue
                        if L in i_mrs and L in self.l_out[s].get(hub, ()):
                            return False
        return True

    # -- frozen merge-join layout ------------------------------------------ #
    def freeze(self, mr_ids: Dict[LabelSeq, int]) -> "FrozenRLCIndex":
        return FrozenRLCIndex.from_index(self, mr_ids)


@dataclass
class FrozenRLCIndex:
    """Aid-sorted flat layout of an :class:`RLCIndex` (paper §V-C query cost).

    Per direction: CSR over vertices; per vertex a run of entries sorted by
    ``(aid(hub), mr_id)`` — exactly the order Algorithm 1's merge join
    expects. This layout feeds the batched device query engine.
    """

    num_vertices: int
    k: int
    aid: np.ndarray
    out_indptr: np.ndarray  # (n+1,)
    out_hub: np.ndarray     # (#out,) hub vertex ids
    out_mr: np.ndarray      # (#out,) dense MR ids
    in_indptr: np.ndarray
    in_hub: np.ndarray
    in_mr: np.ndarray

    @staticmethod
    def _flatten(maps: List[EntryMap], aid: np.ndarray,
                 mr_ids: Dict[LabelSeq, int]):
        indptr = np.zeros(len(maps) + 1, dtype=np.int64)
        hubs: List[int] = []
        mrs: List[int] = []
        for v, d in enumerate(maps):
            rows = sorted(
                ((int(aid[h]), mr_ids[m], h) for h, ms in d.items()
                 for m in ms))
            indptr[v + 1] = indptr[v] + len(rows)
            hubs.extend(r[2] for r in rows)
            mrs.extend(r[1] for r in rows)
        return (indptr, np.asarray(hubs, dtype=np.int32),
                np.asarray(mrs, dtype=np.int32))

    @staticmethod
    def from_index(idx: RLCIndex, mr_ids: Dict[LabelSeq, int]
                   ) -> "FrozenRLCIndex":
        oi, oh, om = FrozenRLCIndex._flatten(idx.l_out, idx.aid, mr_ids)
        ii, ih, im = FrozenRLCIndex._flatten(idx.l_in, idx.aid, mr_ids)
        return FrozenRLCIndex(idx.num_vertices, idx.k, idx.aid,
                              oi, oh, om, ii, ih, im)

    @staticmethod
    def _row_sorted(d: EntryMap, aid: np.ndarray,
                    mr_ids: Dict[LabelSeq, int]):
        rows = sorted(((int(aid[h]), mr_ids[m], h) for h, ms in d.items()
                       for m in ms))
        return (np.asarray([r[2] for r in rows], dtype=np.int32),
                np.asarray([r[1] for r in rows], dtype=np.int32))

    def patch_rows(self, index: RLCIndex, mr_ids: Dict[LabelSeq, int],
                   dirty_out, dirty_in, aid=None) -> "FrozenRLCIndex":
        """Re-freeze ``index`` reusing this frozen layout's clean rows.

        ``dirty_out``/``dirty_in`` are the vertex sets (any container
        supporting ``in``) whose entry rows may differ from this frozen
        snapshot — rows whose entries changed, plus rows whose aid sort
        order may have shifted (they hold a hub whose access rank moved).
        Dirty rows are re-derived from ``index``'s dict layout; clean rows
        are copied from this object's flat arrays, skipping the per-entry
        python sort that dominates a full :meth:`RLCIndex.freeze`. The
        result is bit-identical to ``index.freeze(mr_ids)`` provided the
        dirty sets cover every changed/re-ordered row — the delta-build
        property suite enforces exactly that.

        ``aid``: the hub sort order of the result; defaults to
        ``index.aid`` (the current access order). Algorithm 1 only needs
        *one consistent* total order on both sides of the merge join, so
        a caller that mixes patched and unpatched row ranges across hosts
        (the sharded service) passes ``self.aid`` instead — the stable
        order it froze with — and then rows whose entries did not change
        never need re-freezing at all, whatever happened to access ranks.
        """
        aid = np.asarray(index.aid if aid is None else aid)

        def patch(old_indptr, old_hub, old_mr, maps, dirty):
            n = len(maps)
            hubs, mrs = [], []
            indptr = np.zeros(n + 1, dtype=np.int64)
            for v in range(n):
                if v in dirty:
                    h, m = self._row_sorted(maps[v], aid, mr_ids)
                else:
                    lo, hi = old_indptr[v], old_indptr[v + 1]
                    h, m = old_hub[lo:hi], old_mr[lo:hi]
                indptr[v + 1] = indptr[v] + len(h)
                hubs.append(h)
                mrs.append(m)
            cat = lambda parts: (np.concatenate(parts)  # noqa: E731
                                 if parts else np.empty(0, np.int32))
            return indptr, cat(hubs).astype(np.int32), \
                cat(mrs).astype(np.int32)

        oi, oh, om = patch(self.out_indptr, self.out_hub, self.out_mr,
                           index.l_out, dirty_out)
        ii, ih, im = patch(self.in_indptr, self.in_hub, self.in_mr,
                           index.l_in, dirty_in)
        return FrozenRLCIndex(index.num_vertices, index.k, aid,
                              oi, oh, om, ii, ih, im)

    def row_out(self, s: int) -> Tuple[np.ndarray, np.ndarray]:
        """Zero-copy ``(hub, mr)`` view of L_out(s), aid-sorted."""
        o0, o1 = self.out_indptr[s], self.out_indptr[s + 1]
        return self.out_hub[o0:o1], self.out_mr[o0:o1]

    def row_in(self, t: int) -> Tuple[np.ndarray, np.ndarray]:
        """Zero-copy ``(hub, mr)`` view of L_in(t), aid-sorted."""
        i0, i1 = self.in_indptr[t], self.in_indptr[t + 1]
        return self.in_hub[i0:i1], self.in_mr[i0:i1]

    def query(self, s: int, t: int, mr_id: int) -> bool:
        """Algorithm 1 over the flat layout (true aid-ordered merge join)."""
        oh, om = self.row_out(s)
        ih, im = self.row_in(t)
        return merge_join_rows(oh, om, ih, im, self.aid, s, t, mr_id)

    def explain(self, s: int, t: int, mr_id: int,
                max_hubs: int = 8) -> dict:
        """Witness-mode :meth:`query`: the derivation Algorithm 1's
        merge join performs over this layout's two CSR rows (see
        :mod:`repro_torch.obs.explain` for the witness shape)."""
        from repro_torch.obs.explain import explain_rows
        oh, om = self.row_out(int(s))
        ih, im = self.row_in(int(t))
        return explain_rows(oh, om, ih, im, int(s), int(t), int(mr_id),
                            aid=self.aid, max_hubs=max_hubs)

    def query_batch(self, s: Sequence[int], t: Sequence[int],
                    mr_id: Sequence[int], witness: bool = False):
        """Vectorized-per-query Algorithm 1 over the flat numpy layout.

        The frozen-numpy serving backend: no device transfer, no padding —
        each query touches only its two CSR rows. With ``witness=True``
        returns ``(answers, witnesses)`` — one :meth:`explain` record per
        query — instead of the bare answer array (opt-in: the witness
        walk is strictly more work than the merge join).
        """
        s = np.asarray(s)
        t = np.asarray(t)
        mr_id = np.asarray(mr_id)
        out = np.zeros(len(s), dtype=bool)
        for q in range(len(s)):
            out[q] = self.query(int(s[q]), int(t[q]), int(mr_id[q]))
        if witness:
            ws = [self.explain(int(s[q]), int(t[q]), int(mr_id[q]))
                  for q in range(len(s))]
            return out, ws
        return out

    @property
    def max_row(self) -> int:
        return int(max(np.max(np.diff(self.out_indptr), initial=0),
                       np.max(np.diff(self.in_indptr), initial=0)))

    # -- shard slicing ----------------------------------------------------- #
    def num_entries(self) -> int:
        return len(self.out_hub) + len(self.in_hub)

    def size_bytes(self) -> int:
        """Paper-comparable size (matches :meth:`RLCIndex.size_bytes`)."""
        return self.num_entries() * (4 + self.k)

    def entry_weights(self) -> np.ndarray:
        """Per-vertex entry counts (out + in) — the shard planner's balance
        weight."""
        return (np.diff(self.out_indptr) + np.diff(self.in_indptr))

    def slice_rows(self, lo: int, hi: int) -> "FrozenRLCIndex":
        """Zero-copy shard slice owning vertex rows ``[lo, hi)``.

        The result keeps global vertex ids (``num_vertices``/``aid`` are
        shared, not re-numbered): rows inside the range are numpy *views* of
        this index's entry arrays (rows are contiguous because vertices
        are), rows outside are empty. Queries with both endpoints in range
        behave exactly like on the full index; a query whose ``s`` is
        outside the range sees an empty out-row — that is the two-sided
        routing contract: the caller must ship s's out-row digest in via
        :func:`merge_join_rows` (or the device-side equivalent) instead.
        """
        if not (0 <= lo <= hi <= self.num_vertices):
            raise ValueError(
                f"slice [{lo}, {hi}) out of range "
                f"[0, {self.num_vertices}]")

        def cut(indptr, hub, mr):
            base0, base1 = int(indptr[lo]), int(indptr[hi])
            new = np.clip(indptr, base0, base1) - base0
            return new, hub[base0:base1], mr[base0:base1]

        oi, oh, om = cut(self.out_indptr, self.out_hub, self.out_mr)
        ii, ih, im = cut(self.in_indptr, self.in_hub, self.in_mr)
        return FrozenRLCIndex(self.num_vertices, self.k, self.aid,
                              oi, oh, om, ii, ih, im)
