"""Shared wave machinery for the batched (numpy / cuda) build backends.

Algorithm 2 is restated level-synchronously: one (hub, direction) phase
advances a *batch* of label contexts per wave:

* **kernel-search rows** are label sequences, identified by their
  base-``|L|`` digit string: depth-``d`` row ``seq`` holds the vertices
  reachable from the hub by spelling ``seq``;
* **kernel-BFS rows** are product-automaton coordinates ``(kernel, p)``,
  all of a hub's eager kernels advancing in lockstep.

Frontiers travel as **index pairs** ``(row, vertex)`` so every per-wave
operation is proportional to the edges actually traversed; the dense
side — visited/attempted bitsets and the per-MR PR1 coverage rows from
:meth:`RLCIndex.pr1_cover_all` — exists only for O(1) membership
gathers. A wave therefore costs one neighbor gather over the
label-partitioned CSR, one sort-dedup, and a handful of mask gathers,
regardless of how many kernels ride in the batch.

Why this is bit-identical to the sequential reference (and why batching
stops at the hub boundary): within one (hub, direction) phase, every
PR1 outcome is a function of the *pre-phase* index snapshot only — an
insertion made during the phase can change ``Query(y, v, L)`` solely by
creating that exact ``(v, L)`` entry at ``y``, i.e. the duplicate-attempt
case, which the visited/attempted bitsets detect exactly like the
reference's ``seen`` sets (within one depth the duplicate cannot even
occur: two same-length sequences never share a minimum repeat, since
``L^h`` is unique for fixed length and ``L``). PR2 is a static access-id
comparison. Across hubs the dependence is real — hub ``v``'s PR1 reads
entries completed by every earlier hub — so hubs are scheduled
sequentially in access order, the same reason
``dense.build_condensed_device`` only matches the paper schedule at
``hub_batch=1``. Equivalence of entries *and* pruning counters is
enforced by ``tests/test_build_backends.py``.

Low-degree hubs would waste the fixed per-wave cost, so a two-hop work
estimate dispatches them to the scalar reference stages instead (same
inserter, same index — identical by construction). ``mode`` forces
``"vector"`` / ``"scalar"`` for testing.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.graph import LabeledGraph
from repro_torch.core.minimum_repeat import LabelSeq, minimum_repeat, mr_id_space
from repro_torch.core.rlc_index import RLCIndex

from .base import (BuildBackend, BuildStats, PrunedInserter, access_schedule,
                   vertex_mask)
from .reference import (_MemoMR, _NeighborLists, kernel_bfs_scalar,
                        kernel_search_scalar)

# Attach the packed PR1 mirror only while it stays below this footprint;
# beyond it every hub takes the scalar path (correct, just not batched).
MIRROR_BUDGET_BYTES = 256 * 1024 * 1024

#: two-hop work estimate below which a hub-direction runs the scalar
#: stages (tuned on the bench stand-ins; see README).
SCALAR_THRESHOLD = 12

#: two-hop work estimate above which the engine's array waves replace the
#: packed-word waves (array overhead amortizes only on wide frontiers).
GATHER_THRESHOLD = 2000


class FrontierEngine:
    """Expansion strategy for one wave (the only backend-specific part).

    Both hooks take a frontier as parallel ``(rows, ys)`` index arrays
    and return the raw expanded pairs (possibly with duplicates — the
    caller dedups against its visited sets). ``expand`` advances pair
    ``j`` along ``rowlab[rows[j]]`` into row ``dstrow[rows[j]]``;
    ``expand_fanout`` advances along *every* label, landing label ``l``
    of row ``r`` in row ``r * num_labels + l``.
    """

    def expand(self, rows: np.ndarray, ys: np.ndarray, rowlab: np.ndarray,
               dstrow: np.ndarray, backward: bool
               ) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def expand_fanout(self, rows: np.ndarray, ys: np.ndarray,
                      backward: bool) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError


def _two_hop_estimate(indptr: np.ndarray, nbrs: np.ndarray,
                      deg: np.ndarray) -> np.ndarray:
    """``deg(v) + sum_{u in N(v)} deg(u)`` — a depth-2 breadth proxy for
    the kernel-search state count (the hybrid dispatch signal)."""
    if not deg.size:
        return deg.astype(np.int64)
    keys = np.repeat(np.arange(deg.size), np.diff(indptr))
    two = np.bincount(keys, weights=deg[nbrs].astype(np.float64),
                      minlength=deg.size)
    return deg.astype(np.int64) + two.astype(np.int64)


class _PhaseContext:
    """State for the vectorized (hub, direction) phases, allocated once
    per build: MR/row tables, the reusable attempted/coverage buffers,
    and the stats plumbing shared with the scalar path."""

    def __init__(self, graph: LabeledGraph, k: int, index: RLCIndex,
                 stats: BuildStats, engine: FrontierEngine,
                 mr_ids: Dict[LabelSeq, int],
                 use_pr1: bool, use_pr2: bool, use_pr3: bool):
        self.g = graph
        self.k = k
        self.index = index
        self.stats = stats
        self.engine = engine
        self.use_pr1, self.use_pr2, self.use_pr3 = use_pr1, use_pr2, use_pr3
        self.V = graph.num_vertices
        self.nl = graph.num_labels
        self.aid = np.asarray(index.aid)
        self.mrs_by_c: List[LabelSeq] = [
            mr for mr, _ in sorted(mr_ids.items(), key=lambda kv: kv[1])]
        C = self.C = len(self.mrs_by_c)
        # row-id (base-|L| digit string) -> mr id, or -1 when |MR| > k
        self._rowid_c: Dict[Tuple[int, int, bool], int] = {}
        # reusable per-phase buffers (rows cleared after each phase)
        self._att = np.zeros((C, self.V), dtype=bool)
        self._cov = np.empty((C, self.V), dtype=bool)
        self._cov_has = np.zeros(C, dtype=bool)
        # static kernel-BFS row layout over ALL kernels, per direction:
        # rows [base_c, base_c + m_c) hold kernel c's phases 0..m_c-1;
        # inactive kernels simply never receive frontier pairs.
        self._layout = {bw: self._make_layout(bw) for bw in (False, True)}
        # packed-word adjacency for the bits tier (built on first use)
        self._adjb: Dict[bool, Tuple[list, list]] = {}
        self._pr2_cache: Tuple[int, int] = (-1, 0)
        self._want_cache: Dict[Tuple[int, bool], list] = {}

    def _make_layout(self, backward: bool) -> Tuple[np.ndarray, ...]:
        rowlab, dstrow, c_of_row, is_p0, p0_of_c = [], [], [], [], []
        base = 0
        for c, L in enumerate(self.mrs_by_c):
            m = len(L)
            for p in range(m):
                rowlab.append(L[m - 1 - p] if backward else L[p])
                dstrow.append(base + (p + 1) % m)
                c_of_row.append(c)
                is_p0.append(p == 0)
            p0_of_c.append(base)
            base += m
        return (np.asarray(rowlab, dtype=np.int64),
                np.asarray(dstrow, dtype=np.int64),
                np.asarray(c_of_row, dtype=np.int64),
                np.asarray(is_p0, dtype=bool),
                np.asarray(p0_of_c, dtype=np.int64),
                base)

    # ------------------------------------------------------------------ #
    def _c_of_rowid1(self, r: int, depth: int, backward: bool) -> int:
        """MR id for one kernel-search row id (−1 when not an entry). A
        row id's base-|L| digits spell the sequence (reversed when
        backward, which prepends labels)."""
        key = (r, depth, backward)
        c = self._rowid_c.get(key)
        if c is None:
            digits = []
            rr = r
            for _ in range(depth):
                digits.append(rr % self.nl)
                rr //= self.nl
            seq = tuple(digits) if backward else tuple(digits[::-1])
            mr = minimum_repeat(seq)
            c = self.index._mr_ids[mr] if len(mr) <= self.k else -1
            self._rowid_c[key] = c
        return c

    def _c_of_rowids(self, rowids: np.ndarray, depth: int, backward: bool
                     ) -> np.ndarray:
        return np.array([self._c_of_rowid1(r, depth, backward)
                         for r in rowids.tolist()], dtype=np.int64)

    def _cov_rows(self, cs: np.ndarray, packed: Optional[np.ndarray]
                  ) -> None:
        """Ensure unpacked PR1 coverage rows exist for MR ids ``cs``."""
        for c in cs[~self._cov_has[cs]].tolist():
            self._cov[c] = np.unpackbits(packed[c], count=self.V,
                                         bitorder="little").astype(bool)
            self._cov_has[c] = True

    # ------------------------------------------------------------------ #
    def run_phase(self, v: int, backward: bool, probe=None) -> None:
        pr2pass = (self.aid >= self.aid[v]) if self.use_pr2 else None
        cov_packed = (self.index.pr1_cover_all(v, backward)
                      if self.use_pr1 else None)
        touched: List[np.ndarray] = []
        seeds_c: List[np.ndarray] = []
        seeds_y: List[np.ndarray] = []
        self._kernel_search(v, backward, pr2pass, cov_packed, touched,
                            seeds_c, seeds_y, probe)
        if seeds_c:
            self._kernel_bfs(v, backward, pr2pass, cov_packed, touched,
                             np.concatenate(seeds_c),
                             np.concatenate(seeds_y), probe)
        # reset the reusable buffers (only rows this phase touched)
        if touched:
            cs = np.unique(np.concatenate(touched))
            self._att[cs] = False
            self._cov_has[cs] = False

    # -- stage 2: vectorized kernel-search ------------------------------- #
    def _kernel_search(self, v: int, backward: bool,
                       pr2pass: Optional[np.ndarray],
                       cov_packed: Optional[np.ndarray],
                       touched: List[np.ndarray],
                       seeds_c: List[np.ndarray],
                       seeds_y: List[np.ndarray], probe=None) -> None:
        nl, V, st = self.nl, self.V, self.stats
        nb, lb = self.g.in_edges(v) if backward else self.g.out_edges(v)
        rows = lb.astype(np.int64)          # depth-1 row id == label
        ys = nb.astype(np.int64)            # edges are unique: no dedup
        if probe is not None:
            probe.visited |= 1 << v
            probe.near |= 1 << v
        for depth in range(1, self.k + 1):
            if depth > 1:
                raw_r, raw_y = self.engine.expand_fanout(rows, ys, backward)
                if not raw_r.size:
                    return
                pairs = np.unique(raw_r * V + raw_y)
                rows, ys = pairs // V, pairs % V
            if probe is not None:
                m = vertex_mask(ys, V)
                probe.visited |= m
                if depth < self.k:
                    probe.near |= m
            st.kernel_search_states += len(rows)
            urows, inv = np.unique(rows, return_inverse=True)
            cs = self._c_of_rowids(urows, depth, backward)[inv]
            keep = cs >= 0
            if keep.any():
                self._attempts_ks(v, backward, cs[keep], ys[keep],
                                  pr2pass, cov_packed, touched,
                                  seeds_c, seeds_y)

    def _attempts_ks(self, v: int, backward: bool, cs: np.ndarray,
                     yy: np.ndarray, pr2pass: Optional[np.ndarray],
                     cov_packed: Optional[np.ndarray],
                     touched: List[np.ndarray],
                     seeds_c: List[np.ndarray],
                     seeds_y: List[np.ndarray]) -> None:
        """Stage-4 pruned insertion for one kernel-search wave.

        Within a depth every ``(mr, y)`` pair occurs at most once (same-
        length sequences never share an MR), so only the *cross-depth*
        repeat needs the attempted bitset: the reference resolves it as
        PR2 refiring, else PR1 firing on the now-present entry."""
        st = self.stats
        seeds_c.append(cs)
        seeds_y.append(yy)
        touched.append(cs)
        prev = self._att[cs, yy]
        self._att[cs, yy] = True
        if pr2pass is not None:
            ok2 = pr2pass[yy]
            st.pruned_pr2 += int((~ok2).sum())
        else:
            ok2 = np.ones(len(yy), dtype=bool)
        if cov_packed is not None:   # PR1 on
            self._cov_rows(np.unique(cs), cov_packed)
            newins = ok2 & ~self._cov[cs, yy] & ~prev
            st.pruned_pr1 += int(ok2.sum() - newins.sum())
            st.inserted += int(newins.sum())
            self._apply(v, backward, cs[newins], yy[newins])
        else:                        # PR1 off: every PR2 pass (re-)inserts
            st.inserted += int(ok2.sum())
            self._apply(v, backward, cs[ok2], yy[ok2])

    # -- stage 3: vectorized kernel-BFS ----------------------------------- #
    def _kernel_bfs(self, v: int, backward: bool,
                    pr2pass: Optional[np.ndarray],
                    cov_packed: Optional[np.ndarray],
                    touched: List[np.ndarray],
                    seed_c: np.ndarray, seed_y: np.ndarray,
                    probe=None) -> None:
        V, st = self.V, self.stats
        rowlab, dstrow, c_of_row, is_p0, p0_of_c, R = self._layout[backward]
        pairs = np.unique(seed_c * V + seed_y)   # cross-depth seeds collapse
        seed_c, seed_y = pairs // V, pairs % V
        VIS = np.zeros((R, V), dtype=bool)
        fr = p0_of_c[seed_c]
        fy = seed_y
        VIS[fr, fy] = True
        use_pr3 = self.use_pr3
        while fr.size:
            if probe is not None:
                labs = rowlab[fr]
                for lv in np.unique(labs).tolist():
                    probe.lab[lv] |= vertex_mask(fy[labs == lv], V)
            raw_r, raw_y = self.engine.expand(fr, fy, rowlab, dstrow,
                                              backward)
            if not raw_r.size:
                return
            pairs = np.unique(raw_r * V + raw_y)
            nr, ny = pairs // V, pairs % V
            new = ~VIS[nr, ny]
            nr, ny = nr[new], ny[new]
            if not nr.size:
                return
            if probe is not None:
                probe.visited |= vertex_mask(ny, V)
            st.kernel_bfs_states += len(nr)
            VIS[nr, ny] = True
            p0 = is_p0[nr]
            if p0.any():
                yy = ny[p0]
                cs = c_of_row[nr[p0]]
                if pr2pass is not None:
                    ok = pr2pass[yy]
                    st.pruned_pr2 += int((~ok).sum())
                else:
                    ok = np.ones(len(yy), dtype=bool)
                if cov_packed is not None:
                    self._cov_rows(np.unique(cs), cov_packed)
                    cov = self._cov[cs, yy] & ok
                    st.pruned_pr1 += int(cov.sum())
                    ok &= ~cov
                st.inserted += int(ok.sum())
                self._apply(v, backward, cs[ok], yy[ok])
                if use_pr3 and not ok.all():
                    st.pr3_cuts += int(len(ok) - ok.sum())
                    keep = np.ones(len(nr), dtype=bool)
                    keep[np.nonzero(p0)[0][~ok]] = False
                    nr, ny = nr[keep], ny[keep]
            fr, fy = nr, ny

    # ================= packed-word (bits) tier ========================== #
    # The same staged semantics with frontiers as arbitrary-width machine
    # words (python ints over the V-bit vertex space): zero per-op
    # dispatch overhead, which wins for the many small-to-mid phases
    # where array calls cannot amortize. One OR per (state, label) is the
    # whole expansion step.
    def _adj_bits(self, backward: bool) -> Tuple[list, list]:
        """``(by_label, by_vertex)`` packed-word adjacency views of the
        label-partitioned CSR: ``by_label[l][y]`` is the neighbor bitset
        of ``y`` via ``l``; ``by_vertex[y]`` lists its nonzero
        ``(l, bits)`` pairs (the fanout layout). Built edge-
        proportionally (one shifted-bit OR per edge)."""
        got = self._adjb.get(backward)
        if got is not None:
            return got
        V, nl = self.V, self.nl
        lptr, lnbr = self.g.label_csr(backward)
        bounds = lptr.tolist()
        nbr_list = lnbr.tolist()
        by_label = [[0] * V for _ in range(nl)]
        by_vertex: list = [()] * V
        nz = np.nonzero(np.diff(lptr))[0]
        for key in nz.tolist():
            y, l = divmod(key, nl)
            bits = 0
            for n in nbr_list[bounds[key]:bounds[key + 1]]:
                bits |= 1 << n
            by_label[l][y] = bits
        for y in range(V):
            row = tuple((l, by_label[l][y]) for l in range(nl)
                        if by_label[l][y])
            if row:
                by_vertex[y] = row
        got = self._adjb[backward] = (by_label, by_vertex)
        return got

    def _pr2_bits(self, v: int) -> int:
        """``{y : aid(y) >= aid(v)}`` as a packed word (cached per hub —
        both directions share it)."""
        if self._pr2_cache[0] != v:
            packed = np.packbits(self.aid >= self.aid[v],
                                 bitorder="little")
            self._pr2_cache = (v, int.from_bytes(packed.tobytes(),
                                                 "little"))
        return self._pr2_cache[1]

    def run_phase_bits(self, v: int, backward: bool, probe=None) -> None:
        by_label, by_vertex = self._adj_bits(backward)
        pr2 = self._pr2_bits(v) if self.use_pr2 else None
        mirror = self.index._mirror
        side = mirror.out if backward else mirror.in_
        cov_cache: Dict[int, int] = {}
        cmap: Dict[int, list] = {}
        if self.use_pr1:
            row = (self.index.l_in[v] if backward else self.index.l_out[v])
            mr_ids = self.index._mr_ids
            for x, mrs in row.items():
                for mr in mrs:
                    cmap.setdefault(mr_ids[mr], []).append(x)

        def covget(c: int) -> int:
            acc = cov_cache.get(c)
            if acc is None:
                acc = int.from_bytes(side[v, c].tobytes(), "little")
                for x in cmap.get(c, ()):
                    acc |= (int.from_bytes(side[x, c].tobytes(), "little")
                            | (1 << x))
                cov_cache[c] = acc
            return acc

        att = self._ks_bits(v, backward, pr2, covget, by_vertex, probe)
        for c, seeds in att.items():
            self._kbfs_bits(v, backward, pr2, covget, by_label, c, seeds,
                            probe)

    def _ks_bits(self, v: int, backward: bool, pr2: Optional[int], covget,
                 by_vertex: list, probe=None) -> Dict[int, int]:
        """Bits-tier kernel-search; returns the eager kernel seeds
        (``{mr id: attempted bitset}`` — exactly the reference's
        ``kernels`` map)."""
        st, nl = self.stats, self.nl
        att: Dict[int, int] = {}
        if probe is not None:
            probe.visited |= 1 << v
            probe.near |= 1 << v
        # depth-1 rows are single labels: v's own adjacency fans out
        cur: Dict[int, int] = {l: b for l, b in by_vertex[v]}
        for depth in range(1, self.k + 1):
            if depth > 1:
                nxt: Dict[int, int] = {}
                nxt_get = nxt.get
                for r, bits in cur.items():
                    base = r * nl
                    loc: Dict[int, int] = {}
                    loc_get = loc.get
                    f = bits
                    while f:
                        b = f & -f
                        f ^= b
                        for l, ab in by_vertex[b.bit_length() - 1]:
                            loc[l] = loc_get(l, 0) | ab
                    for l, bb in loc.items():
                        key = base + l
                        nxt[key] = nxt_get(key, 0) | bb
                cur = nxt
                if not cur:
                    break
            use_pr1 = self.use_pr1
            add = (self.index.add_out_many if backward
                   else self.index.add_in_many)
            for r, bits in cur.items():
                st.kernel_search_states += bits.bit_count()
                if probe is not None:
                    probe.visited |= bits
                    if depth < self.k:
                        probe.near |= bits
                c = self._c_of_rowid1(r, depth, backward)
                if c < 0:
                    continue
                prev = att.get(c, 0)
                att[c] = prev | bits
                # stage-4 pruned insertion, inlined (hot: once per row)
                if pr2 is not None:
                    p2 = bits & pr2
                    st.pruned_pr2 += bits.bit_count() - p2.bit_count()
                    if not p2:
                        continue
                else:
                    p2 = bits
                if use_pr1:
                    ok = p2 & ~covget(c)
                    if prev:
                        ok &= ~prev
                    st.pruned_pr1 += p2.bit_count() - ok.bit_count()
                else:
                    ok = p2
                if ok:
                    st.inserted += ok.bit_count()
                    ys, f = [], ok
                    while f:
                        b = f & -f
                        ys.append(b.bit_length() - 1)
                        f ^= b
                    add(ys, v, self.mrs_by_c[c])
        return att

    def _kbfs_bits(self, v: int, backward: bool, pr2: Optional[int],
                   covget, by_label: list, c: int, seeds: int,
                   probe=None) -> None:
        """Bits-tier kernel-BFS for one kernel ``c`` from its seed set.

        The stage-4 logic is inlined into the wave loop (this runs once
        per (hub, direction, kernel) — the hottest python scope in the
        build). ``m == 1`` skips the phase bookkeeping entirely.
        """
        st = self.stats
        key = (c, backward)
        cached = self._want_cache.get(key)
        if cached is None:
            L = self.mrs_by_c[c]
            m = len(L)
            lbls = [L[m - 1 - p] if backward else L[p] for p in range(m)]
            cached = self._want_cache[key] = (
                [by_label[lv] for lv in lbls], lbls)
        want, lbls = cached
        m = len(want)
        if m == 1:
            adjl = want[0]
            vis = fr = seeds
            while fr:
                if probe is not None:
                    probe.lab[lbls[0]] |= fr
                acc = 0
                while fr:
                    b = fr & -fr
                    acc |= adjl[b.bit_length() - 1]
                    fr ^= b
                new = acc & ~vis
                if not new:
                    return
                st.kernel_bfs_states += new.bit_count()
                if probe is not None:
                    probe.visited |= new
                vis |= new
                fr = self._p0_bits(new, c, v, backward, pr2, covget)
            return
        vis = [0] * m
        vis[0] = seeds
        fr = [0] * m
        fr[0] = seeds
        while True:
            nxt = [0] * m
            for p in range(m):
                f = fr[p]
                if not f:
                    continue
                if probe is not None:
                    probe.lab[lbls[p]] |= f
                adjl = want[p]
                acc = 0
                while f:
                    b = f & -f
                    acc |= adjl[b.bit_length() - 1]
                    f ^= b
                if acc:
                    nxt[(p + 1) % m] |= acc
            alive = False
            for p in range(m):
                new = nxt[p] & ~vis[p]
                if not new:
                    fr[p] = 0
                    continue
                st.kernel_bfs_states += new.bit_count()
                if probe is not None:
                    probe.visited |= new
                vis[p] |= new
                if p == 0:
                    new = self._p0_bits(new, c, v, backward, pr2, covget)
                fr[p] = new
                if new:
                    alive = True
            if not alive:
                return

    def _p0_bits(self, new: int, c: int, v: int, backward: bool,
                 pr2: Optional[int], covget) -> int:
        """Phase-0 boundary crossing: pruned insertion + the PR3 cut.
        Returns the bits the BFS may keep expanding."""
        st = self.stats
        if pr2 is not None:
            p2 = new & pr2
            st.pruned_pr2 += new.bit_count() - p2.bit_count()
        else:
            p2 = new
        if self.use_pr1 and p2:
            ok = p2 & ~covget(c)
            st.pruned_pr1 += p2.bit_count() - ok.bit_count()
        else:
            ok = p2
        if ok:
            st.inserted += ok.bit_count()
            ys, f = [], ok
            while f:
                b = f & -f
                ys.append(b.bit_length() - 1)
                f ^= b
            if backward:
                self.index.add_out_many(ys, v, self.mrs_by_c[c])
            else:
                self.index.add_in_many(ys, v, self.mrs_by_c[c])
        if self.use_pr3:
            if ok != new:
                st.pr3_cuts += new.bit_count() - ok.bit_count()
            return ok
        return new

    # -- stage 4 application ---------------------------------------------- #
    def _apply(self, v: int, backward: bool, cs: np.ndarray, ys: np.ndarray
               ) -> None:
        """Record the surviving entries (grouped per MR for one bulk dict +
        mirror update each)."""
        if not cs.size:
            return
        add = self.index.add_out_many if backward else self.index.add_in_many
        if cs[0] == cs[-1] and (cs == cs[0]).all():   # common: one MR
            add(ys.tolist(), v, self.mrs_by_c[int(cs[0])])
            return
        order = np.argsort(cs, kind="stable")
        cs, ys = cs[order], ys[order]
        splits = np.nonzero(np.diff(cs))[0] + 1
        for chunk_c, chunk_y in zip(np.split(cs, splits),
                                    np.split(ys, splits)):
            add(chunk_y.tolist(), v, self.mrs_by_c[int(chunk_c[0])])


class PhaseRunner:
    """One build's per-phase dispatch state: the hybrid tier selection,
    the shared :class:`_PhaseContext`, and the scalar fallback.

    Factored out of :meth:`BatchedBackend._build` so the delta engine
    (:mod:`repro_torch.build.delta`) can drive phases in its own schedule —
    replaying most of them from a trace and running only the dirty ones —
    while executing *exactly* the code path a full build would have used
    (that shared path is what makes delta results bit-identical).
    ``run`` accepts an optional :class:`repro_torch.build.base.PhaseProbe` that
    records the phase's traversal footprint.
    """

    def __init__(self, backend: "BatchedBackend", graph: LabeledGraph,
                 k: int, index: RLCIndex, stats: BuildStats, mirror=None):
        self.backend = backend
        self.g = graph
        self.k = int(k)
        self.index = index
        self.stats = stats
        self.inserter = PrunedInserter(index, stats, backend.use_pr1,
                                       backend.use_pr2)
        V, nl = graph.num_vertices, graph.num_labels
        words = (V + 7) // 8
        C = len(mr_id_space(nl, k)) if nl else 0
        self.can_batch = (backend.mode != "scalar" and V > 0 and nl > 0
                          and 2 * C * V * words <= backend.mirror_budget)
        self._nbrs = None      # scalar-tier accessor, built on first dispatch
        self._mr_fn = _MemoMR()
        self.out_deg, self.in_deg = graph.out_degree(), graph.in_degree()
        #: True when a caller-provided mirror was adopted instead of a
        #: fresh (empty) one — the delta engine hands back the previous
        #: build's mirror, whose rows double as the old phase outputs.
        self.adopted_mirror = False
        if self.can_batch:
            mr_ids = mr_id_space(nl, k)
            if mirror is not None:
                index._mirror = mirror
                index._mr_ids = dict(mr_ids)
                self.adopted_mirror = True
            else:
                index.attach_bit_mirror(mr_ids)
            stats.peak_mirror_bytes = max(stats.peak_mirror_bytes,
                                          index._mirror.size_bytes())
            self.ctx = _PhaseContext(graph, k, index, stats,
                                     backend._make_engine(graph), mr_ids,
                                     backend.use_pr1, backend.use_pr2,
                                     backend.use_pr3)
            self._est = {
                True: _two_hop_estimate(graph.bwd[0], graph.bwd[1],
                                        self.in_deg),
                False: _two_hop_estimate(graph.fwd[0], graph.fwd[1],
                                         self.out_deg)}

    def run(self, v: int, backward: bool, probe=None) -> None:
        """Run one ``(hub, direction)`` phase (no-op on a degree-0 hub,
        exactly like the full build's skip). With a
        :class:`repro_torch.obs.BuildPhaseObserver` on the backend, the phase's
        wall time and counter deltas are reported (the degree-0 skip is
        never timed — it would drown the histograms in zeros)."""
        if not (self.in_deg[v] if backward else self.out_deg[v]):
            return
        obs = self.backend.observer
        if obs is None:
            self._run_phase(v, backward, probe)
            return
        before = self.stats.counters()
        t0 = time.perf_counter()
        self._run_phase(v, backward, probe)
        obs.phase(v, backward, time.perf_counter() - t0,
                  counter_delta=tuple(
                      a - b for a, b in zip(self.stats.counters(), before)))

    def _run_phase(self, v: int, backward: bool, probe=None) -> None:
        backend = self.backend
        if self.can_batch:
            est = self._est[backward][v]
            if backend.mode == "vector":
                self.ctx.run_phase(v, backward, probe)
                return
            if backend.mode == "bits" or (
                    backend.mode == "hybrid"
                    and backend.scalar_threshold <= est
                    < backend.gather_threshold):
                self.ctx.run_phase_bits(v, backward, probe)
                return
            if (backend.mode == "hybrid"
                    and est >= backend.gather_threshold):
                self.ctx.run_phase(v, backward, probe)
                return
        if self._nbrs is None:
            self._nbrs = _NeighborLists(self.g)
        kernels = kernel_search_scalar(
            self._nbrs, self.inserter, self.stats, self._mr_fn, v, self.k,
            backward, probe)
        for L, seeds in kernels.items():
            kernel_bfs_scalar(self._nbrs, self.inserter, self.stats,
                              backend.use_pr3, v, L, seeds, backward, probe)

    def finish(self) -> RLCIndex:
        """Detach the construction-time scratch (the coverage mirror is up
        to ``mirror_budget`` bytes — never serve it)."""
        if self.index._mirror is not None:
            self.stats.peak_mirror_bytes = max(
                self.stats.peak_mirror_bytes,
                self.index._mirror.size_bytes())
        self.index._mirror = None
        self.index._mr_ids = None
        return self.index


class BatchedBackend(BuildBackend):
    """Template for wave-batched backends; subclasses provide the engine."""

    def __init__(self, use_pr1: bool = True, use_pr2: bool = True,
                 use_pr3: bool = True, mode: str = "hybrid",
                 scalar_threshold: Optional[int] = None,
                 gather_threshold: Optional[int] = None,
                 mirror_budget: int = MIRROR_BUDGET_BYTES):
        super().__init__(use_pr1, use_pr2, use_pr3)
        if mode not in ("hybrid", "vector", "bits", "scalar"):
            raise ValueError(
                f"mode {mode!r} not in hybrid|vector|bits|scalar")
        self.mode = mode
        self.scalar_threshold = (SCALAR_THRESHOLD if scalar_threshold is None
                                 else scalar_threshold)
        self.gather_threshold = (GATHER_THRESHOLD if gather_threshold is None
                                 else gather_threshold)
        self.mirror_budget = mirror_budget

    # -- subclass hook ---------------------------------------------------- #
    def _make_engine(self, graph: LabeledGraph) -> FrontierEngine:
        raise NotImplementedError

    # --------------------------------------------------------------------- #
    def _build(self, graph: LabeledGraph, k: int, stats: BuildStats
               ) -> RLCIndex:
        order, aid = access_schedule(graph)
        index = RLCIndex(graph.num_vertices, k, aid)
        runner = PhaseRunner(self, graph, k, index, stats)
        for v in order:
            v = int(v)
            for backward in (True, False):
                runner.run(v, backward)
        return runner.finish()
