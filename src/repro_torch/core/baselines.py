"""Baseline evaluators (paper §VI-a): NFA-guided BFS, BiBFS, and ETC.

The RLC constraint ``L^+`` compiles to a cyclic automaton over positions
``{0..m-1}``; an online query is a BFS over the product space
``V x positions``. These evaluators double as the *oracle* in tests —
they are exact under arbitrary-path semantics because the product space is
finite. A small NFA class additionally supports concatenations of plus-
blocks such as the paper's extended query Q4 = ``a+ ∘ b+``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Sequence, Set, Tuple


from .graph import LabeledGraph
from .minimum_repeat import LabelSeq, minimum_repeat


# --------------------------------------------------------------------- #
# L^+ product-automaton traversals (the paper's BFS / BiBFS baselines)
# --------------------------------------------------------------------- #
def bfs_rlc(g: LabeledGraph, s: int, t: int, L: Sequence[int]) -> bool:
    """Forward BFS over ``V x {0..m-1}``; true iff s ~~L+~~> t."""
    L = tuple(L)
    m = len(L)
    seen = {(s, 0)}
    q = deque([(s, 0)])
    while q:
        x, p = q.popleft()
        for y in g.out_neighbors_with_label(x, L[p]).tolist():
            p2 = (p + 1) % m
            if p2 == 0 and y == t:
                return True
            if (y, p2) not in seen:
                seen.add((y, p2))
                q.append((y, p2))
    return False


def bibfs_rlc(g: LabeledGraph, s: int, t: int, L: Sequence[int]) -> bool:
    """Bidirectional BFS over the product automaton (expand smaller side).

    Forward state ``(v, p)``: consumed ``p (mod m)`` labels of ``L``-cycles
    from ``s``. Backward state ``(v, p)``: a path ``v -> t`` consumes labels
    ``L[p:]`` then whole cycles. Meeting at an identical state closes a path
    whose total consumption is a multiple of ``m``; the zero-length meet at
    ``s == t`` is discounted by seeding *after* one expansion step each.
    """
    L = tuple(L)
    m = len(L)
    # One-step-expanded seeds avoid the trivial s==t zero-length match.
    fwd: Set[Tuple[int, int]] = set()
    fq: deque = deque()
    for y in g.out_neighbors_with_label(s, L[0]).tolist():
        st = (y, 1 % m)
        if st not in fwd:
            if st == (t, 0):
                return True
            fwd.add(st)
            fq.append(st)
    bwd: Set[Tuple[int, int]] = set()
    bq: deque = deque()
    for x in g.in_neighbors_with_label(t, L[m - 1]).tolist():
        st = (x, m - 1)
        if st not in bwd:
            bwd.add(st)
            bq.append(st)
    if fwd & bwd or (s, 0) in bwd:
        return True
    while fq and bq:
        if len(fq) <= len(bq):
            for _ in range(len(fq)):
                x, p = fq.popleft()
                for y in g.out_neighbors_with_label(x, L[p]).tolist():
                    st = (y, (p + 1) % m)
                    if st in bwd or st == (t, 0):
                        return True
                    if st not in fwd:
                        fwd.add(st)
                        fq.append(st)
        else:
            for _ in range(len(bq)):
                y, p = bq.popleft()
                pprev = (p - 1) % m
                for x in g.in_neighbors_with_label(y, L[pprev]).tolist():
                    st = (x, pprev)
                    if st in fwd or st == (s, 0):
                        return True
                    if st not in bwd:
                        bwd.add(st)
                        bq.append(st)
    return False


# --------------------------------------------------------------------- #
# Generic small NFA (for extended queries, e.g. Q4 = a+ ∘ b+)
# --------------------------------------------------------------------- #
@dataclass
class NFA:
    """Label-transition NFA; ``delta[state][label] -> set of states``."""

    num_states: int
    delta: List[Dict[int, Set[int]]]
    start: FrozenSet[int]
    accept: FrozenSet[int]

    @staticmethod
    def from_plus_blocks(blocks: Sequence[Sequence[int]]) -> "NFA":
        """NFA for ``(B1)^+ ∘ (B2)^+ ∘ ...`` where each block is a label
        concatenation. State = (block, position); each block must complete
        at least one full repeat before moving to the next block."""
        delta: List[Dict[int, Set[int]]] = []
        offsets = []
        for b in blocks:
            offsets.append(len(delta))
            for _ in b:
                delta.append({})
        # boundary states: entering block i at position 0
        n = len(delta)
        accept_state = n
        delta.append({})  # explicit accept sink (no out-transitions needed)
        for bi, b in enumerate(blocks):
            off = offsets[bi]
            m = len(b)
            for p, lab in enumerate(b):
                src = off + p
                dsts = delta[src].setdefault(lab, set())
                if p + 1 < m:
                    dsts.add(off + p + 1)
                else:
                    # completed a repeat of block bi: loop, advance, or accept
                    dsts.add(off)  # another repeat
                    if bi + 1 < len(blocks):
                        dsts.add(offsets[bi + 1])  # start next block
                    if bi == len(blocks) - 1:
                        dsts.add(accept_state)
        return NFA(num_states=n + 1, delta=delta,
                   start=frozenset({offsets[0]}),
                   accept=frozenset({accept_state}))

    def step(self, states: Set[int], label: int) -> Set[int]:
        out: Set[int] = set()
        for s in states:
            out |= self.delta[s].get(label, set())
        return out


def bfs_nfa(g: LabeledGraph, s: int, t: int, nfa: NFA) -> bool:
    """NFA-guided BFS (paper §III-B first naive approach, also used for
    extended queries). True iff an s->t path spells a word the NFA accepts."""
    seen: Set[Tuple[int, int]] = {(s, q) for q in nfa.start}
    dq = deque(seen)
    while dq:
        x, qs = dq.popleft()
        nbrs, labs = g.out_edges(x)
        for y, lab in zip(nbrs.tolist(), labs.tolist()):
            for q2 in nfa.delta[qs].get(lab, ()):  # type: ignore[arg-type]
                if q2 in nfa.accept and y == t:
                    return True
                if (y, q2) not in seen:
                    seen.add((y, q2))
                    dq.append((y, q2))
    return False


def rlc_index_plus_traversal(index, g: LabeledGraph, s: int, t: int,
                             blocks: Sequence[Sequence[int]]) -> bool:
    """Paper §VI-C Q4 technique: evaluate ``(B1)^+ ∘ (B2)^+ ∘ ...`` with the
    RLC index answering each ``B_i^+`` hop instead of a graph BFS.

    For a non-final block the next boundary frontier is seeded from the
    index itself: hubs ``x`` with ``(x, B_i) in L_out(u)`` are witnessed
    ``B_i^+``-reachable, and every vertex ``w`` whose ``L_in(w)`` row joins
    the frontier under ``B_i`` is added via Case-1/Case-2 checks. The final
    block is a single batch of index lookups against ``t``.
    """
    frontier: Set[int] = {s}
    for bi, b in enumerate(blocks):
        L = tuple(b)
        if bi == len(blocks) - 1:
            return any(index.query(u, t, L) for u in frontier)
        nxt: Set[int] = set()
        for u in frontier:
            # direct witnesses: hubs with (hub, L) in L_out(u)
            for hub, mrs in index.l_out[u].items():
                if L in mrs:
                    nxt.add(hub)
        for w in range(g.num_vertices):
            if w not in nxt and any(index.query(u, w, L) for u in frontier):
                nxt.add(w)
        frontier = nxt
        if not frontier:
            return False
    return False


# --------------------------------------------------------------------- #
# ETC — extended transitive closure (paper §VI-a baseline)
# --------------------------------------------------------------------- #
class ETC:
    """Extended transitive closure: hashmap ``(u, v) -> set of k-MRs``.

    Built by a forward KBS from every vertex with NO pruning rules —
    exactly the paper's ETC. Doubles as the ground-truth ``S^k``.
    """

    def __init__(self, g: LabeledGraph, k: int):
        self.g = g
        self.k = k
        self.table: Dict[Tuple[int, int], Set[LabelSeq]] = {}
        self._build()

    def _build(self) -> None:
        for v in range(self.g.num_vertices):
            self._forward_kbs(int(v))

    def _record(self, u: int, y: int, L: LabelSeq) -> None:
        self.table.setdefault((u, y), set()).add(L)

    def _forward_kbs(self, v: int) -> None:
        k = self.k
        seen: Set[Tuple[int, LabelSeq]] = {(v, ())}
        q: deque = deque([(v, ())])
        kernels: Dict[LabelSeq, Set[int]] = {}
        while q:
            x, seq = q.popleft()
            nbrs, labs = self.g.out_edges(x)
            for y, lab in zip(nbrs.tolist(), labs.tolist()):
                seq2 = seq + (lab,)
                if (y, seq2) in seen:
                    continue
                seen.add((y, seq2))
                L = minimum_repeat(seq2)
                if len(L) <= k:
                    self._record(v, y, L)
                    kernels.setdefault(L, set()).add(y)
                if len(seq2) < k:
                    q.append((y, seq2))
        for L, seeds in kernels.items():
            m = len(L)
            visited: Set[Tuple[int, int]] = {(x, 0) for x in seeds}
            dq: deque = deque(visited)
            while dq:
                x, p = dq.popleft()
                for y in self.g.out_neighbors_with_label(x, L[p]).tolist():
                    p2 = (p + 1) % m
                    if (y, p2) in visited:
                        continue
                    if p2 == 0:
                        self._record(v, y, L)
                    visited.add((y, p2))
                    dq.append((y, p2))

    # -- queries --------------------------------------------------------- #
    def s_k(self, u: int, v: int) -> Set[LabelSeq]:
        return self.table.get((u, v), set())

    def query(self, s: int, t: int, L: Sequence[int]) -> bool:
        return tuple(L) in self.table.get((s, t), ())

    def num_entries(self) -> int:
        return sum(len(v) for v in self.table.values())

    def size_bytes(self) -> int:
        # hashmap entry: 8B key + k bytes per recorded MR (paper-comparable)
        return len(self.table) * 8 + self.num_entries() * self.k
