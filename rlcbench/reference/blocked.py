"""Plain reference of the condensed build, MR by MR, for graphs whose
all-MR stacks do not fit the card at once (``epinions-k2``).

The same semantics as :mod:`rlcbench.reference.plain`, whose helpers it
uses (MRs, access order, keys), from the edge list alone: it imports
nothing of the program and takes nothing the program made. It differs in
three ways, none of which changes an answer:

* **One MR at a time.** The labeling of MR ``c`` reads and writes the
  entries of ``c`` alone: PR1's query ``(s, t, c)`` joins ``L_out(s)``
  and ``L_in(t)`` on entries of ``c``, and PR2 compares access ids, which
  no MR changes. So the MRs are labeled one after another, each over its
  own reach, which is dropped before the next one is made.
* **Only the vertices an MR's reach touches.** ``R_L+`` relates only
  vertices of an ``L`` step (a path's every vertex ends or starts one),
  so its closure and its labeling run on those vertices, ``T``. A hub
  outside ``T`` reaches and is reached by nothing, adds no entry and
  takes part in no join. ``T`` is numbered in access order, so the
  global hub batches (``hub_batch`` hubs at a time, in access order) are
  contiguous ranges of ``T``, and PR2's ``aid(h) <= aid(y)`` is ``h <=
  y`` there: the backward candidates of hub ``h`` are the lower triangle
  of ``R``'s column ``h``, the forward ones the upper triangle of its
  row ``h``.
* **Products in bf16.** Every term of an OR-AND product over 0/1 values
  is 0 or 1, so every partial sum is >= 0 and the sum is positive exactly
  when one term is. Rounding a non-negative sum to a narrower float never
  makes a positive sum 0 or a zero sum positive (the smallest positive
  sum is 1, far above the format's smallest normal number), so the test
  ``> 0`` gives the OR in any precision, whatever the order of the
  additions.

Keys are :func:`plain.entry_keys`' ``((side * C + c) * n + y) * n + x``.
``short_closure`` and ``case1=False`` break one guarantee each, for the
controls, as in :mod:`plain`.
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from rlcbench.reference import plain

Word = plain.Word
DTYPE = torch.bfloat16
_SHIFTS = torch.arange(8, dtype=torch.uint8)
_POPCOUNT = torch.tensor([bin(i).count("1") for i in range(256)],
                         dtype=torch.int64)


def adjacency(edges: np.ndarray, n: int, num_labels: int,
              device) -> torch.Tensor:
    """``A[l, s, d] = 1`` iff the edge ``(s, l, d)`` exists, in bf16."""
    e = torch.from_numpy(plain.unique_edges(edges)).to(device)
    A = torch.zeros((num_labels, n, n), dtype=DTYPE, device=device)
    A[e[:, 1], e[:, 0], e[:, 2]] = 1
    return A


def closure(M: torch.Tensor, short: bool = False) -> torch.Tensor:
    """``M+`` as bool, by squaring ``R <- R | R R`` until nothing changes
    (:func:`plain.closure`, with bf16 products)."""
    R = M > 0
    prev = R
    while True:
        Rh = R.to(DTYPE)
        nxt = R | (torch.matmul(Rh, Rh) > 0)
        if torch.equal(nxt, R):
            return prev if short else R
        prev, R = R, nxt


def access_rank(edges: np.ndarray, n: int) -> np.ndarray:
    """``rank[v]``: the position of vertex ``v`` in the access order."""
    rank = np.empty(n, np.int64)
    rank[plain.access_order(edges, n)] = np.arange(n)
    return rank


def touched(M: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """The vertices with a true cell in ``M``'s row or column, in access
    order."""
    T = torch.nonzero((M > 0).any(1) | (M > 0).any(0)).flatten()
    return T[torch.argsort(rank[T])]


def mr_reaches(edges: np.ndarray, n: int, num_labels: int, k: int, device,
               short_closure: bool = False
               ) -> Iterator[Tuple[Word, torch.Tensor, torch.Tensor]]:
    """For each MR in :func:`plain.minimum_repeats` order ``(word, T,
    R)``: ``T`` the int64 ids of the vertices an ``L`` step touches, in
    access order, and ``R`` the bool ``(|T|, |T|)`` reach of ``L+`` over
    them, ``R[i, j]`` for ``T[i]`` reaching ``T[j]``."""
    rank = torch.from_numpy(access_rank(edges, n)).to(device)
    A = adjacency(edges, n, num_labels, device)
    for word in plain.minimum_repeats(num_labels, k):
        M = A[word[0]]
        for lab in word[1:]:
            M = (torch.matmul(M, A[lab]) > 0).to(DTYPE)
        T = touched(M, rank)
        R = closure(M[T][:, T], short=short_closure)
        del M
        yield word, T, R


def full(T: torch.Tensor, R: torch.Tensor, n: int) -> torch.Tensor:
    """``R`` over ``T`` as the bool ``(n, n)`` reach of all vertices."""
    out = torch.zeros((n, n), dtype=torch.bool, device=R.device)
    out[T[:, None], T[None, :]] = R
    return out


def batch_bounds(rank: np.ndarray, T: torch.Tensor,
                 hub_batch: int) -> List[Tuple[int, int]]:
    """The global hub batches as ranges ``[s, e)`` of ``T`` (in access
    order), the empty ones left out."""
    n = len(rank)
    pos = rank[T.cpu().numpy()]
    cut = np.searchsorted(pos, np.arange(0, n + hub_batch, hub_batch))
    return [(int(s), int(e)) for s, e in zip(cut[:-1], cut[1:]) if e > s]


def label(R: torch.Tensor, bounds: List[Tuple[int, int]],
          case1: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The labeling of one MR over its vertices ``T`` (access order) as two
    bool ``(|T|, |T|)`` stacks, ``OUT[y, x]`` iff ``(x, L)`` is in
    ``L_out(y)``: :func:`plain.condensed` for one MR, hub batch ``[s, e)``
    at a time. ``case1=False`` leaves PR1's hub join out."""
    m = R.shape[0]
    back = torch.tril(R).to(DTYPE)    # [y, h]: y reaches h, aid(h) <= aid(y)
    fwd = torch.triu(R).to(DTYPE)     # [h, y]: h reaches y, aid(h) <= aid(y)
    OUT = torch.zeros((m, m), dtype=DTYPE, device=R.device)
    IN = torch.zeros((m, m), dtype=DTYPE, device=R.device)
    for s, e in bounds:
        # L_out: y reaches h, asked as Query(y, h, L)
        q = OUT[:, s:e] + IN[s:e].T
        if case1:
            q = q + OUT @ IN[s:e].T
        OUT[:, s:e] += back[:, s:e] * (q == 0)
        # L_in: h reaches y, asked as Query(h, y, L); sees the new L_out
        q = IN[:, s:e] + OUT[s:e].T
        if case1:
            q = q + IN @ OUT[s:e].T
        IN[:, s:e] += fwd[s:e].T * (q == 0)
    return OUT > 0, IN > 0


def keys(c: int, C: int, n: int, T: torch.Tensor, OUT: torch.Tensor,
         IN: torch.Tensor) -> np.ndarray:
    """The keys of one MR's entries (unsorted)."""
    parts = []
    for side, stack in enumerate((OUT, IN)):
        y, x = torch.nonzero(stack, as_tuple=True)
        parts.append((((side * C + c) * n + T[y]) * n + T[x]).cpu().numpy())
    return np.concatenate(parts)


def condensed_keys(reaches, edges: np.ndarray, n: int, C: int,
                   hub_batch: int, case1: bool = True,
                   visit: Optional[Callable] = None) -> np.ndarray:
    """Sorted keys of the labeling over ``reaches``, ``(word, T, R)`` per
    MR as :func:`mr_reaches` gives them; ``visit(c, word, T, R)`` sees
    each reach first."""
    rank, out = access_rank(edges, n), []
    for c, (word, T, R) in enumerate(reaches):
        if visit is not None:
            visit(c, word, T, R)
        OUT, IN = label(R, batch_bounds(rank, T, hub_batch), case1)
        out.append(keys(c, C, n, T, OUT, IN))
        del OUT, IN
    return np.sort(np.concatenate(out)) if out else np.zeros(0, np.int64)


def reach(edges: np.ndarray, n: int, num_labels: int, k: int, device,
          short_closure: bool = False) -> Tuple[List[Word], torch.Tensor]:
    """``(mrs, R)`` with ``R[c]`` the bool ``(n, n)`` reach of ``mrs[c]+``,
    made MR by MR into one stack."""
    mrs = plain.minimum_repeats(num_labels, k)
    R = torch.zeros((len(mrs), n, n), dtype=torch.bool, device=device)
    for c, (_, T, Rc) in enumerate(mr_reaches(edges, n, num_labels, k,
                                              device, short_closure)):
        R[c][T[:, None], T[None, :]] = Rc
    return mrs, R


def stack_reaches(R: torch.Tensor, mrs: List[Word], edges: np.ndarray,
                  n: int):
    """A full ``(C, n, n)`` reach stack as :func:`mr_reaches` gives it:
    each MR over the vertices its reach touches, in access order."""
    rank = torch.from_numpy(access_rank(edges, n)).to(R.device)
    for word, Rc in zip(mrs, R):
        T = touched(Rc, rank)
        yield tuple(word), T, Rc[T][:, T]


def pack_rows(B: torch.Tensor) -> torch.Tensor:
    """A bool ``(r, m)`` matrix as ``(r, ceil(m / 8))`` uint8, bit ``j`` of
    byte ``i`` being column ``8 i + j``."""
    r, m = B.shape
    x = torch.nn.functional.pad(B.to(torch.uint8), (0, -m % 8))
    return (x.view(r, -1, 8) << _SHIFTS.to(B.device)).sum(
        -1, dtype=torch.uint8)


def popcount(x: torch.Tensor) -> int:
    """Set bits of a uint8 tensor."""
    return int(_POPCOUNT.to(x.device)[x.long()].sum())
