"""Plain reference of the builds the benchmark times.

Straight PyTorch and NumPy from the edge list alone: it imports nothing
of the program and takes nothing the program made. It works out

* the minimum repeats (MRs) of length ``<= k`` over the labels: the label
  words that are no power of a shorter word (paper, section III-A);
* the label-sliced adjacency and, for each MR ``L``, the reach ``R_L``:
  ``u`` reaches ``v`` by a path whose labels spell ``L`` one or more
  times (``L+``); a chain of OR-AND products spells ``L`` once, and
  squaring ``R <- R | R R`` until nothing changes closes it;
* the access order: vertices by ``(out-degree + 1) * (in-degree + 1)``
  descending, ties by vertex id (paper, section V-B);
* the condensed labeling of the paper's Algorithm 2 with the hubs taken
  in access order, ``hub_batch`` at a time. For each batch, first every
  vertex ``y`` that reaches hub ``h`` by ``L+`` gets ``(h, L)`` in
  ``L_out(y)``, then every ``y`` that ``h`` reaches gets ``(h, L)`` in
  ``L_in(y)``, each only where ``aid(h) <= aid(y)`` (pruning rule PR2) and
  where the index built so far does not already answer the query
  (pruning rule PR1). Within a batch the backward additions see the
  entries of earlier batches only; the forward additions see those and
  the batch's backward ones. A batch of one is the paper's sequential
  schedule.

The query of the index (Algorithm 1): ``(s, t, L+)`` holds iff ``(t, L)``
is in ``L_out(s)``, or ``(s, L)`` in ``L_in(t)``, or some ``x`` has
``(x, L)`` in both ``L_out(s)`` and ``L_in(t)``.

Products run in float32 with TF32 off. They sum 0/1 values, so any
positive sum is a true OR. ``short_closure`` and ``case1`` exist for the
controls (``rlcbench/controls.py``): each breaks one guarantee.
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

Word = Tuple[int, ...]


def is_primitive(word: Word) -> bool:
    """True iff ``word`` is no power ``w ** z`` (z >= 2) of a shorter
    word, so that it is its own minimum repeat."""
    m = len(word)
    return m > 0 and not any(
        m % p == 0 and word == word[:p] * (m // p) for p in range(1, m))


def minimum_repeats(num_labels: int, k: int) -> List[Word]:
    """Every MR of length 1..k, by length, then in lexicographic order."""
    return [w for m in range(1, k + 1)
            for w in itertools.product(range(num_labels), repeat=m)
            if is_primitive(w)]


@contextlib.contextmanager
def exact_float32() -> Iterator[None]:
    """float32 products without TF32, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def unique_edges(edges: np.ndarray) -> np.ndarray:
    return np.unique(np.asarray(edges, np.int64).reshape(-1, 3), axis=0)


def adjacency(edges: np.ndarray, n: int, num_labels: int,
              device) -> torch.Tensor:
    """``A[l, s, d] = 1.0`` iff the edge ``(s, l, d)`` exists."""
    e = torch.from_numpy(unique_edges(edges)).to(device)
    A = torch.zeros((num_labels, n, n), dtype=torch.float32, device=device)
    A[e[:, 1], e[:, 0], e[:, 2]] = 1.0
    return A


def closure(M: torch.Tensor, short: bool = False) -> torch.Tensor:
    """``M+`` as bool: square ``R <- R | R R`` until nothing changes.
    With ``short``, stop one squaring before the last one that changed
    anything (the control: a closure cut one step short)."""
    R = M > 0
    prev = R
    while True:
        nxt = R | (torch.matmul(R.float(), R.float()) > 0)
        if torch.equal(nxt, R):
            return prev if short else R
        prev, R = R, nxt


def reach(edges: np.ndarray, n: int, num_labels: int, k: int, device,
          short_closure: bool = False) -> Tuple[List[Word], torch.Tensor]:
    """``(mrs, R)`` with ``R[c]`` the bool ``(n, n)`` reach of ``mrs[c]+``."""
    mrs = minimum_repeats(num_labels, k)
    with exact_float32():
        A = adjacency(edges, n, num_labels, device)
        R = torch.empty((len(mrs), n, n), dtype=torch.bool, device=device)
        for c, word in enumerate(mrs):
            M = A[word[0]]
            for lab in word[1:]:
                M = (torch.matmul(M, A[lab]) > 0).float()
            R[c] = closure(M, short=short_closure)
    return mrs, R


def access_order(edges: np.ndarray, n: int) -> np.ndarray:
    """``order[i]`` is the vertex with access id ``i + 1``."""
    e = unique_edges(edges)
    score = ((np.bincount(e[:, 0], minlength=n) + 1)
             * (np.bincount(e[:, 2], minlength=n) + 1))
    return np.lexsort((np.arange(n), -score))


def condensed(R: torch.Tensor, order: np.ndarray, hub_batch: int,
              case1: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The labeling as two bool ``(C, n, n)`` stacks: ``OUT[c, y, x]`` iff
    ``(x, mrs[c])`` is in ``L_out(y)``, ``IN[c, y, x]`` iff it is in
    ``L_in(y)``. ``case1=False`` leaves the hub join (Case 1) out of
    PR1's query: the control that skips the coverage product."""
    C, n, _ = R.shape
    dev = R.device
    order_t = torch.from_numpy(np.asarray(order, np.int64)).to(dev)
    aid = torch.empty(n, dtype=torch.int64, device=dev)
    aid[order_t] = torch.arange(1, n + 1, device=dev)
    Rf = R.float()
    OUT = torch.zeros((C, n, n), dtype=torch.float32, device=dev)
    IN = torch.zeros((C, n, n), dtype=torch.float32, device=dev)

    def answered(out_rows, in_rows, direct_out, direct_in):
        """Query over the index so far, for (C, n, B) pairs: the two
        direct cases, and the join of ``out_rows`` (C, n, n) with
        ``in_rows`` (C, B, n) on the hub."""
        hit = (direct_out > 0) | (direct_in > 0)
        if case1:
            hit |= torch.bmm(out_rows, in_rows.transpose(1, 2)) > 0
        return hit

    with exact_float32():
        for i in range(0, n, hub_batch):
            H = order_t[i:i + hub_batch]
            pr2 = (aid[H][None, :] <= aid[:, None]).float()[None]
            # L_out: y reaches h; asked as Query(y, h, L)
            q = answered(OUT, IN[:, H, :], OUT[:, :, H],
                         IN[:, H, :].transpose(1, 2))
            OUT[:, :, H] = torch.maximum(
                OUT[:, :, H], Rf[:, :, H] * pr2 * (~q).float())
            # L_in: h reaches y; asked as Query(h, y, L)
            q = answered(IN, OUT[:, H, :], IN[:, :, H],
                         OUT[:, H, :].transpose(1, 2))
            IN[:, :, H] = torch.maximum(
                IN[:, :, H], Rf[:, H, :].transpose(1, 2) * pr2
                * (~q).float())
    return OUT > 0, IN > 0


def entry_keys(OUT: torch.Tensor, IN: torch.Tensor) -> np.ndarray:
    """Sorted int64 keys of every entry, ``((side * C + c) * n + y) * n +
    x`` with side 0 for ``L_out`` and 1 for ``L_in``."""
    C, n, _ = OUT.shape
    parts = []
    for side, stack in enumerate((OUT, IN)):
        c, y, x = (t.to(torch.int64) for t in torch.nonzero(
            stack, as_tuple=True))
        parts.append((((side * C + c) * n + y) * n + x).cpu().numpy())
    return np.sort(np.concatenate(parts))


def mr_index(mrs: List[Word]) -> Dict[Word, int]:
    return {w: c for c, w in enumerate(mrs)}
