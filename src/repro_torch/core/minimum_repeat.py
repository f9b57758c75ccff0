"""Minimum repeats, kernels and tails of label sequences (paper §III-A, §IV).

A label sequence is represented as a tuple of non-negative ints (label ids).
All routines are O(n) via the KMP failure function [75].

Definitions (paper):
  * ``L'`` is a *repeat* of ``L`` if ``L = (L')^z`` for an integer ``z >= 1``.
  * ``MR(L)`` is the shortest repeat of ``L`` (unique, Lemma 1).
  * ``L`` has *kernel* ``L'`` and *tail* ``L''`` if ``L = (L')^h ∘ L''`` with
    ``h >= 2``, ``MR(L') = L'`` and ``L''`` a proper prefix of ``L'`` (or ε).
    The kernel, when it exists, is unique (Lemma 2).
  * ``L`` has a non-empty *k-MR* iff ``|MR(L)| <= k``; the k-MR is ``MR(L)``.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Iterator, Optional, Sequence, Tuple

Label = int
LabelSeq = Tuple[Label, ...]


def failure_function(seq: Sequence[Label]) -> list:
    """KMP failure function. ``fail[i]`` = length of the longest proper
    prefix of ``seq[:i+1]`` that is also a suffix of it."""
    n = len(seq)
    fail = [0] * n
    j = 0
    for i in range(1, n):
        while j > 0 and seq[i] != seq[j]:
            j = fail[j - 1]
        if seq[i] == seq[j]:
            j += 1
        fail[i] = j
    return fail


def minimum_repeat(seq: Sequence[Label]) -> LabelSeq:
    """``MR(L)``: the shortest ``L'`` such that ``L = (L')^z`` (Lemma 1).

    The shortest period of ``seq`` is ``p = n - fail[n-1]``; it yields a
    repeat iff ``p`` divides ``n``, otherwise ``seq`` is its own MR.
    """
    seq = tuple(seq)
    n = len(seq)
    if n == 0:
        return ()
    p = n - failure_function(seq)[-1]
    if n % p == 0:
        return seq[:p]
    return seq


def is_minimum_repeat(seq: Sequence[Label]) -> bool:
    seq = tuple(seq)
    return minimum_repeat(seq) == seq


def k_mr(seq: Sequence[Label], k: int) -> Optional[LabelSeq]:
    """The k-MR of ``seq``: ``MR(seq)`` if ``|MR(seq)| <= k`` else ``None``."""
    mr = minimum_repeat(seq)
    return mr if len(mr) <= k else None


def kernel_tail(seq: Sequence[Label]) -> Optional[Tuple[LabelSeq, LabelSeq]]:
    """Kernel/tail decomposition (Definition 3), or ``None`` if none exists.

    Returns the unique ``(kernel, tail)`` with ``seq = kernel^h ∘ tail``,
    ``h >= 2``, ``MR(kernel) = kernel`` and ``tail`` a proper prefix of the
    kernel (possibly ε). Uniqueness is Lemma 2; the shortest valid period is
    therefore the kernel.
    """
    seq = tuple(seq)
    n = len(seq)
    for p in range(1, n // 2 + 1):
        # seq must be periodic with period p over its whole length ...
        if all(seq[i] == seq[i - p] for i in range(p, n)):
            kern = seq[:p]
            # ... the kernel must be its own MR and repeat at least twice.
            if minimum_repeat(kern) == kern and n // p >= 2:
                return kern, seq[(n // p) * p:]
    return None


def has_k_mr_path(prefix_2k: Sequence[Label], rest: Sequence[Label], k: int
                  ) -> Optional[LabelSeq]:
    """Theorem 1, Case 3 helper: given a path split at ``|prefix| = 2k``,
    return its k-MR or None. Used by the lazy-KBS reference and in tests."""
    kt = kernel_tail(tuple(prefix_2k))
    if kt is None:
        return None
    kern, tail = kt
    if len(kern) > k:
        return None
    if minimum_repeat(tuple(tail) + tuple(rest)) == kern:
        return kern
    return None


@lru_cache(maxsize=64)
def enumerate_mrs(num_labels: int, k: int) -> Tuple[LabelSeq, ...]:
    """All sequences over ``{0..num_labels-1}`` of length <= k that are their
    own minimum repeat. ``len(enumerate_mrs(|L|, k))`` equals the paper's C
    (index-size analysis §V-C)."""
    out = []

    def rec(prefix: LabelSeq):
        if prefix and is_minimum_repeat(prefix):
            out.append(prefix)
        if len(prefix) < k:
            for lab in range(num_labels):
                rec(prefix + (lab,))

    rec(())
    return tuple(out)


def count_mrs(num_labels: int, k: int) -> int:
    """Closed-form C = Σ_{i<=k} F(i), F(i) = |L|^i - Σ_{j|i, j≠i} F(j)."""
    F = {}
    for i in range(1, k + 1):
        F[i] = num_labels ** i - sum(F[j] for j in range(1, i) if i % j == 0)
    return sum(F.values())


def mr_id_space(num_labels: int, k: int) -> dict:
    """Canonical MR -> dense id mapping (deterministic order)."""
    return {mr: i for i, mr in enumerate(enumerate_mrs(num_labels, k))}


def iter_rotations(seq: LabelSeq) -> Iterator[LabelSeq]:
    for i in range(len(seq)):
        yield seq[i:] + seq[:i]
