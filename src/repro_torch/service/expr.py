"""Path-expression parser for recursive label-concatenated constraints.

Grammar (whitespace- or comma-separated labels, one ``+``-starred group):

    expr   := group '+'
    group  := '(' body ')' | body
    body   := '"' tokens '"' | "'" tokens "'" | tokens
    tokens := token (sep token)*

Accepted spellings of the paper's ``(debits credits)+``::

    (debits credits)+    ("debits credits")+    (2 3)+    2,3+    (1)+

Tokens are either non-negative integer label ids or label names resolved
through an optional name map. The parsed sequence is validated against the
graph's label alphabet and the index's ``k`` bound, then canonicalized to
its minimum repeat via :func:`repro_torch.core.minimum_repeat.minimum_repeat`
(``(a b a b)+`` and ``(a b)+`` denote the same query, Lemma 1), so every
expression maps onto exactly one indexed MR id.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

from repro_torch.core.minimum_repeat import LabelSeq, minimum_repeat


class ExpressionError(ValueError):
    """Raised for malformed, unknown-label or over-``k`` expressions."""


@dataclass(frozen=True)
class PathExpression:
    """A validated, canonicalized ``L^+`` constraint."""

    raw: str            # original text
    labels: LabelSeq    # label ids exactly as written
    mr: LabelSeq        # minimum repeat of ``labels`` (what the index stores)

    def __len__(self) -> int:
        return len(self.mr)


_QUOTES = {'"': '"', "'": "'"}


def _strip_group(text: str) -> str:
    """Peel ``( ... )+`` / ``...+`` down to the token body."""
    body = text.strip()
    if not body:
        raise ExpressionError("empty expression")
    if not body.endswith("+"):
        raise ExpressionError(
            f"expression must end with '+' (recursive concatenation): "
            f"{text!r}")
    body = body[:-1].strip()
    if body.startswith("(") or body.endswith(")"):
        if not (body.startswith("(") and body.endswith(")")):
            raise ExpressionError(f"unbalanced parentheses in {text!r}")
        body = body[1:-1].strip()
    if body[:1] in _QUOTES:
        if len(body) < 2 or body[-1] != _QUOTES[body[0]]:
            raise ExpressionError(f"unbalanced quotes in {text!r}")
        body = body[1:-1].strip()
    if not body:
        raise ExpressionError(f"empty label group in {text!r}")
    if any(ch in body for ch in "()+\"'"):
        raise ExpressionError(
            f"nested groups / stray '+' are not supported: {text!r}")
    return body


def parse_expression(text: str, *, num_labels: int, k: int,
                     label_names: Optional[Dict[str, int]] = None
                     ) -> PathExpression:
    """Parse and validate one textual constraint into a :class:`PathExpression`.

    Raises :class:`ExpressionError` with an actionable message when the
    expression is malformed, uses an unknown label, or its minimum repeat
    is longer than the index's ``k``.
    """
    if not isinstance(text, str):
        raise ExpressionError(f"expression must be a string, got "
                              f"{type(text).__name__}")
    body = _strip_group(text)
    tokens = [t for t in re.split(r"[\s,]+", body) if t]
    labels = []
    for tok in tokens:
        if re.fullmatch(r"\d+", tok):
            lab = int(tok)
        elif label_names is not None and tok in label_names:
            lab = int(label_names[tok])
        else:
            known = (f"; known names: {sorted(label_names)}"
                     if label_names else "")
            raise ExpressionError(
                f"unknown label {tok!r} in {text!r}{known}")
        if not 0 <= lab < num_labels:
            raise ExpressionError(
                f"label id {lab} out of range [0, {num_labels}) in {text!r}")
        labels.append(lab)
    seq: LabelSeq = tuple(labels)
    mr = minimum_repeat(seq)
    if len(mr) > k:
        raise ExpressionError(
            f"minimum repeat {mr} of {text!r} has length {len(mr)} > k={k}; "
            f"the index cannot answer it (rebuild with a larger k)")
    return PathExpression(raw=text, labels=seq, mr=mr)


def canonicalize(labels: Sequence[int], *, num_labels: int, k: int
                 ) -> PathExpression:
    """Same validation/canonicalization for programmatic (tuple) input."""
    seq = tuple(int(l) for l in labels)
    if not seq:
        raise ExpressionError("empty label sequence")
    for lab in seq:
        if not 0 <= lab < num_labels:
            raise ExpressionError(
                f"label id {lab} out of range [0, {num_labels})")
    mr = minimum_repeat(seq)
    if len(mr) > k:
        raise ExpressionError(
            f"minimum repeat {mr} has length {len(mr)} > k={k}")
    return PathExpression(raw=repr(seq), labels=seq, mr=mr)
