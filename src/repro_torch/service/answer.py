"""The typed query answer: value + disposition + backend attribution.

``query`` / ``query_batch`` / ``submit`` all resolve to :class:`Answer`
objects instead of bare booleans, so callers can tell *how* a query was
answered — cache hit vs freshly computed vs degraded to the BiBFS oracle
mid-swap — and *which* backend computed it, without giving up boolean
ergonomics:

* ``bool(ans)`` / ``if ans:`` coerce to the reachability value exactly
  like the old bare-bool answers;
* ``ans == True`` / ``ans == other_answer`` compare by value only, so
  a cache hit and a computed answer for the same key compare equal and
  list-vs-list comparisons against expected booleans keep working;
* a *shed* answer (admission control dropped the query) is the
  :data:`SHED` singleton — ``ans is SHED`` still works, and ``bool()``
  on it still raises: a shed query has no reachability value and any
  code path coercing one is a bug that must fail loud.

Dispositions:

=============  =======================================================
``cache_hit``  answered from the result cache (no backend ran)
``computed``   executed through the batch path (``backend`` names the
               engine: ``cuda`` / ``sorted`` / ``numpy`` / ``python``,
               ``digest`` for a cross-shard digest join, ``rpc:*`` when
               a shard-host worker process answered over the wire)
``degraded``   answered exactly but off the index path (online BiBFS
               while a shard was mid-swap or its workers were gone)
``shed``       dropped by admission control — no value
=============  =======================================================
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["Answer", "SHED", "DISPOSITIONS"]

DISPOSITIONS = ("cache_hit", "computed", "degraded", "shed")


class Answer:
    """One resolved query result; immutable, value-comparable."""

    __slots__ = ("value", "disposition", "backend")

    def __init__(self, value: Optional[bool], disposition: str,
                 backend: Optional[str] = None):
        if disposition not in DISPOSITIONS:
            raise ValueError(
                f"unknown disposition {disposition!r}; "
                f"choose from {DISPOSITIONS}")
        if (value is None) != (disposition == "shed"):
            raise ValueError(
                "shed answers carry no value; every other disposition "
                f"requires one (got value={value!r}, "
                f"disposition={disposition!r})")
        object.__setattr__(self, "value", value)
        object.__setattr__(self, "disposition", disposition)
        object.__setattr__(self, "backend", backend)

    def __setattr__(self, name, value):
        raise AttributeError("Answer is immutable")

    @property
    def shed(self) -> bool:
        return self.disposition == "shed"

    def __bool__(self) -> bool:
        if self.shed:
            raise TypeError(
                "SHED is not a boolean answer; check `ans is SHED` before "
                "interpreting query results under admission control")
        return self.value

    def __eq__(self, other) -> bool:
        # value-only equality: a cache hit and a computed answer for the
        # same key are the same answer; sheds equal only sheds
        if isinstance(other, Answer):
            if self.shed or other.shed:
                return self.shed and other.shed
            return self.value == other.value
        if isinstance(other, (bool, int, np.bool_)) and not self.shed:
            return self.value == bool(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash((Answer, self.value))

    def __repr__(self) -> str:
        if self.shed:
            return "SHED"
        b = f", backend={self.backend!r}" if self.backend else ""
        return f"Answer({self.value}, {self.disposition!r}{b})"

    def as_dict(self) -> dict:
        return dict(value=self.value, disposition=self.disposition,
                    backend=self.backend)


#: The singleton explicit shed answer (admission control dropped the
#: query). ``repr(SHED) == "SHED"``, ``bool(SHED)`` raises, and shed
#: answers are always this object — ``ans is SHED`` is the check.
SHED = Answer(None, "shed")
