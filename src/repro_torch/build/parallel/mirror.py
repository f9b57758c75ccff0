"""Hub-sliced PR1 coverage mirror for the parallel build workers.

:class:`repro_torch.core.rlc_index.BitMirror` allocates the dense
``2 * C * V * ceil(V/8)`` byte cube up front — the memory bound the
parallel build lifts. A build worker only ever touches the rows of hubs
it is assigned plus the hubs those phases' PR1 reads (the entries at
the hub vertex), so :class:`HubSliceMirror` stores per-hub **sparse rows**
(python-int bitmasks, the representation the bits build tier and the
delta engine already speak) and materializes a dense ``(C, W)`` uint8
block per hub only on first access. It quacks exactly like
``BitMirror`` for every read/write the build path performs
(``side[hub]``, ``side[hub, c]``, ``set1``, ``set_many``), so
:class:`repro_torch.build.batched.PhaseRunner` adopts it through its existing
``mirror=`` seam unchanged.

The split between ``rows`` and ``blocks`` is the epoch protocol's
retraction lever: broadcast state (committed prefix plus speculatively
forwarded parked results) lives in ``rows`` (updated only by
:meth:`_SideRows.apply_mask` at epoch boundaries), while a phase's own
in-flight writes land in its hub's ``blocks`` entry. A hub's write-side
row has exactly one writer — its own phase — so retracting a
mis-speculated result is an exact full-row wipe
(:meth:`_SideRows.clear_row`).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.rlc_index import _BIT

__all__ = ["HubSliceMirror"]


class _SideRows:
    """One direction of the sliced mirror (the ``out`` / ``in_`` twin)."""

    __slots__ = ("C", "W", "rows", "blocks", "_row_bytes")

    def __init__(self, num_mrs: int, words: int):
        self.C = num_mrs
        self.W = words
        #: committed prefix rows: hub -> {mr id -> packed int mask}
        self.rows: Dict[int, Dict[int, int]] = {}
        #: dense per-hub row blocks, materialized on first access
        self.blocks: Dict[int, np.ndarray] = {}
        #: running byte tally of ``rows`` (footprint reads are per
        #: worker epoch — a full walk there is quadratic over the build)
        self._row_bytes = 0

    def _materialize(self, hub: int) -> np.ndarray:
        blk = self.blocks.get(hub)
        if blk is None:
            blk = np.zeros((self.C, self.W), np.uint8)
            for c, m in self.rows.get(hub, {}).items():
                blk[c] = np.frombuffer(m.to_bytes(self.W, "little"),
                                       np.uint8)
            self.blocks[hub] = blk
        return blk

    # BitMirror-shaped indexing: side[hub] -> (C, W), side[hub, c] -> (W,)
    def __getitem__(self, key):
        if isinstance(key, tuple):
            hub, c = key
            blk = self.blocks.get(hub)   # np ints hash like python ints
            if blk is None:
                blk = self._materialize(int(hub))
            return blk[c]
        blk = self.blocks.get(key)
        if blk is None:
            blk = self._materialize(int(key))
        return blk

    # -- protocol extras (not part of the BitMirror surface) ----------- #
    def row_int(self, hub: int, c: int) -> int:
        """Current row content as a packed int (block view when dense,
        else the committed prefix row) — the fingerprint read path."""
        blk = self.blocks.get(hub)
        if blk is not None:
            return int.from_bytes(blk[c].tobytes(), "little")
        return self.rows.get(hub, {}).get(c, 0)

    def apply_mask(self, hub: int, c: int, mask: int) -> None:
        """Commit new entry bits into the prefix rows (and the dense
        block, when one is live) — the epoch-boundary delta apply."""
        d = self.rows.setdefault(hub, {})
        old = d.get(c, 0)
        d[c] = new = old | mask
        self._row_bytes += ((new.bit_length() + 7) // 8 + 16 if not old
                            else (new.bit_length() + 7) // 8
                            - (old.bit_length() + 7) // 8)
        blk = self.blocks.get(hub)
        if blk is not None:
            blk[c] |= np.frombuffer(mask.to_bytes(self.W, "little"),
                                    np.uint8)

    def masks(self, hub: int) -> Dict[int, int]:
        """Nonzero rows of the hub's dense block as packed ints — the
        phase-output extraction (the write-side hub block holds exactly
        the phase's inserts, because the prefix rows of an uncommitted
        hub are empty)."""
        blk = self.blocks.get(hub)
        if blk is None:
            return {}
        out: Dict[int, int] = {}
        for c in np.nonzero(blk.any(axis=1))[0].tolist():
            out[c] = int.from_bytes(blk[c].tobytes(), "little")
        return out

    def drop(self, hub: int) -> None:
        """Forget the hub's dense block (revert of uncommitted writes)."""
        self.blocks.pop(hub, None)

    def clear_row(self, hub: int) -> None:
        """Wipe the hub's row entirely — block *and* broadcast rows.
        Exact because a hub's write-side row has a single writer (its
        own phase), so the row content is that one phase's output."""
        self.blocks.pop(hub, None)
        d = self.rows.pop(hub, None)
        if d:
            self._row_bytes -= sum((m.bit_length() + 7) // 8 + 16
                                   for m in d.values())

    def bytes_now(self) -> int:
        return len(self.blocks) * self.C * self.W + self._row_bytes


class HubSliceMirror:
    """Drop-in ``BitMirror`` replacement holding only touched hub rows.

    ``out[x, c]`` / ``in_[x, c]`` have the same meaning as on
    ``BitMirror``; allocation is proportional to the hubs actually read
    or written instead of ``V``. :meth:`size_bytes` reports the current
    footprint and tracks the high-water mark in :attr:`peak_bytes`.
    """

    def __init__(self, num_mrs: int, num_vertices: int):
        self.num_vertices = num_vertices
        self.words = (num_vertices + 7) // 8
        self.out = _SideRows(num_mrs, self.words)
        self.in_ = _SideRows(num_mrs, self.words)
        self.peak_bytes = 0

    # -- BitMirror write surface ---------------------------------------- #
    def set1(self, side: _SideRows, c: int, hub: int, y: int) -> None:
        side._materialize(hub)[c, y >> 3] |= _BIT[y & 7]

    def set_many(self, side: _SideRows, c: int, hub: int, ys) -> None:
        row = side._materialize(hub)[c]
        if len(ys) <= 16:
            for y in ys:
                row[y >> 3] |= _BIT[y & 7]
            return
        dense = np.zeros(self.num_vertices, np.uint8)
        dense[np.asarray(ys)] = 1
        row |= np.packbits(dense, bitorder="little")[:self.words]

    def nbytes(self) -> int:
        return self.out.bytes_now() + self.in_.bytes_now()

    def size_bytes(self) -> int:
        """Current footprint (also bumps :attr:`peak_bytes`)."""
        cur = self.nbytes()
        if cur > self.peak_bytes:
            self.peak_bytes = cur
        return cur
