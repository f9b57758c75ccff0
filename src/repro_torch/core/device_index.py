"""Batched RLC query evaluation on device (serving path).

The frozen index is laid out as padded per-vertex rows sorted by
``(aid(hub), mr_id)`` — Algorithm 1's merge-join order. A query batch
``(s, t, mr)`` evaluates Case 2 (direct entry) and Case 1 (hub join) with
vectorized compares, or through the CUDA merge-join kernel
(:mod:`repro_torch.kernels.mergejoin`).

Row padding uses hub id ``-1`` (never matches a real hub / query vertex).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .constants import PAD
from .devices import resolve_device
from .minimum_repeat import LabelSeq, mr_id_space
from .rlc_index import FrozenRLCIndex, RLCIndex

_INT32_MAX = np.iinfo(np.int32).max


@dataclass
class DeviceIndex:
    """Padded dense layout: (rows, E) hub-id and mr-id tensors per direction.

    Three query formulations:
      * dense — (E x E) broadcast join per query;
      * sorted — rows re-encoded as ascending ``hub * C + mr`` keys; the
        join is a batched ``searchsorted`` intersection, moving (Q, E)
        instead of (Q, E, E) through memory;
      * kernel — the CUDA merge join (the plain version on CPU tensors).

    With ``row_lo > 0`` the tensors hold only the vertex-row window
    ``[row_lo, row_lo + rows)`` (a shard's slice): query/hub *ids* stay
    global, only row storage is windowed. Every query mode raises
    ``IndexError`` for a vertex id outside the window.
    """

    num_vertices: int
    k: int
    row_len: int
    out_hub: torch.Tensor  # (rows, E) int32, PAD-filled
    out_mr: torch.Tensor   # (rows, E) int32
    in_hub: torch.Tensor
    in_mr: torch.Tensor
    mr_ids: Dict[LabelSeq, int]
    num_mrs: int = 0
    out_key: Optional[torch.Tensor] = None  # (rows, E) int32 sorted asc
    in_key: Optional[torch.Tensor] = None
    row_lo: int = 0     # first vertex id stored

    @property
    def device(self) -> torch.device:
        return self.out_hub.device

    @staticmethod
    def from_index(idx: RLCIndex, num_labels: int,
                   row_len: Optional[int] = None,
                   pad_to_multiple: int = 8,
                   device="cuda") -> "DeviceIndex":
        ids = mr_id_space(num_labels, idx.k)
        return DeviceIndex.from_frozen(idx.freeze(ids), ids,
                                       row_len=row_len,
                                       pad_to_multiple=pad_to_multiple,
                                       device=device)

    @staticmethod
    def from_frozen(frozen: FrozenRLCIndex, mr_ids: Dict[LabelSeq, int],
                    row_len: Optional[int] = None,
                    pad_to_multiple: int = 8,
                    rows: Optional[Tuple[int, int]] = None,
                    device="cuda") -> "DeviceIndex":
        """Device transfer of an already-frozen index.

        ``rows=(lo, hi)`` packs only that vertex-row window — pair it with
        :meth:`FrozenRLCIndex.slice_rows` so a shard's device tensors
        cover just the rows it owns instead of full height. A ``row_len``
        below :attr:`FrozenRLCIndex.max_row` truncates rows, as the
        reference layout does.
        """
        dev = resolve_device(device)
        E = row_len or max(1, frozen.max_row)
        E = ((E + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple
        lo, hi = (0, frozen.num_vertices) if rows is None else rows
        if not (0 <= lo <= hi <= frozen.num_vertices):
            raise ValueError(
                f"rows [{lo}, {hi}) out of range "
                f"[0, {frozen.num_vertices}]")

        def pack(indptr, hub, mr):
            H = np.full((hi - lo, E), PAD, np.int32)
            M = np.full((hi - lo, E), PAD, np.int32)
            for v in range(lo, hi):
                a, b = indptr[v], indptr[v + 1]
                ln = min(b - a, E)
                H[v - lo, :ln] = hub[a:a + ln]
                M[v - lo, :ln] = mr[a:a + ln]
            return H, M

        oh, om = pack(frozen.out_indptr, frozen.out_hub, frozen.out_mr)
        ih, im = pack(frozen.in_indptr, frozen.in_hub, frozen.in_mr)
        C = len(mr_ids)

        def keys(h, m):
            key = np.where(h == PAD, _INT32_MAX,
                           h.astype(np.int64) * C + m).astype(np.int32)
            return np.sort(key, axis=1)

        on = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        return DeviceIndex(frozen.num_vertices, frozen.k, E, on(oh), on(om),
                           on(ih), on(im), mr_ids, C, on(keys(oh, om)),
                           on(keys(ih, im)), lo)

    # ---------------------------------------------------------------- #
    def query_batch(self, s: np.ndarray, t: np.ndarray, mr: np.ndarray,
                    use_kernel: bool = False,
                    method: str = "dense") -> np.ndarray:
        if use_kernel:
            from repro_torch.kernels import mergejoin
            out = mergejoin.query_batch(
                self.out_hub, self.out_mr, self.in_hub, self.in_mr,
                s, t, mr, row_base_out=self.row_lo, row_base_in=self.row_lo)
            return out.cpu().numpy()
        # storage rows, range-checked on the host as the kernel's wrapper
        # checks them: an id outside the window raises IndexError
        s_row, t_row = self._rows(s), self._rows(t)
        s, t, mr = (torch.as_tensor(np.asarray(a, np.int32),
                                    device=self.device) for a in (s, t, mr))
        if method == "sorted":
            out = _query_batch_sorted_rows(
                self.out_key, self.in_key, s_row, t_row, s, t, mr,
                self.num_mrs)
        else:
            out = _query_batch_rows(self.out_hub, self.out_mr, self.in_hub,
                                    self.in_mr, s_row, t_row, s, t, mr)
        return out.cpu().numpy()

    def query(self, s: int, t: int, L: Sequence[int]) -> bool:
        c = self.mr_ids.get(tuple(L))
        if c is None:
            return False
        return bool(self.query_batch(np.array([s]), np.array([t]),
                                     np.array([c]))[0])

    def explain_batch(self, s: np.ndarray, t: np.ndarray, mr: np.ndarray,
                      max_hubs: int = 8) -> list:
        """Witness mode for the device join path: per query, the
        derivation over exactly the padded rows the kernel joins,
        gathered on the layout's device and copied to the host (PAD
        slots dropped). Device rows carry no access-id table, so join
        hubs report ``aid: null`` and sort by vertex id; row lengths
        reflect the ``row_len`` truncation the layout serves with."""
        from repro_torch.obs.explain import explain_rows
        s = np.asarray(s)
        t = np.asarray(t)
        mr = np.asarray(mr)
        oh, om = (a.cpu().numpy() for a in self.gather_out_rows(s))
        ih, im = (a.cpu().numpy() for a in self.gather_in_rows(t))
        return [explain_rows(oh[q], om[q], ih[q], im[q],
                             int(s[q]), int(t[q]), int(mr[q]),
                             pad=PAD, max_hubs=max_hubs)
                for q in range(len(s))]

    # -- shard scatter/gather helpers -------------------------------------- #
    def _rows(self, ids: np.ndarray) -> torch.Tensor:
        """Storage rows of global vertex ids, range-checked on the host (an
        index outside the rows would be a device-side fault on a card)."""
        rows = np.asarray(ids, np.int64) - self.row_lo
        if rows.size and not (rows.min() >= 0
                              and rows.max() < self.out_hub.shape[0]):
            raise IndexError(
                f"vertex ids outside the stored rows [{self.row_lo}, "
                f"{self.row_lo + self.out_hub.shape[0]})")
        return torch.as_tensor(rows, device=self.device)

    def gather_out_rows(self, s: np.ndarray
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Padded ``(Q, E)`` out-row digests for a batch of source vertices
        (:func:`join_rows`'s left side). ``s`` is in global vertex ids."""
        s = self._rows(s)
        return self.out_hub[s], self.out_mr[s]

    def gather_in_rows(self, t: np.ndarray
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        t = self._rows(t)
        return self.in_hub[t], self.in_mr[t]


def join_rows(oh, om, ih, im, s, t, mr) -> torch.Tensor:
    """Batched Algorithm 1 on pre-gathered rows.

    ``oh/om`` are (Q, Eo) out-rows of each query's ``s``; ``ih/im`` are
    (Q, Ei) in-rows of each query's ``t`` (Eo and Ei may differ). Case 2
    via direct compares, Case 1 via an (Eo x Ei) broadcast join.
    """
    q_mr = mr[:, None]
    case2 = ((oh == t[:, None]) & (om == q_mr)).any(dim=1) | \
        ((ih == s[:, None]) & (im == q_mr)).any(dim=1)
    o_ok = (om == q_mr) & (oh != PAD)            # (Q, Eo)
    i_ok = (im == q_mr) & (ih != PAD)            # (Q, Ei)
    join = (oh[:, :, None] == ih[:, None, :]) & \
        o_ok[:, :, None] & i_ok[:, None, :]      # (Q, Eo, Ei)
    return case2 | join.any(dim=(1, 2))


def _query_batch_rows(out_hub, out_mr, in_hub, in_mr, s_row, t_row,
                      s, t, mr) -> torch.Tensor:
    """Row-windowed batched Algorithm 1: gather by *storage* row index
    (``s_row = s - row_lo``), compare by global vertex id."""
    s_row, t_row = s_row.long(), t_row.long()
    return join_rows(out_hub[s_row], out_mr[s_row],
                     in_hub[t_row], in_mr[t_row], s, t, mr)


def _query_batch_sorted_rows(out_key, in_key, s_row, t_row, s, t, mr,
                             num_mrs) -> torch.Tensor:
    """Sorted-key intersection join: O(E log E) per query, (Q, E) memory
    traffic. Key = hub * C + mr; PAD slots sort to INT32_MAX and never
    match. Rows are gathered by storage index; key compares use global
    ids. ``torch.searchsorted`` with ``right=False`` takes the left
    position on ties, like ``jnp.searchsorted``."""
    ok = out_key[s_row.long()]            # (Q, E) ascending
    ik = in_key[t_row.long()]
    q_mr = mr[:, None]
    last = ik.shape[1] - 1
    # Case 1: out keys with the queried mr present in the in row
    pos = torch.searchsorted(ik, ok).clamp(max=last)
    hit = torch.gather(ik, 1, pos) == ok
    mr_match = (ok % num_mrs) == q_mr
    case1 = (hit & mr_match & (ok != _INT32_MAX)).any(dim=1)
    # Case 2: direct entries (t, mr) in L_out(s) / (s, mr) in L_in(t)
    kt = (t * num_mrs + mr)[:, None]
    ks = (s * num_mrs + mr)[:, None]
    p2 = torch.searchsorted(ok, kt).clamp(max=ok.shape[1] - 1)
    c2a = torch.gather(ok, 1, p2) == kt
    p3 = torch.searchsorted(ik, ks).clamp(max=last)
    c2b = torch.gather(ik, 1, p3) == ks
    return case1 | c2a.any(dim=1) | c2b.any(dim=1)
