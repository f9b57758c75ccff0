"""Entry ``condensed_on_card``: ``build_condensed_device`` over a reach
that stays on the card, the RLC index handed back as an ``RLCIndex``.

Set-up makes the all-MR reach once with the program's ``device_reach``
(a bool ``(C, n, n)`` tensor on the card) and runs one warm build; the
window runs ``build_condensed_device(reach=R)`` back to back (the default
``Entry.window``), so no build copies the reach through the host.
``device_reach`` is looked up before anything is allocated: a program
without it fails within seconds.

The check holds two window results and the set-up reach against
``reference/blocked.py``, the plain reference MR by MR (this
configuration's stacks do not fit the card at once in
``reference/plain.py``'s form). It first keeps the reach on the host at
one bit a cell and releases it on the card.

Controls, each breaking one guarantee of the configuration, in blocked
form:

* ``short_closure``: the reference's labeling over a reach closed one
  squaring short (breaks the exact reach);
* ``no_case1``: the reference's labeling with PR1's hub join left out
  (breaks the exact labeling)."""
from __future__ import annotations

import gc
from typing import List

import torch

from rlcbench.entries import (Entry, Verdict, dense, entry_diff, index_keys,
                              mr_diff)
from rlcbench.reference import blocked, plain


class CondensedOnCard(Entry):

    def __init__(self, *args):
        super().__init__(*args)
        self.make_reach = dense().device_reach

    def setup(self) -> None:
        self.mrs, self.reach = self.make_reach(self.graph, self.k,
                                               device=self.device)
        self.build()

    def build(self):
        idx, _ = dense().build_condensed_device(
            self.graph, self.k, hub_batch=self.hub_batch, reach=self.reach,
            device=self.device)
        return idx

    def canonical(self, idx):
        return index_keys(idx, plain.minimum_repeats(self.num_labels,
                                                     self.k), self.n)

    def release_reach(self):
        """The set-up reach's words and their rows on the host, one bit a
        cell; the stack on the card is released."""
        mrs = [tuple(w) for w in self.mrs]
        rows = [blocked.pack_rows(Rc).cpu() for Rc in self.reach]
        del self.reach
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return mrs, rows

    def check(self, samples: List) -> Verdict:
        mrs, rows = self.release_reach()
        ref_mrs = plain.minimum_repeats(self.num_labels, self.k)
        at = {w: c for c, w in enumerate(mrs)}
        diff = {"reach": 0, "seen": set()}

        def visit(c, word, T, R):
            mine = at.get(word)
            if mine is None or mine in diff["seen"]:
                diff["reach"] += int(R.sum())
                return
            diff["seen"].add(mine)
            full = blocked.pack_rows(blocked.full(T, R, self.n))
            diff["reach"] += blocked.popcount(
                full ^ rows[mine].to(full.device))

        ref_keys = blocked.condensed_keys(
            blocked.mr_reaches(self.edges, self.n, self.num_labels, self.k,
                               self.device),
            self.edges, self.n, len(ref_mrs), self.hub_batch, visit=visit)
        # an MR of the program's that the reference lacks: its true cells
        reach_diff = diff["reach"] + sum(
            blocked.popcount(rows[c]) for c in range(len(mrs))
            if c not in diff["seen"])
        mrs_diff = mr_diff(mrs, ref_mrs)
        diffs = [entry_diff(s, ref_keys) for s in samples]
        bad = len(samples) if mrs_diff + reach_diff \
            else sum(d > 0 for d in diffs)
        return {"mr_diff": (mrs_diff, 0), "reach_diff": (reach_diff, 0),
                "entry_diff": (max(diffs), 0)}, bad


class ShortClosureLabeling(CondensedOnCard):
    """The reference's labeling over a reach closed one squaring short."""

    short = True
    case1 = True

    def setup(self) -> None:
        self.mrs, self.reach = blocked.reach(
            self.edges, self.n, self.num_labels, self.k, self.device,
            short_closure=self.short)

    def build(self):
        return blocked.condensed_keys(
            blocked.stack_reaches(self.reach, self.mrs, self.edges, self.n),
            self.edges, self.n, len(self.mrs), self.hub_batch,
            case1=self.case1)

    def canonical(self, result):
        return result


class NoCase1Labeling(ShortClosureLabeling):
    """The reference's labeling with PR1's hub join left out."""

    short = False
    case1 = False


ENTRY = CondensedOnCard
CONTROLS = {"short_closure": ShortClosureLabeling,
            "no_case1": NoCase1Labeling}
