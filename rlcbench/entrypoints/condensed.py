"""Entry ``condensed``: ``build_condensed_device``, the RLC index built on
the card as hub-batched masked products over a reach made once in set-up
by ``DenseEngine.build``, handed back as an ``RLCIndex``.

Controls, each breaking one guarantee of the configuration:

* ``short_closure``: the reference's labeling over a reach closed one
  squaring short (breaks the exact reach);
* ``no_case1``: the reference's labeling with PR1's hub join (the coverage
  product) left out (breaks the exact labeling)."""
from __future__ import annotations

from typing import List

from rlcbench.entries import (Entry, Verdict, dense, entry_diff, index_keys,
                              mr_diff, reach_diff)
from rlcbench.reference import plain


class CondensedBuild(Entry):

    def setup(self) -> None:
        eng = dense().DenseEngine.build(self.graph, self.k,
                                        device=self.device)
        self.mrs, self.reach = eng.mrs, eng.reach
        self.build()

    def build(self):
        idx, _ = dense().build_condensed_device(
            self.graph, self.k, hub_batch=self.hub_batch, reach=self.reach,
            device=self.device)
        return idx

    def canonical(self, idx):
        return index_keys(idx, plain.minimum_repeats(self.num_labels,
                                                     self.k), self.n)

    def check(self, samples: List) -> Verdict:
        ref_mrs, ref_R = self.reference_reach()
        setup_mrs = mr_diff(self.mrs, ref_mrs)
        setup_diff = reach_diff(self.mrs, self.reach, ref_mrs, ref_R)
        order = plain.access_order(self.edges, self.n)
        OUT, IN = plain.condensed(ref_R, order, self.hub_batch)
        del ref_R
        ref_keys = plain.entry_keys(OUT, IN)
        del OUT, IN
        diffs = [entry_diff(s, ref_keys) for s in samples]
        bad = len(samples) if setup_mrs + setup_diff \
            else sum(d > 0 for d in diffs)
        return {"mr_diff": (setup_mrs, 0), "reach_diff": (setup_diff, 0),
                "entry_diff": (max(diffs), 0)}, bad


class ShortClosureLabeling(CondensedBuild):
    """The reference's labeling over a reach closed one squaring short."""

    def setup(self) -> None:
        mrs, R = plain.reach(self.edges, self.n, self.num_labels, self.k,
                             self.device, short_closure=True)
        self.mrs, self.reach, self._R = mrs, R.cpu().numpy(), R

    def build(self):
        order = plain.access_order(self.edges, self.n)
        return plain.entry_keys(*plain.condensed(self._R, order,
                                                 self.hub_batch))

    def canonical(self, result):
        return result

    def check(self, samples):
        del self._R
        return super().check(samples)


class NoCase1Labeling(ShortClosureLabeling):
    """The reference's labeling with PR1's hub join left out."""

    def setup(self) -> None:
        mrs, R = plain.reach(self.edges, self.n, self.num_labels, self.k,
                             self.device)
        self.mrs, self.reach, self._R = mrs, R.cpu().numpy(), R

    def build(self):
        order = plain.access_order(self.edges, self.n)
        return plain.entry_keys(*plain.condensed(self._R, order,
                                                 self.hub_batch, case1=False))


ENTRY = CondensedBuild
CONTROLS = {"short_closure": ShortClosureLabeling,
            "no_case1": NoCase1Labeling}
