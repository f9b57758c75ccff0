"""Entry ``dense_engine``: ``DenseEngine.build``, the all-MR reach (the
paper's ETC analog), handed back as the numpy ``(C, n, n)`` stack.

Control ``short_closure``: the reference's reach, each MR closed one
squaring short of its fixed point (breaks the exact reach)."""
from __future__ import annotations

from typing import List

from rlcbench.entries import Entry, Verdict, dense, mr_diff, reach_diff
from rlcbench.reference import plain


class DenseEngineBuild(Entry):

    def build(self):
        return dense().DenseEngine.build(self.graph, self.k,
                                         device=self.device)

    def canonical(self, eng):
        return eng.mrs, eng.reach

    def check(self, samples: List) -> Verdict:
        ref_mrs, ref_R = self.reference_reach()
        mrs = [mr_diff(s[0], ref_mrs) for s in samples]
        diffs = [reach_diff(*s, ref_mrs, ref_R) for s in samples]
        return ({"mr_diff": (max(mrs), 0), "reach_diff": (max(diffs), 0)},
                sum(m + d > 0 for m, d in zip(mrs, diffs)))


class ShortClosureReach(DenseEngineBuild):
    """The reference's reach, each MR closed one squaring short."""

    def setup(self) -> None:
        pass

    def build(self):
        mrs, R = plain.reach(self.edges, self.n, self.num_labels, self.k,
                             self.device, short_closure=True)
        return mrs, R.cpu().numpy()

    def canonical(self, result):
        return result


ENTRY = DenseEngineBuild
CONTROLS = {"short_closure": ShortClosureReach}
