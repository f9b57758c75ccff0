"""Cost model + list scheduler for the parallel build dispatch rounds.

Replaces Algorithm 2's fixed access-order loop. The coordinator asks
for one worker's plan at a time (:meth:`ListScheduler.plan_for`) the
moment that worker goes idle — there is no global epoch barrier, so a
straggling phase on one worker never stalls the other workers' next
batches. A position is *dispatchable* when every predecessor is

* **committed** or **parked** (executed earlier, result awaiting the
  validation frontier) — parked outputs are not yet guaranteed
  correct, so this is the protocol's optimism: if the dependency was
  real and the parked result turns out stale, the phase's validation
  catches it and the coordinator re-runs it exactly. Requiring
  *committed* predecessors instead couples DAG levels to the
  sequential commit frontier and inflates round counts far past the
  DAG depth;
* or assigned **earlier in this same plan** — the worker runs its plan
  in position order, so the chain's writes are locally visible and the
  phase reads exactly what the sequential build would have produced
  (if the chain head was right). Chains across two in-flight plans
  wait instead; unbounded cross-worker chaining is what degenerates
  into one worker owning the whole build.

Positions currently in flight on *other* workers are neither
dispatchable nor dependency-satisfying (their results are not back
yet), so plans never overlap and never chain across workers.

Each plan takes free (no-chain-needed) phases in ascending position
order up to ``balance`` times the worker's fair share of the free
set's cost — the free set is an antichain, so whatever this worker
leaves is immediately dispatchable to the next idle worker — then
extends chains rooted in the plan up to the same budget (with a small
floor of :attr:`ListScheduler.CHAIN_MIN` phases so serial chain
regions don't degenerate into one-phase round trips). Dispatch is
bounded to :attr:`ListScheduler.WINDOW` positions past the validation
frontier so the coordinator's merge cost stays flat (see the
attribute's note).

Costs start from the same two-hop state proxy the hybrid tier dispatch
uses (``PhaseRunner._est``); as phases complete,
:meth:`PhaseCostModel.observe` collects measured wall times and
:meth:`PhaseCostModel.refit` re-derives the seconds-per-state
coefficient (median ratio — robust to the handful of scalar-tier
outliers), so later rounds balance on real per-(hub, direction)
timings, exactly the signal the ``build_obs`` series record.

The earliest active position that is neither executed nor in flight
always has all predecessors executed (the validation frontier commits
in position order), so it is always free: whenever work remains and
nothing is in flight, a nonempty plan exists and the build progresses.
"""
from __future__ import annotations

from typing import Iterable, List, Set, Tuple

import numpy as np

from .dag import PhaseDAG

__all__ = ["PhaseCostModel", "ListScheduler"]


class PhaseCostModel:
    """Per-position wall-time estimates, refit from measurements."""

    #: starting seconds-per-two-hop-state (order of magnitude only; the
    #: first refit replaces it)
    INIT_COEF = 2e-6
    BASE_S = 5e-5

    def __init__(self, est: np.ndarray):
        self.est = np.maximum(np.asarray(est, dtype=np.float64), 1.0)
        self.coef = self.INIT_COEF
        self._samples: List[Tuple[float, float]] = []

    def cost(self, pos: int) -> float:
        return self.BASE_S + self.coef * float(self.est[pos])

    def costs(self) -> np.ndarray:
        return self.BASE_S + self.coef * self.est

    def observe(self, pos: int, seconds: float) -> None:
        self._samples.append((float(self.est[pos]), float(seconds)))

    def refit(self) -> float:
        """Median measured seconds-per-state over everything observed so
        far; returns the (possibly unchanged) coefficient."""
        if self._samples:
            ratios = sorted(s / e for e, s in self._samples)
            self.coef = max(ratios[len(ratios) // 2], 1e-9)
        return self.coef


class ListScheduler:
    """Per-worker plans: windowed, budgeted antichain slices + chains."""

    #: minimum chain extension depth per plan — in serial chain regions
    #: the cost budget is near zero and would hand out one phase per
    #: round trip; a short fixed allowance amortizes dispatch overhead
    #: without letting a chain hoard parallel work
    CHAIN_MIN = 4
    #: dispatch horizon past the validation frontier, in positions.
    #: Unbounded run-ahead piles up parked results whose views miss
    #: every commit in between, and the coordinator's per-commit
    #: dirty-set fan-out grows with that lag — the window keeps the
    #: parked population (and so the merge cost) O(1) while still
    #: holding many plans' worth of dispatchable work
    WINDOW = 128

    def __init__(self, dag: PhaseDAG, cost_model: PhaseCostModel,
                 workers: int, balance: float = 1.6):
        self.dag = dag
        self.cost = cost_model
        self.workers = max(1, int(workers))
        self.balance = float(balance)
        # incremental readiness: per position, the predecessors never yet
        # executed (executed = committed or parked — monotone, so edges
        # are retired exactly once over the build instead of the whole
        # pred list being rescanned every round)
        self._succs: List[List[int]] = [[] for _ in range(dag.npos)]
        for p, ps in enumerate(dag.preds):
            for q in ps:
                self._succs[q].append(p)
        self._unexec: List[set] = [set(ps) for ps in dag.preds]
        self._exec_mask = np.zeros(dag.npos, dtype=bool)

    def plan_for(self, committed: np.ndarray, pending: Iterable[int],
                 inflight: Set[int], frontier: int = 0) -> List[int]:
        """One idle worker's next batch (ascending — its local execution
        order); empty when nothing is dispatchable. ``committed`` marks
        validated positions (inactive ones pre-marked), ``pending``
        positions have a parked un-validated result (not re-dispatched,
        but dependency-satisfying — see the module docstring), and
        ``inflight`` positions are on some worker's in-flight plan
        (neither). Only positions within :attr:`WINDOW` of ``frontier``
        (the coordinator's commit frontier) are considered."""
        dag, nw = self.dag, self.workers
        npos = dag.npos
        pend_mask = np.zeros(npos, dtype=bool)
        pend_list = list(pending)
        if pend_list:
            pend_mask[pend_list] = True
        # retire dependency edges of everything newly executed
        exec_now = committed | pend_mask
        unexec = self._unexec
        for q in np.nonzero(exec_now & ~self._exec_mask)[0].tolist():
            for s in self._succs[q]:
                unexec[s].discard(q)
        self._exec_mask = exec_now
        avail = dag.active & ~exec_now
        if inflight or frontier + self.WINDOW < npos:
            avail = avail.copy()
            avail[frontier + self.WINDOW:] = False
            if inflight:
                avail[list(inflight)] = False
        todo = np.nonzero(avail)[0].tolist()
        if not todo:
            return []
        costs = self.cost.costs()
        free = [p for p in todo if not unexec[p]]
        budget = self.balance * sum(
            float(costs[p]) for p in free) / nw
        plan: List[int] = []
        load = 0.0
        # lowest positions first up to the fair share; the rest of the
        # antichain stays immediately dispatchable to the next idle
        # worker, so leaving it behind wastes nothing. Position order
        # (not LPT) keeps dispatch hugging the validation frontier, so
        # parked results commit soon after collection and the
        # coordinator's per-commit dirty-set fan-out stays small —
        # batch-level imbalance is cheap here, since an early finisher
        # is re-dispatched immediately rather than waiting on a barrier
        for p in free:
            if plan and load >= budget:
                break
            plan.append(p)
            load += float(costs[p])
        aset = set(plan)
        # chain extensions in position order (a chain pred must be in
        # the plan before its dependents are considered)
        for p in todo:
            if p in aset or not unexec[p]:
                continue
            if not unexec[p] <= aset:
                continue          # off-plan / cross-plan chain: waits
            if load >= budget and len(plan) >= self.CHAIN_MIN:
                continue
            aset.add(p)
            plan.append(p)
            load += float(costs[p])
        plan.sort()
        return plan
