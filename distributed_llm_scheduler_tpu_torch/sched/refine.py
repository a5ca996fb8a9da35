"""Local-search refinement over group placements.

LPT packing (:mod:`.pack`) balances *parameter-load* unions greedily, but
its one-pass greedy choice is blind to two things the replay actually
charges: dependency-wait serialization (a balanced device can still idle on
cross-device inputs) and the interaction between load order and compute
overlap.  This policy closes that gap with plain hill climbing:

1. seed with pack's LPT group placement;
2. repeatedly propose **moves** (bottleneck-device group -> elsewhere) and
   **swaps** (bottleneck group <-> lighter-device group), scoring each
   candidate with the event simulation the ordering pass uses
   (:func:`..sched.eventsim.simulate_placement`).  This is a close
   SURROGATE of the replay's objective — same link charges, per-node
   serial execution, prefetch queue — but not the replay loop itself
   (``backends/sim.py`` additionally models host dispatch slots and its
   own cache accounting), so improvement under the surrogate is
   guaranteed only against the surrogate; in practice the two move
   together (tests pin refine <= pack under the replay on the covered
   graphs, and the flagship bench confirms it end-to-end);
3. first-improvement acceptance, stop when a full neighborhood pass finds
   nothing better or the evaluation budget runs out;
4. commit through pack's assignment path (same memory checks, same
   dependency-aware final ordering).

The reference has no search-based policy (its four schedulers are one-pass
list schedulers, reference ``schedulers.py:138-525``); this is new
capability in the rebuild's favor — a second optimization *tier* on top of
the policy set, the standard makespan play when scheduling time is cheap
relative to execution time (here: milliseconds of host search for
milliseconds of device makespan, re-spent every run of a static graph).

Memory feasibility mirrors pack exactly: a candidate device must hold the
union of its groups' params plus the largest single-task activation.

PyTorch port of ``distributed_llm_scheduler_tpu.sched.refine``; pure
Python over the port's event simulation and incremental analyzer, so its
per-node lists equal the JAX package's at the same seed and budget.  One
addition: ``stats`` records the evaluations spent and whether the static
pre-filter ran (``static_filter``: ``"on"``, or ``"off: <why>"``), so a
filter that fell off cannot hide.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Set, Tuple

from ..backends.sim import LinkModel
from ..core.schedule import Schedule
from .base import SchedulerRun
from .eventsim import simulate_placement
from .pack import GroupPackScheduler
from .pipeline import _group_stats


class _StaticMoveFilter:
    """Incremental static-analysis pre-filter for candidate placements.

    Mirrors the search's group -> device assignment into a placed
    :class:`Schedule` tracked by :class:`..analysis.IncrementalAnalyzer`.
    A candidate whose delta-recheck introduces ERROR diagnostics beyond
    the seed baseline (memory overcommit ``fits()`` under-models,
    placement-dependent typecheck breakage) is rejected *before* the
    eventsim replay is paid for.  Only active when the analyzer's exact
    fast path holds — a dirty baseline would force a full re-analysis
    per candidate, costing more than the replay it saves — otherwise
    every query answers True (no filtering, search unchanged).  Any
    analyzer failure turns the filter off, as in the reference; ``status``
    says why.
    """

    def __init__(
        self,
        run: SchedulerRun,
        devices,
        group_of: Dict[str, str],
        assign: Dict[str, int],
    ):
        self.devices = devices
        self.enabled = False
        self.state = dict(assign)
        self.status = "off: not built"
        try:
            from ..analysis import IncrementalAnalyzer

            order = run.graph.topo_order
        except Exception as e:
            self.status = f"off: {type(e).__name__}: {e}"
            return
        # tasks per group in one fixed topo order, so every mirrored
        # per-node list is a subsequence of assignment_order — the
        # invariant the analyzer's fast path rests on
        self.tasks_of: Dict[str, List[str]] = {}
        per_node: Dict[str, List[str]] = {d.node_id: [] for d in devices}
        placed_order: List[str] = []
        for tid in order:
            g = group_of.get(tid)
            if g is None or g not in assign:
                continue
            self.tasks_of.setdefault(g, []).append(tid)
            per_node[devices[assign[g]].node_id].append(tid)
            placed_order.append(tid)
        mirror = Schedule(
            policy="refine-static",
            per_node=per_node,
            assignment_order=placed_order,
            completed=set(placed_order),
        )
        try:
            self._inc = IncrementalAnalyzer(run.graph, run.cluster, mirror)
        except Exception as e:
            self.status = f"off: {type(e).__name__}: {e}"
            return
        self.base_errors = self._inc.error_count()
        self.enabled = self._inc.exact_fast_path
        self.status = "on" if self.enabled else "off: dirty baseline"

    def _apply(self, frm: Dict[str, int], to: Dict[str, int]) -> None:
        for g, d in to.items():
            if frm.get(g) == d:
                continue
            dst = self.devices[d].node_id
            for tid in self.tasks_of.get(g, ()):
                self._inc.move_task(tid, dst)

    def ok(self, cand: Dict[str, int]) -> bool:
        """True iff ``cand`` adds no ERROR over the seed baseline."""
        if not self.enabled:
            return True
        self._apply(self.state, cand)
        good = self._inc.error_count() <= self.base_errors
        self._apply(cand, self.state)  # revert; subsequence re-insertion
        return good                    # restores the exact prior lists

    def sync(self, assign: Dict[str, int]) -> None:
        """Advance the mirror to an accepted incumbent so later ``ok()``
        queries diff against it (one or two group moves, not the whole
        drift from the seed)."""
        if not self.enabled:
            return
        self._apply(self.state, assign)
        self.state = dict(assign)


class RefinedPackScheduler(GroupPackScheduler):
    """Hill-climbed group placement (pack seed, event-sim objective)."""

    name = "refine"

    def __init__(
        self,
        link: Optional[LinkModel] = None,
        max_evals: int = 400,
        tol: float = 1e-9,
        seed: int = 0,
    ):
        super().__init__(link=link)
        self.max_evals = max_evals
        self.tol = tol
        self.seed = seed
        #: filled per schedule() call: evals / static_filter
        self.stats: Dict[str, object] = {}

    def run_policy(self, run: SchedulerRun) -> None:
        graph, devices = run.graph, run.cluster.devices
        self.stats = {"evals": 0, "static_filter": "off: no search"}
        placed = self.plan(graph, devices)
        if placed and len(devices) > 1:
            placed = self._search(run, placed)
        self.commit(run, placed)

    # -- search ------------------------------------------------------------
    def _search(
        self, run: SchedulerRun, placed: Dict[str, int]
    ) -> Dict[str, int]:
        graph, devices = run.graph, run.cluster.devices
        n_dev = len(devices)
        groups, compute, activ, gparams = _group_stats(graph)
        gidx = {g: i for i, g in enumerate(groups)}
        speeds = {d.node_id: d.compute_speed for d in devices}
        slices = run.cluster.slice_ids()
        group_of = {
            t.task_id: (t.group or t.task_id) for t in graph.tasks()
        }
        flt = _StaticMoveFilter(run, devices, group_of, placed)

        def union_gb(names: Set[str]) -> float:
            return sum(graph.param_size_gb(p) for p in sorted(names))

        def fits(assign: Dict[str, int], d: int) -> bool:
            members = [g for g, dd in assign.items() if dd == d]
            params: Set[str] = set()
            act = 0.0
            for g in members:
                params |= gparams[gidx[g]]
                act = max(act, activ[gidx[g]])
            return union_gb(params) + act <= devices[d].total_memory + 1e-9

        def evaluate(
            assign: Dict[str, int]
        ) -> Tuple[float, Dict[str, float]]:
            placement = {
                tid: devices[assign[g]].node_id
                for tid, g in group_of.items()
                if g in assign
            }
            _, makespan, node_finish = simulate_placement(
                graph, placement, speeds, self.link, slices
            )
            return makespan, node_finish

        evals = 0

        def climb(start: Dict[str, int], start_m, start_nf):
            """First-improvement hill climbing from one placement."""
            nonlocal evals
            cur, cur_m, node_finish = dict(start), start_m, start_nf
            improved = True
            while improved and evals < self.max_evals:
                improved = False
                # groups on the bottleneck device, heaviest param union
                # first — moving them is what shortens the critical device.
                # tie-break by node_id: node_finish iterates in set order,
                # so bare max() would be PYTHONHASHSEED-dependent on ties
                bottleneck = max(
                    node_finish.items(), key=lambda kv: (kv[1], kv[0])
                )[0]
                b_idx = next(
                    i for i, d in enumerate(devices)
                    if d.node_id == bottleneck
                )
                hot = sorted(
                    (g for g, d in cur.items() if d == b_idx),
                    key=lambda g: -union_gb(gparams[gidx[g]]),
                )
                # lighter devices first as destinations
                dests = sorted(
                    range(n_dev),
                    key=lambda d: node_finish.get(devices[d].node_id, 0.0),
                )
                for g in hot:
                    if evals >= self.max_evals or improved:
                        break
                    for d in dests:
                        if d == b_idx:
                            continue
                        # move g -> d
                        cand = dict(cur)
                        cand[g] = d
                        if fits(cand, d) and flt.ok(cand):
                            m, nf = evaluate(cand)
                            evals += 1
                            if m < cur_m - self.tol:
                                cur, cur_m, node_finish = cand, m, nf
                                flt.sync(cand)
                                improved = True
                                break
                            if evals >= self.max_evals:
                                break
                        # swap g <-> lightest group on d
                        there = [g2 for g2, dd in cur.items() if dd == d]
                        if not there:
                            continue
                        g2 = min(
                            there, key=lambda x: union_gb(gparams[gidx[x]])
                        )
                        cand = dict(cur)
                        cand[g], cand[g2] = d, b_idx
                        if (
                            fits(cand, d)
                            and fits(cand, b_idx)
                            and flt.ok(cand)
                        ):
                            m, nf = evaluate(cand)
                            evals += 1
                            if m < cur_m - self.tol:
                                cur, cur_m, node_finish = cand, m, nf
                                flt.sync(cand)
                                improved = True
                                break
                            if evals >= self.max_evals:
                                break
            return cur, cur_m, node_finish

        seed_m, seed_nf = evaluate(placed)
        evals += 1
        best, best_m, _ = climb(placed, seed_m, seed_nf)

        # basin hopping: hill climbing converges in tens of evals; spend
        # the remaining budget escaping its local optimum — perturb the
        # incumbent by a few random feasible group moves (explicit seed:
        # same-seed placements are bitwise reproducible cross-process)
        # and re-climb, keeping the global best
        rng = random.Random(self.seed)
        glist = sorted(best)
        stale = 0  # consecutive failures to produce any feasible change
        while evals + 2 < self.max_evals and glist and stale < 10:
            cand = dict(best)
            for _ in range(3):
                g = rng.choice(glist)
                d = rng.randrange(n_dev)
                if d != cand[g]:
                    moved = dict(cand)
                    moved[g] = d
                    if fits(moved, d):
                        cand = moved
            if cand == best or not flt.ok(cand):
                # every proposed move was infeasible (or the perturbed
                # placement fails the static pre-filter); don't burn the
                # whole budget re-evaluating or replaying it
                stale += 1
                continue
            stale = 0
            flt.sync(cand)
            m, nf = evaluate(cand)
            evals += 1
            cur, cur_m, _ = climb(cand, m, nf)
            if cur_m < best_m - self.tol:
                best, best_m = cur, cur_m
        self.stats = {"evals": evals, "static_filter": flt.status}
        return best
