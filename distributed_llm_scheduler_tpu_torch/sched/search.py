"""Annealed iterated local search over task-level placements.

The third scheduling tier (heuristics -> :mod:`.refine` -> search).
:mod:`.refine` hill-climbs *group* moves — it cannot split a group across
devices, so its optimum is bounded by the group partition the heuristics
chose.  This policy searches the full task->device space:

1. **seed** from a portfolio of the existing heuristics (``pack`` /
   ``critical`` / ``heft`` by default; ``refine`` may be added), keeping
   whichever placement the event simulation
   (:func:`..sched.eventsim.simulate_placement_timeline`) scores best.
   ``refine`` is deliberately *not* in the default portfolio: seeding one
   local search with another's budget-truncated output strands the walk
   mid-descent in a state whose neighborhood the task-level sweeps no
   longer intersect — from the constructive ``pack`` seed the annealer
   owns the whole descent and lands strictly below refine's optimum;
2. **propose** task->device moves and task<->task swaps aimed at the
   *simulated critical path* (walked backward from the last finish, the
   same latest-release rule ``obs/attribution.py`` applies to measured
   traces).  The workhorse proposal is **hop healing**: the walk records
   every cross-device dependency edge that *binds* a start time — each
   one pays the link's transfer latency on the critical path — and the
   search proposes collapsing it by co-locating consumer with producer
   (either endpoint, singleton or whole group-slice).  Load-balance
   proposals (bottleneck-device rebalances, group-slice moves) round out
   the mix;
3. **pre-filter** every candidate through the incremental re-analysis
   engine (:class:`..analysis.IncrementalAnalyzer`, ``move_task`` deltas):
   a move that introduces new ERROR diagnostics is rejected *before* the
   event-sim replay is paid for;
4. **accept** under simulated annealing — always downhill, uphill with
   probability ``exp(-delta/T)`` under a geometric cooling schedule — and
   escape local optima with perturbation **kicks** (a few random feasible
   moves off the incumbent best, temperature re-warmed) once progress
   stalls;
5. **commit** the best placement found through pack's memory-checked
   assignment path, so the result is a legal :class:`~..core.schedule.
   Schedule` ordered by the same dependency-aware event simulation every
   other policy uses.

Everything is driven by one seeded ``random.Random`` and a hard evaluation
budget (optionally a wall-clock budget too), so the same seed + budget
yields the identical placement digest across processes — CI gates on that.

Grounded in "GDP: Generalized Device Placement for Dataflow Graphs" and
"The TensorFlow Partitioning and Scheduling Problem: It's the Critical
Path!" (PAPERS.md): search over placements scored by a calibrated
simulator, with critical-path-aware proposals.

PyTorch port of ``distributed_llm_scheduler_tpu.sched.search``; pure
Python over the port's event simulation and incremental analyzer, with
the same portfolio seeding, ``random.Random`` draw order and eval budget,
so per-node lists, ``placement_digest`` and ``stats`` equal the JAX
package's at the same seed and budget.  One addition:
``stats["static_filter"]`` says whether the static pre-filter ran
(``"on"``, or ``"off: <why>"``), so a filter that fell off cannot hide.
"""

from __future__ import annotations

import hashlib
import math
import random
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..backends.sim import LinkModel
from ..core.schedule import Schedule
from .base import SchedulerRun
from .eventsim import PlacementTimeline, simulate_placement_timeline
from .heft import HEFTScheduler
from .pack import GroupPackScheduler
from .refine import RefinedPackScheduler

_EPS = 1e-12


def placement_digest(placement: Dict[str, str]) -> str:
    """Stable cross-process fingerprint of a task->node placement."""
    h = hashlib.sha256()
    for tid in sorted(placement):
        h.update(f"{tid}\x00{placement[tid]}\x01".encode())
    return h.hexdigest()


class _TaskMoveFilter:
    """Incremental static pre-filter over task-level moves.

    The task-level twin of refine's ``_StaticMoveFilter``: the incumbent
    assignment is mirrored into a placed :class:`Schedule` (per-node lists
    in one fixed topo order, so each stays a subsequence of
    ``assignment_order`` — the analyzer's exact-fast-path invariant) and
    every candidate is diffed against it with ``move_task`` deltas.  A
    candidate that raises the ERROR count above the seed baseline is
    rejected before any event-sim evaluation.  Disabled (every query True)
    when the analyzer's fast path doesn't hold — a dirty baseline would
    force full re-analysis per candidate, costing more than it saves.
    Any analyzer failure turns the filter off, as in the reference;
    ``status`` says why.
    """

    def __init__(self, run: SchedulerRun, devices, assign: Dict[str, int]):
        self.devices = devices
        self.enabled = False
        self.state = dict(assign)
        self.rejected = 0  # candidates killed before an eventsim eval
        self.status = "off: not built"
        try:
            from ..analysis import IncrementalAnalyzer
        except Exception as e:
            self.status = f"off: {type(e).__name__}: {e}"
            return
        per_node: Dict[str, List[str]] = {d.node_id: [] for d in devices}
        placed_order: List[str] = []
        for tid in run.graph.topo_order:
            d = assign.get(tid)
            if d is None:
                continue
            per_node[devices[d].node_id].append(tid)
            placed_order.append(tid)
        mirror = Schedule(
            policy="search-static",
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
        for tid, d in to.items():
            if frm.get(tid) != d:
                self._inc.move_task(tid, self.devices[d].node_id)

    def ok(self, cand: Dict[str, int]) -> bool:
        """True iff ``cand`` adds no ERROR over the seed baseline."""
        if not self.enabled:
            return True
        self._apply(self.state, cand)
        good = self._inc.error_count() <= self.base_errors
        self._apply(cand, self.state)  # exact undo (subsequence re-insert)
        if not good:
            self.rejected += 1
        return good

    def sync(self, assign: Dict[str, int], verify: bool = False) -> None:
        """Advance the mirror to an accepted incumbent; with ``verify``
        the analyzer re-runs the full suite fresh and asserts the cached
        state matches diagnostic-for-diagnostic (test-only)."""
        if not self.enabled:
            return
        self._apply(self.state, assign)
        self.state = dict(assign)
        if verify:
            self._inc.verify()


class _DeviceLoads:
    """Incremental per-device memory model: param-name union GB + the
    largest single-task activation must fit ``total_memory`` — exactly the
    feasibility rule refine/pack enforce, maintained under task moves."""

    def __init__(self, graph, devices, assign: Dict[str, int]):
        self.graph = graph
        self.devices = devices
        n = len(devices)
        self.counts: List[Dict[str, int]] = [{} for _ in range(n)]
        self.union_gb = [0.0] * n
        self.acts: List[Dict[str, float]] = [{} for _ in range(n)]
        for tid, d in assign.items():
            self.add(tid, d)

    def add(self, tid: str, d: int) -> None:
        task = self.graph[tid]
        cnt = self.counts[d]
        for p in sorted(task.params_needed):
            c = cnt.get(p, 0)
            cnt[p] = c + 1
            if c == 0:
                self.union_gb[d] += self.graph.param_size_gb(p)
        self.acts[d][tid] = task.memory_required

    def remove(self, tid: str, d: int) -> None:
        task = self.graph[tid]
        cnt = self.counts[d]
        for p in sorted(task.params_needed):
            c = cnt[p] - 1
            if c == 0:
                del cnt[p]
                self.union_gb[d] -= self.graph.param_size_gb(p)
            else:
                cnt[p] = c
        del self.acts[d][tid]

    def fits(self, d: int) -> bool:
        act = max(self.acts[d].values(), default=0.0)
        return (
            self.union_gb[d] + act
            <= self.devices[d].total_memory + 1e-9
        )


class SearchScheduler(GroupPackScheduler):
    """Seeded iterated local search / simulated annealing over task moves."""

    name = "search"

    #: random-stream mix (only runs once both deterministic sweeps are
    #: exhausted).  Blind single-task moves almost always lose on a
    #: param-cached graph (any move onto a device that lacks the task's
    #: params duplicates a whole weight-set's load), so most of the
    #: stream stays param-free.
    P_REBALANCE = 0.70  # param-free rebalance off the bottleneck device
    P_SWAP = 0.25       # within single-move proposals: swap instead

    def __init__(
        self,
        link: Optional[LinkModel] = None,
        budget: int = 800,
        seed: int = 0,
        time_budget_s: Optional[float] = None,
        portfolio: Sequence[str] = ("pack", "critical", "heft"),
        tol: float = 1e-9,
        verify_filter: bool = False,
    ):
        super().__init__(link=link)
        self.budget = budget
        self.seed = seed
        self.time_budget_s = time_budget_s
        self.portfolio = tuple(portfolio)
        self.tol = tol
        self.verify_filter = verify_filter
        #: filled per schedule() call: evals / filtered / infeasible_mem /
        #: accepted / kicks / seed_policy / seed + best makespans /
        #: static_filter
        self.stats: Dict[str, object] = {}

    # -- seeding -----------------------------------------------------------

    def _portfolio(self) -> List[Tuple[str, GroupPackScheduler]]:
        # late import: policies.py imports this module for the registry
        from .policies import CriticalPathScheduler

        avail = {
            "pack": lambda: GroupPackScheduler(link=self.link),
            "refine": lambda: RefinedPackScheduler(
                link=self.link, seed=self.seed
            ),
            "critical": lambda: CriticalPathScheduler(),
            "heft": lambda: HEFTScheduler(link=self.link),
        }
        return [(n, avail[n]()) for n in self.portfolio if n in avail]

    def run_policy(self, run: SchedulerRun) -> None:
        graph, devices = run.graph, run.cluster.devices
        self.stats = {
            "evals": 0, "filtered": 0, "infeasible_mem": 0,
            "accepted": 0, "kicks": 0, "seed_policy": "pack",
            "seed_makespan": 0.0, "best_makespan": 0.0,
            "static_filter": "off: no search",
        }
        if len(devices) < 2 or not graph.topo_order:
            self.commit(run, self.plan(graph, devices))
            return

        speeds = {d.node_id: d.compute_speed for d in devices}
        slices = run.cluster.slice_ids()
        dev_idx = {d.node_id: i for i, d in enumerate(devices)}

        def evaluate(assign: Dict[str, int]) -> PlacementTimeline:
            placement = {
                tid: devices[d].node_id for tid, d in assign.items()
            }
            return simulate_placement_timeline(
                graph, placement, speeds, self.link, slices
            )

        # -- portfolio seeding: each member runs on a fresh SchedulerRun
        # (which resets the shared graph/cluster), so restore both before
        # committing anything through *this* run
        best_seed: Optional[Dict[str, int]] = None
        best_key: Optional[Tuple[int, float]] = None
        for pname, sched in self._portfolio():
            try:
                s = sched.schedule(graph, run.cluster)
            except Exception:
                continue
            assign = {
                tid: dev_idx[node]
                for tid, node in s.placement.items()
                if node in dev_idx
            }
            if not assign:
                continue
            tl = evaluate(assign)
            key = (len(s.failed), tl.makespan)
            if best_key is None or key < best_key:
                best_key, best_seed = key, assign
                self.stats["seed_policy"] = pname
                self.stats["seed_makespan"] = tl.makespan
        run.graph.reset()
        run.cluster.reset()
        if best_seed is None:  # every heuristic failed: degrade to pack
            self.commit(run, self.plan(graph, devices))
            return

        best = self._anneal(run, best_seed, evaluate, slices)
        self.commit(run, best)

    # -- the annealed search ----------------------------------------------

    def _anneal(self, run, seed_assign, evaluate, slices) -> Dict[str, int]:
        devices = run.cluster.devices
        graph = run.graph
        n_dev = len(devices)
        rng = random.Random(self.seed)
        stats = self.stats

        cur = dict(seed_assign)
        tl = evaluate(cur)
        cur_m = tl.makespan
        best, best_m = dict(cur), cur_m
        stats["best_makespan"] = best_m
        if self.budget <= 0:
            return best

        loads = _DeviceLoads(graph, devices, cur)
        flt = _TaskMoveFilter(run, devices, cur)
        stats["static_filter"] = flt.status
        tids = sorted(cur)
        crit, hops = self._critical_tasks(graph, devices, cur, tl, slices)
        # time_budget_s users opt into a nondeterministic cutoff; the
        # deterministic knob (and the default) is the eval budget
        deadline = (
            # dls-lint: allow(DET001) opt-in wall-time budget
            time.perf_counter() + self.time_budget_s
            if self.time_budget_s is not None else None
        )

        # geometric cooling from a small fraction of the seed makespan
        # down ~4 orders of magnitude across the budget.  The fraction is
        # deliberately tiny: near a balanced seed the real improvements
        # are micro-moves worth ~1e-3 of the makespan, and a warmer start
        # accepts so much uphill drift the walk never exploits them
        t0 = max(cur_m, _EPS) * 0.002
        alpha = math.exp(math.log(1e-4) / max(self.budget, 1))
        temp = t0
        evals = 0
        stall = 0
        stall_limit = max(40, self.budget // 8)
        attempts = 0
        max_attempts = self.budget * 20  # proposal-storm backstop

        def bottleneck_dev() -> int:
            # sorted tie-break: node_finish iterates in set order
            nid = max(tl.node_finish.items(), key=lambda kv: (kv[1], kv[0]))[0]
            return next(
                i for i, d in enumerate(devices) if d.node_id == nid
            )

        def pick_dst(exclude: int) -> int:
            # min-of-two-uniforms over devices sorted lightest-first:
            # biased toward low node_finish, every device still reachable
            order = sorted(
                range(n_dev),
                key=lambda d: (
                    tl.node_finish.get(devices[d].node_id, 0.0),
                    devices[d].node_id,
                ),
            )
            d = order[min(rng.randrange(n_dev), rng.randrange(n_dev))]
            if d == exclude:
                d = order[rng.randrange(n_dev)]
            return d

        def added_gb(tid: str, d: int) -> float:
            """Param GB a move of ``tid`` onto ``d`` would newly load."""
            cnt = loads.counts[d]
            return sum(
                graph.param_size_gb(p)
                for p in sorted(graph[tid].params_needed)
                if p not in cnt
            )

        def cheap_dst(tid: str, src: int) -> int:
            """Lightest device already holding ``tid``'s params (a
            param-free rebalance), else the biased-light fallback."""
            free = [
                d for d in range(n_dev)
                if d != src and added_gb(tid, d) <= 1e-12
            ]
            if free:
                return min(
                    free,
                    key=lambda d: (
                        tl.node_finish.get(devices[d].node_id, 0.0),
                        devices[d].node_id,
                    ),
                )
            return pick_dst(src)

        group_of = {
            t.task_id: (t.group or t.task_id) for t in graph.tasks()
        }

        def slice_scan():
            """Bottleneck-device group slices (heaviest param union first)
            x destinations (lightest finish first) — refine's systematic
            neighborhood rebuilt at the task-slice level.  Walked by a
            cursor so every candidate is tried exactly once per incumbent
            (random sampling of the same set needs coupon-collector many
            draws to cover it, which is why a pure-random mix stalls)."""
            b = bottleneck_dev()
            by_g: Dict[str, List[str]] = {}
            for t in tids:
                if cur[t] == b:
                    by_g.setdefault(group_of.get(t, t), []).append(t)

            def gsize(g: str) -> float:
                names: Set[str] = set()
                for t in by_g[g]:
                    names.update(graph[t].params_needed)
                return sum(graph.param_size_gb(p) for p in sorted(names))

            gs = sorted(by_g, key=lambda g: (-gsize(g), g))
            dests = sorted(
                (d for d in range(n_dev) if d != b),
                key=lambda d: (
                    tl.node_finish.get(devices[d].node_id, 0.0),
                    devices[d].node_id,
                ),
            )
            return b, gs, by_g, dests

        # deterministic sweep cursors.  The heal cursor re-arms on every
        # accept (the critical path genuinely changes); the slice cursor
        # keeps its don't-look state unless the bottleneck signature
        # (device + its group set) changed — without that, every µs-scale
        # heal accept would trigger a futile full re-scan of a slice
        # neighborhood that was just proven improvement-free.
        heal_i = 0
        slice_i = 0
        b_idx, slice_gs, slice_members, slice_dests = slice_scan()
        slice_sig = (b_idx, tuple(slice_gs))

        def rearm() -> None:
            nonlocal heal_i, slice_i, slice_sig
            nonlocal b_idx, slice_gs, slice_members, slice_dests
            heal_i = 0
            b_idx, slice_gs, slice_members, slice_dests = slice_scan()
            sig = (b_idx, tuple(slice_gs))
            if sig != slice_sig:
                slice_sig = sig
                slice_i = 0

        while evals < self.budget and attempts < max_attempts:
            # dls-lint: allow(DET001) opt-in time_budget_s cutoff (see above)
            if deadline is not None and time.perf_counter() >= deadline:
                break
            attempts += 1

            # -- propose ---------------------------------------------------
            # Sweeps first: the two structured neighborhoods are walked
            # to exhaustion (first-improvement descent, cursors reset on
            # every accept) before any randomized proposal runs — an
            # annealed uphill accept mid-sweep would reset the cursors
            # and rob the pass of its coverage guarantee.  Once the
            # incumbent is locally optimal for both sweeps, the annealed
            # random stream (rebalances / blind moves / swaps) takes
            # over, and any accept there re-arms the sweeps.
            r = rng.random()
            moves: List[Tuple[str, int, int]] = []
            sweep = False  # deterministic-sweep candidates accept greedily
            if (
                slice_gs and slice_dests
                and slice_i < 2 * len(slice_gs) * len(slice_dests)
            ):
                # move one (group x bottleneck-device) slice wholesale —
                # the unit a param load is charged per, so this rebalances
                # whole weight-sets the way refine does, but per-slice —
                # or swap it with the lightest slice on the destination
                # (the swap form carries most of the improvement on
                # balanced seeds: a bare move just shifts the bottleneck,
                # an exchange keeps both unions level).  Group-major
                # sweep, heaviest slice first, move-then-swap per
                # destination (lightest first).  Runs before the heal
                # sweep: rebalancing moves the makespan in ~10µs steps,
                # hop healing in ~1µs steps, so the big-step neighborhood
                # must drain first.
                sweep = True
                pair, var = divmod(slice_i, 2)
                gi, di = divmod(pair, len(slice_dests))
                slice_i += 1
                g_name = slice_gs[gi]
                src, dst = b_idx, slice_dests[di]
                moves = [(t, src, dst) for t in slice_members[g_name]]
                if var == 1:
                    # swap: pull the lightest group-slice on dst back
                    there: Dict[str, List[str]] = {}
                    for t in tids:
                        if cur[t] == dst:
                            there.setdefault(
                                group_of.get(t, t), []
                            ).append(t)

                    def usize(gname: str) -> float:
                        names: Set[str] = set()
                        for t in there[gname]:
                            names.update(graph[t].params_needed)
                        return sum(
                            graph.param_size_gb(p) for p in sorted(names)
                        )

                    if not there:
                        continue
                    g2 = min(sorted(there), key=usize)
                    if g2 == g_name:
                        continue
                    moves += [(t, dst, src) for t in there[g2]]
            elif hops and heal_i < 4 * len(hops):
                # collapse a binding cross-device hop on the critical
                # path: co-locate its endpoints.  Four variants per hop —
                # move either endpoint, alone or with its whole
                # group-slice (the slice form keeps a weight-set's tasks
                # together; it is the shape of the winning "pull the tail
                # group onto its producer's device" moves).  Hop-major
                # sweep: all single moves across hops first, then slices.
                sweep = True
                k, var = heal_i % len(hops), heal_i // len(hops)
                heal_i += 1
                prod, cons = hops[k]
                if var % 2 == 0:
                    tid, dst = cons, cur[prod]  # push consumer to producer
                else:
                    tid, dst = prod, cur[cons]  # pull producer to consumer
                src = cur[tid]
                if dst == src:
                    continue
                if var >= 2:
                    g_name = group_of.get(tid, tid)
                    moves = [
                        (t, src, dst) for t in tids
                        if cur[t] == src and group_of.get(t, t) == g_name
                    ]
                else:
                    moves = [(tid, src, dst)]
            elif r < self.P_REBALANCE:
                # param-free rebalance off the bottleneck device
                on_b = [t for t in tids if cur[t] == b_idx]
                if not on_b:
                    continue
                tid = on_b[rng.randrange(len(on_b))]
                src = b_idx
                dst = cheap_dst(tid, src)
                if dst == src:
                    continue
                moves = [(tid, src, dst)]
                if rng.random() < self.P_SWAP:
                    there = [t for t in tids if cur[t] == dst]
                    if there:
                        t2 = there[rng.randrange(len(there))]
                        moves.append((t2, dst, src))
            else:
                # blind exploration: any task, biased-light destination
                tid = tids[rng.randrange(len(tids))]
                src = cur[tid]
                dst = pick_dst(src)
                if dst == src:
                    continue
                moves = [(tid, src, dst)]
                if rng.random() < self.P_SWAP:
                    there = [t for t in tids if cur[t] == dst]
                    if there:
                        t2 = there[rng.randrange(len(there))]
                        moves.append((t2, dst, src))

            # -- memory feasibility (cheap, incremental) ------------------
            for t, s, d in moves:
                loads.remove(t, s)
                loads.add(t, d)
            feasible = all(loads.fits(d) for _, _, d in moves)
            if not feasible:
                for t, s, d in reversed(moves):
                    loads.remove(t, d)
                    loads.add(t, s)
                stats["infeasible_mem"] += 1
                continue

            cand = dict(cur)
            for t, _, d in moves:
                cand[t] = d

            # -- static pre-filter: reject before paying for the replay ---
            if not flt.ok(cand):
                for t, s, d in reversed(moves):
                    loads.remove(t, d)
                    loads.add(t, s)
                continue

            # -- score + SA acceptance ------------------------------------
            cand_tl = evaluate(cand)
            evals += 1
            m = cand_tl.makespan
            delta = m - cur_m
            # sweep candidates accept strictly downhill only: an uphill
            # drift mid-sweep would reset the cursors and rob the
            # systematic pass of its coverage guarantee.  The random
            # stream anneals as usual.
            if delta < -self.tol or (
                not sweep
                and temp > _EPS
                and rng.random() < math.exp(-delta / temp)
            ):
                cur, cur_m, tl = cand, m, cand_tl
                flt.sync(cand, verify=self.verify_filter)
                crit, hops = self._critical_tasks(
                    graph, devices, cur, tl, slices
                )
                rearm()
                stats["accepted"] += 1
                if m < best_m - self.tol:
                    best, best_m = dict(cand), m
                    stall = 0
                else:
                    stall += 1
            else:
                for t, s, d in reversed(moves):
                    loads.remove(t, d)
                    loads.add(t, s)
                stall += 1
            temp *= alpha

            # -- kick: perturb off the best incumbent, re-warm ------------
            if stall >= stall_limit and evals < self.budget:
                stats["kicks"] += 1
                stall = 0
                # restore incumbent (and its memory/analyzer mirrors)
                for t, d in best.items():
                    if cur[t] != d:
                        loads.remove(t, cur[t])
                        loads.add(t, d)
                cur = dict(best)
                for _ in range(3):
                    t = tids[rng.randrange(len(tids))]
                    d = rng.randrange(n_dev)
                    if d == cur[t]:
                        continue
                    loads.remove(t, cur[t])
                    loads.add(t, d)
                    if loads.fits(d):
                        cur[t] = d
                    else:
                        loads.add(t, cur[t])
                        loads.remove(t, d)
                if flt.ok(cur):
                    flt.sync(cur, verify=self.verify_filter)
                else:
                    # perturbation statically invalid: fall back to best
                    for t, d in best.items():
                        if cur[t] != d:
                            loads.remove(t, cur[t])
                            loads.add(t, d)
                    cur = dict(best)
                    flt.sync(cur, verify=self.verify_filter)
                tl = evaluate(cur)
                evals += 1
                cur_m = tl.makespan
                crit, hops = self._critical_tasks(
                    graph, devices, cur, tl, slices
                )
                # a kick teleports the incumbent: all don't-look state is
                # invalid, so both sweeps restart from scratch
                rearm()
                slice_sig = (b_idx, tuple(slice_gs))
                slice_i = 0
                temp = t0 * 0.5

        stats["evals"] = evals
        stats["filtered"] = flt.rejected
        stats["best_makespan"] = best_m
        return best

    # -- critical path on the simulated timeline ---------------------------

    def _critical_tasks(
        self, graph, devices, assign: Dict[str, int],
        tl: PlacementTimeline, slices: Dict[str, int],
    ) -> Tuple[List[str], List[Tuple[str, str]]]:
        """Walk the event-sim timeline backward from the last finish,
        following the latest-release predecessor at each step (incoming
        dependency arrival incl. transfer vs. the prior task's finish on
        the same device) — the same binding rule ``obs/attribution.py``
        applies to measured traces.

        Returns ``(path, hops)``: the critical tasks, and every
        **cross-device dependency edge that bound a start time** as
        ``(producer, consumer)`` pairs.  Each hop pays the link's transfer
        latency on the critical path, so collapsing one (co-locating its
        endpoints) is the highest-yield move the search can propose — on
        load-balanced placements the residual makespan above the param
        floor is almost entirely these hops plus node serialization."""
        if not tl.finish:
            return [], []
        topo_pos = {t: i for i, t in enumerate(graph.topo_order)}
        node_of = {tid: devices[d].node_id for tid, d in assign.items()}
        by_node: Dict[str, List[str]] = {}
        for tid in sorted(
            tl.start_at, key=lambda t: (tl.start_at[t], topo_pos[t])
        ):
            by_node.setdefault(node_of[tid], []).append(tid)
        pos_on_node = {
            t: i for lst in by_node.values() for i, t in enumerate(lst)
        }
        cur = max(tl.finish, key=lambda t: (tl.finish[t], topo_pos[t]))
        path: List[str] = []
        hops: List[Tuple[str, str]] = []
        seen: Set[str] = set()
        while cur is not None and cur not in seen:
            seen.add(cur)
            path.append(cur)
            start = tl.start_at.get(cur, 0.0)
            if start <= _EPS:
                break
            nid = node_of[cur]
            best_rel, best = -1.0, None
            for dep in graph[cur].dependencies:
                if dep not in tl.finish:
                    continue
                rel = tl.finish[dep]
                if node_of[dep] != nid:
                    rel += self.link.transfer_time(
                        graph.output_gb(dep),
                        src_slice=slices.get(node_of[dep]),
                        dst_slice=slices.get(nid),
                    )
                if rel > best_rel:
                    best_rel, best = rel, dep
            i = pos_on_node[cur]
            if i > 0:
                prev = by_node[nid][i - 1]
                if tl.finish[prev] >= best_rel:
                    best_rel, best = tl.finish[prev], prev
            if best is not None and node_of[best] != nid:
                hops.append((best, cur))
            cur = best
        return path, hops


__all__ = ["SearchScheduler", "placement_digest"]
