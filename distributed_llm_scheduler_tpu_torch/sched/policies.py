"""The policy registry: the reference's four policies plus six new ones.

PyTorch port of ``distributed_llm_scheduler_tpu.sched.policies``; the
policies are framework-free copies and must give equal schedules.

DFS/Greedy/CriticalPath/MRU mirror the reference's observed behavior
(reference ``schedulers.py:138-525``); RoundRobin is the new comparator
baseline the north-star benchmark measures against (BASELINE.md); HEFT
(:mod:`.heft`) is the communication-aware policy built to win it.  The four
reference policies share the ``_round_loop`` skeleton in :mod:`.base`; each
supplies only a ready-set ordering and a node-picking rule.

The one deliberate divergence from the reference: MRU's node *scoring* is
side-effect free here.  The reference performs real evictions while merely
scoring candidate nodes (reference ``schedulers.py:492``, rolled back only
on shortfall) — we score with a hypothetical eviction plan and apply it only
on the chosen node, keeping the reference's scoring semantics without the
state-mutation bug (SURVEY.md §2 quirks).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..core.cluster import DeviceState
from ..core.graph import Task
from .base import BaseScheduler, SchedulerRun


class RoundRobinScheduler(BaseScheduler):
    """Cyclic placement, ignoring locality: the north-star comparator.

    Ready tasks are taken in DAG insertion order; each goes to the next
    device in cyclic order that can fit it (params + activation).  No
    cache-awareness, no load model — the "do nothing clever" baseline.
    """

    name = "roundrobin"

    def run_policy(self, run: SchedulerRun) -> None:
        cursor = [0]
        devices = run.cluster.devices

        def order(run, ready):
            return ready

        def pick(run, task, ready_ids) -> Optional[DeviceState]:
            n = len(devices)
            for i in range(n):
                node = devices[(cursor[0] + i) % n]
                if self.can_fit(run, task, node):
                    cursor[0] = (cursor[0] + i + 1) % n
                    return node
            return None

        self._round_loop(run, order, pick)


class DFSScheduler(BaseScheduler):
    """Depth-first policy (reference ``schedulers.py:138-208``).

    Each round sorts ready tasks deepest-first (DAG depth from roots) and
    assigns each to the fitting node with the most available memory.

    Divergence from the reference: candidates pass the load-band filter
    (``BaseScheduler.load_band``) first.  When params are shared across
    microbatches, available memory barely moves within a round, so the
    reference rule dumps an entire ready set on one node (3x round-robin
    on the 5k-task Llama probe).
    """

    name = "dfs"

    def run_policy(self, run: SchedulerRun) -> None:
        depth = run.graph.depths()

        def order(run, ready):
            return sorted(ready, key=lambda t: -depth[t.task_id])

        def pick(run, task, ready_ids) -> Optional[DeviceState]:
            fitting = [n for n in run.cluster if self.can_fit(run, task, n)]
            if not fitting:
                return None
            return max(self.load_band(run, task, fitting),
                       key=lambda n: n.available_memory)

        self._round_loop(run, order, pick)


class GreedyScheduler(BaseScheduler):
    """Parameter-locality greedy (reference ``schedulers.py:211-296``).

    Picks the node minimizing the number of params that would need loading,
    tie-broken by most available memory (the reference tie-break).  (The
    reference also defines a chain-identification helper its ``schedule``
    never calls — SURVEY.md §2; we implement the code's actual behavior.)

    Divergence from the reference: the load-band filter
    (``BaseScheduler.load_band``) bounds concentration.  Pure param-overlap
    scoring sends every microbatch of a layer to the node that cached the
    layer's weights first, forever — 11x worse than round-robin on the
    5k-task Llama probe (ICI_r04.json; VERDICT r4 next #3).
    """

    name = "greedy"

    # tighter base band than the other policies: greedy's primary key
    # (min params-to-load) ALWAYS takes the most-cached in-band node, so
    # at the default width it concentrates 2.5x round-robin on the
    # 5k-task probe; one task-time keeps it at 1.96x with the full-hit
    # exception still carrying expert locality
    LOAD_BAND_FACTOR = 1.0

    def run_policy(self, run: SchedulerRun) -> None:
        def order(run, ready):
            return ready

        def pick(run, task, ready_ids) -> Optional[DeviceState]:
            fitting = [n for n in run.cluster if self.can_fit(run, task, n)]
            best, best_key = None, None
            for node in self.load_band(run, task, fitting):
                to_load = sum(
                    1 for p in task.params_needed if p not in node.cached_params
                )
                key = (to_load, -node.available_memory)
                if best_key is None or key < best_key:
                    best, best_key = node, key
            return best

        self._round_loop(run, order, pick)


class CriticalPathScheduler(BaseScheduler):
    """HEFT-flavored makespan policy (reference ``schedulers.py:299-372``).

    Ready tasks sorted by longest downstream critical-path length (own time
    + max over dependents), assigned to the **fastest** fitting node.

    Divergence from the reference: the load-band filter
    (``BaseScheduler.load_band``) applies before the speed pick — without
    it, equal-speed clusters degrade to the dfs dump-on-one-node pathology
    (3x round-robin, and memory exhaustion from param duplication, on the
    5k-task Llama probe).
    """

    name = "critical"

    def run_policy(self, run: SchedulerRun) -> None:
        cpl = run.graph.critical_path_lengths()

        def order(run, ready):
            return sorted(ready, key=lambda t: -cpl[t.task_id])

        def pick(run, task, ready_ids) -> Optional[DeviceState]:
            fitting = [n for n in run.cluster if self.can_fit(run, task, n)]
            if not fitting:
                return None
            return max(self.load_band(run, task, fitting),
                       key=lambda n: (n.compute_speed, n.available_memory))

        self._round_loop(run, order, pick)


class MRUScheduler(BaseScheduler):
    """Cache-aware policy with predictive eviction (reference
    ``schedulers.py:375-525``).

    Keeps per-param usage frequency and recency under a logical clock;
    eviction score (higher = keep) is
    ``10*frequency + 100/(recency+1) + 1000 if needed by any ready pending
    task`` (reference ``schedulers.py:383-402``).  Node choice scores
    ``20*cached-param-overlap + (available_memory if the task fits without
    eviction else 5) - 0.5*completed-task count`` (reference
    ``schedulers.py:444-525`` — the two bonuses are mutually exclusive),
    and ready tasks are ordered by how many pending dependents they unblock.
    """

    name = "mru"

    # scoring weights, verbatim from the reference (SURVEY.md §2 #7)
    W_FREQ = 10.0
    W_RECENCY = 100.0
    W_NEEDED = 1000.0
    W_OVERLAP = 20.0
    W_FITS_AFTER_EVICT = 5.0
    W_LOAD_PENALTY = 0.5

    def run_policy(self, run: SchedulerRun) -> None:
        usage_count: Dict[str, int] = {}
        last_used: Dict[str, int] = {}
        clock = [0]

        def eviction_score(run: SchedulerRun, param: str,
                           ready_ids: List[str]) -> float:
            score = self.W_FREQ * usage_count.get(param, 0)
            recency = clock[0] - last_used.get(param, -clock[0])
            score += self.W_RECENCY / (recency + 1)
            for tid in ready_ids:
                if tid in run.pending and param in run.graph[tid].params_needed:
                    score += self.W_NEEDED
                    break
            return score

        def eviction_plan(run: SchedulerRun, task: Task, node: DeviceState,
                          ready_ids: List[str]) -> Optional[List[Tuple[str, float]]]:
            """Lowest-score-first params to evict so `task` fits; None if
            even evicting everything evictable isn't enough.  Pure."""
            need = self.memory_requirement(run, task, node)
            deficit = need - node.available_memory
            if deficit <= 1e-9:
                return []
            candidates = sorted(
                p for p in node.cached_params if p not in task.params_needed
            )
            # stable sort over the name-ordered list: ties break by name, so
            # eviction order is deterministic (and native-engine parity holds)
            candidates.sort(key=lambda p: eviction_score(run, p, ready_ids))
            plan: List[Tuple[str, float]] = []
            freed = 0.0
            for p in candidates:
                size = run.graph.param_size_gb(p)
                plan.append((p, size))
                freed += size
                if freed >= deficit - 1e-9:
                    return plan
            return None

        def order(run, ready):
            pending_dependents = {
                t.task_id: sum(
                    1 for d in run.graph.dependents(t.task_id) if d in run.pending
                )
                for t in ready
            }
            return sorted(ready, key=lambda t: -pending_dependents[t.task_id])

        def pick(run, task, ready_ids) -> Optional[DeviceState]:
            # candidates = nodes that fit (possibly after eviction); the
            # load band applies on top — the overlap bonus otherwise
            # concentrates shared-param work just like greedy (8x
            # round-robin on the 5k-task Llama probe, VERDICT r4 next #3)
            candidates = [
                (node, plan) for node in run.cluster
                if (plan := eviction_plan(run, task, node, ready_ids))
                is not None
            ]
            eligible = {
                n.node_id
                for n in self.load_band(run, task, [n for n, _ in candidates])
            }
            best, best_score, best_plan = None, None, None
            for node, plan in candidates:
                if node.node_id not in eligible:
                    continue
                overlap = len(task.params_needed & node.cached_params)
                # Reference conditional scoring (schedulers.py:487-493):
                # a node that fits WITHOUT eviction earns its available
                # memory; one that needs eviction earns only the flat +5.
                # The two bonuses are mutually exclusive — an empty plan
                # means no eviction needed (ADVICE r1 #3).
                score = (
                    self.W_OVERLAP * overlap
                    + (node.available_memory if not plan
                       else self.W_FITS_AFTER_EVICT)
                    - self.W_LOAD_PENALTY * len(node.completed_tasks)
                )
                if best_score is None or score > best_score:
                    best, best_score, best_plan = node, score, plan
            if best is None:
                return None
            for p, size in best_plan:
                self.evict_param(run, best, p, size)
            # usage bookkeeping under the logical clock
            for p in task.params_needed:
                usage_count[p] = usage_count.get(p, 0) + 1
                last_used[p] = clock[0]
            clock[0] += 1
            return best

        self._round_loop(run, order, pick)


from .heft import HEFTScheduler  # noqa: E402  (avoids a circular import)
from .pack import GroupPackScheduler  # noqa: E402
from .pipeline import PipelineStageScheduler  # noqa: E402
from .refine import RefinedPackScheduler  # noqa: E402
from .search import SearchScheduler  # noqa: E402

ALL_SCHEDULERS = {
    cls.name: cls
    for cls in (
        RoundRobinScheduler,
        DFSScheduler,
        GreedyScheduler,
        CriticalPathScheduler,
        MRUScheduler,
        HEFTScheduler,
        PipelineStageScheduler,
        GroupPackScheduler,
        RefinedPackScheduler,
        SearchScheduler,
    )
}


def get_scheduler(name: str, link=None, **kwargs) -> BaseScheduler:
    """Policy by name.  ``"native:<policy>"`` selects the C++ engine
    explicitly; ``DLS_NATIVE=1`` upgrades every natively-supported policy
    (parity-tested: identical schedules, faster wall time).  A failed
    engine build raises in both cases: the Python policy never runs in
    the engine's place.

    ``link`` hands link-aware policies (any whose constructor takes a
    ``link=`` keyword) the same cost model the replay charges — required
    for DCN-aware multislice runs.  An explicit ``"native:..."`` request
    with a tiered link raises (the C ABI is flat-link only); under
    ``DLS_NATIVE=1`` a tiered link keeps the Python policy, so the tiered
    costs are honored.

    Extra ``kwargs`` (e.g. ``budget``/``seed`` for the search tier) are
    forwarded only to policies whose constructor declares them, so one
    call site can configure the whole registry uniformly.
    """
    import inspect

    from ..backends.sim import TieredLinkModel
    from ..utils.env import env_str

    tiered = isinstance(link, TieredLinkModel)
    if name.startswith("native:"):
        from .native import NativeScheduler

        return NativeScheduler(name.split(":", 1)[1], link=link)
    if name not in ALL_SCHEDULERS:
        raise ValueError(
            f"unknown scheduler {name!r}; available: {sorted(ALL_SCHEDULERS)}"
        )
    if env_str("DLS_NATIVE") == "1" and not tiered:
        from .. import native as native_mod
        from .native import NativeScheduler

        if name in native_mod.POLICY_IDS:
            native_mod.load_engine()  # a failed build raises here
            return NativeScheduler(name, link=link)
    cls = ALL_SCHEDULERS[name]
    params = inspect.signature(cls.__init__).parameters
    accepted = {
        k: v for k, v in kwargs.items() if k in params and v is not None
    }
    if link is not None and "link" in params:
        accepted["link"] = link
    return cls(**accepted)
