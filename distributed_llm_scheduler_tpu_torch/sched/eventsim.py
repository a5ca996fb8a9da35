"""Dependency-aware per-node ordering for a fixed placement.

PyTorch port of ``distributed_llm_scheduler_tpu.sched.eventsim``; it is
framework-free, so this is a copy that must give equal orders, makespans
and per-task times.

A :class:`Schedule`'s per-node lists are executed **in order** by both
backends, so a placement-correct schedule can still serialize terribly if
its order induces head-of-line blocking: a task queued early on a node
blocks everything behind it while it waits for a slow cross-node input.
Round-loop policies emit Kahn-wave order, which for microbatched pipeline
DAGs is the worst case.

:func:`dependency_aware_order` fixes the *order* without touching the
*placement*: an event-driven simulation under the cost model the replay
charges (per-node serial execution, cross-node transfer on dependency
edges, prefetched parameter loads queued per node in first-use order).
Whenever a node is free it starts the **deepest** task whose inputs have
already arrived — depth-first within a node drives one microbatch through
a whole stage before starting the next, so 1F1B interleaving emerges from
the DAG structure.  If nothing has arrived yet, the earliest-arriving
task is taken instead.  The returned order is sorted by simulated start
time.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..backends.sim import LinkModel
from ..core.graph import TaskGraph

_EPS = 1e-12


@dataclass
class PlacementTimeline:
    """Full event-sim outcome for one placement.

    ``simulate_placement`` keeps the ``(order, makespan, node_finish)``
    triple; the timeline also carries per-task ``start_at``/``finish``.
    """

    order: List[str] = field(default_factory=list)
    makespan: float = 0.0
    node_finish: Dict[str, float] = field(default_factory=dict)
    start_at: Dict[str, float] = field(default_factory=dict)
    finish: Dict[str, float] = field(default_factory=dict)


def dependency_aware_order(
    graph: TaskGraph,
    placement: Dict[str, str],
    speeds: Optional[Dict[str, float]] = None,
    link: Optional[LinkModel] = None,
    slices: Optional[Dict[str, int]] = None,
) -> List[str]:
    """Order placed tasks to minimize head-of-line blocking.

    Args:
      graph: frozen task graph (tasks not in ``placement`` are skipped —
        they failed placement and never become ready).
      placement: task_id -> node_id for every placed task.
      speeds: node_id -> compute speed (default 1.0).
      link: cost model for cross-node dependency transfers and parameter
        loads (defaults to :class:`LinkModel` defaults).
      slices: node_id -> slice_id (``Cluster.slice_ids()``); lets a
        :class:`~..backends.sim.TieredLinkModel` charge DCN on cross-slice
        edges.  Omitted: every hop is charged at the ICI tier.

    Returns:
      All placed task_ids ordered by simulated start time (ties broken by
      topological position).
    """
    order, _, _ = simulate_placement(graph, placement, speeds, link, slices)
    return order


def simulate_placement(
    graph: TaskGraph,
    placement: Dict[str, str],
    speeds: Optional[Dict[str, float]] = None,
    link: Optional[LinkModel] = None,
    slices: Optional[Dict[str, int]] = None,
) -> Tuple[List[str], float, Dict[str, float]]:
    """The event simulation behind :func:`dependency_aware_order`, with its
    cost estimates exposed: ``(order, makespan, node_finish)``.

    ``makespan`` is the max simulated finish over placed tasks and
    ``node_finish`` each node's last finish, under the cost model the
    ordering pass and the replay charge (the pipeline policy costs its
    candidate stage plans with it).
    """
    tl = simulate_placement_timeline(graph, placement, speeds, link, slices)
    return tl.order, tl.makespan, tl.node_finish


def simulate_placement_timeline(
    graph: TaskGraph,
    placement: Dict[str, str],
    speeds: Optional[Dict[str, float]] = None,
    link: Optional[LinkModel] = None,
    slices: Optional[Dict[str, int]] = None,
) -> PlacementTimeline:
    """:func:`simulate_placement` with the per-task times kept
    (``start_at``/``finish``), from which a simulated critical path can be
    walked backward."""
    link = link or LinkModel()
    speeds = speeds or {}
    slices = slices or {}
    topo_pos = {tid: i for i, tid in enumerate(graph.topo_order)}
    depth = graph.depths()

    # per-node ready lists: tasks whose deps all completed, with the time
    # their last input arrives on this node
    ready: Dict[str, List[Tuple[str, float]]] = {}
    node_free: Dict[str, float] = {}
    load_queue_end: Dict[str, float] = {}
    cached: Dict[str, set] = {}
    for nid in sorted(set(placement.values())):
        ready[nid] = []
        node_free[nid] = 0.0
        load_queue_end[nid] = 0.0
        cached[nid] = set()

    missing_deps: Dict[str, int] = {}
    arrival: Dict[str, float] = {}
    finish: Dict[str, float] = {}
    start_at: Dict[str, float] = {}

    for tid in graph.topo_order:
        if tid not in placement:
            continue
        placed_deps = [d for d in graph[tid].dependencies if d in placement]
        missing_deps[tid] = len(placed_deps)
        arrival[tid] = 0.0
        if not placed_deps:
            ready[placement[tid]].append((tid, 0.0))

    # completion event queue: (finish time, topo position, tid)
    events: List[Tuple[float, int, str]] = []

    def dispatch(nid: str) -> None:
        """If `nid` has ready work, start one task: the deepest among those
        whose inputs arrived by the time the node frees up (1F1B), else the
        one arriving soonest.  Params enqueue on the node's host link at
        first use, mirroring SimulatedBackend's prefetch model."""
        lst = ready[nid]
        if not lst:
            return
        now = node_free[nid]
        arrived = [
            (depth[t], -topo_pos[t], i)
            for i, (t, arr) in enumerate(lst)
            if arr <= now + _EPS
        ]
        if arrived:
            _, _, idx = max(arrived)
        else:
            idx = min(
                range(len(lst)), key=lambda i: (lst[i][1], topo_pos[lst[i][0]])
            )
        tid, dep_ready = lst.pop(idx)
        task = graph[tid]
        params_ready = 0.0
        for p in sorted(task.params_needed):
            if p not in cached[nid]:
                cached[nid].add(p)
                load_queue_end[nid] += link.param_load_time(
                    graph.param_size_gb(p)
                )
                params_ready = max(params_ready, load_queue_end[nid])
        start = max(now, dep_ready, params_ready)
        dur = task.compute_time / speeds.get(nid, 1.0)
        start_at[tid] = start
        finish[tid] = start + dur
        node_free[nid] = start + dur  # node committed (serial execution)
        heapq.heappush(events, (start + dur, topo_pos[tid], tid))

    for nid in ready:
        dispatch(nid)

    while events:
        t_done, _, tid = heapq.heappop(events)
        nid = placement[tid]
        for dep in graph.dependents(tid):
            if dep not in placement or dep not in missing_deps:
                continue
            dep_nid = placement[dep]
            arr = finish[tid]
            if dep_nid != nid:
                arr += link.transfer_time(
                    graph.output_gb(tid),
                    src_slice=slices.get(nid),
                    dst_slice=slices.get(dep_nid),
                )
            arrival[dep] = max(arrival[dep], arr)
            missing_deps[dep] -= 1
            if missing_deps[dep] == 0:
                ready[dep_nid].append((dep, arrival[dep]))
                if node_free[dep_nid] <= arrival[dep]:
                    dispatch(dep_nid)
        dispatch(nid)  # node just freed: start its next ready task

    # any still-undispatched ready tasks (nodes that went idle before work
    # arrived): flush deterministically
    for nid in ready:
        while ready[nid]:
            dispatch(nid)

    placed = [tid for tid in graph.topo_order if tid in placement]
    order = sorted(placed, key=lambda t: (start_at.get(t, 0.0), topo_pos[t]))
    node_finish = {nid: 0.0 for nid in ready}
    for tid, f in finish.items():
        nid = placement[tid]
        node_finish[nid] = max(node_finish[nid], f)
    makespan = max(node_finish.values(), default=0.0)
    return PlacementTimeline(
        order=order,
        makespan=makespan,
        node_finish=node_finish,
        start_at=start_at,
        finish=finish,
    )
