"""Mechanical fixes for the auto-repairable diagnostics (``lint --fix``).

Only findings whose repair is provably behavior-preserving get a fixer:

* ``DAG003`` (duplicate dependency): dependency *edges* are a set
  semantically, but ``Task.arg_tasks`` — which defaults to the
  dependency list — is positional, so deduplicating in place would
  silently change a task's call arity.  The fixer therefore pins
  ``arg_tasks`` to the original (duplicated) list before deduplicating
  ``dependencies``.
* ``SCH005``/``PIP001`` (order inversions): a schedule whose per-node
  lists disagree with the global order or run a task before a same-node
  dependency is re-linearized.  Re-sorting changes only *when* tasks
  run, never *where* — placement is preserved exactly, so any legal
  topological order is behavior-preserving.

PyTorch port's copy of ``distributed_llm_scheduler_tpu.analysis.fixes``,
whole: the module is framework-free.
"""

from __future__ import annotations

import heapq
from typing import List, Optional

from ..core.graph import TaskGraph
from ..core.schedule import Schedule


def fix_duplicate_dependencies(graph: TaskGraph) -> List[str]:
    """Deduplicate every task's ``dependencies`` in place, first-occurrence
    order preserved.  Tasks relying on the arg_tasks-defaults-to-deps
    behavior keep their fn call arity: the original list is pinned as
    ``arg_tasks`` before the dedup.  Returns the ids of the tasks fixed.
    """
    was_frozen = graph._topo is not None
    fixed: List[str] = []
    for t in graph.tasks():
        if len(t.dependencies) == len(set(t.dependencies)):
            continue
        if t.arg_tasks is None:
            t.arg_tasks = list(t.dependencies)
        seen = set()
        deduped = []
        for d in t.dependencies:
            if d not in seen:
                seen.add(d)
                deduped.append(d)
        t.dependencies = deduped
        fixed.append(t.task_id)
    if fixed and was_frozen:
        graph.freeze()  # rebuild the cached dependents/topo edge state
    return fixed


def _order_violations(graph: TaskGraph, schedule: Schedule) -> bool:
    """True when any per-node list violates SCH005 (ranks out of step
    with ``assignment_order``) or PIP001 (task before a same-node
    dependency)."""
    pos = {t: i for i, t in enumerate(schedule.assignment_order)}
    placement = schedule.placement
    for node, tasks in schedule.per_node.items():
        ranks = [pos[t] for t in tasks if t in pos]
        if any(b < a for a, b in zip(ranks, ranks[1:])):
            return True  # SCH005
        done = set()
        for t in tasks:
            try:
                deps = graph[t].dependencies
            except KeyError:
                deps = []
            for d in deps:
                if placement.get(d) == node and d not in done:
                    if d in tasks:
                        return True  # PIP001
            done.add(t)
    return False


def fix_per_node_order(
    graph: TaskGraph, schedule: Schedule,
) -> Optional[List[str]]:
    """Re-linearize a schedule whose orders violate SCH005/PIP001.

    Builds one global topological order over the placed tasks (Kahn's
    algorithm with the task's current ``assignment_order`` position as
    the tie-break priority, so the repaired order stays as close to the
    original intent as a legal order allows), then rewrites
    ``assignment_order`` and every ``per_node`` list as filtered views
    of it.  Placement is untouched.

    Returns the node ids whose per-node list changed (the literal
    ``"assignment_order"`` when only the global order moved), ``[]``
    when the schedule was already legal, and ``None`` when no legal
    topological order exists (a dependency cycle among the placed
    tasks — that is DAG001 territory, not fixable by re-sorting).
    """
    if not _order_violations(graph, schedule):
        return []
    placement = schedule.placement
    placed = set(placement)
    indeg = {t: 0 for t in placed}
    dependents: dict = {t: [] for t in placed}
    for t in placed:
        try:
            deps = graph[t].dependencies
        except KeyError:
            continue
        for d in sorted(set(deps)):
            if d in placed and d != t:
                indeg[t] += 1
                dependents[d].append(t)
    big = len(schedule.assignment_order)
    pos = {t: i for i, t in enumerate(schedule.assignment_order)}

    def key(t: str):
        return (pos.get(t, big), t)

    heap = [(key(t), t) for t in placed if indeg[t] == 0]
    heapq.heapify(heap)
    order: List[str] = []
    while heap:
        _, t = heapq.heappop(heap)
        order.append(t)
        for u in dependents[t]:
            indeg[u] -= 1
            if indeg[u] == 0:
                heapq.heappush(heap, (key(u), u))
    if len(order) != len(placed):
        return None  # cycle among placed tasks: no legal order exists
    new_per_node = {
        n: [t for t in order if placement[t] == n]
        for n in schedule.per_node
    }
    changed = sorted(
        n for n in schedule.per_node
        if new_per_node[n] != schedule.per_node[n]
    )
    if not changed and order != list(schedule.assignment_order):
        changed = ["assignment_order"]
    schedule.assignment_order = order
    for n in schedule.per_node:
        schedule.per_node[n][:] = new_per_node[n]
    return changed
