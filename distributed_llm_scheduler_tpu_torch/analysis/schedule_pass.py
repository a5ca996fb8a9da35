"""Pass 2a — schedule consistency (the old core/validate.py checks).

Independent checker over the :class:`Schedule` contract, sharing no code
with the policies it checks: placement integrity, order permutation and
per-node subsequence consistency, completed/failed partition coverage, and
dependency ordering.  Message texts are kept byte-compatible with the
historical ``validate_schedule`` violations (tests assert on substrings).

PyTorch port's copy of ``distributed_llm_scheduler_tpu.analysis.
schedule_pass``; framework-free, so the findings are identical.
"""

from __future__ import annotations

from typing import Dict

from ..core.cluster import Cluster
from ..core.graph import TaskGraph
from ..core.schedule import Schedule
from .diagnostics import AnalysisReport, Severity


def placement_of(
    graph: TaskGraph, cluster: Cluster, schedule: Schedule, rep: AnalysisReport
) -> Dict[str, str]:
    """First-wins task->node map; emits SCH001/SCH002/SCH003 on the way."""
    placed: Dict[str, str] = {}
    for nid, tids in schedule.per_node.items():
        if nid not in cluster:
            rep.add(
                "SCH001",
                Severity.ERROR,
                f"per_node references unknown device {nid!r}",
                node=nid,
            )
            continue
        for tid in tids:
            if tid not in graph:
                rep.add(
                    "SCH002",
                    Severity.ERROR,
                    f"{tid!r} on {nid} is not a graph task",
                    task=tid,
                    node=nid,
                )
            elif tid in placed:
                rep.add(
                    "SCH003",
                    Severity.ERROR,
                    f"{tid!r} placed on both {placed[tid]} and {nid}",
                    task=tid,
                    node=nid,
                )
            else:
                placed[tid] = nid
    return placed


def analyze_schedule(
    graph: TaskGraph, cluster: Cluster, schedule: Schedule
) -> AnalysisReport:
    rep = AnalysisReport()
    placed = placement_of(graph, cluster, schedule, rep)

    # global order: a permutation of placed tasks
    order = schedule.assignment_order
    if sorted(order) != sorted(placed):
        rep.add(
            "SCH004",
            Severity.ERROR,
            "assignment_order is not a permutation of the placed tasks",
        )
    pos = {tid: i for i, tid in enumerate(order)}

    # per-node lists must be subsequences of the global order
    for nid, tids in schedule.per_node.items():
        ranks = [pos[t] for t in tids if t in pos]
        if ranks != sorted(ranks):
            rep.add(
                "SCH005",
                Severity.ERROR,
                f"per_node[{nid}] order disagrees with assignment_order",
                node=nid,
            )

    # completed/failed partition — and total coverage: a scheduler that
    # silently DROPS tasks (or returns an empty schedule) must not validate
    if schedule.completed & schedule.failed:
        rep.add(
            "SCH006", Severity.ERROR, "completed and failed sets overlap"
        )
    unaccounted = set(graph.task_ids()) - schedule.completed - schedule.failed
    for tid in sorted(unaccounted)[:20]:
        rep.add(
            "SCH007",
            Severity.ERROR,
            f"{tid!r} neither completed nor failed",
            task=tid,
        )
    if len(unaccounted) > 20:
        rep.add(
            "SCH007",
            Severity.ERROR,
            f"...and {len(unaccounted) - 20} more unaccounted tasks",
        )
    for tid in schedule.completed:
        if tid not in placed:
            rep.add(
                "SCH008",
                Severity.ERROR,
                f"completed task {tid!r} has no placement",
                task=tid,
            )
    for tid in placed:
        if tid not in schedule.completed:
            rep.add(
                "SCH008",
                Severity.ERROR,
                f"placed task {tid!r} not marked completed",
                task=tid,
            )

    # dependency order + failed-dependency propagation
    for tid in placed:
        if tid not in graph:
            continue
        for d in graph[tid].dependencies:
            if d in schedule.failed:
                rep.add(
                    "SCH010",
                    Severity.ERROR,
                    f"{tid!r} completed but its dependency {d!r} failed",
                    task=tid,
                )
            elif d not in placed:
                rep.add(
                    "SCH010",
                    Severity.ERROR,
                    f"{tid!r} placed but its dependency {d!r} is unplaced",
                    task=tid,
                )
            elif pos.get(d, -1) > pos.get(tid, -1):
                rep.add(
                    "SCH009",
                    Severity.ERROR,
                    f"{tid!r} ordered before its dependency {d!r}",
                    task=tid,
                )
    return rep
