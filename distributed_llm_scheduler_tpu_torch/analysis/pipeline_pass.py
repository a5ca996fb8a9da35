"""Pass 4 — pipeline soundness.

``sched/pipeline.py`` emits per-node lists that a backend executes *in
order*; a dispatch that respects both those lists and the dependency edges
exists iff the combined graph (dependency edges + per-node
consecutive-order edges) is acyclic.  Two findings:

* ``PIP001`` — a node's list orders a task before one of its *same-node*
  dependencies: that node can never make progress past the inversion.
* ``PIP002`` — the combined graph has a cycle spanning nodes: a circular
  wait (classic pipeline deadlock — each node is blocked on a task another
  node refuses to run yet).

Cross-node edges that merely *wrap* (virtual-stage interleaving places
stage ``s`` on device ``s % n``) are fine and must not be flagged: a
backward device hop is not a deadlock unless it closes a cycle, which is
exactly what the combined-graph test checks.

PyTorch port's copy of ``distributed_llm_scheduler_tpu.analysis.
pipeline_pass``; framework-free, so the findings are identical.
"""

from __future__ import annotations

from typing import Dict, List

from ..core.graph import TaskGraph
from ..core.schedule import Schedule
from .diagnostics import AnalysisReport, Severity


def analyze_pipeline(graph: TaskGraph, schedule: Schedule) -> AnalysisReport:
    rep = AnalysisReport()

    # PIP001: same-node order inversions, straight from the per-node lists
    for nid, tids in schedule.per_node.items():
        pos = {tid: i for i, tid in enumerate(tids)}
        for tid in tids:
            if tid not in graph:
                continue
            for d in graph[tid].dependencies:
                if d in pos and pos[d] > pos[tid]:
                    rep.add(
                        "PIP001",
                        Severity.ERROR,
                        f"per_node[{nid}] runs {tid!r} before its "
                        f"same-node dependency {d!r}",
                        task=tid,
                        node=nid,
                    )

    # PIP002: cycle in dependency edges + per-node successor edges
    placed = {
        tid for tids in schedule.per_node.values() for tid in tids
    }
    succ: Dict[str, List[str]] = {tid: [] for tid in placed}
    indeg: Dict[str, int] = {tid: 0 for tid in placed}

    def edge(a: str, b: str) -> None:
        succ[a].append(b)
        indeg[b] += 1

    for tids in schedule.per_node.values():
        for a, b in zip(tids, tids[1:]):
            if a in indeg and b in indeg and a != b:
                edge(a, b)
    for tid in placed:
        if tid not in graph:
            continue
        for d in graph[tid].dependencies:
            if d in indeg and d != tid:
                edge(d, tid)

    queue = [tid for tid in placed if indeg[tid] == 0]
    seen = 0
    while queue:
        tid = queue.pop()
        seen += 1
        for child in succ[tid]:
            indeg[child] -= 1
            if indeg[child] == 0:
                queue.append(child)
    if seen != len(placed):
        stuck = sorted(tid for tid in placed if indeg[tid] > 0)
        rep.add(
            "PIP002",
            Severity.ERROR,
            "circular wait between per-node execution orders and "
            f"dependencies involving tasks {stuck[:5]}",
            data={"tasks": stuck},
        )
    return rep
