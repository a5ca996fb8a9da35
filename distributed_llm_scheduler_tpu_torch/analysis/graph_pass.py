"""Pass 1 — graph hygiene.

Checks a :class:`~..core.graph.TaskGraph` for structural defects without
calling ``freeze()`` (which raises on the first problem): cycles with the
offending tasks named, dangling and duplicate dependencies, tasks that
can never run because they wait on a cycle, negative resource
declarations, and parameter size-table inconsistencies.  Works on frozen
and unfrozen graphs alike.

PyTorch port's copy of ``distributed_llm_scheduler_tpu.analysis.graph_pass``;
framework-free, so the findings are identical.
"""

from __future__ import annotations

from typing import Dict, List

from ..core.graph import TaskGraph
from .diagnostics import AnalysisReport, Severity


def _cycle_members(graph: TaskGraph) -> tuple:
    """(on-cycle tasks, cycle-blocked tasks) via Kahn leftovers over the
    resolvable edges (dangling deps are DAG002, not DAG001)."""
    known = {t.task_id for t in graph.tasks()}
    indeg: Dict[str, int] = {tid: 0 for tid in known}
    out: Dict[str, List[str]] = {tid: [] for tid in known}
    for t in graph.tasks():
        for d in sorted(set(t.dependencies)):
            if d in known:
                indeg[t.task_id] += 1
                out[d].append(t.task_id)
    queue = [tid for tid, n in indeg.items() if n == 0]
    seen = 0
    while queue:
        tid = queue.pop()
        seen += 1
        for child in out[tid]:
            indeg[child] -= 1
            if indeg[child] == 0:
                queue.append(child)
    if seen == len(known):
        return [], []
    leftovers = {tid for tid, n in indeg.items() if n > 0}
    # split leftovers into the strongly-connected part and tasks that
    # merely *wait* on it: repeatedly peel leftovers none of whose
    # leftover-children wait on them (i.e. with no leftover dependents
    # left, they cannot be on a cycle themselves)
    on_cycle = set(leftovers)
    changed = True
    while changed:
        changed = False
        for tid in list(on_cycle):
            if not any(c in on_cycle for c in out[tid]):
                on_cycle.discard(tid)
                changed = True
    if not on_cycle:  # degenerate; be conservative
        on_cycle = leftovers
    return sorted(on_cycle), sorted(leftovers - on_cycle)


def analyze_graph(graph: TaskGraph) -> AnalysisReport:
    rep = AnalysisReport()
    tasks = graph.tasks()
    known = {t.task_id for t in tasks}

    for t in tasks:
        for d in t.dependencies:
            if d not in known:
                rep.add(
                    "DAG002",
                    Severity.ERROR,
                    f"task {t.task_id!r} depends on unknown task {d!r}",
                    task=t.task_id,
                )
        dupes = {d for d in t.dependencies if t.dependencies.count(d) > 1}
        for d in sorted(dupes):
            rep.add(
                "DAG003",
                Severity.WARNING,
                f"task {t.task_id!r} lists dependency {d!r} more than once",
                task=t.task_id,
            )
        if t.memory_required < 0 or t.compute_time < 0:
            rep.add(
                "DAG005",
                Severity.ERROR,
                f"task {t.task_id!r} declares negative resources "
                f"(memory={t.memory_required}, compute={t.compute_time})",
                task=t.task_id,
            )

    cyclic, blocked = _cycle_members(graph)
    if cyclic:
        rep.add(
            "DAG001",
            Severity.ERROR,
            f"dependency cycle involving tasks {cyclic[:5]}",
            data={"tasks": cyclic},
        )
    for tid in blocked:
        rep.add(
            "DAG004",
            Severity.WARNING,
            f"task {tid!r} can never run: blocked behind a "
            "dependency cycle",
            task=tid,
        )

    # param size table: flag conflicts always; flag *missing* declarations
    # only when the graph declares sizes at all (synthetic generator DAGs
    # legitimately rely on the DEFAULT_PARAM_GB fallback for every param)
    sizes: Dict[str, int] = {}
    any_declared = any(t.param_bytes for t in tasks)
    for t in tasks:
        for p, nbytes in t.param_bytes.items():
            prev = sizes.setdefault(p, nbytes)
            if prev != nbytes:
                rep.add(
                    "DAG007",
                    Severity.ERROR,
                    f"param {p!r} declared with conflicting sizes "
                    f"({prev} vs {nbytes} bytes)",
                    task=t.task_id,
                    param=p,
                )
    if any_declared:
        undeclared = sorted(
            {
                p
                for t in tasks
                for p in t.params_needed
                if p not in sizes
            }
        )
        for p in undeclared[:10]:
            rep.add(
                "DAG006",
                Severity.INFO,
                f"param {p!r} is used but never given a byte size "
                "(falls back to DEFAULT_PARAM_GB)",
                param=p,
            )
    return rep
