"""Pass 9 — static stream-safety prover for ``stream_params`` schedules.

The interpreted device backend streams parameters through a per-node HBM
budget with Belady eviction (``backends/device._ParamStreamer``); the
compiled path instead holds every parameter a device will ever touch
resident.  Whether a *streamed* schedule can take the compiled
rung is therefore a static question about the residency plan, answered
here by replaying it symbolically — per node, in that node's dispatch
order, accumulating the first-use union of parameter working sets
against the same budget the streamer enforces
(``device.total_memory`` GB, sizes from the graph's authoritative
``param_size_gb`` table):

* ``STR001`` (info) — the node's full parameter union fits the budget:
  the streamed schedule compiles **as-is** (the resident load subsumes
  the plan; streaming was never needed on this node).
* ``STR002`` (warning) — the union overflows, but a nonempty prefix of
  the node's task order fits: compilable **with a pinned prefix** (pin
  the prefix's params resident, stream the suffix interpreted).  The
  payload carries the split point.
* ``STR003`` (warning) — no useful prefix fits (the first
  parameter-bearing task already overflows): **interpreter-only**, the
  node must evict from its very first task.

:func:`stream_verdict` folds a report to the schedule-wide class;
``backends/device.execute(compiled=True, stream_params=True)`` uses it to
replace the historical unconditional refusal with a diagnostic-driven
one (:func:`compiled_stream_refusal`).

PyTorch port's copy of ``distributed_llm_scheduler_tpu.analysis.
stream_pass``; framework-free, so the findings are identical.  The port's
device backend has no captured streamed rung: a streamed schedule runs
per task or segmented unless this pass proves every node's union
resident (``STR001``), and then the compiled rung loads it whole.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..core.cluster import Cluster
from ..core.graph import TaskGraph
from ..core.schedule import Schedule
from .diagnostics import AnalysisReport, Severity

_EPS = 1e-9


def _node_plan(
    graph: TaskGraph, schedule: Schedule, nid: str
) -> List[Tuple[str, Tuple[str, ...]]]:
    """(task, global-params) rows for one node, in its dispatch order —
    the same rows ``DeviceBackend.execute`` feeds ``_ParamStreamer``."""
    rows: List[Tuple[str, Tuple[str, ...]]] = []
    for tid in schedule.per_node.get(nid, []):
        if tid not in graph:
            continue
        rows.append(
            (tid, tuple(g for _, g in graph[tid].param_items()))
        )
    return rows


def analyze_streaming(
    graph: TaskGraph,
    cluster: Cluster,
    schedule: Schedule,
) -> AnalysisReport:
    """Classify every node's streaming residency plan (STR001–STR003)."""
    rep = AnalysisReport()
    for dev in cluster:
        nid = dev.node_id
        plan = _node_plan(graph, schedule, nid)
        if not plan:
            continue
        budget = dev.total_memory
        union: Dict[str, float] = {}
        total = 0.0
        # cumulative first-use union after each task; find the longest
        # fitting prefix and the full-union total in one walk
        prefix_len = 0
        prefix_gb = 0.0
        fits = True
        spill_task = None
        for i, (tid, globals_) in enumerate(plan):
            for g in globals_:
                if g not in union:
                    union[g] = graph.param_size_gb(g)
                    total += union[g]
            if fits and total <= budget + _EPS:
                prefix_len = i + 1
                prefix_gb = total
            elif fits:
                fits = False
                spill_task = tid
        if fits:
            rep.add(
                "STR001",
                Severity.INFO,
                f"{nid} streams {total:.2f} GB of params within its "
                f"{budget:.2f} GB budget: compilable as-is (the resident "
                f"slab subsumes the streaming plan)",
                node=nid,
                data={"union_gb": total, "budget_gb": budget},
            )
        elif prefix_gb > 0.0:
            rep.add(
                "STR002",
                Severity.WARNING,
                f"{nid} needs {total:.2f} GB of params against a "
                f"{budget:.2f} GB budget; compilable only with the first "
                f"{prefix_len} task(s) pinned ({prefix_gb:.2f} GB), "
                f"streaming resumes at {spill_task!r}",
                node=nid,
                task=spill_task,
                data={
                    "union_gb": total,
                    "budget_gb": budget,
                    "prefix_tasks": prefix_len,
                    "prefix_gb": prefix_gb,
                    "spill_task": spill_task,
                },
            )
        else:
            rep.add(
                "STR003",
                Severity.WARNING,
                f"{nid} must evict from its first parameter-bearing task "
                f"({spill_task!r}): {total:.2f} GB of params against "
                f"{budget:.2f} GB, interpreter-only",
                node=nid,
                task=spill_task,
                data={
                    "union_gb": total,
                    "budget_gb": budget,
                    "spill_task": spill_task,
                },
            )
    return rep


def stream_verdict(report: AnalysisReport) -> str:
    """Fold a stream-pass report to the schedule-wide classification:
    ``"compilable"`` / ``"pinned-prefix"`` / ``"interpreter-only"``
    (worst node wins; nodes without STR findings are compilable)."""
    if report.has("STR003"):
        return "interpreter-only"
    if report.has("STR002"):
        return "pinned-prefix"
    return "compilable"


def compiled_stream_refusal(report: AnalysisReport) -> AnalysisReport:
    """The gate-grade form of a non-compilable verdict: STR002/STR003
    findings promoted to errors (unchanged messages), so the compiled
    path's refusal carries the per-node diagnosis instead of a blanket
    'incompatible with stream_params'."""
    out = AnalysisReport()
    for d in report.diagnostics:
        if d.code in ("STR002", "STR003"):
            out.add(
                d.code,
                Severity.ERROR,
                d.message,
                task=d.task,
                node=d.node,
                param=d.param,
                data=dict(d.data),
            )
    return out
