"""Cost-model fidelity pass (CST00x): analytic memory vs the preflight.

The schedulers place against each task's *analytic* ``memory_required``
(GB) — frontend builders derive it from shapes.  ``utils/hbm.py``'s
``preflight_task_memory`` measures what each task actually allocates
on the card.  When the two diverge by more than ``factor``
(default 2×) in either direction, every memory-feasibility decision
built on the analytic number (MEM00x, streaming budgets, segment caps)
is suspect — this pass surfaces that as warnings, never errors: a bad
estimate degrades placement quality, it does not corrupt execution, so
CST codes are deliberately absent from the backends' gate sets.

Caveat the caller must respect: ``preflight_task_memory`` *mutates*
``task.memory_required`` up to ``max(analytic, compiled)``.  Snapshot
the analytic values first and pass them as ``analytic_gb`` (the `lint
--preflight` CLI path does); without the snapshot this pass compares
against the already-raised values and can only catch over-prediction.

PyTorch port's copy of ``distributed_llm_scheduler_tpu.analysis.
cost_pass``.  The port's ``utils/hbm.preflight_task_memory`` reads the
CUDA caching allocator's peak around one run of each task on the card
where the JAX package reads XLA's compiled memory analysis (on the CPU it
propagates shapes only and measures nothing, so every task above the
floor is CST003).  Given the same ``compiled_gb`` and ``analytic_gb`` the
diagnostics are the JAX package's, messages included ("XLA preflight" is
the reference's name for the measurement).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..core.graph import GB, TaskGraph
from .diagnostics import AnalysisReport, Severity

#: divergence threshold: flag when one estimate exceeds ``factor`` times
#: the other (two-sided)
DEFAULT_FACTOR = 2.0

#: estimates below this (GB) are noise — scalar glue tasks measure ~KB
#: footprints and any ratio there is meaningless
_FLOOR_GB = 1e-3


def _measured_task_gb(memory_report: Any) -> Dict[str, float]:
    """Per-task measured output footprints (GB) from a memprof source:
    either a live ``obs.memprof.MemoryProfiler`` (``task_output_bytes``)
    or a plain ``{tid: bytes}`` dict loaded from a report artifact."""
    if memory_report is None:
        return {}
    if hasattr(memory_report, "task_output_bytes"):
        memory_report = memory_report.task_output_bytes()
    try:
        return {
            str(t): int(b) / GB for t, b in dict(memory_report).items()
        }
    except (TypeError, ValueError, AttributeError):
        return {}


def analyze_cost(
    graph: TaskGraph,
    compiled_gb: Dict[str, float],
    analytic_gb: Optional[Dict[str, float]] = None,
    factor: float = DEFAULT_FACTOR,
    memory_report: Any = None,
) -> AnalysisReport:
    """Compare analytic vs compiled per-task memory, flag >factor gaps.

    ``compiled_gb`` is ``utils.hbm.preflight_task_memory``'s result;
    ``analytic_gb`` the pre-preflight ``memory_required`` snapshot
    (falls back to the graph's current values).

    ``memory_report`` (optional): a measured memory source — an
    ``obs.memprof.MemoryProfiler`` or a ``{tid: bytes}`` mapping of
    measured task-output births.  When a flagged task has a measurement,
    the diagnostic's ``data`` gains ``measured_gb``, so the CST00x
    payloads carry all three numbers (analytic / compiled / measured)
    and downstream tooling can tell which estimate reality sides with.
    """
    measured_gb = _measured_task_gb(memory_report)
    rep = AnalysisReport()
    for task in graph.tasks():
        tid = task.task_id
        analytic = (
            analytic_gb.get(tid, task.memory_required)
            if analytic_gb is not None
            else task.memory_required
        )
        if tid not in compiled_gb:
            if analytic > _FLOOR_GB:
                data3 = {"analytic_gb": analytic}
                if tid in measured_gb:
                    data3["measured_gb"] = measured_gb[tid]
                rep.add(
                    "CST003",
                    Severity.INFO,
                    f"no XLA preflight measurement for {tid!r} "
                    f"(analytic {analytic:.3f} GB unchecked)",
                    task=tid,
                    data=data3,
                )
            continue
        compiled = compiled_gb[tid]
        if analytic <= _FLOOR_GB and compiled <= _FLOOR_GB:
            continue
        data = {
            "analytic_gb": analytic,
            "compiled_gb": compiled,
            "factor": factor,
        }
        if tid in measured_gb:
            data["measured_gb"] = measured_gb[tid]
        if compiled > factor * max(analytic, _FLOOR_GB):
            rep.add(
                "CST001",
                Severity.WARNING,
                f"analytic memory {analytic:.3f} GB under-predicts XLA "
                f"preflight {compiled:.3f} GB by more than {factor:g}x; "
                "placement may overcommit HBM",
                task=tid,
                data=data,
            )
        elif analytic > factor * max(compiled, _FLOOR_GB):
            rep.add(
                "CST002",
                Severity.WARNING,
                f"analytic memory {analytic:.3f} GB over-predicts XLA "
                f"preflight {compiled:.3f} GB by more than {factor:g}x; "
                "placement is wastefully conservative",
                task=tid,
                data=data,
            )
    return rep


__all__ = ["DEFAULT_FACTOR", "analyze_cost"]
