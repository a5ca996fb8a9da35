"""Cost-model drift detection: predicted vs measured, per task and run.

PyTorch port of ``distributed_llm_scheduler_tpu.obs.drift`` (the
framework-free half of the ``doctor`` command; nothing here touches a
device).  The HEFT/eventsim stack schedules against *predicted* per-task
seconds (``utils/costmodel.CostModel.task_seconds`` when calibrated, else
the graph's analytic ``compute_time``).  Profile-mode execution fills
``Schedule.timings`` with *measured* walls.  This module compares the two
so the cost assumptions behind every placement decision can be audited
against reality:

* per-task ratio ``measured / predicted`` with the worst offenders
  ranked by ``|log ratio|`` (a 4x underestimate and a 4x overestimate
  are equally wrong);
* per-op-class ratio distribution (:func:`task_class` normalizes
  microbatch/shard/layer indices away so ``mb3_layer_7_attn`` pools with
  every other ``layer_attn``), which is the actionable view: a whole
  class drifting means the model (not noise) is wrong;
* predicted vs measured *makespan*: the schedule-time expectation from
  ``sched/eventsim.simulate_placement`` under the predicted times,
  against the measured span of the executed timings.

``DriftReport.exceeds(threshold)`` is the `doctor` CLI's gate: true
when any task's two-sided ratio ``max(r, 1/r)`` crosses the threshold.
"""

from __future__ import annotations

import math
import re
import statistics
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

_MB_RE = re.compile(r"^mb\d+_")
_SHARD_RE = re.compile(r"_shard_\d+$")
_LAYER_RE = re.compile(r"layer_\d+_")


def task_class(task_id: str) -> str:
    """Canonical op class of a task id: strips the microbatch prefix,
    layer index and shard suffix, so ``mb3_layer_7_attention`` and
    ``mb0_layer_0_attention`` share a class, and ``mb0_embedding_shard_2``
    maps to the ``embedding`` class (the JAX package's ``eval/benchlib.
    task_class``)."""
    s = _MB_RE.sub("", task_id)
    s = _SHARD_RE.sub("", s)
    s = _LAYER_RE.sub("layer_", s)
    return s


@dataclass
class TaskDrift:
    task_id: str
    op_class: str
    predicted_s: float
    measured_s: float

    @property
    def ratio(self) -> float:
        return self.measured_s / self.predicted_s

    def to_json(self) -> Dict[str, Any]:
        return {
            "task": self.task_id, "class": self.op_class,
            "predicted_s": self.predicted_s,
            "measured_s": self.measured_s, "ratio": self.ratio,
        }


@dataclass
class DriftReport:
    """Per-task and per-class predicted-vs-measured comparison."""

    tasks: List[TaskDrift] = field(default_factory=list)
    per_class: Dict[str, Dict[str, float]] = field(default_factory=dict)
    worst: List[TaskDrift] = field(default_factory=list)
    predicted_makespan_s: Optional[float] = None
    measured_makespan_s: Optional[float] = None
    source: str = "compute_time"

    def worst_ratio(self) -> float:
        """Largest two-sided drift: max over tasks of max(r, 1/r)."""
        if not self.tasks:
            return 1.0
        return max(max(t.ratio, 1.0 / t.ratio) for t in self.tasks)

    def exceeds(self, threshold: Optional[float]) -> bool:
        return threshold is not None and self.worst_ratio() > threshold

    @property
    def makespan_ratio(self) -> Optional[float]:
        if (
            self.predicted_makespan_s
            and self.measured_makespan_s is not None
        ):
            return self.measured_makespan_s / self.predicted_makespan_s
        return None

    def summary(self) -> Dict[str, Any]:
        ratios = [t.ratio for t in self.tasks]
        return {
            "n_tasks": len(self.tasks),
            "source": self.source,
            "median_ratio": statistics.median(ratios) if ratios else None,
            "worst_ratio": self.worst_ratio() if self.tasks else None,
            "per_class": {
                k: dict(v) for k, v in sorted(self.per_class.items())
            },
            "worst_offenders": [t.to_json() for t in self.worst],
            "predicted_makespan_s": self.predicted_makespan_s,
            "measured_makespan_s": self.measured_makespan_s,
            "makespan_ratio": self.makespan_ratio,
        }


def compute_drift(
    graph: Any,
    schedule: Any,
    cost_model: Any = None,
    *,
    measured: Optional[Dict[str, float]] = None,
    link: Any = None,
    top_k: int = 10,
) -> DriftReport:
    """Build a :class:`DriftReport` for an executed schedule.

    ``measured`` defaults to the durations in ``schedule.timings``
    (profile mode fills them); predictions come from
    ``cost_model.task_seconds`` when given, else each task's
    ``compute_time``.  Tasks missing on either side, and tasks with a
    non-positive value on either side, are skipped — drift is a ratio.
    """
    timings = getattr(schedule, "timings", None) or {}
    if measured is None:
        measured = {tid: tt.duration for tid, tt in timings.items()}
    pred_map: Dict[str, float] = {}
    source = "compute_time"
    if cost_model is not None:
        pred_map = dict(getattr(cost_model, "task_seconds", {}) or {})
        source = getattr(cost_model, "method", "") or "costmodel"

    tasks: List[TaskDrift] = []
    for tid, meas in measured.items():
        try:
            task = graph[tid]
        except KeyError:
            continue
        pred = pred_map.get(tid, task.compute_time)
        if pred is None or pred <= 0 or meas is None or meas <= 0:
            continue
        tasks.append(TaskDrift(
            task_id=tid, op_class=task_class(tid),
            predicted_s=float(pred), measured_s=float(meas),
        ))
    tasks.sort(key=lambda t: t.task_id)

    per_class: Dict[str, Dict[str, float]] = {}
    by_class: Dict[str, List[TaskDrift]] = {}
    for t in tasks:
        by_class.setdefault(t.op_class, []).append(t)
    for cls, members in sorted(by_class.items()):
        ratios = [t.ratio for t in members]
        per_class[cls] = {
            "n": float(len(members)),
            "median_ratio": statistics.median(ratios),
            "min_ratio": min(ratios),
            "max_ratio": max(ratios),
            "predicted_s": sum(t.predicted_s for t in members),
            "measured_s": sum(t.measured_s for t in members),
        }

    worst = sorted(
        tasks, key=lambda t: abs(math.log(t.ratio)), reverse=True,
    )[:top_k]

    # schedule-time expectation under the *predicted* times: swap the
    # predictions in, simulate the same placement, restore.  The graph
    # is the caller's — never leave it mutated.  A placement the event
    # simulation cannot replay leaves the prediction None
    from ..sched.eventsim import simulate_placement

    saved: Dict[str, float] = {}
    for tid, s in pred_map.items():
        if tid in graph:
            saved[tid] = graph[tid].compute_time
            graph[tid].compute_time = max(float(s), 1e-7)
    try:
        _, predicted_makespan, _ = simulate_placement(
            graph, schedule.placement, link=link,
        )
    except (KeyError, ValueError):
        predicted_makespan = None
    finally:
        for tid, s in saved.items():
            graph[tid].compute_time = s

    measured_makespan = None
    if timings:
        measured_makespan = (
            max(tt.finish for tt in timings.values())
            - min(tt.start for tt in timings.values())
        )

    return DriftReport(
        tasks=tasks,
        per_class=per_class,
        worst=worst,
        predicted_makespan_s=predicted_makespan,
        measured_makespan_s=measured_makespan,
        source=source,
    )


__all__ = ["DriftReport", "TaskDrift", "compute_drift", "task_class"]
