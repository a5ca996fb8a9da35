"""Memory-drift detection: measured device-memory peaks vs the planning
model.

PyTorch port of ``distributed_llm_scheduler_tpu.obs.memdrift``, the
memory analog of :mod:`.drift` (framework-free: it reads a profiler's
summary and the graph).  Every placement decision rests on *predicted*
bytes — ``analysis/memory_pass.py``'s no-evict residency replay (per
device) and each task's analytic ``memory_required`` (per task).  A
:class:`..obs.memprof.MemoryProfiler` run produces *measured* peaks (the
CUDA allocator's peak where the card reports one, the model-derived
timeline elsewhere).  This module compares the two:

* per-device ratio ``measured_peak / predicted_peak`` with the worst
  offenders ranked by ``|log ratio|`` (a 4x under-prediction — the
  OOM-shaped error — and a 4x over-prediction — wasted capacity — are
  equally wrong);
* per-task ratio of the measured task-output birth size against the
  task's analytic ``memory_required``;
* **near-OOM headroom**: devices whose measured peak leaves less than
  ``headroom_warn`` of their HBM budget free get an explicit warning —
  the signal the streamed/overcommit work tunes against.

``MemDriftReport.exceeds(threshold)`` is the ``doctor --memory`` gate:
true when any device's two-sided ratio ``max(r, 1/r)`` crosses the
threshold.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..core.graph import GB
from .drift import task_class


@dataclass
class DeviceMemDrift:
    node_id: str
    predicted_bytes: int
    measured_bytes: int
    source: str = "model"  # "platform" when the allocator reported

    @property
    def ratio(self) -> float:
        return self.measured_bytes / self.predicted_bytes

    def to_json(self) -> Dict[str, Any]:
        return {
            "node": self.node_id, "source": self.source,
            "predicted_bytes": self.predicted_bytes,
            "measured_bytes": self.measured_bytes, "ratio": self.ratio,
        }


@dataclass
class TaskMemDrift:
    task_id: str
    op_class: str
    predicted_bytes: int
    measured_bytes: int

    @property
    def ratio(self) -> float:
        return self.measured_bytes / self.predicted_bytes

    def to_json(self) -> Dict[str, Any]:
        return {
            "task": self.task_id, "class": self.op_class,
            "predicted_bytes": self.predicted_bytes,
            "measured_bytes": self.measured_bytes, "ratio": self.ratio,
        }


@dataclass
class MemDriftReport:
    """Per-device and per-task predicted-vs-measured memory comparison."""

    devices: List[DeviceMemDrift] = field(default_factory=list)
    tasks: List[TaskMemDrift] = field(default_factory=list)
    worst_devices: List[DeviceMemDrift] = field(default_factory=list)
    worst_tasks: List[TaskMemDrift] = field(default_factory=list)
    headroom: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    warnings: List[str] = field(default_factory=list)

    def worst_ratio(self) -> float:
        """Largest two-sided device drift: max of max(r, 1/r)."""
        if not self.devices:
            return 1.0
        return max(max(d.ratio, 1.0 / d.ratio) for d in self.devices)

    def exceeds(self, threshold: Optional[float]) -> bool:
        return threshold is not None and self.worst_ratio() > threshold

    def summary(self) -> Dict[str, Any]:
        dev_ratios = [d.ratio for d in self.devices]
        task_ratios = [t.ratio for t in self.tasks]
        return {
            "n_devices": len(self.devices),
            "n_tasks": len(self.tasks),
            "median_device_ratio": (
                statistics.median(dev_ratios) if dev_ratios else None
            ),
            "worst_ratio": self.worst_ratio() if self.devices else None,
            "median_task_ratio": (
                statistics.median(task_ratios) if task_ratios else None
            ),
            "devices": [d.to_json() for d in self.devices],
            "worst_tasks": [t.to_json() for t in self.worst_tasks],
            "headroom": self.headroom,
            "warnings": list(self.warnings),
        }


def predicted_node_peak_bytes(
    graph: Any, cluster: Any, schedule: Any,
) -> Dict[str, int]:
    """The planning model's per-device peak, in bytes: the same
    no-evict residency replay ``analysis/memory_pass.py`` reports as
    MEM001 (params accumulate on first use, plus each task's activation
    footprint while it runs), over ``schedule.assignment_order``."""
    from ..analysis.memory_pass import _param_sizes_gb
    from ..analysis.schedule_pass import placement_of
    from ..analysis.diagnostics import AnalysisReport
    from ..core.graph import DEFAULT_PARAM_GB

    sizes = _param_sizes_gb(graph)
    placed = placement_of(graph, cluster, schedule, AnalysisReport())
    resident: Dict[str, Dict[str, float]] = {
        d.node_id: {} for d in cluster
    }
    peak = {d.node_id: 0.0 for d in cluster}
    for tid in schedule.assignment_order:
        nid = placed.get(tid)
        if nid is None or tid not in graph:
            continue
        task = graph[tid]
        for p in task.params_needed:
            resident[nid].setdefault(p, sizes.get(p, DEFAULT_PARAM_GB))
        now = sum(resident[nid].values()) + task.memory_required
        peak[nid] = max(peak[nid], now)
    return {nid: int(round(pk * GB)) for nid, pk in peak.items()}


def compute_mem_drift(
    graph: Any,
    cluster: Any,
    schedule: Any,
    memprof: Any,
    *,
    headroom_warn: float = 0.10,
    top_k: int = 10,
) -> MemDriftReport:
    """Build a :class:`MemDriftReport` from an instrumented run.

    ``memprof`` is the :class:`..obs.memprof.MemoryProfiler` the run
    recorded into; its platform-reconciled peaks are the measured side
    (the allocator's peak where reported, the model-derived timeline
    elsewhere).  Devices and tasks missing on either side, or with a
    non-positive value on either side, are skipped — drift is a ratio.
    """
    predicted = predicted_node_peak_bytes(graph, cluster, schedule)
    summary = memprof.summary()
    mem_devices = summary.get("devices", {})

    devices: List[DeviceMemDrift] = []
    headroom: Dict[str, Dict[str, Any]] = {}
    warnings: List[str] = []
    for nid in sorted(mem_devices):
        entry = mem_devices[nid]
        measured = entry.get("platform_peak_bytes") or entry["peak_bytes"]
        pred = predicted.get(nid, 0)
        if measured > 0 and pred > 0:
            devices.append(DeviceMemDrift(
                node_id=nid, predicted_bytes=pred,
                measured_bytes=int(measured),
                source=entry.get("source", "model"),
            ))
        try:
            cap = int(round(cluster[nid].total_memory * GB))
        except (KeyError, TypeError, AttributeError):
            cap = 0
        if cap > 0:
            free_frac = 1.0 - measured / cap
            headroom[nid] = {
                "capacity_bytes": cap,
                "measured_peak_bytes": int(measured),
                "headroom_frac": free_frac,
            }
            if free_frac < headroom_warn:
                msg = (
                    f"{nid}: measured peak {measured / GB:.2f} GB leaves "
                    f"{free_frac:.1%} of {cap / GB:.2f} GB HBM free "
                    f"(< {headroom_warn:.0%} headroom) — near OOM"
                )
                headroom[nid]["warn"] = True
                warnings.append(msg)

    tasks: List[TaskMemDrift] = []
    for tid, measured in sorted(memprof.task_output_bytes().items()):
        try:
            task = graph[tid]
        except KeyError:
            continue
        pred = int(round(task.memory_required * GB))
        if pred <= 0 or measured <= 0:
            continue
        tasks.append(TaskMemDrift(
            task_id=tid, op_class=task_class(tid),
            predicted_bytes=pred, measured_bytes=int(measured),
        ))

    worst_devices = sorted(
        devices, key=lambda d: abs(math.log(d.ratio)), reverse=True,
    )[:top_k]
    worst_tasks = sorted(
        tasks, key=lambda t: abs(math.log(t.ratio)), reverse=True,
    )[:top_k]
    return MemDriftReport(
        devices=devices,
        tasks=tasks,
        worst_devices=worst_devices,
        worst_tasks=worst_tasks,
        headroom=headroom,
        warnings=warnings,
    )


__all__ = [
    "DeviceMemDrift",
    "MemDriftReport",
    "TaskMemDrift",
    "compute_mem_drift",
    "predicted_node_peak_bytes",
]
