"""Schedule data structures.

The reference returns a bare ``Dict[node_id, List[task_id]]`` whose list
order *is* the execution order (reference ``schedulers.py:133-135``), plus
side-band state on the scheduler (completed/failed sets).  We make that an
explicit :class:`Schedule` object carrying:

* the ordered per-node task lists (reference-compatible view),
* the global assignment order (needed for faithful cache replay),
* completed/failed task sets,
* optionally, per-task timestamps filled in by a backend (simulated or
  measured), from which Gantt charts and makespan derive.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set


@dataclass
class TaskTiming:
    """Start/finish of one task on one node, seconds from schedule start."""

    task_id: str
    node_id: str
    start: float
    finish: float

    @property
    def duration(self) -> float:
        return self.finish - self.start


@dataclass
class Schedule:
    """Output of a scheduling policy over (graph, cluster)."""

    policy: str
    per_node: Dict[str, List[str]] = field(default_factory=dict)
    assignment_order: List[str] = field(default_factory=list)
    completed: Set[str] = field(default_factory=set)
    failed: Set[str] = field(default_factory=set)
    # host-side wall seconds spent inside schedule() — the reference's
    # ``execution_time`` metric (reference simulation.py:327-333)
    scheduling_wall_s: float = 0.0
    # filled by a backend
    timings: Dict[str, TaskTiming] = field(default_factory=dict)

    def node_of(self, task_id: str) -> Optional[str]:
        for node_id, tasks in self.per_node.items():
            if task_id in tasks:
                return node_id
        return None

    @property
    def placement(self) -> Dict[str, str]:
        """task_id -> node_id for all placed tasks."""
        out: Dict[str, str] = {}
        for node_id, tasks in self.per_node.items():
            for tid in tasks:
                out[tid] = node_id
        return out

    def signature(self) -> tuple:
        """Hashable identity of the scheduling DECISION: policy, per-node
        ordered task lists, and global assignment order — everything a
        dispatch plan is a pure function of.  Two schedules with equal
        signatures must produce identical dispatch plans
        (:mod:`..backends.dispatch_plan`); mutable backend-filled state
        (timings) and bookkeeping (completed/failed, wall time) are
        deliberately excluded."""
        return (
            self.policy,
            tuple((n, tuple(ts)) for n, ts in sorted(self.per_node.items())),
            tuple(self.assignment_order),
        )

    def completion_rate(self, total_tasks: int) -> float:
        return len(self.completed) / total_tasks if total_tasks else 0.0

    @property
    def makespan(self) -> float:
        """Max finish time over timed tasks (0 if no backend ran yet)."""
        if not self.timings:
            return 0.0
        return max(t.finish for t in self.timings.values())

    def summary(self) -> Dict[str, object]:
        return {
            "policy": self.policy,
            "completed": len(self.completed),
            "failed": len(self.failed),
            "per_node_counts": {n: len(ts) for n, ts in self.per_node.items()},
            "scheduling_wall_s": self.scheduling_wall_s,
            "makespan": self.makespan,
        }
