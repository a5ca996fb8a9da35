"""DAG and schedule serialization (JSON).

The PyTorch port of ``distributed_llm_scheduler_tpu.utils.serialization``:
framework-free, so the files are the same.  The reference persists its extracted DAG with pickle
(``test_gpt2.py:266-269``, ``gpt2_dag.pkl``); here graphs and schedules
round-trip through explicit JSON — portable, diffable, and safe to load.
Task ``fn``s are code, not data: a deserialized graph is schedule-only
(exactly what the simulated backend and all policies need); re-attach fns
by rebuilding from the model frontend when real execution is needed.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

from ..core.graph import Task, TaskGraph
from ..core.schedule import Schedule, TaskTiming

FORMAT_VERSION = 1


def graph_to_dict(graph: TaskGraph) -> Dict[str, Any]:
    return {
        "format_version": FORMAT_VERSION,
        "name": graph.name,
        "tasks": [
            {
                "task_id": t.task_id,
                "memory_required": t.memory_required,
                "compute_time": t.compute_time,
                "dependencies": list(t.dependencies),
                "params_needed": sorted(t.params_needed),
                "param_bytes": dict(t.param_bytes),
                "flops": t.flops,
                "group": t.group,
            }
            for t in graph.tasks()
        ],
    }


def graph_from_dict(d: Dict[str, Any]) -> TaskGraph:
    if d.get("format_version", 1) > FORMAT_VERSION:
        raise ValueError(f"unsupported graph format {d['format_version']}")
    tasks = [
        Task(
            td["task_id"],
            td["memory_required"],
            td["compute_time"],
            list(td.get("dependencies", [])),
            set(td.get("params_needed", [])),
            param_bytes=dict(td.get("param_bytes", {})),
            flops=td.get("flops"),
            group=td.get("group"),
        )
        for td in d["tasks"]
    ]
    return TaskGraph(tasks, name=d.get("name", "dag")).freeze()


def save_graph(graph: TaskGraph, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(graph_to_dict(graph), f, indent=1)
    return path


def load_graph(path: str) -> TaskGraph:
    with open(path) as f:
        return graph_from_dict(json.load(f))


def schedule_to_dict(schedule: Schedule) -> Dict[str, Any]:
    return {
        "format_version": FORMAT_VERSION,
        "policy": schedule.policy,
        "per_node": {k: list(v) for k, v in schedule.per_node.items()},
        "assignment_order": list(schedule.assignment_order),
        "completed": sorted(schedule.completed),
        "failed": sorted(schedule.failed),
        "scheduling_wall_s": schedule.scheduling_wall_s,
        "timings": [
            {"task_id": t.task_id, "node_id": t.node_id,
             "start": t.start, "finish": t.finish}
            for t in schedule.timings.values()
        ],
    }


def schedule_from_dict(d: Dict[str, Any]) -> Schedule:
    s = Schedule(
        policy=d["policy"],
        per_node={k: list(v) for k, v in d["per_node"].items()},
        assignment_order=list(d["assignment_order"]),
        completed=set(d.get("completed", [])),
        failed=set(d.get("failed", [])),
        scheduling_wall_s=d.get("scheduling_wall_s", 0.0),
    )
    for td in d.get("timings", []):
        s.timings[td["task_id"]] = TaskTiming(
            td["task_id"], td["node_id"], td["start"], td["finish"]
        )
    return s


def save_schedule(schedule: Schedule, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(schedule_to_dict(schedule), f, indent=1)
    return path


def load_schedule(path: str) -> Schedule:
    with open(path) as f:
        return schedule_from_dict(json.load(f))
