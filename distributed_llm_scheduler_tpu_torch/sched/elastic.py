"""Elastic recovery: re-place surviving work after node failures.

The PyTorch port of ``distributed_llm_scheduler_tpu.sched.elastic``
(framework-free; the same partitions and remainder graphs).

The reference's failure story stops at *scheduling-time* degradation (tasks
that fit nowhere are failed, reference ``schedulers.py:128-131,202-206``);
node churn is explicitly future work in its paper ("nodes may join or
leave... we focus on static configurations", §3.1.2; checkpointing/task
migration "unimplemented", §6.6.2).  This module implements that future
work for the rebuild:

* :func:`surviving_work` — partition a partially-executed run: outputs on
  dead nodes are LOST (a dead chip's HBM is gone), so completed tasks on
  dead nodes — and anything transitively depending only on them — must
  re-run; completed tasks on live nodes keep their outputs and become
  external inputs to the remainder.
* :func:`remainder_graph` — a re-schedulable TaskGraph of exactly the
  tasks that must (re-)run, with satisfied dependencies pruned and param
  requirements intact (params cached on a dead node must re-load onto
  whatever node inherits its work).  ``arg_tasks`` keep referencing the
  surviving producers; at execution time their live outputs are fed in
  via ``DeviceBackend.execute(ext_outputs=...)``.
* :func:`reschedule` — places the remainder on the surviving cluster with
  any registered policy, preserving the live nodes' completed placement
  (their caches still hold the params they loaded — the MRU locality model
  keeps paying after a failure).

This upgrades fail-and-continue into fail-and-recover: kill a node
mid-run, reschedule the remainder, and total work done is bounded by
(completed-on-survivors + remainder); ``execute --inject-failure`` checks
the recovered output against the uninterrupted run.
"""

from __future__ import annotations

import copy
from typing import Iterable, Optional, Set, Tuple

from ..core.cluster import Cluster
from ..core.graph import Task, TaskGraph
from ..core.schedule import Schedule


def surviving_work(
    graph: TaskGraph,
    schedule: Schedule,
    completed: Iterable[str],
    dead_nodes: Iterable[str],
    have_outputs: Optional[Iterable[str]] = None,
) -> Tuple[Set[str], Set[str]]:
    """Split tasks into (must_run, available) after node failures.

    ``available``: completed tasks whose outputs live on surviving nodes —
    they stay available to re-running consumers (a consumer re-run never
    forces its producer to re-run; the producer's output is alive and is
    fed in via ``DeviceBackend.execute(ext_outputs=...)``).
    ``must_run``: everything else — incomplete tasks and completed tasks
    whose outputs sat on dead nodes.

    ``have_outputs``: the task ids whose output values the caller actually
    retained (``DeviceBackend.execute(keep_outputs=True)`` ->
    ``DeviceReport.task_outputs``).  Completed-on-survivor tasks whose
    values were NOT kept (e.g. segment-internal values under fused
    dispatch) re-run too — availability means "I can hand its bytes to
    ext_outputs", not just "it once finished".
    """
    dead = set(dead_nodes)
    placement = schedule.placement
    done = set(completed)
    available: Set[str] = {
        t for t in done if placement.get(t) is not None
        and placement[t] not in dead
    }
    if have_outputs is not None:
        available &= set(have_outputs)
    # a completed-on-survivor task whose output feeds a re-running consumer
    # is still available (its output is alive); only dead-node outputs are
    # gone.  must_run closure: start from non-available, propagate nothing —
    # a task re-runs iff it is not available.
    must_run = {t.task_id for t in graph.tasks()} - available
    return must_run, available


def remainder_graph(
    graph: TaskGraph,
    must_run: Set[str],
    name: Optional[str] = None,
) -> TaskGraph:
    """A fresh TaskGraph of ``must_run`` tasks, dependencies on available
    tasks pruned (their outputs are external inputs at execution time).

    Tasks are deep-copied with scheduling state reset, so the remainder
    can be handed to any policy like a brand-new DAG.
    """
    sub = TaskGraph(name=name or f"{graph.name}_remainder")
    for tid in graph.topo_order:
        if tid not in must_run:
            continue
        t = graph[tid]
        nt = Task(
            task_id=t.task_id,
            memory_required=t.memory_required,
            compute_time=t.compute_time,
            dependencies=[d for d in t.dependencies if d in must_run],
            params_needed=set(t.params_needed),
            param_bytes=dict(t.param_bytes),
            fn=t.fn,
            # materialize the implicit args-are-deps default BEFORE pruning:
            # the remainder task's dependencies shrink, but its fn still
            # consumes the original producers' outputs (surviving ones via
            # DeviceBackend ext_outputs)
            arg_tasks=list(t.arg_tasks or t.dependencies),
            param_alias=copy.copy(t.param_alias),
            out_shape=t.out_shape,
            out_bytes=t.out_bytes,
            flops=t.flops,
            group=t.group,
        )
        sub.add_task(nt)
    sub.freeze()
    return sub


def reschedule(
    graph: TaskGraph,
    schedule: Schedule,
    completed: Iterable[str],
    dead_nodes: Iterable[str],
    cluster: Cluster,
    scheduler,
    have_outputs: Optional[Iterable[str]] = None,
) -> Tuple[Schedule, TaskGraph, Set[str], Set[str]]:
    """Re-place everything that must (re-)run after ``dead_nodes`` fail.

    Args:
      graph: the original full graph.
      schedule: the schedule that was executing when the failure hit.
      completed: task_ids finished before the failure.
      dead_nodes: node_ids lost (their HBM contents with them).
      cluster: the surviving cluster (must not contain dead nodes).
      scheduler: any policy instance (``get_scheduler(...)``).
      have_outputs: retained output ids (``DeviceReport.task_outputs``
        from ``execute(keep_outputs=True)``); see :func:`surviving_work`.

    Returns ``(new_schedule, remainder, must_run, available)`` — the
    remainder graph IS the one the schedule was computed over; execute
    that same object rather than rebuilding it.
    """
    dead = set(dead_nodes)
    still_dead = [d.node_id for d in cluster if d.node_id in dead]
    if still_dead:
        raise ValueError(
            f"surviving cluster still contains dead nodes {still_dead}"
        )
    must_run, available = surviving_work(
        graph, schedule, completed, dead, have_outputs
    )
    sub = remainder_graph(graph, must_run)
    new_schedule = scheduler.schedule(sub, cluster)
    return new_schedule, sub, must_run, available
