"""Measured cost model: calibrate task times on the device, apply them.

PyTorch port of the calibration half of ``distributed_llm_scheduler_tpu.
utils.costmodel``: profile-execute the DAG on one device, record per-task
times, and feed them back into ``Task.compute_time`` so the policies (HEFT
and critical-path especially) optimize measured times instead of the
builder's analytic seed estimates.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from ..core.graph import TaskGraph


@dataclass
class CostModel:
    """task_id -> measured seconds on ``platform`` for the graph named
    ``graph_name``."""

    graph_name: str
    platform: str
    task_seconds: Dict[str, float] = field(default_factory=dict)

    def apply(self, graph: TaskGraph) -> int:
        """Overwrite compute_time for tasks present in the model.

        Returns how many tasks were updated.  Unknown tasks keep their
        analytic seed estimate.
        """
        n = 0
        for tid, secs in self.task_seconds.items():
            t = graph.get(tid)
            if t is not None:
                t.compute_time = max(secs, 1e-7)
                n += 1
        return n


def calibrate(
    graph: TaskGraph,
    params: Dict[str, Any],
    graph_input: Any,
    device: Optional[Any] = None,
    repeats: int = 3,
) -> CostModel:
    """Measure per-task times on one device (CUDA unless told otherwise).

    Places the whole graph on one node bound to ``device`` (greedy), runs
    it once untimed to warm up, then ``repeats`` profile runs (so
    ``repeats + 1`` forwards in all), each timing every
    task between CUDA events recorded on the device's stream around it
    (host clock on the CPU); keeps each task's minimum.  Per-task times
    include what per-task execution pays (launch latency when the host is
    the bottleneck), which is what the placed run will pay too.
    """
    from ..backends.device import DeviceBackend
    from ..core.cluster import Cluster
    from ..sched.policies import get_scheduler

    device = torch.device(device if device is not None else "cuda")
    cluster = Cluster.from_torch_devices([device])
    backend = DeviceBackend(cluster)
    schedule = get_scheduler("greedy").schedule(graph, cluster)

    best: Dict[str, float] = {}
    for i in range(repeats):
        # the first call warms up untimed before its profile run
        rep = backend.execute(
            graph, schedule, params, graph_input, profile=True,
            warmup=i == 0,
        )
        for tid, t in rep.timings.items():
            dur = t.duration
            if tid not in best or dur < best[tid]:
                best[tid] = dur
    return CostModel(graph.name, device.type, best)
