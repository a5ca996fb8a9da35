"""Measured cost model: calibrate task times on the device, apply them.

PyTorch port of the calibration half of ``distributed_llm_scheduler_tpu.
utils.costmodel``: profile-execute the DAG on one device, record per-task
times, and feed them back into ``Task.compute_time`` so the policies (HEFT
and critical-path especially) optimize measured times instead of the
analytic seed estimates the DAG frontends set.  ``repeat_capture`` is
the one sample-collection idiom the bench shares with it.  Persistence
(``calibrate_cached``) is not ported yet: the port's bench calibrates
live on every run.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..core.graph import TaskGraph


@dataclass
class CostModel:
    """task_id -> measured seconds on ``platform`` for the graph named
    ``graph_name``, plus provenance.

    ``dispatch_s`` is a per-task host dispatch cost for the replay to
    charge on top of the task times (``SimulatedBackend(dispatch_s=...)``).
    :func:`calibrate` records events around each task as it is dispatched, so
    its task times already include what each launch costs, and it leaves
    ``dispatch_s`` at 0, as the JAX package's profile method does:
    charging it again would count it twice.  ``measured_at`` is the UTC
    time the calibration was measured ("" when it was not)."""

    graph_name: str
    platform: str
    task_seconds: Dict[str, float] = field(default_factory=dict)
    dispatch_s: float = 0.0
    measured_at: str = ""

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
    the bottleneck), which is what the placed run will pay too, so
    ``dispatch_s`` stays 0.
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
    return CostModel(graph.name, device.type, best, measured_at=_utc_stamp())


def median_cost_model(models: Sequence[CostModel]) -> CostModel:
    """One cost model from several calibrations of the same graph: each
    task's median time over them, stamped with the last one's
    ``measured_at``."""
    first = models[0]
    return CostModel(
        first.graph_name, first.platform,
        {tid: statistics.median(m.task_seconds[tid] for m in models)
         for tid in first.task_seconds},
        dispatch_s=first.dispatch_s, measured_at=models[-1].measured_at,
    )


def repeat_capture(fn: Any, n: int) -> List[Any]:
    """All ``n`` samples of ``fn()``, in capture order — the raw material
    every derived estimator (min for device time, median for headline
    quotes, min/max for the bench's spread block) reduces from."""
    return [fn() for _ in range(n)]


def _utc_stamp() -> str:
    import datetime

    return datetime.datetime.now(datetime.timezone.utc).isoformat(
        timespec="seconds"
    )
