"""Measured cost model: calibrate task times on the device, persist,
apply.

PyTorch port of ``distributed_llm_scheduler_tpu.utils.costmodel``'s
calibration and persistence: profile-execute the DAG on one device, record
per-task times, and feed them back into ``Task.compute_time`` so the
policies (HEFT and critical-path especially) optimize measured times
instead of the analytic seed estimates the DAG frontends set.  A
calibration is saved as JSON in the JAX package's fields, keyed by graph
name and device type (``{graph.name}_{device.type}.json``), so either
package reads the other's file and a rerun replays it instead of
measuring again (:func:`calibrate_cached`; ``DLS_RECALIBRATE`` asks a
bench to re-measure).  ``repeat_capture`` is the one sample-collection
idiom the bench shares with it.
"""

from __future__ import annotations
# dls-lint: allow-file(DET001) calibration measures real step/transfer time

import json
import os
import statistics
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..core.graph import TaskGraph
from .env import env_str


@dataclass
class CostModel:
    """task_id -> measured seconds on ``platform`` for the graph named
    ``graph_name``, plus provenance.

    ``dispatch_s`` is a per-task host dispatch cost for the replay to
    charge on top of the task times (``SimulatedBackend(dispatch_s=...)``).
    :func:`calibrate` records events around each task as it is dispatched, so
    its task times already include what each launch costs, and it leaves
    ``dispatch_s`` at 0, as the JAX package's profile method does:
    charging it again would count it twice.  ``method`` is how the times
    were measured (``"profile"``; "" marks a file from before the field,
    which :func:`load_cached` refuses), ``measured_at`` the UTC time the
    calibration was measured ("" when it was not), and ``cache_hit``
    whether this object came off disk rather than being measured in this
    process (not persisted)."""

    graph_name: str
    platform: str
    task_seconds: Dict[str, float] = field(default_factory=dict)
    dispatch_s: float = 0.0
    method: str = ""
    measured_at: str = ""
    cache_hit: bool = False

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

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> str:
        """Write the JAX package's JSON fields to ``path``."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(
                {
                    "graph_name": self.graph_name,
                    "platform": self.platform,
                    "task_seconds": self.task_seconds,
                    "dispatch_s": self.dispatch_s,
                    "method": self.method,
                    "measured_at": self.measured_at,
                },
                f,
                indent=1,
            )
        return path

    @classmethod
    def load(cls, path: str) -> "CostModel":
        with open(path) as f:
            d = json.load(f)
        return cls(
            d["graph_name"], d["platform"], d["task_seconds"],
            d.get("dispatch_s", 0.0), d.get("method", ""),
            d.get("measured_at", ""),
        )


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
    return CostModel(graph.name, device.type, best, method="profile",
                     measured_at=_utc_stamp())


def median_cost_model(models: Sequence[CostModel]) -> CostModel:
    """One cost model from several calibrations of the same graph: each
    task's median time over them, stamped with the last one's
    ``measured_at``."""
    first = models[0]
    return CostModel(
        first.graph_name, first.platform,
        {tid: statistics.median(m.task_seconds[tid] for m in models)
         for tid in first.task_seconds},
        dispatch_s=first.dispatch_s, method=first.method,
        measured_at=models[-1].measured_at,
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


def cache_age_days(measured_at: str) -> Optional[float]:
    """Days since a ``measured_at`` stamp; None if blank or unparseable."""
    import datetime

    if not measured_at:
        return None
    try:
        then = datetime.datetime.fromisoformat(measured_at)
    except ValueError:
        return None
    if then.tzinfo is None:  # a naive stamp: take it as UTC
        then = then.replace(tzinfo=datetime.timezone.utc)
    now = datetime.datetime.now(datetime.timezone.utc)
    # clamp: clock skew or a future stamp must not read as negative age
    return max((now - then).total_seconds() / 86400.0, 0.0)


def recalibrate_requested() -> bool:
    """``DLS_RECALIBRATE``: a bench passes this as ``refresh=`` so a saved
    calibration cannot stand in for a live measurement when a run asks
    for one.  Library callers (and tests) are not environment-sensitive:
    they get cache semantics unless they opt in."""
    return (env_str("DLS_RECALIBRATE") or "").strip().lower() not in (
        "", "0", "false", "no", "off"
    )


def calibration_path(cache_dir: str, graph_name: str, device_type: str) -> str:
    """The saved calibration of ``graph_name`` on ``device_type``."""
    return os.path.join(cache_dir, f"{graph_name}_{device_type}.json")


def load_cached(path: str, graph: TaskGraph) -> Optional[CostModel]:
    """The calibration saved at ``path`` when it covers exactly
    ``graph``'s tasks and records its method (a file from before the
    ``method`` field measured other semantics), marked ``cache_hit``;
    None otherwise."""
    if not os.path.exists(path):
        return None
    cm = CostModel.load(path)
    if cm.method and set(cm.task_seconds) == set(graph.task_ids()):
        cm.cache_hit = True
        return cm
    return None


def calibrate_cached(
    graph: TaskGraph,
    params: Dict[str, Any],
    graph_input: Any,
    cache_dir: str = ".costmodel_torch",
    device: Optional[Any] = None,
    repeats: int = 3,
    refresh: bool = False,
) -> CostModel:
    """Load the saved calibration of this graph on this device type, or
    calibrate (:func:`calibrate`) and save it.

    ``refresh=True`` re-measures and overwrites the file: bench-level
    callers wire it to :func:`recalibrate_requested`, so a saved
    calibration replays only until a run asks for a fresh one."""
    device = torch.device(device if device is not None else "cuda")
    path = calibration_path(cache_dir, graph.name, device.type)
    if not refresh:
        cm = load_cached(path, graph)
        if cm is not None:
            return cm
    cm = calibrate(graph, params, graph_input, device=device, repeats=repeats)
    cm.save(path)
    return cm
