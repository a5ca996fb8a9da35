"""Pass 2b — memory feasibility.

Replays per-node HBM residency over the schedule timeline: a task whose
own activation + parameter footprint exceeds its node's capacity can never
run there even with perfect MRU-style eviction (``MEM003``, error); a node
whose *no-eviction* peak exceeds capacity merely requires eviction
(``MEM002``, warning — cache-aware policies like MRU legitimately rely on
it; error under ``strict``).  Per-node peaks are always reported as
``MEM001`` info diagnostics with a machine-readable ``peak_gb`` payload.

Sizes come from the graph's ``param_bytes`` declarations (the same table
``utils/costmodel.py`` and the schedulers consume); callers wanting the
footprints a task really takes on the device run
``utils.hbm.preflight_task_memory`` first — the pass then sees the raised
``memory_required`` values.

PyTorch port's copy of ``distributed_llm_scheduler_tpu.analysis.
memory_pass``; framework-free, so the findings are identical.
"""

from __future__ import annotations

from typing import Dict

from ..core.cluster import Cluster
from ..core.graph import DEFAULT_PARAM_GB, GB, TaskGraph
from ..core.schedule import Schedule
from .diagnostics import AnalysisReport, Severity
from .schedule_pass import placement_of

_EPS = 1e-9


def _param_sizes_gb(graph: TaskGraph) -> Dict[str, float]:
    """First-declared-wins size table, safe on unfrozen graphs (mirrors
    the table ``freeze()`` fixes, without raising on conflicts — those are
    DAG007's job)."""
    sizes: Dict[str, float] = {}
    for t in graph.tasks():
        for p, nbytes in t.param_bytes.items():
            sizes.setdefault(p, nbytes / GB)
    return sizes


def node_memory_slice(
    graph: TaskGraph,
    cluster: Cluster,
    schedule: Schedule,
    nid: str,
    strict: bool = False,
    *,
    _placed: Dict[str, str] = None,
    _sizes: Dict[str, float] = None,
) -> AnalysisReport:
    """MEM001/MEM002/MEM003 for one node.

    Residency accumulates independently per node, so the diagnostics for
    ``nid`` depend only on the tasks placed there — the property the JAX
    package's incremental engine (``analysis/incremental.py``, not ported
    yet) relies on to recompute exactly two node slices after a move.  :func:`analyze_memory`
    is the union of these slices plus the schedule-independent MEM004.
    """
    rep = AnalysisReport()
    sizes = _sizes if _sizes is not None else _param_sizes_gb(graph)

    def gb(p: str) -> float:
        return sizes.get(p, DEFAULT_PARAM_GB)

    placed = (
        _placed
        if _placed is not None
        else placement_of(graph, cluster, schedule, AnalysisReport())
    )
    cap = cluster[nid].total_memory
    resident: Dict[str, float] = {}
    peak = 0.0
    for tid in schedule.assignment_order:
        if placed.get(tid) != nid or tid not in graph:
            continue
        task = graph[tid]
        own = task.memory_required + sum(
            gb(p) for p in task.params_needed
        )
        if own > cap + _EPS:
            rep.add(
                "MEM003",
                Severity.ERROR,
                f"{tid!r} needs {own:.2f} GB alone but {nid} has "
                f"{cap:.2f} GB",
                task=tid,
                node=nid,
                data={"own_gb": own, "cap_gb": cap},
            )
        for p in task.params_needed:
            resident.setdefault(p, gb(p))
        now = sum(resident.values()) + task.memory_required
        peak = max(peak, now)

    rep.add(
        "MEM001",
        Severity.INFO,
        f"{nid} peak no-evict residency {peak:.2f} GB "
        f"of {cap:.2f} GB",
        node=nid,
        data={"peak_gb": peak},
    )
    if peak > cap + _EPS:
        rep.add(
            "MEM002",
            Severity.ERROR if strict else Severity.WARNING,
            f"{nid} peak no-evict residency {peak:.2f} GB exceeds "
            f"{cap:.2f} GB",
            node=nid,
            data={"peak_gb": peak},
        )
    return rep


def analyze_memory(
    graph: TaskGraph,
    cluster: Cluster,
    schedule: Schedule,
    strict: bool = False,
) -> AnalysisReport:
    rep = AnalysisReport()
    sizes = _param_sizes_gb(graph)

    # params that no device could ever hold alongside nothing else
    if len(cluster) > 0:
        biggest = max(d.total_memory for d in cluster)
        for p in sorted(sizes):
            if sizes[p] > biggest + _EPS:
                rep.add(
                    "MEM004",
                    Severity.ERROR,
                    f"param {p!r} is {sizes[p]:.2f} GB but the largest "
                    f"device holds {biggest:.2f} GB",
                    param=p,
                )

    placed = placement_of(graph, cluster, schedule, AnalysisReport())
    for d in cluster:
        rep.extend(
            node_memory_slice(
                graph, cluster, schedule, d.node_id, strict,
                _placed=placed, _sizes=sizes,
            )
        )
    return rep
