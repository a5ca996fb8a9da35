"""DAG and schedule visualization.

The PyTorch port of ``distributed_llm_scheduler_tpu.visu.plots`` (the same
figures, from the port's types and its ``obs/attribution``).  Capability
parity with the reference's ``visu.py`` (components #21-23 in
SURVEY.md §2): simple and detailed DAG renderings (node color = memory,
size = compute) and per-node Gantt charts — but drawing from the real
framework types (one ``Task`` definition, not ``visu.py``'s duplicate
dataclasses, SURVEY.md §1 wart) and from *timestamped* schedules produced
by a backend, not hand-written ones (the reference's Gantt scales durations
by node speed because it has no real timings, ``visu.py:206-248``).

Non-interactive by default: figures save to files (Agg).  The reference's
interactive menu loop (``visu.py:294-339``) is replaced by an opt-in
``show=True`` / CLI ``--show``, which opens the rendered figure in a
window on display-capable machines after saving it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from ..core.graph import TaskGraph
from ..core.schedule import Schedule


def _savefig(fig, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120)


def _plt(show: bool = False):
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _layout(graph: TaskGraph) -> Dict[str, tuple]:
    """Layered layout from DAG depths (deterministic; no networkx spring
    randomness): x = depth, y = slot within depth."""
    depths = graph.depths()
    by_depth: Dict[int, list] = {}
    for tid in graph.topo_order:
        by_depth.setdefault(depths[tid], []).append(tid)
    pos = {}
    for d, tids in by_depth.items():
        n = len(tids)
        for i, tid in enumerate(tids):
            pos[tid] = (d, (i - (n - 1) / 2.0))
    return pos


def visualize_dag(
    graph: TaskGraph,
    path: str = "dag.png",
    detailed: bool = False,
    max_labels: int = 60,
    show: bool = False,
) -> str:
    """Render the DAG.  ``detailed`` colors nodes by activation memory and
    sizes them by compute time (reference visu.py:122-204)."""
    plt = _plt(show)
    pos = _layout(graph)
    fig, ax = plt.subplots(
        figsize=(max(8, len(set(x for x, _ in pos.values())) * 0.9), 8)
    )

    for t in graph:
        x1, y1 = pos[t.task_id]
        for d in t.dependencies:
            x0, y0 = pos[d]
            ax.annotate(
                "",
                xy=(x1, y1),
                xytext=(x0, y0),
                arrowprops=dict(arrowstyle="->", color="0.7", lw=0.7),
            )

    xs = [pos[t.task_id][0] for t in graph]
    ys = [pos[t.task_id][1] for t in graph]
    if detailed:
        mems = [t.memory_required for t in graph]
        comps = [t.compute_time for t in graph]
        cmax = max(comps) or 1.0
        sizes = [60 + 400 * c / cmax for c in comps]
        sc = ax.scatter(xs, ys, s=sizes, c=mems, cmap="viridis", zorder=3)
        fig.colorbar(sc, ax=ax, label="activation memory (GB)")
    else:
        ax.scatter(xs, ys, s=80, c="#4C72B0", zorder=3)

    if len(graph) <= max_labels:
        for t in graph:
            x, y = pos[t.task_id]
            ax.annotate(t.task_id, (x, y), fontsize=6,
                        xytext=(0, 6), textcoords="offset points", ha="center")

    ax.set_title(f"{graph.name}: {len(graph)} tasks")
    ax.set_xlabel("DAG depth")
    ax.set_yticks([])
    fig.tight_layout()
    _savefig(fig, path)
    if show:
        plt.show()
    plt.close(fig)
    return path


def visualize_schedule(
    schedule: Schedule,
    path: str = "schedule.png",
    title: Optional[str] = None,
    show: bool = False,
) -> str:
    """Gantt chart from a timestamped schedule (run a backend first to fill
    ``schedule.timings``; reference analog visu.py:206-248)."""
    if not schedule.timings:
        raise ValueError(
            "schedule has no timings; execute it on a backend first "
            "(SimulatedBackend.execute or DeviceBackend profile mode)"
        )
    plt = _plt(show)
    nodes = sorted(schedule.per_node)
    ypos = {n: i for i, n in enumerate(nodes)}
    cmap = plt.get_cmap("tab20")

    fig, ax = plt.subplots(figsize=(12, 1.2 + 0.6 * len(nodes)))
    groups = {}
    for i, t in enumerate(sorted(schedule.timings.values(), key=lambda t: t.start)):
        grp = t.task_id.rsplit("_", 1)[0]
        color = groups.setdefault(grp, cmap(len(groups) % 20))
        ax.barh(
            ypos[t.node_id],
            t.duration,
            left=t.start,
            height=0.6,
            color=color,
            edgecolor="white",
            linewidth=0.3,
        )
    ax.set_yticks(range(len(nodes)))
    ax.set_yticklabels(nodes)
    ax.set_xlabel("time (s)")
    ax.set_title(title or f"{schedule.policy}: makespan {schedule.makespan:.4f}s")
    fig.tight_layout()
    _savefig(fig, path)
    if show:
        plt.show()
    plt.close(fig)
    return path


def visualize_trace_gantt(
    trace: object,
    path: str = "trace_gantt.png",
    title: Optional[str] = None,
    show: bool = False,
) -> str:
    """Gantt chart from an exported Chrome/Perfetto trace JSON (path or
    loaded dict) — the *measured* timeline a ``DLS_TRACE=1`` run wrote,
    rather than the simulated schedule.  Device task/launch spans render
    exactly like :func:`visualize_schedule` bars; spans on the measured
    critical path (``obs/attribution.py``) get a highlight edge."""
    from ..obs.attribution import attribute_trace

    att = attribute_trace(trace)
    if not att.critical_path and not att.per_device:
        raise ValueError(
            "trace has no device spans; export one from a traced run "
            "(DLS_TRACE=1 or the `trace` CLI) first"
        )
    plt = _plt(show)
    # re-read the spans the attribution walked: per-device rows come
    # from its per_device keys, bars from the exported X events
    import json as _json
    import os as _os

    obj = trace
    if isinstance(trace, (str, _os.PathLike)):
        with open(trace) as f:
            obj = _json.load(f)
    events = obj.get("traceEvents", [])
    track_of = {
        ev.get("tid"): ev.get("args", {}).get("name", "")
        for ev in events
        if ev.get("ph") == "M" and ev.get("name") == "thread_name"
    }
    nodes = sorted(att.per_device)
    ypos = {n: i for i, n in enumerate(nodes)}
    on_path = {(s.name, s.track) for s in att.critical_path}
    cmap = plt.get_cmap("tab20")

    fig, ax = plt.subplots(figsize=(12, 1.2 + 0.6 * len(nodes)))
    groups: Dict[str, tuple] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        track = track_of.get(ev.get("tid"), "")
        if track not in ypos or ev.get("cat") not in ("task", "launch"):
            continue
        name = ev.get("name", "")
        grp = name.rsplit("_", 1)[0]
        color = groups.setdefault(grp, cmap(len(groups) % 20))
        critical = (name, track) in on_path
        ax.barh(
            ypos[track],
            ev.get("dur", 0.0) / 1e6,
            left=ev.get("ts", 0.0) / 1e6,
            height=0.6,
            color=color,
            edgecolor="#C44E52" if critical else "white",
            linewidth=1.2 if critical else 0.3,
        )
    ax.set_yticks(range(len(nodes)))
    ax.set_yticklabels(nodes)
    ax.set_xlabel("time (s)")
    ax.set_title(
        title
        or f"measured: makespan {att.makespan_s:.4f}s "
        f"(critical path {len(att.critical_path)} spans)"
    )
    fig.tight_layout()
    _savefig(fig, path)
    if show:
        plt.show()
    plt.close(fig)
    return path
