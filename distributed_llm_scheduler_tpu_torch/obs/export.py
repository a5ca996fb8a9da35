"""Chrome/Perfetto trace export: one unified timeline per run.

Renders :class:`..obs.trace.Tracer` event lists — and, separately,
replayed/profiled ``Schedule.timings`` — as Chrome ``traceEvents`` JSON
loadable at https://ui.perfetto.dev or ``chrome://tracing``:

* one row ("thread") per track: ``host`` (execute phases) first, then
  each device node_id (task/launch spans);
* ``X`` complete events for spans, ``i`` instants for point markers
  (fences, retires), ``C`` counter events — each distinct counter name
  is its own Perfetto counter row (pool occupancy, queue depth);
* ``s``/``f`` flow pairs for cross-device transfer edges, drawn as
  arrows from the producer's slice to the consumer's.

This module subsumes ``utils/profiling.export_chrome_trace`` (kept as a
delegating shim): :func:`export_chrome_trace` still renders
timings-only schedules exactly as before (device rows, ``X`` events,
thread metadata), and now also emits transfer flow arrows when given the
graph (cross-device dependency edges) and a ``run_fence`` instant
closing the timeline.

:func:`validate_trace` is the exporter's own schema check — the CI
trace-smoke step and the ``trace`` CLI run it on every produced file, so
a malformed event shape fails the build rather than silently rendering
an empty timeline.

The PyTorch port's copy of ``distributed_llm_scheduler_tpu.obs.export``: framework-free,
so the port keeps it without importing the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from .trace import HOST_TRACK, Tracer

_US = 1e6  # seconds -> Chrome microsecond timestamps

PID = 1


def _track_tids(tracer: Tracer) -> Dict[str, int]:
    """Stable row order: host first (tid 1), then remaining tracks
    sorted; flow endpoints may name tracks no span lives on."""
    tracks = list(tracer.tracks())
    for ev in tracer.events:
        if ev["type"] == "flow":
            for t in (ev["src_track"], ev["dst_track"]):
                if t not in tracks:
                    tracks.append(t)
    ordered = ([HOST_TRACK] if HOST_TRACK in tracks else []) + sorted(
        t for t in tracks if t != HOST_TRACK
    )
    return {t: i + 1 for i, t in enumerate(ordered)}


def chrome_events(
    tracer: Tracer, process_name: str = "distributed_llm_scheduler_tpu_torch",
    memprof: Any = None,
) -> List[Dict[str, Any]]:
    """Render a tracer's event list as Chrome ``traceEvents``.

    Timestamps are normalized so the earliest recorded event sits at
    ``ts=0`` (raw ``perf_counter`` epochs are meaningless absolute).

    ``memprof`` (a :class:`..obs.memprof.MemoryProfiler`) additionally
    renders one ``mem.hbm_bytes.<device>`` counter track per device
    from the profiler's timeline — for profilers constructed *without*
    a tracer (one built with ``tracer=`` already emitted its samples
    into the tracer's own event list, and passing it again here would
    double every sample)."""
    tids = _track_tids(tracer)
    stamps: List[float] = []
    for ev in tracer.events:
        if ev["type"] == "span":
            stamps.append(ev["t0"])
        elif ev["type"] in ("instant", "counter"):
            stamps.append(ev["t"])
        else:  # flow
            stamps.append(ev["src_ts"])
    if memprof is not None:
        stamps.extend(ev["t"] for ev in memprof.events)
    epoch = min(stamps) if stamps else 0.0

    out: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": PID, "tid": 0,
        "args": {"name": process_name},
    }]
    for track, tid in tids.items():
        out.append({
            "name": "thread_name", "ph": "M", "pid": PID, "tid": tid,
            "args": {"name": track},
        })
    for ev in tracer.events:
        kind = ev["type"]
        if kind == "span":
            t1 = ev["t1"] if ev["t1"] is not None else ev["t0"]
            out.append({
                "name": ev["name"], "cat": ev["cat"], "ph": "X",
                "pid": PID, "tid": tids[ev["track"]],
                "ts": (ev["t0"] - epoch) * _US,
                "dur": max(t1 - ev["t0"], 0.0) * _US,
                "args": ev["args"],
            })
        elif kind == "instant":
            out.append({
                "name": ev["name"], "cat": ev["cat"], "ph": "i",
                "s": "t",  # thread-scoped marker
                "pid": PID, "tid": tids[ev["track"]],
                "ts": (ev["t"] - epoch) * _US,
                "args": ev["args"],
            })
        elif kind == "counter":
            out.append({
                "name": ev["name"], "ph": "C", "pid": PID, "tid": 0,
                "ts": (ev["t"] - epoch) * _US,
                "args": {"value": ev["value"]},
            })
        else:  # flow: the s/f pair binds to the enclosing slices
            base = {
                "name": ev["name"], "cat": ev["cat"], "id": ev["id"],
                "pid": PID,
            }
            out.append({
                **base, "ph": "s", "tid": tids[ev["src_track"]],
                "ts": (ev["src_ts"] - epoch) * _US, "args": ev["args"],
            })
            out.append({
                **base, "ph": "f", "bp": "e",
                "tid": tids[ev["dst_track"]],
                "ts": (ev["dst_ts"] - epoch) * _US, "args": ev["args"],
            })
    if memprof is not None:
        from .memprof import COUNTER_PREFIX

        for ev in memprof.events:
            out.append({
                "name": COUNTER_PREFIX + ev["device"], "ph": "C",
                "pid": PID, "tid": 0,
                "ts": (ev["t"] - epoch) * _US,
                "args": {"value": ev["total"]},
            })
    return out


def export_perfetto(
    tracer: Tracer, path: str,
    process_name: str = "distributed_llm_scheduler_tpu_torch",
    memprof: Any = None,
) -> str:
    """Write a tracer's unified timeline to ``path``; returns ``path``."""
    events = chrome_events(tracer, process_name=process_name,
                           memprof=memprof)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return path


# -- schedule-timings exporter (the pre-obs surface, extended) -------------
def export_chrome_trace(
    schedule: Any, path: str, graph: Any = None,
) -> str:
    """Write a schedule's task timeline as a Chrome/Perfetto trace JSON.

    One row per device, one complete event per ``TaskTiming``,
    microsecond units — any timed schedule works (``DeviceBackend``
    profile mode and the simulated backend's replay both fill
    ``Schedule.timings``).  Extensions over the original exporter, both
    backward compatible with timings-only schedules:

    * ``graph`` (optional): cross-device dependency edges become flow
      arrows from the producer's slice end to the consumer's slice
      start (same-device edges draw nothing — no transfer happened);
    * a ``run_fence`` instant marks the makespan point where the
      end-of-run readback fence observes completion (process-scoped,
      tid 0 — device rows and their metadata are unchanged).

    Returns ``path``.  Raises ``ValueError`` if the schedule carries no
    timings (execute with ``profile=True`` or replay on the simulated
    backend first).
    """
    timings = getattr(schedule, "timings", None) or {}
    if not timings:
        raise ValueError(
            "schedule has no timings; run DeviceBackend.execute("
            "profile=True) or SimulatedBackend.execute first"
        )
    # stable row order: sort devices by id, tasks by start
    node_ids = sorted({t.node_id for t in timings.values()})
    tids = {n: i + 1 for i, n in enumerate(node_ids)}
    events: List[Dict[str, Any]] = [
        {
            "name": "process_name", "ph": "M", "pid": PID, "tid": 0,
            "args": {"name": getattr(schedule, "policy", "schedule")},
        }
    ]
    for n in node_ids:
        events.append({
            "name": "thread_name", "ph": "M", "pid": PID, "tid": tids[n],
            "args": {"name": n},
        })
    for tt in sorted(timings.values(), key=lambda t: (t.start, t.task_id)):
        events.append({
            "name": tt.task_id,
            "cat": "task",
            "ph": "X",  # complete event
            "pid": PID,
            "tid": tids[tt.node_id],
            "ts": tt.start * _US,
            "dur": max(tt.duration, 0.0) * _US,
            "args": {"node": tt.node_id},
        })
    if graph is not None:
        flow_id = 0
        for tt in timings.values():
            try:
                deps = graph[tt.task_id].dependencies
            except KeyError:
                continue
            for d in deps:
                src = timings.get(d)
                if src is None or src.node_id == tt.node_id:
                    continue  # untimed producer / same-device edge
                flow_id += 1
                base = {
                    "name": "transfer", "cat": "transfer", "id": flow_id,
                    "pid": PID, "args": {"src": d, "dst": tt.task_id},
                }
                events.append({
                    **base, "ph": "s", "tid": tids[src.node_id],
                    "ts": src.finish * _US,
                })
                events.append({
                    **base, "ph": "f", "bp": "e",
                    "tid": tids[tt.node_id], "ts": tt.start * _US,
                })
    makespan = max(t.finish for t in timings.values())
    events.append({
        "name": "run_fence", "cat": "collect", "ph": "i", "s": "p",
        "pid": PID, "tid": 0, "ts": makespan * _US, "args": {},
    })
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return path


# -- validation ------------------------------------------------------------
_PH_NEEDS_NAME = set("MXiCsf")


def validate_trace(obj_or_path: Any) -> List[str]:
    """Structural validation of an exported trace (the exporter schema).

    Accepts a path or an already-loaded dict; returns human-readable
    problems, empty when the file is Perfetto-loadable by construction:
    ``traceEvents`` list, per-phase required fields (``X`` needs
    ``dur``, ``C`` needs ``args.value``, flows need ``id``), timestamps
    non-negative and numeric, and every flow-start paired with a
    flow-finish.
    """
    errs: List[str] = []
    obj = obj_or_path
    if isinstance(obj_or_path, (str, os.PathLike)):
        try:
            with open(obj_or_path) as f:
                obj = json.load(f)
        except (OSError, ValueError) as e:
            return [f"unreadable trace file: {e}"]
    if not isinstance(obj, dict) or not isinstance(
        obj.get("traceEvents"), list
    ):
        return ["trace must be a dict with a traceEvents list"]
    flow_starts: Dict[Any, int] = {}
    flow_ends: Dict[Any, int] = {}
    for i, ev in enumerate(obj["traceEvents"]):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not a dict")
            continue
        ph = ev.get("ph")
        if ph not in _PH_NEEDS_NAME:
            errs.append(f"{where}: unknown ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str):
            errs.append(f"{where}: missing name")
        if "pid" not in ev or "tid" not in ev:
            errs.append(f"{where}: missing pid/tid")
        if ph == "M":
            if not isinstance(ev.get("args", {}).get("name"), str):
                errs.append(f"{where}: metadata without args.name")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: complete event with bad dur {dur!r}")
        elif ph == "C":
            v = ev.get("args", {}).get("value")
            if not isinstance(v, (int, float)):
                errs.append(f"{where}: counter without numeric args.value")
        elif ph in ("s", "f"):
            if "id" not in ev:
                errs.append(f"{where}: flow event without id")
            else:
                (flow_starts if ph == "s" else flow_ends)[ev["id"]] = i
    for fid in flow_starts:
        if fid not in flow_ends:
            errs.append(f"flow id {fid!r} has a start but no finish")
    for fid in flow_ends:
        if fid not in flow_starts:
            errs.append(f"flow id {fid!r} has a finish but no start")
    return errs


def trace_summary(obj_or_path: Any) -> Dict[str, Any]:
    """Counts the ``trace`` CLI prints (and the CI smoke step asserts):
    rows, span/flow/counter/instant totals, distinct counter tracks."""
    obj = obj_or_path
    if isinstance(obj_or_path, (str, os.PathLike)):
        with open(obj_or_path) as f:
            obj = json.load(f)
    events = obj.get("traceEvents", [])
    by_ph: Dict[str, int] = {}
    for ev in events:
        by_ph[ev.get("ph", "?")] = by_ph.get(ev.get("ph", "?"), 0) + 1
    threads = [
        ev["args"]["name"] for ev in events
        if ev.get("ph") == "M" and ev.get("name") == "thread_name"
    ]
    counters = sorted({
        ev["name"] for ev in events if ev.get("ph") == "C"
    })
    return {
        "events": len(events),
        "rows": threads,
        "spans": by_ph.get("X", 0),
        "instants": by_ph.get("i", 0),
        "flows": by_ph.get("s", 0),
        "counter_samples": by_ph.get("C", 0),
        "counter_tracks": counters,
    }


__all__ = [
    "chrome_events",
    "export_perfetto",
    "export_chrome_trace",
    "validate_trace",
    "trace_summary",
]
