"""Measured critical-path attribution: explain where a run's time went.

The tracer (`obs/trace.py`) records what actually happened — per-task
device spans, host dispatch-phase spans, and cross-device transfer flow
arrows.  This module walks that record *backward* from the last device
span to reconstruct the measured critical path (the chain of spans and
waits that determined the makespan) and attributes every second of the
run window to exactly one of four buckets:

* **compute**  — device-span time on the critical path;
* **transfer** — waits bound by an incoming transfer flow (producer
  finish on another device → consumer start);
* **dispatch** — same-device waits that overlap host activity (the
  scheduler/stager/launcher was the bottleneck);
* **idle**     — same-device waits with no host span covering them
  (a genuine pipeline bubble).

By construction the four buckets tile ``[window_start, last_finish]``,
so ``compute + transfer + dispatch + idle == makespan`` exactly (the
walk maintains a cursor and clamps every segment to it, so overlapping
or slightly inconsistent timestamps cannot break the invariant — CI
asserts the fractions sum to ~1.0 on a real trace, and the golden tests
assert the sum to 1e-9 on a scripted clock).

Two entry points: :func:`attribute_run` consumes a live
:class:`~.trace.Tracer`; :func:`attribute_trace` consumes an exported
Chrome/Perfetto JSON (path or loaded dict) — both the tracer export
(`export_perfetto`) and the schedule-timings export
(`export_chrome_trace`) parse back losslessly enough to attribute.

The backward walk's binding rule at each span ``S``: the *latest
release* among (a) the best incoming transfer flow's producer finish
and (b) the previous span's finish on the same device decides what the
wait before ``S`` was spent on.  Flows are matched by ``args["dst"]``
(the backend records the consumer task id there) with a timestamp
fallback, so both backend flows and schedule-export flows bind.

The PyTorch port's copy of ``distributed_llm_scheduler_tpu.obs.attribution``: framework-free,
so the port keeps it without importing the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .trace import HOST_TRACK, Tracer

_US = 1e6
_EPS = 1e-9

# span cats that count as device work (profile-mode task timings and
# host-measured launch windows; decode-engine spans are excluded)
_DEVICE_CATS = ("task", "launch")

# the compiled execution path fuses each device's whole run into one
# program: its device rows carry a single cat="program" span each, with
# no per-task boundaries.  When a trace has NO per-task/launch device
# spans, attribution degrades to PROGRAM-level granularity over those
# spans — compute/dispatch/idle still tile the makespan exactly (the
# cursor invariant is cat-agnostic) instead of returning an empty
# critical path.
_PROGRAM_CAT = "program"


@dataclass
class PathStep:
    """One device span on the measured critical path, plus the wait that
    preceded it (``wait_kind`` ∈ {"", "transfer", "wait"})."""

    name: str
    track: str
    t0: float
    t1: float
    cat: str = "task"
    wait_kind: str = ""
    wait_s: float = 0.0


@dataclass
class Attribution:
    """The run doctor's verdict: measured makespan, its four-way split,
    the critical path that produced it, and the per-device picture."""

    makespan_s: float = 0.0
    window: Tuple[float, float] = (0.0, 0.0)
    breakdown_s: Dict[str, float] = field(default_factory=lambda: {
        "compute": 0.0, "transfer": 0.0, "dispatch": 0.0, "idle": 0.0,
    })
    critical_path: List[PathStep] = field(default_factory=list)
    per_device: Dict[str, Dict[str, float]] = field(default_factory=dict)
    stragglers: List[str] = field(default_factory=list)
    bubbles: List[Dict[str, Any]] = field(default_factory=list)

    def fractions(self) -> Dict[str, float]:
        m = self.makespan_s
        if m <= 0:
            return {k: 0.0 for k in self.breakdown_s}
        return {k: v / m for k, v in self.breakdown_s.items()}

    def summary(self) -> Dict[str, Any]:
        """JSON-safe digest — what `doctor` prints and what
        ``DeviceReport.summary()`` / bench artifacts embed."""
        return {
            "makespan_s": self.makespan_s,
            "breakdown_s": dict(self.breakdown_s),
            "fractions": self.fractions(),
            "critical_path": [
                {
                    "task": s.name, "device": s.track,
                    "start_s": s.t0, "finish_s": s.t1,
                    "wait_kind": s.wait_kind, "wait_s": s.wait_s,
                }
                for s in self.critical_path
            ],
            "per_device": {
                k: dict(v) for k, v in sorted(self.per_device.items())
            },
            "stragglers": list(self.stragglers),
            "bubbles": [dict(b) for b in self.bubbles],
        }


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if hi <= lo:
            continue
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _overlap(
    lo: float, hi: float, union: List[Tuple[float, float]],
) -> float:
    got = 0.0
    for a, b in union:
        if b <= lo:
            continue
        if a >= hi:
            break
        got += min(hi, b) - max(lo, a)
    return got


def _attribute(
    dev_spans: List[Dict[str, Any]],
    host_spans: List[Dict[str, Any]],
    flows: List[Dict[str, Any]],
    window: Optional[Tuple[float, float]],
    straggler_frac: float,
) -> Attribution:
    """Core algorithm over normalized span/flow dicts (tracer shapes)."""
    if window is not None:
        w0, w1 = window
        dev_spans = [
            s for s in dev_spans
            if s["t0"] >= w0 - _EPS and s["t1"] <= w1 + _EPS
        ]
        host_spans = [
            s for s in host_spans
            if s["t0"] >= w0 - _EPS and s["t1"] <= w1 + _EPS
        ]
        flows = [
            f for f in flows
            if f["src_ts"] >= w0 - _EPS and f["dst_ts"] <= w1 + _EPS
        ]
    if not dev_spans:
        return Attribution(window=window or (0.0, 0.0))
    if window is None:
        w0 = min(s["t0"] for s in dev_spans + host_spans)
        w1 = max(s["t1"] for s in dev_spans + host_spans)

    by_track: Dict[str, List[Dict[str, Any]]] = {}
    for s in dev_spans:
        by_track.setdefault(s["track"], []).append(s)
    for spans in by_track.values():
        spans.sort(key=lambda s: (s["t0"], s["t1"]))

    # host busy union = every host phase span except the outer `execute`
    # envelope (it covers the whole window and would mask real idle)
    host_union = _merge([
        (s["t0"], s["t1"]) for s in host_spans if s["name"] != "execute"
    ])

    # -- backward walk: latest-release predecessor binds each wait -----
    terminal = max(dev_spans, key=lambda s: (s["t1"], s["t0"]))
    rev: List[Tuple[Dict[str, Any], str]] = []  # (span, incoming wait kind)
    cur = terminal
    seen = set()
    while cur is not None and id(cur) not in seen:
        # dls-lint: allow(DET004) in-process cycle guard, never serialized
        seen.add(id(cur))
        best_flow = None
        for f in flows:
            dst = f.get("args", {}).get("dst")
            if dst is not None:
                if dst != cur["name"]:
                    continue
            elif (
                f["dst_track"] != cur["track"]
                or abs(f["dst_ts"] - cur["t0"]) > 1e-6
            ):
                continue
            if best_flow is None or f["src_ts"] > best_flow["src_ts"]:
                best_flow = f
        prev_same = None
        for s in by_track[cur["track"]]:
            if s is cur or s["t1"] > cur["t0"] + _EPS:
                continue
            if prev_same is None or s["t1"] > prev_same["t1"]:
                prev_same = s
        flow_rel = best_flow["src_ts"] if best_flow is not None else None
        prev_rel = prev_same["t1"] if prev_same is not None else None
        if flow_rel is None and prev_rel is None:
            rev.append((cur, "wait"))  # leading gap back to window start
            cur = None
        elif prev_rel is None or (
            flow_rel is not None and flow_rel >= prev_rel
        ):
            rev.append((cur, "transfer"))
            # producer span: by the flow's recorded src task id, else by
            # finish-timestamp on the source track
            src_name = best_flow.get("args", {}).get("src")
            producer = None
            for s in by_track.get(best_flow["src_track"], []):
                if src_name is not None and s["name"] == src_name:
                    producer = s
                    break
                if src_name is None and abs(s["t1"] - flow_rel) <= 1e-6:
                    producer = s
            cur = producer
        else:
            rev.append((cur, "wait"))
            cur = prev_same

    # -- forward tiling: cursor guarantees the exact-sum invariant -----
    breakdown = {"compute": 0.0, "transfer": 0.0, "dispatch": 0.0,
                 "idle": 0.0}
    path: List[PathStep] = []
    wait_gaps: List[Tuple[float, float]] = []
    cursor = w0
    for span, kind in reversed(rev):
        gap = max(span["t0"] - cursor, 0.0)
        if gap > 0:
            lo, hi = cursor, span["t0"]
            if kind == "transfer":
                breakdown["transfer"] += gap
            else:
                disp = _overlap(lo, hi, host_union)
                breakdown["dispatch"] += disp
                breakdown["idle"] += gap - disp
            wait_gaps.append((lo, hi))
        compute = max(span["t1"] - max(span["t0"], cursor), 0.0)
        breakdown["compute"] += compute
        path.append(PathStep(
            name=span["name"], track=span["track"],
            t0=span["t0"], t1=span["t1"], cat=span.get("cat", "task"),
            wait_kind=kind if gap > 0 else "", wait_s=gap,
        ))
        cursor = max(cursor, span["t1"])
    makespan = cursor - w0

    # -- per-device busy/idle, stragglers, bubbles ---------------------
    per_device: Dict[str, Dict[str, float]] = {}
    last_finishes: Dict[str, float] = {}
    idle_by_dev: Dict[str, List[Tuple[float, float]]] = {}
    for track, spans in by_track.items():
        busy_union = _merge([(s["t0"], s["t1"]) for s in spans])
        busy = sum(b - a for a, b in busy_union)
        last = max(s["t1"] for s in spans)
        idles: List[Tuple[float, float]] = []
        prev_end = w0
        for a, b in busy_union:
            if a > prev_end + _EPS:
                idles.append((prev_end, a))
            prev_end = max(prev_end, b)
        if cursor > prev_end + _EPS:
            idles.append((prev_end, cursor))  # tail idle up to makespan
        idle_by_dev[track] = idles
        per_device[track] = {
            "busy_s": busy,
            "idle_s": max(makespan - busy, 0.0),
            "utilization": busy / makespan if makespan > 0 else 0.0,
            "last_finish_s": last - w0,
            "n_spans": float(len(spans)),
        }
        last_finishes[track] = last

    stragglers: List[str] = []
    if len(last_finishes) >= 2 and makespan > 0:
        med = statistics.median(last_finishes.values())
        stragglers = sorted(
            t for t, f in last_finishes.items()
            if f - med > straggler_frac * makespan
        )

    bubbles: List[Dict[str, Any]] = []
    for track, idles in idle_by_dev.items():
        for a, b in idles:
            ov = _overlap(a, b, _merge(list(wait_gaps)))
            if ov > _EPS:
                bubbles.append({
                    "device": track, "t0": a - w0, "t1": b - w0,
                    "duration_s": b - a, "critical_overlap_s": ov,
                })
    bubbles.sort(key=lambda b: -b["critical_overlap_s"])

    return Attribution(
        makespan_s=makespan,
        window=(w0, cursor),
        breakdown_s=breakdown,
        critical_path=path,
        per_device=per_device,
        stragglers=stragglers,
        bubbles=bubbles,
    )


def attribute_run(
    tracer: Tracer,
    window: Optional[Tuple[float, float]] = None,
    straggler_frac: float = 0.10,
) -> Attribution:
    """Attribute a live tracer's record.

    With no explicit ``window``, the last completed ``execute`` span
    bounds the analysis (so an ambient tracer that observed several
    executes attributes the most recent one); without one, the full
    span extent is used.
    """
    dev_spans: List[Dict[str, Any]] = []
    program_spans: List[Dict[str, Any]] = []
    host_spans: List[Dict[str, Any]] = []
    flows: List[Dict[str, Any]] = []
    execute: Optional[Dict[str, Any]] = None
    for ev in tracer.events:
        if ev["type"] == "span":
            if ev["t1"] is None:
                continue
            if ev["track"] == HOST_TRACK:
                host_spans.append(ev)
                if ev["name"] == "execute":
                    execute = ev  # events append at end(): last wins
            elif ev["cat"] in _DEVICE_CATS:
                dev_spans.append(ev)
            elif ev["cat"] == _PROGRAM_CAT:
                program_spans.append(ev)
        elif ev["type"] == "flow":
            flows.append(ev)
    if not dev_spans:
        dev_spans = program_spans  # compiled run: program-level fallback
    if window is None and execute is not None:
        window = (execute["t0"], execute["t1"])
    return _attribute(
        dev_spans, host_spans, flows, window, straggler_frac,
    )


def attribute_trace(
    obj_or_path: Any,
    window: Optional[Tuple[float, float]] = None,
    straggler_frac: float = 0.10,
) -> Attribution:
    """Attribute an exported Chrome/Perfetto trace (path or dict).

    Parses the ``traceEvents`` back into span/flow records: thread-name
    metadata maps tids to tracks, ``X`` events become spans (µs → s),
    and ``s``/``f`` pairs are re-joined by flow id.  Works on both the
    tracer export and the schedule-timings export.
    """
    obj = obj_or_path
    if isinstance(obj_or_path, (str, os.PathLike)):
        with open(obj_or_path) as f:
            obj = json.load(f)
    events = obj.get("traceEvents", []) if isinstance(obj, dict) else []
    track_of: Dict[Any, str] = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            track_of[ev.get("tid")] = ev.get("args", {}).get("name", "")
    dev_spans: List[Dict[str, Any]] = []
    program_spans: List[Dict[str, Any]] = []
    host_spans: List[Dict[str, Any]] = []
    starts: Dict[Any, Dict[str, Any]] = {}
    ends: Dict[Any, Dict[str, Any]] = {}
    execute: Optional[Dict[str, Any]] = None
    for ev in events:
        ph = ev.get("ph")
        if ph == "X":
            track = track_of.get(ev.get("tid"), f"tid{ev.get('tid')}")
            span = {
                "name": ev.get("name", ""), "track": track,
                "cat": ev.get("cat", ""),
                "t0": ev.get("ts", 0.0) / _US,
                "t1": (ev.get("ts", 0.0) + ev.get("dur", 0.0)) / _US,
                "args": ev.get("args", {}),
            }
            if track == HOST_TRACK:
                host_spans.append(span)
                if span["name"] == "execute":
                    execute = span
            elif span["cat"] in _DEVICE_CATS:
                dev_spans.append(span)
            elif span["cat"] == _PROGRAM_CAT:
                program_spans.append(span)
        elif ph == "s":
            starts[ev.get("id")] = ev
        elif ph == "f":
            ends[ev.get("id")] = ev
    if not dev_spans:
        dev_spans = program_spans  # compiled run: program-level fallback
    flows: List[Dict[str, Any]] = []
    for fid, s in starts.items():
        e = ends.get(fid)
        if e is None:
            continue
        args = dict(s.get("args", {}) or {})
        args.update(e.get("args", {}) or {})
        flows.append({
            "name": s.get("name", ""), "cat": s.get("cat", ""),
            "src_track": track_of.get(s.get("tid"), ""),
            "src_ts": s.get("ts", 0.0) / _US,
            "dst_track": track_of.get(e.get("tid"), ""),
            "dst_ts": e.get("ts", 0.0) / _US,
            "args": args,
        })
    if window is None and execute is not None:
        window = (execute["t0"], execute["t1"])
    return _attribute(
        dev_spans, host_spans, flows, window, straggler_frac,
    )


__all__ = [
    "Attribution",
    "PathStep",
    "attribute_run",
    "attribute_trace",
]
