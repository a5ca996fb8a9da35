"""Always-on flight recorder: bounded rings, dump-on-trigger.

Post-hoc diagnosis of a transient stall today requires having run with
``DLS_TRACE=1`` from the start — the full tracer grows without bound, so
nobody leaves it on in a long run, so the one segment that stalled is
never in the trace.  The flight recorder is the aviation answer: record
*always*, into fixed-size ring buffers (last-N spans + counter samples
via :class:`RingTracer`, last-N request lifecycles via the bounded
:class:`~.reqlog.RequestLog`), and dump a full Perfetto trace + request
log only when a trigger fires:

* an SLO breach (:meth:`~.slo.SLOReport.exceeds`),
* near-OOM headroom (a :class:`~.memdrift.MemDriftReport` whose
  headroom block carries ``warn`` entries),
* a straggler device (:class:`~.attribution.Attribution.stragglers`),
* a soak health breach (:meth:`~.health.HealthReport.exceeds` — a
  leak/degradation trend crossing its detector threshold mid-soak).

Memory is O(capacity) regardless of run length — ``collections.deque``
with ``maxlen`` evicts the oldest event on each append — and the
disabled path keeps the ambient tracer's discipline: when no flight
recorder is wired, engine hot paths see ``tracer is None`` and do no
work at all (there is no no-op recorder object).

:class:`TeeTracer` covers the both-worlds case: a caller who passed an
explicit tracer AND wants the flight ring gets every event recorded
once into the primary tracer and mirrored (same dict objects, no copy)
into the ring.

The PyTorch port's copy of ``distributed_llm_scheduler_tpu.obs.flight``: framework-free,
so the port keeps it without importing the JAX package.
"""

from __future__ import annotations

import json
import os
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional

from .clockutil import resolve_clock
from .reqlog import RequestLog
from .trace import HOST_TRACK, Tracer


class RingTracer(Tracer):
    """A :class:`Tracer` whose event store is a bounded ring.

    ``events`` is a ``deque(maxlen=capacity)``: every record method and
    the Perfetto exporter only ever ``append`` to / iterate over it, so
    the whole tracer surface works unchanged while the oldest event is
    evicted in O(1) once the ring is full.  Spans enter the ring when
    they *close* (``end``/``complete``); a span still open at dump time
    is not in the buffer.
    """

    def __init__(
        self, capacity: int = 4096,
        clock: Optional[Callable[[], float]] = None,
    ):
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0, got {capacity}")
        super().__init__(clock=clock)
        self.capacity = capacity
        self.events: Any = deque(maxlen=capacity)  # type: ignore[assignment]


class TeeTracer:
    """Forward the tracer surface to a primary :class:`Tracer`, mirroring
    every finished event dict into a secondary sink's ring.

    The primary executes each call (its clock, its open-span stack, its
    flow ids — introspection delegates to it); the mirror receives the
    SAME event dicts by reference, so teeing costs one ``deque.append``
    per event and the two sinks can never disagree on timestamps.
    """

    def __init__(self, primary: Tracer, mirror: Tracer):
        self.primary = primary
        self.mirror = mirror

    # -- the Tracer recording surface, forwarded ---------------------------
    @property
    def events(self) -> List[Dict[str, Any]]:
        return self.primary.events

    @property
    def clock(self) -> Callable[[], float]:
        return self.primary.clock

    def now(self) -> float:
        return self.primary.now()

    def begin(self, name: str, track: str = HOST_TRACK, cat: str = "host",
              **args: Any) -> Dict[str, Any]:
        # nothing to mirror yet: the event reaches both sinks at end()
        return self.primary.begin(name, track=track, cat=cat, **args)

    def end(self, ev: Dict[str, Any], **args: Any) -> Dict[str, Any]:
        self.primary.end(ev, **args)
        self.mirror.events.append(ev)
        return ev

    @contextmanager
    def span(self, name: str, track: str = HOST_TRACK, cat: str = "host",
             **args: Any) -> Iterator[Dict[str, Any]]:
        ev = self.begin(name, track=track, cat=cat, **args)
        try:
            yield ev
        finally:
            self.end(ev)

    def complete(self, name: str, t0: float, t1: float,
                 track: str = HOST_TRACK, cat: str = "host",
                 **args: Any) -> Dict[str, Any]:
        ev = self.primary.complete(name, t0, t1, track=track, cat=cat,
                                   **args)
        self.mirror.events.append(ev)
        return ev

    def instant(self, name: str, track: str = HOST_TRACK,
                cat: str = "host", t: Optional[float] = None,
                **args: Any) -> Dict[str, Any]:
        ev = self.primary.instant(name, track=track, cat=cat, t=t, **args)
        self.mirror.events.append(ev)
        return ev

    def counter(self, name: str, value: float,
                t: Optional[float] = None) -> Dict[str, Any]:
        ev = self.primary.counter(name, value, t=t)
        self.mirror.events.append(ev)
        return ev

    def flow(self, name: str, src_track: str, src_ts: float,
             dst_track: str, dst_ts: float, **kw: Any) -> Dict[str, Any]:
        ev = self.primary.flow(name, src_track, src_ts, dst_track, dst_ts,
                               **kw)
        self.mirror.events.append(ev)
        return ev

    def tracks(self) -> List[str]:
        return self.primary.tracks()

    def counter_names(self) -> List[str]:
        return self.primary.counter_names()

    def __len__(self) -> int:
        return len(self.primary)


class FlightRecorder:
    """Bounded always-on recorder with dump-on-trigger.

    Wire it into the decode engine (``flight=FlightRecorder()``): the
    engine records spans/counters into :attr:`tracer` (the ring) and
    request lifecycles into :attr:`reqlog` (bounded, oldest retired
    records evicted first).  After (or during) a run, call
    :meth:`maybe_dump` with whatever evidence is at hand — an
    :class:`~.slo.SLOReport`, a :class:`~.memdrift.MemDriftReport`, an
    :class:`~.attribution.Attribution` — and the recorder writes a
    Perfetto trace + ``dls.requests/1`` log iff a trigger fired.
    """

    def __init__(
        self,
        capacity: int = 4096,
        request_capacity: int = 256,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.clock: Callable[[], float] = resolve_clock(clock)
        self.tracer = RingTracer(capacity, clock=self.clock)
        self.reqlog = RequestLog(clock=self.clock,
                                 capacity=request_capacity)
        self.dumps: List[Dict[str, Any]] = []

    # -- triggers ----------------------------------------------------------
    @staticmethod
    def triggers(
        slo_report: Any = None,
        memdrift: Any = None,
        attribution: Any = None,
        health: Any = None,
        chunk_stalls: Any = None,
        chunk_stall_min: int = 3,
    ) -> List[str]:
        """Evaluate the trigger conditions; returns human-readable
        reasons (empty list == nothing to dump).

        ``chunk_stalls`` is a trailing window of ``decode.chunk_stalls``
        counter samples (monotonic totals, e.g.
        :meth:`chunk_stall_samples`): SUSTAINED growth — at least
        ``chunk_stall_min`` new stalls accumulated across two or more
        rising steps — means a chunked prefill is being starved of its
        per-segment budget RIGHT NOW, the transient the ring exists to
        capture."""
        reasons: List[str] = []
        if slo_report is not None and slo_report.exceeds():
            worst = slo_report.worst_breach()
            reasons.append(
                "slo_breach: {metric} {percentile}={value:.6g}s > "
                "{target:.6g}s in window {window}".format(**worst)
            )
        if memdrift is not None:
            headroom = getattr(memdrift, "headroom", memdrift)
            if isinstance(headroom, dict):
                for dev in sorted(headroom):
                    entry = headroom[dev]
                    if isinstance(entry, dict) and entry.get("warn"):
                        reasons.append(
                            f"near_oom: {dev} headroom "
                            f"{entry.get('headroom_frac', 0.0):.1%}"
                        )
        if attribution is not None:
            for dev in getattr(attribution, "stragglers", []) or []:
                reasons.append(f"straggler: {dev}")
        if health is not None and health.exceeds():
            for f in health.breaches():
                slope = "n/a" if f.slope is None else f"{f.slope:+.6g}"
                reasons.append(
                    f"health_breach: {f.code} {f.detector} "
                    f"{f.series} slope={slope}/s > {f.threshold:g}/s"
                )
        if chunk_stalls:
            vals = [float(v) for v in chunk_stalls]
            growth = vals[-1] - vals[0]
            rising = sum(
                1 for a, b in zip(vals, vals[1:]) if b > a
            )
            if growth >= chunk_stall_min and rising >= 2:
                reasons.append(
                    f"chunk_stall: +{growth:g} stalls over "
                    f"{len(vals)} trailing samples"
                )
        return reasons

    def chunk_stall_samples(self, window: int = 32) -> List[float]:
        """The trailing ``decode.chunk_stalls`` counter totals still in
        the ring (the engine samples the counter into the tracer at
        every stall) — feed these to :meth:`triggers`/:meth:`maybe_dump`
        as ``chunk_stalls``."""
        vals = [
            float(ev["value"]) for ev in self.tracer.events
            if ev["type"] == "counter"
            and ev["name"] == "decode.chunk_stalls"
        ]
        return vals[-window:]

    # -- dumping -----------------------------------------------------------
    def dump(self, out_dir: str, reasons: List[str]) -> Dict[str, Any]:
        """Unconditionally write the rings to ``out_dir``:
        ``flight_trace.json`` (Perfetto, passes ``validate_trace``) and
        ``flight_requests.json`` (``dls.requests/1`` plus the trigger
        provenance)."""
        from .export import export_perfetto

        os.makedirs(out_dir, exist_ok=True)
        trace_path = os.path.join(out_dir, "flight_trace.json")
        req_path = os.path.join(out_dir, "flight_requests.json")
        export_perfetto(self.tracer, trace_path,
                        process_name="dls-flight")
        payload = {
            "reasons": list(reasons),
            "dumped_at": self.clock(),
            "ring_capacity": self.tracer.capacity,
            "ring_events": len(self.tracer.events),
            "request_log": self.reqlog.snapshot(),
        }
        with open(req_path, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        record = {"reasons": list(reasons), "trace": trace_path,
                  "requests": req_path}
        self.dumps.append(record)
        return record

    def maybe_dump(
        self,
        out_dir: str,
        slo_report: Any = None,
        memdrift: Any = None,
        attribution: Any = None,
        health: Any = None,
        chunk_stalls: Any = None,
    ) -> Optional[Dict[str, Any]]:
        """Dump iff a trigger fires; returns the dump record or None."""
        reasons = self.triggers(slo_report=slo_report, memdrift=memdrift,
                                attribution=attribution, health=health,
                                chunk_stalls=chunk_stalls)
        if not reasons:
            return None
        return self.dump(out_dir, reasons)


__all__ = ["FlightRecorder", "RingTracer", "TeeTracer"]
