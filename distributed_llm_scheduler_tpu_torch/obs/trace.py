"""Structured span tracer: the host-side event recorder behind DLS_TRACE.

One :class:`Tracer` instance records everything a run emits — nested
spans (phases of ``DeviceBackend.execute``, per-launch dispatch windows,
decode-engine segments), instant markers (fences, retires), counter
samples (page-pool occupancy, queue depth), and flow edges (cross-device
transfers) — as plain dicts on a Python list.  Nothing is interpreted at
record time; :mod:`..obs.export` renders the list as a Chrome/Perfetto
``traceEvents`` JSON after the run.

Design constraints, in order:

* **Zero overhead when off.**  Tracing is opt-in; every instrumented hot
  path guards with ``if tracer is not None`` and does *no* work
  otherwise.
  There is deliberately no no-op tracer object: a None check is cheaper
  than a dispatched no-op method call, and the call sites stay honest
  about what runs in the disabled path.
* **Injectable clock.**  ``Tracer(clock=...)`` takes any ``() -> float``
  seconds source; tests drive a fake clock and assert exact span
  nesting/ordering.  Default is ``time.perf_counter`` — the same
  timebase the backend's measured timings use, so profile-mode task
  walls and tracer spans land on one consistent timeline.
* **Host-side only.**  Spans bound *host* observations (dispatch
  windows, segment round-trips); device-side truth comes from CUDA
  events (profile-mode task timings, a captured rung's replay windows),
  which callers record via :meth:`Tracer.complete` with explicit
  timestamps on the host clock.

Track names are free-form strings; by convention ``"host"``
(:data:`HOST_TRACK`) carries the execute phases and every device node_id
(``node_0`` …) carries its launches.

The PyTorch port's copy of ``distributed_llm_scheduler_tpu.obs.trace``: framework-free,
so the port keeps it without importing the JAX package.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional

from .clockutil import resolve_clock

HOST_TRACK = "host"

# event categories (Chrome "cat" field): the execute phase machine plus
# the decode engine's lifecycle
CAT_SCHEDULE = "schedule"   # dispatch-order linearization
CAT_PLAN = "plan"           # plan build + warmup compilation
CAT_STAGE = "stage"         # param placement + transfer staging
CAT_LAUNCH = "launch"       # executable calls (tasks, groups, segments)
CAT_COLLECT = "collect"     # end-of-run fence + readbacks
CAT_TASK = "task"           # per-task device spans (profile timings)
CAT_TRANSFER = "transfer"   # cross-device flow edges
CAT_DECODE = "decode"       # paged decode engine lifecycle


class Tracer:
    """Append-only event recorder with an injectable clock.

    Events are dicts with a ``type`` discriminant:

    * ``span``:    {name, track, cat, t0, t1, args}
    * ``instant``: {name, track, cat, t, args}
    * ``counter``: {name, t, value}
    * ``flow``:    {name, cat, id, src_track, src_ts, dst_track, dst_ts,
                    args}

    Timestamps are raw clock values (seconds); the exporter normalizes
    to the earliest event.  Not thread-safe — the dispatch loop and the
    decode engine are single-threaded host code, and keeping the record
    path to a dict literal + ``list.append`` is what keeps enabled-mode
    overhead per launch in the sub-microsecond range.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self.clock: Callable[[], float] = resolve_clock(clock)
        self.events: List[Dict[str, Any]] = []
        self._open: List[Dict[str, Any]] = []
        self._flow_id = 0

    def now(self) -> float:
        return self.clock()

    # -- spans -------------------------------------------------------------
    def begin(
        self, name: str, track: str = HOST_TRACK, cat: str = "host",
        **args: Any,
    ) -> Dict[str, Any]:
        """Open a span; close it with :meth:`end`.  For phases whose
        boundaries straddle control flow (the rep loop); prefer
        :meth:`span` where a ``with`` block fits."""
        ev = {
            "type": "span", "name": name, "track": track, "cat": cat,
            "t0": self.clock(), "t1": None, "args": args,
        }
        self._open.append(ev)
        return ev

    def end(self, ev: Dict[str, Any], **args: Any) -> Dict[str, Any]:
        ev["t1"] = self.clock()
        if args:
            ev["args"].update(args)
        if ev in self._open:
            self._open.remove(ev)
        self.events.append(ev)
        return ev

    @contextmanager
    def span(
        self, name: str, track: str = HOST_TRACK, cat: str = "host",
        **args: Any,
    ) -> Iterator[Dict[str, Any]]:
        ev = self.begin(name, track=track, cat=cat, **args)
        try:
            yield ev
        finally:
            self.end(ev)

    def complete(
        self, name: str, t0: float, t1: float,
        track: str = HOST_TRACK, cat: str = "host", **args: Any,
    ) -> Dict[str, Any]:
        """Record a span with caller-measured timestamps (profile-mode
        task timings, replayed schedules)."""
        ev = {
            "type": "span", "name": name, "track": track, "cat": cat,
            "t0": t0, "t1": t1, "args": args,
        }
        self.events.append(ev)
        return ev

    # -- points ------------------------------------------------------------
    def instant(
        self, name: str, track: str = HOST_TRACK, cat: str = "host",
        t: Optional[float] = None, **args: Any,
    ) -> Dict[str, Any]:
        ev = {
            "type": "instant", "name": name, "track": track, "cat": cat,
            "t": self.clock() if t is None else t, "args": args,
        }
        self.events.append(ev)
        return ev

    def counter(
        self, name: str, value: float, t: Optional[float] = None,
    ) -> Dict[str, Any]:
        """One sample of a counter track (pool occupancy, queue depth).
        Each distinct ``name`` renders as its own Perfetto counter row."""
        ev = {
            "type": "counter", "name": name,
            "t": self.clock() if t is None else t, "value": value,
        }
        self.events.append(ev)
        return ev

    def flow(
        self, name: str, src_track: str, src_ts: float,
        dst_track: str, dst_ts: float, cat: str = CAT_TRANSFER,
        **args: Any,
    ) -> Dict[str, Any]:
        """A flow arrow between two points on (usually different) tracks —
        the cross-device transfer edge.  The exporter emits the Chrome
        ``s``/``f`` pair binding to the enclosing slices."""
        self._flow_id += 1
        ev = {
            "type": "flow", "name": name, "cat": cat, "id": self._flow_id,
            "src_track": src_track, "src_ts": src_ts,
            "dst_track": dst_track, "dst_ts": dst_ts, "args": args,
        }
        self.events.append(ev)
        return ev

    # -- introspection -----------------------------------------------------
    def tracks(self) -> List[str]:
        """Distinct span/instant tracks, host first, then sorted."""
        seen: Dict[str, None] = {}
        for ev in self.events:
            if ev["type"] in ("span", "instant"):
                seen.setdefault(ev["track"])
        rest = sorted(t for t in seen if t != HOST_TRACK)
        return ([HOST_TRACK] if HOST_TRACK in seen else []) + rest

    def counter_names(self) -> List[str]:
        return sorted({
            ev["name"] for ev in self.events if ev["type"] == "counter"
        })

    def __len__(self) -> int:
        return len(self.events)
