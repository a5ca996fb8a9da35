"""Observability of the port: framework-free copies of the JAX package's
``obs`` modules, wired into the device backend and the paged decode
engine.

* :mod:`.trace` — structured span tracer (nested spans, categories,
  injectable clock);
* :mod:`.metrics` — counters/gauges/histograms with a stable JSON
  snapshot schema;
* :mod:`.export` — Chrome/Perfetto rendering of a tracer's timeline or a
  timed schedule;
* :mod:`.attribution` — measured critical path and the compute /
  transfer / dispatch / idle split that tiles the makespan;
* :mod:`.memprof` — per-device memory timelines with watermark
  attribution;
* :mod:`.reqlog` — per-request lifecycle records (``dls.requests/1``);
* :mod:`.slo` — sliding-window SLO accounting over the request log;
* :mod:`.flight` — bounded ring-buffer flight recorder that dumps trace
  and request log on a breach;
* :mod:`.reqtrace` — per-request waterfall tracks;
* :mod:`.interference` — per-request latency attribution into wait and
  compute buckets that tile its end-to-end time;
* :mod:`.clockutil` — the one clock resolver;
* :mod:`.timeseries` — bounded time series, Theil–Sen trends and the
  soak sampler;
* :mod:`.health` — the soak doctor's detectors (HLT001–HLT006);
* :mod:`.fleet` — fleet-level snapshot merge and health report.

Everything is opt-in: pass ``trace=Tracer()`` / ``metrics=`` /
``memprof=`` to ``DeviceBackend.execute`` (or ``tracer=``/``flight=``/
``memprof=`` to the paged decode engine), or set ``DLS_TRACE=1``
(``DLS_FLIGHT=1``) so every ``execute`` and engine in the process
records into one shared tracer and registry (flight recorder).  With
neither, the ambient getters return ``None`` and every instrumented path
skips all recording behind ``if tracer is not None`` checks.

The JAX package's ``drift`` and ``memdrift`` modules are not ported.
"""

from __future__ import annotations

from typing import Optional

from ..utils.env import env_flag
from .attribution import Attribution, attribute_run, attribute_trace
from .clockutil import Clock, default_clock, resolve_clock
from .fleet import (
    FleetHealthReport,
    fleet_detectors,
    merge_snapshots,
    report_from_fleet_artifact,
    validate_fleet_health,
)
from .flight import FlightRecorder, RingTracer, TeeTracer
from .health import (
    Detector,
    HealthFinding,
    HealthMonitor,
    HealthReport,
    default_detectors,
    report_from_soak_artifact,
)
from .interference import (
    InterferenceReport,
    attribute_requests,
    events_from_perfetto,
)
from .memprof import MemoryProfiler
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    diff_snapshots,
    validate_snapshot,
)
from .reqlog import (
    RequestLog,
    RequestRecord,
    stitch_logical_chains,
    summarize_request_log,
    validate_request_log,
)
from .reqtrace import RequestTraceRecorder, base_rid, request_track
from .slo import SLOPolicy, SLOReport, evaluate_slo
from .timeseries import (
    Series,
    SoakSampler,
    TimeSeriesStore,
    load_timeseries,
    save_timeseries,
    snapshot_at,
    theil_sen_slope,
    validate_timeseries,
)
from .trace import HOST_TRACK, Tracer

_ambient_tracer: Optional[Tracer] = None
_ambient_metrics: Optional[MetricsRegistry] = None
_ambient_flight: Optional[FlightRecorder] = None


def trace_enabled() -> bool:
    """True when ``DLS_TRACE`` requests ambient observability."""
    return env_flag("DLS_TRACE")


def ambient_tracer() -> Optional[Tracer]:
    """The process-wide tracer when ``DLS_TRACE`` is set, else None.
    Created lazily on first use; one tracer accumulates every run in the
    process so the export is a single timeline."""
    global _ambient_tracer
    if not trace_enabled():
        return None
    if _ambient_tracer is None:
        _ambient_tracer = Tracer()
    return _ambient_tracer


def ambient_metrics() -> Optional[MetricsRegistry]:
    """The process-wide registry when ``DLS_TRACE`` is set, else None."""
    global _ambient_metrics
    if not trace_enabled():
        return None
    if _ambient_metrics is None:
        _ambient_metrics = MetricsRegistry()
    return _ambient_metrics


def flight_enabled() -> bool:
    """True when ``DLS_FLIGHT`` requests the ambient flight recorder."""
    return env_flag("DLS_FLIGHT")


def ambient_flight() -> Optional[FlightRecorder]:
    """The process-wide flight recorder when ``DLS_FLIGHT`` is set, else
    None: with the env var unset and no recorder passed, the engine's hot
    paths see None and do no work (there is no no-op recorder)."""
    global _ambient_flight
    if not flight_enabled():
        return None
    if _ambient_flight is None:
        _ambient_flight = FlightRecorder()
    return _ambient_flight


def reset_ambient() -> None:
    """Drop the ambient tracer, registry and flight recorder."""
    global _ambient_tracer, _ambient_metrics, _ambient_flight
    _ambient_tracer = None
    _ambient_metrics = None
    _ambient_flight = None


__all__ = [
    "Attribution", "attribute_run", "attribute_trace",
    "Clock", "default_clock", "resolve_clock",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "diff_snapshots", "validate_snapshot",
    "Detector", "HealthFinding", "HealthMonitor", "HealthReport",
    "default_detectors", "report_from_soak_artifact",
    "FleetHealthReport", "fleet_detectors", "merge_snapshots",
    "report_from_fleet_artifact", "validate_fleet_health",
    "FlightRecorder", "RingTracer", "TeeTracer",
    "InterferenceReport", "attribute_requests", "events_from_perfetto",
    "MemoryProfiler",
    "RequestLog", "RequestRecord", "stitch_logical_chains",
    "summarize_request_log", "validate_request_log",
    "RequestTraceRecorder", "base_rid", "request_track",
    "SLOPolicy", "SLOReport", "evaluate_slo",
    "Series", "SoakSampler", "TimeSeriesStore", "load_timeseries",
    "save_timeseries", "snapshot_at", "theil_sen_slope",
    "validate_timeseries",
    "HOST_TRACK", "Tracer",
    "ambient_flight", "ambient_metrics", "ambient_tracer",
    "flight_enabled", "reset_ambient", "trace_enabled",
]
