"""Observability the paged decode engine and the serving layer carry:
framework-free copies of the JAX package's ``obs`` modules that serving
reads.

* :mod:`.metrics` — the metrics registry;
* :mod:`.clockutil` — the one clock resolver;
* :mod:`.reqlog` — per-request lifecycle records (``dls.requests/1``);
* :mod:`.slo` — sliding-window SLO accounting over the request log;
* :mod:`.interference` — per-request latency attribution into wait and
  compute buckets that tile its end-to-end time.

The tracer, flight recorder, memory profiler, request traces, time
series and health doctors are not ported.
"""

from .clockutil import Clock, default_clock, resolve_clock
from .interference import (
    InterferenceReport,
    attribute_requests,
    events_from_perfetto,
)
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .reqlog import (
    RequestLog,
    RequestRecord,
    stitch_logical_chains,
    summarize_request_log,
    validate_request_log,
)
from .slo import SLOPolicy, SLOReport, evaluate_slo

__all__ = [
    "Clock", "default_clock", "resolve_clock",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "InterferenceReport", "attribute_requests", "events_from_perfetto",
    "RequestLog", "RequestRecord", "stitch_logical_chains",
    "summarize_request_log", "validate_request_log",
    "SLOPolicy", "SLOReport", "evaluate_slo",
]
