"""Observability the paged decode engine always carries: the metrics
registry and the one clock resolver (framework-free copies of the JAX
package's ``obs.metrics`` and ``obs.clockutil``)."""

from .clockutil import Clock, default_clock, resolve_clock
from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = [
    "Clock", "default_clock", "resolve_clock",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
]
