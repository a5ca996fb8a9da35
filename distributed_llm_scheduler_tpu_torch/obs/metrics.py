"""Metrics registry: counters / gauges / histograms with a stable JSON
snapshot schema.

Framework-free copy of ``distributed_llm_scheduler_tpu.obs.metrics`` (the
``dls.metrics/1`` schema), so the port's decode engine keeps the same
always-on registry without importing the JAX package:

```json
{"schema": "dls.metrics/1",
 "counters":   {"<name>": {"value": 0, "unit": null}},
 "gauges":     {"<name>": {"value": 0, "max": 0, "unit": null}},
 "histograms": {"<name>": {"count": 0, "sum": 0, "min": 0, "max": 0,
                           "mean": 0, "p50": 0, "p95": 0, "p99": 0,
                           "unit": null}}}
```

Metric names are dotted lowercase (``decode.ttft_s``); the ``_s`` /
``_bytes`` / ``_pages`` suffix states the unit in the name, and the
``unit`` field repeats it machine-readably.  Recording is plain Python
arithmetic, cheap enough for the engine to record at every segment
boundary.
"""

from __future__ import annotations

import random
import zlib
from typing import Any, Dict, List, Optional

SCHEMA = "dls.metrics/1"

# histograms keep at most this many raw samples for the percentile
# estimate; count/sum/min/max stay exact beyond it.  Beyond the cap the
# samples are a uniform reservoir (Algorithm R), not the first N observed
_HIST_CAP = 4096


class Counter:
    """Monotonic accumulator (events, bytes)."""

    __slots__ = ("value", "unit")

    def __init__(self, unit: Optional[str] = None):
        self.value: float = 0
        self.unit = unit

    def inc(self, n: float = 1) -> None:
        self.value += n


class Gauge:
    """Last-value-wins sample with a high-water mark (occupancy, depth)."""

    __slots__ = ("value", "max", "unit")

    def __init__(self, unit: Optional[str] = None):
        self.value: float = 0
        self.max: float = 0
        self.unit = unit

    def set(self, v: float) -> None:
        self.value = v
        if v > self.max:
            self.max = v


class Histogram:
    """Distribution sketch (latencies): exact count/sum/min/max,
    p50/p95/p99 from a :data:`_HIST_CAP`-slot uniform reservoir with a
    per-histogram seeded PRNG (two runs observing the same sequence keep
    identical reservoirs)."""

    __slots__ = ("count", "sum", "min", "max", "unit", "_samples", "_rng")

    def __init__(self, unit: Optional[str] = None, seed: int = 0):
        self.count = 0
        self.sum: float = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.unit = unit
        self._samples: List[float] = []
        self._rng = random.Random(seed)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        if len(self._samples) < _HIST_CAP:
            self._samples.append(v)
        else:
            # Algorithm R: keep the new sample with prob cap/count
            j = self._rng.randrange(self.count)
            if j < _HIST_CAP:
                self._samples[j] = v

    def _quantile(self, q: float) -> Optional[float]:
        if not self._samples:
            return None
        s = sorted(self._samples)
        return s[min(int(q * len(s)), len(s) - 1)]


class MetricsRegistry:
    """Get-or-create registry; re-requesting a name returns the same
    instrument (the first declared unit wins).  ``prefix`` namespaces
    every instrument; ``replica`` stamps the snapshot."""

    def __init__(self, prefix: str = "",
                 replica: Optional[str] = None) -> None:
        self.prefix = str(prefix)
        self.replica = replica
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    def _name(self, name: str) -> str:
        return self.prefix + name if self.prefix else name

    def counter(self, name: str, unit: Optional[str] = None) -> Counter:
        name = self._name(name)
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(unit)
        return c

    def gauge(self, name: str, unit: Optional[str] = None) -> Gauge:
        name = self._name(name)
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(unit)
        return g

    def histogram(self, name: str, unit: Optional[str] = None) -> Histogram:
        name = self._name(name)
        h = self._hists.get(name)
        if h is None:
            # name-derived seed: deterministic across runs, distinct
            # per histogram, no global random state
            h = self._hists[name] = Histogram(
                unit, seed=zlib.crc32(name.encode("utf-8"))
            )
        return h

    def snapshot(self) -> Dict[str, Any]:
        """Stable JSON-ready view (see module docstring for the schema)."""
        out: Dict[str, Any] = {
            "schema": SCHEMA,
            "counters": {
                n: {"value": c.value, "unit": c.unit}
                for n, c in sorted(self._counters.items())
            },
            "gauges": {
                n: {"value": g.value, "max": g.max, "unit": g.unit}
                for n, g in sorted(self._gauges.items())
            },
            "histograms": {
                n: {
                    "count": h.count,
                    "sum": h.sum,
                    "min": h.min,
                    "max": h.max,
                    "mean": (h.sum / h.count) if h.count else None,
                    "p50": h._quantile(0.50),
                    "p95": h._quantile(0.95),
                    "p99": h._quantile(0.99),
                    "unit": h.unit,
                }
                for n, h in sorted(self._hists.items())
            },
        }
        if self.replica is not None:
            out["replica"] = str(self.replica)
        return out


__all__ = ["SCHEMA", "Counter", "Gauge", "Histogram", "MetricsRegistry"]
