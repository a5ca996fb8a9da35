"""Bounded-memory time series for soak runs.

The metrics registry answers "how much right now" (last value, running
percentiles); a soak doctor needs "how has it MOVED over the last
hour" — page-pool occupancy creeping two pages per minute is invisible
in a gauge and obvious in a series.  Storing every sample is not an
option: the flight recorder's discipline applies (O(capacity) memory
regardless of run length), but a ring that evicts the oldest point
would also evict the evidence — a leak is precisely a difference
between the start and the end of the run.

:class:`Series` therefore keeps the WHOLE run span at decaying
resolution: a fixed-capacity buffer with deterministic 2:1 decimation.
Samples are admitted only when their global index is a multiple of the
current ``stride``; when an admitted sample would overflow the
capacity, every other retained point is dropped (even positions kept)
and the stride doubles.  The retained set is always exactly::

    {sample i : i % stride == 0}

a pure function of the number of samples offered — never of when the
overflow happened to fire (``tests/test_soak.py`` asserts this
determinism), so a virtual-time soak's series is bitwise reproducible.
Memory is O(capacity) per series for any run length.

On top of the store:

* :func:`theil_sen_slope` — the robust trend estimator the health
  detectors use (median of pairwise slopes; a single GC pause or
  compile spike cannot fake or hide a leak the way least-squares can);
* :class:`SoakSampler` — folds the live surfaces (metrics registry,
  memprof live bytes, engine page occupancy + jit-cache entries,
  frontend latency percentiles) into named series at each sample tick;
* the ``dls.timeseries/1`` schema with ``validate_timeseries`` and a
  save/load round trip, plus :func:`snapshot_at` which rematerializes a
  ``dls.metrics/1``-shaped snapshot from one sample index so ``metrics
  diff --at/--vs`` can compare start-of-soak against end-of-soak.

The PyTorch port's copy of ``distributed_llm_scheduler_tpu.obs.timeseries``: framework-free,
so the port keeps it without importing the JAX package.
"""

from __future__ import annotations

import json
from statistics import median
from typing import Any, Callable, Dict, List, Optional

from .clockutil import resolve_clock

SCHEMA = "dls.timeseries/1"


def theil_sen_slope(
    ts: List[float], vs: List[float]
) -> Optional[float]:
    """Median of all pairwise slopes ``(v_j - v_i) / (t_j - t_i)``.

    Robust to a minority of outliers (breakdown point ~29%): one
    stop-the-world pause or warmup spike shifts least-squares but not
    the median slope.  O(n^2) pairs is fine — n is capacity-bounded.
    Returns None when fewer than two points have distinct timestamps.
    """
    slopes: List[float] = []
    n = len(ts)
    if n != len(vs):
        raise ValueError(f"length mismatch: {n} ts vs {len(vs)} vs")
    for i in range(n):
        for j in range(i + 1, n):
            dt = ts[j] - ts[i]
            if dt != 0.0:
                slopes.append((vs[j] - vs[i]) / dt)
    if not slopes:
        return None
    return float(median(slopes))


class Series:
    """One named series: a capacity-bounded (t, v) buffer with
    deterministic 2:1 decimation (see module docstring)."""

    __slots__ = ("name", "unit", "capacity", "stride", "offered",
                 "ts", "vs")

    def __init__(self, name: str, capacity: int = 512,
                 unit: Optional[str] = None):
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self.name = name
        self.unit = unit
        self.capacity = capacity
        self.stride = 1          # admit every stride-th offered sample
        self.offered = 0         # total samples ever offered
        self.ts: List[float] = []
        self.vs: List[float] = []

    def append(self, t: float, v: float) -> None:
        """Offer one sample; admitted iff its global index is a
        multiple of the current stride.  Timestamps must not move
        backwards — a soak whose clock jumps back has a broken timebase
        and silently accepting it would corrupt every slope."""
        i = self.offered
        self.offered += 1
        if i % self.stride != 0:
            return
        if self.ts and t < self.ts[-1]:
            raise ValueError(
                f"series {self.name!r}: non-monotone timestamp "
                f"{t} after {self.ts[-1]}"
            )
        if len(self.ts) >= self.capacity:
            # 2:1 decimation: keep even positions.  Retained indices
            # were exactly {i % stride == 0}; keeping every other one
            # leaves {i % (2*stride) == 0}, so admission stays a pure
            # function of the global index.
            self.ts = self.ts[::2]
            self.vs = self.vs[::2]
            self.stride *= 2
            if i % self.stride != 0:
                return
        self.ts.append(float(t))
        self.vs.append(float(v))

    def __len__(self) -> int:
        return len(self.ts)

    def last(self) -> Optional[float]:
        return self.vs[-1] if self.vs else None

    def window(self, since_t: Optional[float] = None):
        """The trailing ``(ts, vs)`` with timestamps >= ``since_t``
        (everything when None) — the detectors' warmup exclusion."""
        if since_t is None:
            return list(self.ts), list(self.vs)
        k = 0
        while k < len(self.ts) and self.ts[k] < since_t:
            k += 1
        return self.ts[k:], self.vs[k:]

    def slope(self, since_t: Optional[float] = None) -> Optional[float]:
        """Theil–Sen trend over the trailing window (units: value/s)."""
        ts, vs = self.window(since_t)
        return theil_sen_slope(ts, vs)

    def to_json(self) -> Dict[str, Any]:
        return {
            "unit": self.unit,
            "capacity": self.capacity,
            "stride": self.stride,
            "offered": self.offered,
            "points": [[t, v] for t, v in zip(self.ts, self.vs)],
        }


class TimeSeriesStore:
    """Get-or-create registry of :class:`Series` sharing one clock and
    one default capacity; the soak harness owns exactly one."""

    def __init__(self, capacity: int = 512,
                 clock: Optional[Callable[[], float]] = None):
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self.capacity = capacity
        self.clock = resolve_clock(clock)
        self._series: Dict[str, Series] = {}

    def series(self, name: str, unit: Optional[str] = None) -> Series:
        s = self._series.get(name)
        if s is None:
            s = self._series[name] = Series(
                name, capacity=self.capacity, unit=unit
            )
        return s

    def record(self, name: str, value: float,
               t: Optional[float] = None,
               unit: Optional[str] = None) -> None:
        self.series(name, unit=unit).append(
            self.clock() if t is None else t, value
        )

    def names(self) -> List[str]:
        return sorted(self._series)

    def __len__(self) -> int:
        return len(self._series)

    def snapshot(self) -> Dict[str, Any]:
        """The ``dls.timeseries/1`` dict (see :func:`validate_timeseries`
        for the contract)."""
        return {
            "schema": SCHEMA,
            "capacity": self.capacity,
            "series": {
                name: self._series[name].to_json()
                for name in sorted(self._series)
            },
        }


def validate_timeseries(obj: Any) -> List[str]:
    """Structural check of a ``dls.timeseries/1`` snapshot; returns
    human-readable problems (empty list == valid)."""
    errs: List[str] = []
    if not isinstance(obj, dict):
        return [f"timeseries is {type(obj).__name__}, not dict"]
    if obj.get("schema") != SCHEMA:
        errs.append(f"schema is {obj.get('schema')!r}, want {SCHEMA!r}")
    series = obj.get("series")
    if not isinstance(series, dict):
        return errs + ["series block missing or not a dict"]
    for name, row in series.items():
        if not isinstance(row, dict):
            errs.append(f"series.{name} is not a dict")
            continue
        for f in ("unit", "capacity", "stride", "offered", "points"):
            if f not in row:
                errs.append(f"series.{name} missing {f!r}")
        pts = row.get("points")
        if not isinstance(pts, list):
            errs.append(f"series.{name}.points is not a list")
            continue
        cap = row.get("capacity")
        if isinstance(cap, int) and len(pts) > cap:
            errs.append(
                f"series.{name}: {len(pts)} points exceed capacity {cap}"
            )
        prev_t = None
        for i, p in enumerate(pts):
            if (not isinstance(p, list) or len(p) != 2
                    or not all(isinstance(x, (int, float)) for x in p)):
                errs.append(f"series.{name}.points[{i}] is not [t, v]")
                break
            if prev_t is not None and p[0] < prev_t:
                errs.append(
                    f"series.{name}: non-monotone t at point {i}"
                )
                break
            prev_t = p[0]
    return errs


def save_timeseries(store_or_snap: Any, path: str) -> None:
    """Write a store (or an already-taken snapshot) as
    ``dls.timeseries/1`` JSON."""
    snap = (store_or_snap.snapshot()
            if isinstance(store_or_snap, TimeSeriesStore)
            else store_or_snap)
    errs = validate_timeseries(snap)
    if errs:
        raise ValueError("refusing to save malformed timeseries: "
                         + "; ".join(errs[:5]))
    with open(path, "w") as f:
        json.dump(snap, f, indent=1, sort_keys=True)


def load_timeseries(path: str) -> Dict[str, Any]:
    """Load and validate a ``dls.timeseries/1`` snapshot; raises
    ``ValueError`` naming the first problems when malformed."""
    with open(path) as f:
        obj = json.load(f)
    errs = validate_timeseries(obj)
    if errs:
        raise ValueError(
            f"malformed timeseries {path}: " + "; ".join(errs[:5])
        )
    return obj


def snapshot_at(ts_obj: Dict[str, Any], index: int) -> Dict[str, Any]:
    """Rematerialize one sample index of a ``dls.timeseries/1`` snapshot
    as a ``dls.metrics/1``-shaped gauge snapshot.

    ``index`` addresses each series' retained points with Python
    semantics (negative indexes from the end: ``-1`` is end-of-soak).
    Series too short to hold the index are skipped — after decimation
    different series can legitimately retain different point counts.
    The result validates against the metrics schema, so
    ``diff_snapshots`` (and the ``metrics diff --at/--vs`` CLI) consume
    it unchanged.
    """
    errs = validate_timeseries(ts_obj)
    if errs:
        raise ValueError("malformed timeseries: " + "; ".join(errs[:5]))
    gauges: Dict[str, Any] = {}
    for name in sorted(ts_obj["series"]):
        row = ts_obj["series"][name]
        pts = row["points"]
        if not pts or index >= len(pts) or index < -len(pts):
            continue
        t, v = pts[index]
        upto = pts[:index + 1] if index >= 0 else pts[:len(pts) + index + 1]
        gauges[name] = {
            "value": v,
            "max": max(p[1] for p in upto),
            "unit": row.get("unit"),
            "t": t,
        }
    return {
        "schema": "dls.metrics/1",
        "counters": {},
        "gauges": gauges,
        "histograms": {},
    }


class SoakSampler:
    """Fold the live health surfaces into named series at each tick.

    Reads only — sampling never advances a clock, mutates engine state,
    or dispatches device work, which is what keeps an instrumented
    virtual-time soak bit-identical to a bare one.  Wire whichever
    surfaces exist; missing ones simply contribute no series:

    * ``engine`` — ``page_occupancy()`` (``pool.used_pages`` /
      ``pool.free_pages``, plus ``pool.orphan_pages`` = used minus the
      pages attributed to live requests — the leak signal: exactly 0 on
      a healthy engine at ANY load, monotone under a withheld free),
      queue depth, and the jit-cache entry count
      (``jit.prefill_entries``);
    * ``metrics`` — the cumulative token counter
      (``tok.delivered_total``) plus ``throughput.tok_s``, the delivery
      rate over a trailing :attr:`RATE_WINDOW` lookback (per-sample
      deltas are bursty at segment granularity; the lookback keeps the
      decay detector judging the trend, not the jitter);
    * ``memprof`` — live bytes summed over devices (``hbm.live_bytes``);
    * ``frontend`` — trailing p95 TTFT / queue-wait over the most
      recently completed requests (``ttft.p95_s`` / ``qwait.p95_s``).
    """

    #: completed-request window for the latency percentile series
    LATENCY_WINDOW = 32

    #: trailing lookback (seconds) for the throughput series
    RATE_WINDOW = 1.0

    def __init__(
        self,
        store: TimeSeriesStore,
        engine: Any = None,
        metrics: Any = None,
        memprof: Any = None,
        frontend: Any = None,
    ):
        self.store = store
        self.engine = engine
        self.metrics = metrics
        self.memprof = memprof
        self.frontend = frontend
        self._tok_hist: List[Any] = []   # (t, cumulative tokens)
        self.samples = 0

    def _latency_p95(self, metric: str) -> Optional[float]:
        rows = [
            r for r in self.frontend.request_rows()
            if r.get(metric) is not None
        ]
        if not rows:
            return None
        vals = sorted(
            float(r[metric]) for r in rows[-self.LATENCY_WINDOW:]
        )
        return vals[min(int(0.95 * len(vals)), len(vals) - 1)]

    def sample(self, t: Optional[float] = None) -> None:
        """Take one sample of every wired surface at time ``t``
        (defaults to the store's clock)."""
        now = self.store.clock() if t is None else t
        rec = self.store.record
        if self.engine is not None:
            occ = self.engine.page_occupancy()
            rec("pool.used_pages", occ["used_pages"], t=now, unit="pages")
            rec("pool.free_pages", occ["free_pages"], t=now, unit="pages")
            rec("pool.orphan_pages",
                occ["used_pages"] - sum(occ["per_request"].values()),
                t=now, unit="pages")
            rec("queue.depth", len(self.engine._queue), t=now,
                unit="requests")
            rec("jit.prefill_entries", len(self.engine._prefill_cache),
                t=now, unit="entries")
        if self.metrics is not None:
            tokens = self.metrics.counter("decode.tokens_delivered").value
            rec("tok.delivered_total", tokens, t=now, unit="tokens")
            self._tok_hist.append((now, tokens))
            # keep ONE anchor older than the lookback so the rate spans
            # at least RATE_WINDOW once enough history exists
            while (len(self._tok_hist) >= 2
                   and now - self._tok_hist[1][0] >= self.RATE_WINDOW):
                self._tok_hist.pop(0)
            t_old, v_old = self._tok_hist[0]
            if now > t_old:
                rec("throughput.tok_s", (tokens - v_old) / (now - t_old),
                    t=now, unit="tok/s")
        if self.memprof is not None:
            live = sum(
                self.memprof.live_bytes(d) for d in self.memprof.devices()
            )
            rec("hbm.live_bytes", live, t=now, unit="bytes")
        if self.frontend is not None:
            for metric, name in (("ttft_s", "ttft.p95_s"),
                                 ("queue_wait_s", "qwait.p95_s")):
                p95 = self._latency_p95(metric)
                if p95 is not None:
                    rec(name, p95, t=now, unit="s")
        self.samples += 1


__all__ = [
    "SCHEMA",
    "Series",
    "SoakSampler",
    "TimeSeriesStore",
    "load_timeseries",
    "save_timeseries",
    "snapshot_at",
    "theil_sen_slope",
    "validate_timeseries",
]
