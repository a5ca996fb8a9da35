"""Soak health gate: turn time series into leak/degradation findings.

The drift doctor gates numerics (per-tensor worst ulp ratio), the
memory doctor gates peaks (per-device watermark ratio); this module
gates TRENDS.  A soak that ends with the same pool occupancy, HBM
footprint, jit-cache size, and latency percentiles it had after warmup
is healthy no matter how long it ran; one whose ``pool.used_pages``
series has a positive Theil–Sen slope at matched load is leaking pages
and will eventually wedge admission, however healthy every individual
snapshot looks.

Each :class:`Detector` names one series, a breach direction, and a
slope threshold in the series' natural units per second; evaluation
excludes the warmup prefix (compile classes closing, pool filling to
steady state — growth there is expected) and uses the robust
Theil–Sen estimator from :mod:`.timeseries`, so a single pause or
spike cannot fake or hide a trend.  Breaches become
:class:`HealthFinding` rows shaped like the analysis layer's
Diagnostics (stable ``HLTxxx`` codes, severity, message), and
:class:`HealthReport` exposes the same gate surface as
``MemDriftReport``: ``exceeds()`` for CI, ``worst_breach()`` for the
CLI's exit-1 message, ``summary()`` for humans.  The flight recorder
grows a matching ``health=`` trigger so the first mid-soak breach
dumps the ring while the anomaly's events are still in it.

Detector taxonomy (all enabled by default):

========  ==========================  ======================================
code      detector                    breach means
========  ==========================  ======================================
HLT001    page_leak                   ``pool.orphan_pages`` (allocated but
                                      attributed to no live request) grows —
                                      pages withheld from the free list
HLT002    hbm_growth                  ``hbm.live_bytes`` grows monotonically
                                      after warmup — device buffers leak
HLT003    jit_cache_growth            ``jit.prefill_entries`` grows after the
                                      compile classes should be closed —
                                      recompile churn
HLT004    ttft_degradation            trailing p95 TTFT climbs — admission
                                      latency degrades under sustained load
HLT005    queue_wait_degradation      trailing p95 queue wait climbs —
                                      backlog is not reaching steady state
HLT006    throughput_decay            windowed tok/s falls over time —
                                      the engine is slowing down
========  ==========================  ======================================

The PyTorch port's copy of ``distributed_llm_scheduler_tpu.obs.health``: framework-free,
so the port keeps it without importing the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .timeseries import TimeSeriesStore

SEVERITIES = ("info", "warning", "error")


@dataclass
class HealthFinding:
    """One detector verdict, Diagnostic-shaped for the doctor CLIs."""

    code: str               # stable HLTxxx identifier
    severity: str           # "info" | "warning" | "error"
    detector: str
    series: str
    slope: Optional[float]  # Theil-Sen, series units per second
    threshold: float        # breach threshold, same units
    message: str

    def to_json(self) -> Dict[str, Any]:
        return {
            "code": self.code,
            "severity": self.severity,
            "detector": self.detector,
            "series": self.series,
            "slope": self.slope,
            "threshold": self.threshold,
            "message": self.message,
        }


@dataclass(frozen=True)
class Detector:
    """One trend rule: series + direction + slope threshold.

    ``direction`` "+" breaches when the slope EXCEEDS ``threshold``
    (growth is bad: leaks, latency creep); "-" breaches when the slope
    falls below ``-threshold`` (decay is bad: throughput).  Thresholds
    are strictly positive in the series' natural units per second; the
    default of 0 samples is tolerated — a series the run never produced
    yields an info finding, not a crash, because a soak without memprof
    wired still wants its page gate.
    """

    name: str
    code: str
    series: str
    threshold: float
    direction: str = "+"
    severity: str = "error"

    def __post_init__(self):
        if self.direction not in ("+", "-"):
            raise ValueError(
                f"detector {self.name!r}: direction must be '+' or '-', "
                f"got {self.direction!r}"
            )
        if self.threshold <= 0.0:
            raise ValueError(
                f"detector {self.name!r}: threshold must be > 0, "
                f"got {self.threshold}"
            )
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"detector {self.name!r}: unknown severity "
                f"{self.severity!r}"
            )

    def evaluate(self, store: TimeSeriesStore,
                 warmup_s: float) -> HealthFinding:
        series = store._series.get(self.series)
        slope = None if series is None else series.slope(since_t=warmup_s)
        if slope is None:
            n = 0 if series is None else len(series)
            return HealthFinding(
                code=self.code, severity="info", detector=self.name,
                series=self.series, slope=None, threshold=self.threshold,
                message=(
                    f"{self.name}: series {self.series!r} has {n} "
                    f"point(s) after warmup ({warmup_s:g}s) — no trend "
                    f"to judge"
                ),
            )
        breached = (slope > self.threshold if self.direction == "+"
                    else slope < -self.threshold)
        if breached:
            verb = "grows" if self.direction == "+" else "decays"
            return HealthFinding(
                code=self.code, severity=self.severity,
                detector=self.name, series=self.series, slope=slope,
                threshold=self.threshold,
                message=(
                    f"{self.name}: {self.series} {verb} at "
                    f"{slope:+.6g}/s past warmup "
                    f"(threshold {self.threshold:g}/s)"
                ),
            )
        return HealthFinding(
            code=self.code, severity="info", detector=self.name,
            series=self.series, slope=slope, threshold=self.threshold,
            message=(
                f"{self.name}: {self.series} slope {slope:+.6g}/s "
                f"within {self.threshold:g}/s"
            ),
        )


def default_detectors() -> List[Detector]:
    """The soak doctor's standard battery (HLT001–HLT006).

    The thresholds are calibrated against the serve scenario's measured
    behavior at steady load over a short window:

    * ``pool.orphan_pages`` is 0 EXACTLY on a healthy engine (a page is
      either free or attributed to a live request), so its threshold is
      a numerical floor — one withheld free per request blows through
      it within seconds;
    * the in-flight-occupancy, latency, and throughput series carry
      genuine queueing noise even at steady load (Poisson arrivals over
      a seconds-long window), so their thresholds sit a few times above
      the measured healthy noise floor and an order of magnitude below
      the injected-fault signal.
    """
    return [
        Detector("page_leak", "HLT001", "pool.orphan_pages",
                 threshold=0.05),                  # pages/s orphaned
        Detector("hbm_growth", "HLT002", "hbm.live_bytes",
                 threshold=256.0 * 1024),          # bytes/s of growth
        Detector("jit_cache_growth", "HLT003", "jit.prefill_entries",
                 threshold=3.0),                   # entries/s
        Detector("ttft_degradation", "HLT004", "ttft.p95_s",
                 threshold=0.15),                  # s of p95 per s
        Detector("queue_wait_degradation", "HLT005", "qwait.p95_s",
                 threshold=0.15),                  # s of p95 per s
        Detector("throughput_decay", "HLT006", "throughput.tok_s",
                 threshold=25.0, direction="-"),   # tok/s lost per s
    ]


class HealthReport:
    """All detector verdicts for one soak; the gate surface mirrors
    ``MemDriftReport`` (``exceeds`` / worst offender / ``summary``)."""

    def __init__(self, findings: List[HealthFinding], warmup_s: float):
        self.findings = findings
        self.warmup_s = warmup_s

    def breaches(self) -> List[HealthFinding]:
        return [f for f in self.findings if f.severity == "error"]

    def exceeds(self) -> bool:
        """True when any detector breached at error severity — the
        CI/exit-code gate."""
        return bool(self.breaches())

    def worst_breach(self) -> Optional[HealthFinding]:
        """The breach with the largest slope/threshold ratio — what the
        soak CLI names on exit 1."""
        worst, worst_ratio = None, -1.0
        for f in self.breaches():
            if f.slope is None:
                continue
            ratio = abs(f.slope) / f.threshold
            if ratio > worst_ratio:
                worst, worst_ratio = f, ratio
        return worst

    def slopes(self) -> Dict[str, Optional[float]]:
        """Detector name -> measured slope (None when unjudgeable)."""
        return {f.detector: f.slope for f in self.findings}

    def summary(self) -> str:
        lines = [
            f"health: {len(self.findings)} detector(s), "
            f"{len(self.breaches())} breach(es), "
            f"warmup {self.warmup_s:g}s excluded"
        ]
        for f in self.findings:
            mark = "BREACH" if f.severity == "error" else "ok"
            slope = "n/a" if f.slope is None else f"{f.slope:+.6g}/s"
            lines.append(
                f"  [{mark:6s}] {f.code} {f.detector:24s} "
                f"{f.series:22s} slope={slope}"
            )
        return "\n".join(lines)

    def to_json(self) -> Dict[str, Any]:
        return {
            "warmup_s": self.warmup_s,
            "exceeds": self.exceeds(),
            "findings": [f.to_json() for f in self.findings],
        }


@dataclass
class HealthMonitor:
    """Run a detector battery over a :class:`TimeSeriesStore`.

    ``warmup_s`` is the timestamp (store-clock seconds) before which
    samples are excluded from every trend: pool fill, compile-class
    growth, and latency settling during warmup are expected and would
    otherwise read as breaches at steady state.
    """

    warmup_s: float = 0.0
    detectors: List[Detector] = field(default_factory=default_detectors)

    def evaluate(self, store: TimeSeriesStore) -> HealthReport:
        return HealthReport(
            [d.evaluate(store, self.warmup_s) for d in self.detectors],
            warmup_s=self.warmup_s,
        )


def report_from_soak_artifact(obj: Dict[str, Any]) -> HealthReport:
    """Re-gate a saved ``dls.soak/1`` artifact offline (``doctor
    --soak``): rebuild a store from the embedded timeseries snapshot
    and re-run the default battery with the artifact's warmup.

    Raises ``ValueError`` on a malformed artifact — the caller maps
    that to exit 2.
    """
    from .timeseries import validate_timeseries

    if not isinstance(obj, dict) or "timeseries" not in obj:
        raise ValueError("soak artifact has no timeseries block")
    ts = obj["timeseries"]
    errs = validate_timeseries(ts)
    if errs:
        raise ValueError(
            "soak artifact timeseries malformed: " + "; ".join(errs[:5])
        )
    warmup = obj.get("config", {}).get("warmup_s", 0.0)
    if not isinstance(warmup, (int, float)) or warmup < 0:
        raise ValueError(f"soak artifact warmup_s invalid: {warmup!r}")
    store = TimeSeriesStore(capacity=max(int(ts.get("capacity", 512)), 2))
    for name, row in ts["series"].items():
        s = store.series(name, unit=row.get("unit"))
        for t, v in row["points"]:
            s.append(t, v)
    return HealthMonitor(warmup_s=float(warmup)).evaluate(store)


__all__ = [
    "Detector",
    "HealthFinding",
    "HealthMonitor",
    "HealthReport",
    "default_detectors",
    "report_from_soak_artifact",
]
