"""Sliding-window SLO accounting over the request log.

An aggregate histogram over a whole run cannot detect an SLO breach
*now*: a burst of slow TTFTs in one second disappears into thousands of
fast warm samples.  This module evaluates an :class:`SLOPolicy`
(TTFT/TPOT/e2e targets at a chosen percentile) over **sliding
wall-clock windows** of the request log (:mod:`.reqlog`):

- per-window streaming p50/p95/p99 for each latency metric,
- goodput — tokens delivered by requests that MET the policy — versus
  raw throughput, per window and overall,
- breach detection that names the breaching window and metric,
- an :class:`SLOReport` with an ``exceeds()`` gate mirroring the
  drift/memdrift reports, so CI and the ``slo`` CLI gate the same way
  everything else in this repo gates.

Window assignment follows where the *evidence* lands on the wall clock:
a TTFT sample belongs to the window containing the first-token time
(that is when the breach is observable), TPOT and e2e samples to the
window containing the retire time, and tokens to the window of their
delivery event — so a request straddling two windows contributes
throughput to both, which is exactly what a live dashboard would show.
Empty windows report null percentiles and can never breach.

The report's JSON schema is ``dls.slo/1``.

The PyTorch port's copy of ``distributed_llm_scheduler_tpu.obs.slo``,
whole (framework-free).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from .reqlog import RequestLog

SCHEMA = "dls.slo/1"

#: metric name -> (policy target attr, which timestamp anchors the window)
_METRICS = ("ttft_s", "tpot_s", "e2e_s")
_ANCHOR = {"ttft_s": "t_first_token", "tpot_s": "t_retire",
           "e2e_s": "t_retire"}
_PCTS = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))


@dataclass(frozen=True)
class SLOPolicy:
    """Latency targets evaluated per sliding window.

    A ``None`` target disables that metric.  ``percentile`` picks which
    per-window quantile is compared against the targets (the usual
    serving contract is p95 or p99); goodput always judges each request
    against the raw targets, not the percentile.
    """

    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None
    e2e_s: Optional[float] = None
    window_s: float = 1.0
    percentile: str = "p95"

    def __post_init__(self) -> None:
        if self.window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {self.window_s}")
        if self.percentile not in dict(_PCTS):
            raise ValueError(
                f"percentile must be one of {[p for p, _ in _PCTS]}, "
                f"got {self.percentile!r}"
            )
        if not any(self.targets().values()):
            raise ValueError("policy has no targets (all None)")

    def targets(self) -> Dict[str, Optional[float]]:
        return {"ttft_s": self.ttft_s, "tpot_s": self.tpot_s,
                "e2e_s": self.e2e_s}

    def request_meets(self, row: Dict[str, Any]) -> bool:
        """Does one request (a ``dls.requests/1`` row) meet every
        applicable target?  Drives the goodput split.  A metric the
        request cannot exhibit (single-token TPOT) is vacuously met."""
        for metric, target in self.targets().items():
            if target is None:
                continue
            v = row.get(metric)
            if v is not None and v > target:
                return False
        return True

    def to_json(self) -> Dict[str, Any]:
        return {
            "ttft_s": self.ttft_s, "tpot_s": self.tpot_s,
            "e2e_s": self.e2e_s, "window_s": self.window_s,
            "percentile": self.percentile,
        }


def _quantiles(vals: List[float]) -> Dict[str, Optional[float]]:
    if not vals:
        return {p: None for p, _ in _PCTS}
    s = sorted(vals)
    return {p: s[min(int(f * len(s)), len(s) - 1)] for p, f in _PCTS}


@dataclass
class SLOReport:
    """Windowed evaluation of one policy over one request log."""

    policy: SLOPolicy
    t0: float                       # wall-clock origin of window 0
    windows: List[Dict[str, Any]]   # per-window stats (see evaluate_slo)
    breaches: List[Dict[str, Any]]  # window idx + metric + value + target
    n_requests: int
    n_retired: int
    tokens_total: int               # raw throughput numerator
    tokens_good: int                # goodput numerator (SLO-meeting reqs)

    def exceeds(self) -> bool:
        """Gate: True when any window breached the policy — mirrors
        DriftReport/MemDriftReport so callers gate uniformly."""
        return bool(self.breaches)

    @property
    def goodput_frac(self) -> Optional[float]:
        if self.tokens_total == 0:
            return None
        return self.tokens_good / self.tokens_total

    def worst_breach(self) -> Optional[Dict[str, Any]]:
        """The breach with the largest value/target ratio — the one the
        CLI names when exiting 1."""
        if not self.breaches:
            return None
        return max(self.breaches, key=lambda b: b["value"] / b["target"])

    def summary(self) -> Dict[str, Any]:
        return {
            "schema": SCHEMA,
            "policy": self.policy.to_json(),
            "t0": self.t0,
            "n_windows": len(self.windows),
            "windows": self.windows,
            "breaches": self.breaches,
            "breached": self.exceeds(),
            "n_requests": self.n_requests,
            "n_retired": self.n_retired,
            "tokens_total": self.tokens_total,
            "tokens_good": self.tokens_good,
            "goodput_frac": self.goodput_frac,
        }


def evaluate_slo(log: Any, policy: SLOPolicy,
                 t_end: Optional[float] = None) -> SLOReport:
    """Evaluate ``policy`` over ``log`` (a :class:`RequestLog` or a
    ``dls.requests/1`` snapshot dict).

    Windows tile the wall clock from the earliest submit time in steps
    of ``policy.window_s``; ``t_end`` (default: latest event observed)
    closes the last window so a live caller can evaluate "up to now".
    """
    snap = log.snapshot() if isinstance(log, RequestLog) else log
    rows: List[Dict[str, Any]] = list(snap.get("requests", []))

    if not rows:
        return SLOReport(policy=policy, t0=0.0, windows=[], breaches=[],
                         n_requests=0, n_retired=0, tokens_total=0,
                         tokens_good=0)

    t0 = min(float(r["t_submit"]) for r in rows)
    events: List[float] = [t0]
    for r in rows:
        for f in ("t_admit", "t_first_token", "t_retire"):
            if r.get(f) is not None:
                events.append(float(r[f]))
        for t, _n in r.get("deliveries", []):
            events.append(float(t))
    hi = max(events) if t_end is None else max(float(t_end), t0)
    w = policy.window_s
    # a sample exactly at ``hi`` must land inside the last window
    # (half-open [t0+k*w, t0+(k+1)*w)), hence the +1 when hi is on edge
    n_win = max(1, int(math.floor((hi - t0) / w)) + 1)

    def widx(t: float) -> int:
        return min(max(int((t - t0) // w), 0), n_win - 1)

    # per-window accumulators
    samples: List[Dict[str, List[float]]] = [
        {m: [] for m in _METRICS} for _ in range(n_win)
    ]
    tok_total = [0] * n_win
    tok_good = [0] * n_win
    n_retired = 0
    tokens_good_sum = 0

    for r in rows:
        retired = r.get("state") == "retired"
        if retired:
            n_retired += 1
        meets = policy.request_meets(r)
        for metric in _METRICS:
            v = r.get(metric)
            anchor = r.get(_ANCHOR[metric])
            if v is None or anchor is None:
                continue
            samples[widx(float(anchor))][metric].append(float(v))
        for t, n in r.get("deliveries", []):
            i = widx(float(t))
            tok_total[i] += int(n)
            if meets and retired:
                tok_good[i] += int(n)
                tokens_good_sum += int(n)

    windows: List[Dict[str, Any]] = []
    breaches: List[Dict[str, Any]] = []
    targets = policy.targets()
    for i in range(n_win):
        row: Dict[str, Any] = {
            "window": i,
            "t_start": t0 + i * w,
            "t_end": t0 + (i + 1) * w,
            "tokens": tok_total[i],
            "tokens_good": tok_good[i],
        }
        for metric in _METRICS:
            q = _quantiles(samples[i][metric])
            row[metric] = dict(q, n=len(samples[i][metric]))
            target = targets[metric]
            v = q[policy.percentile]
            if target is not None and v is not None and v > target:
                breaches.append({
                    "window": i,
                    "t_start": row["t_start"],
                    "t_end": row["t_end"],
                    "metric": metric,
                    "percentile": policy.percentile,
                    "value": v,
                    "target": target,
                })
        windows.append(row)

    return SLOReport(
        policy=policy, t0=t0, windows=windows, breaches=breaches,
        n_requests=len(rows), n_retired=n_retired,
        tokens_total=sum(tok_total), tokens_good=tokens_good_sum,
    )


__all__ = ["SCHEMA", "SLOPolicy", "SLOReport", "evaluate_slo"]
