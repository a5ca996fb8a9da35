"""Exact per-request latency attribution over the waterfall tracks.

:mod:`.attribution` answers "where did the RUN's makespan go" with an
exact tiling invariant (components sum to the makespan to 1e-9).  This
module is the same discipline applied per REQUEST: every request's
end-to-end latency is decomposed into eight buckets

    {queue_wait, chunk_budget_contention, page_pool_wait,
     preempted_time, prefill_compute, decode_compute, cow_overhead,
     idle}

that tile ``[t_submit, t_retire]`` exactly on the virtual clock — the
buckets sum to ``e2e_s`` to within :data:`EPS`, asserted per request.
TTFT/TPOT rederived from the track's lifecycle instants are checked
BITWISE against the request-log row (both surfaces record the same
hoisted clock reads, so equality is ``==`` on floats, not a tolerance).

Two input modes:

* **spans** — rows plus the :class:`~.reqtrace.RequestTraceRecorder`
  event stream (a live tracer's ``events`` list, or a flight-recorder
  Perfetto dump re-parsed by :func:`events_from_perfetto`).  Wait spans
  carry cause codes and aggressor lists, so contention lands in its
  true bucket and the aggressor→victim ranking is exact.
* **rows-only** — just the request rows (a ``dls.serve/1`` artifact
  leg, a ``dls.requests/1`` snapshot).  The lifecycle timestamps tile
  e2e into queue/prefill/decode exactly; contention attribution falls
  back to residency overlap (who held the engine while I queued),
  ranked ``via="residency"``.

The aggressor ranking sums, over every wait span, the span's seconds
split across the requests the engine NAMED as the cause (the FIFO head,
the page holders, the budget consumers, the preemptor).  The top pairs
are the routing signal the multi-engine roadmap item wants: a replica
whose breaches attribute to ``page_pool_wait`` needs pages, not fewer
requests.

The PyTorch port's copy of ``distributed_llm_scheduler_tpu.obs.
interference``, whole (framework-free); the four request-trace constants
it reads from ``obs/reqtrace.py``, which is not ported, are copied here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

# the request-trace event vocabulary (``obs/reqtrace.py``'s constants)
CAT_WAIT = "reqwait"
CAT_EXEC = "reqexec"
CAT_LIFE = "reqlife"
TRACK_PREFIX = "req:"

EPS = 1e-9

SCHEMA = "dls.interference/1"

BUCKETS = (
    "queue_wait",
    "chunk_budget_contention",
    "page_pool_wait",
    "preempted_time",
    "prefill_compute",
    "decode_compute",
    "cow_overhead",
    "idle",
)

#: buckets that are WAITING (a finding's dominant bucket must be one of
#: these — a request dominated by its own compute is slow, not
#: interfered with)
WAIT_BUCKETS = (
    "queue_wait", "chunk_budget_contention", "page_pool_wait",
    "preempted_time",
)

_CAUSE_BUCKET = {
    "queued": "queue_wait",
    "head_of_line": "queue_wait",
    "slots_full": "queue_wait",
    "defer_tier": "queue_wait",
    "page_pool": "page_pool_wait",
    "chunk_budget": "chunk_budget_contention",
    "preempted": "preempted_time",
}

_EXEC_BUCKET = {
    "prefill": "prefill_compute",
    "prefill_chunk": "prefill_compute",
    "decode_segment": "decode_compute",
    "cow_split": "cow_overhead",
}


def _span_bucket(ev: Dict[str, Any]) -> Optional[str]:
    if ev.get("cat") == CAT_WAIT:
        return _CAUSE_BUCKET.get(ev.get("args", {}).get("cause"))
    if ev.get("cat") == CAT_EXEC:
        return _EXEC_BUCKET.get(ev.get("name"))
    return None


def events_from_perfetto(obj: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Re-parse an exported Perfetto trace (``flight_trace.json``) back
    into tracer-shaped event dicts (seconds, absolute-within-trace).

    Only the ``req:*`` waterfall rows matter here; the exporter
    normalized timestamps to the earliest event, so offline attribution
    re-anchors each request at its ``submit`` instant (bitwise claims
    are a LIVE-events property — microsecond rounding already happened
    on disk)."""
    tracks: Dict[int, str] = {}
    for ev in obj.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            tracks[ev.get("tid")] = ev.get("args", {}).get("name", "")
    out: List[Dict[str, Any]] = []
    for ev in obj.get("traceEvents", []):
        track = tracks.get(ev.get("tid"), "")
        if not track.startswith(TRACK_PREFIX):
            continue
        if ev.get("ph") == "X":
            t0 = float(ev.get("ts", 0.0)) / 1e6
            out.append({
                "type": "span", "name": ev.get("name"), "track": track,
                "cat": ev.get("cat", ""), "t0": t0,
                "t1": t0 + float(ev.get("dur", 0.0)) / 1e6,
                "args": ev.get("args", {}) or {},
            })
        elif ev.get("ph") == "i":
            out.append({
                "type": "instant", "name": ev.get("name"),
                "track": track, "cat": ev.get("cat", ""),
                "t": float(ev.get("ts", 0.0)) / 1e6,
                "args": ev.get("args", {}) or {},
            })
    return out


@dataclass
class InterferenceReport:
    """Per-request bucket decomposition + aggressor ranking.

    ``requests`` rows carry the buckets, the residual, and the bitwise
    check; ``aggressors`` is the ranked aggressor→victim list;
    ``findings`` the breaching requests whose dominant bucket is a wait
    crossing ``threshold`` — the ``doctor --requests`` exit-1 signal.
    """

    mode: str
    requests: List[Dict[str, Any]] = field(default_factory=list)
    totals: Dict[str, float] = field(default_factory=dict)
    aggressors: List[Dict[str, Any]] = field(default_factory=list)
    findings: List[Dict[str, Any]] = field(default_factory=list)
    threshold: float = 0.5
    ttft_target_s: Optional[float] = None
    n_rows: int = 0
    n_attributed: int = 0
    n_skipped: int = 0

    def max_residual_s(self) -> float:
        return max(
            (abs(r["residual_s"]) for r in self.requests), default=0.0
        )

    def ttft_bitwise_all(self) -> bool:
        return all(
            r.get("ttft_bitwise") is not False for r in self.requests
        )

    def exceeds(self) -> bool:
        return bool(self.findings)

    def summary(self, *, requests: bool = True) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "schema": SCHEMA,
            "mode": self.mode,
            "n_rows": self.n_rows,
            "n_attributed": self.n_attributed,
            "n_skipped": self.n_skipped,
            "threshold": self.threshold,
            "ttft_target_s": self.ttft_target_s,
            "totals_s": {k: self.totals.get(k, 0.0) for k in BUCKETS},
            "max_residual_s": self.max_residual_s(),
            "ttft_bitwise_all": self.ttft_bitwise_all(),
            "aggressors": self.aggressors,
            "findings": self.findings,
        }
        if requests:
            out["requests"] = self.requests
        return out


def _window(row: Dict[str, Any]) -> Optional[Tuple[float, float]]:
    t0 = row.get("t_submit")
    t1 = row.get("t_retire")
    if t1 is None:
        t1 = row.get("t_preempt")
    if t0 is None or t1 is None:
        return None
    return float(t0), float(t1)


def _clip(t: float, w0: float, w1: float) -> float:
    return min(max(t, w0), w1)


def _attribute_spans(
    row: Dict[str, Any], spans: List[Dict[str, Any]],
    w0: float, w1: float,
    pair_s: Dict[Tuple[str, str], Dict[str, Any]],
) -> Dict[str, float]:
    """Forward-cursor exact tiling of ``[w0, w1]`` over the request's
    clipped spans (the buckets sum to the window); accumulates aggressor
    seconds into ``pair_s`` as a side effect."""
    rid = str(row.get("rid"))
    t_adm = row.get("t_admit")
    buckets = {k: 0.0 for k in BUCKETS}
    # bucket of the most recently consumed COMPUTE span: a gap right
    # after it is that compute's trailing service time (the virtual
    # time model charges cost AFTER the dispatch closes its span, so
    # the advance lands between the span and the next event; on a real
    # clock the fold-to-next-dispatch host time rides with the compute
    # that caused it).  A wait span resets it — a gap after a closed
    # wait really is uninstrumented.
    trail: Optional[str] = None

    def _gap(a: float, b: float) -> None:
        # uninstrumented time: before any compute and before admission
        # it is queueing by definition; otherwise the trailing-compute
        # bucket, else idle
        if b <= a:
            return
        if t_adm is not None and a < float(t_adm) and trail is None:
            cut = min(b, float(t_adm))
            buckets["queue_wait"] += cut - a
            if b > cut:
                buckets["idle"] += b - cut
        else:
            buckets[trail or "idle"] += b - a

    cursor = w0
    for ev in sorted(spans, key=lambda e: (e["t0"], e["t1"])):
        bucket = _span_bucket(ev)
        if bucket is None:
            continue
        t0 = _clip(float(ev["t0"]), w0, w1)
        t1 = _clip(float(ev["t1"]), w0, w1)
        if t0 > cursor:
            _gap(cursor, t0)
            cursor = t0
        dur = t1 - cursor
        if dur >= 0:
            trail = (bucket if ev.get("cat") == CAT_EXEC
                     else None)
        if dur > 0:
            buckets[bucket] += dur
            cursor = t1
            if ev.get("cat") == CAT_WAIT:
                by = [str(b) for b in ev.get("args", {}).get("by", [])]
                for agg in by:
                    key = (agg, rid)
                    ent = pair_s.setdefault(
                        key, {"seconds": 0.0, "causes": {}}
                    )
                    share = dur / len(by)
                    ent["seconds"] += share
                    cause = ev.get("args", {}).get("cause", "?")
                    ent["causes"][cause] = (
                        ent["causes"].get(cause, 0.0) + share
                    )
    _gap(cursor, w1)
    return buckets


def _attribute_row_only(
    row: Dict[str, Any], w0: float, w1: float,
) -> Dict[str, float]:
    """Rows-only tiling from the lifecycle timestamps alone: exact by
    construction (queue | prefill | decode partition the window)."""
    buckets = {k: 0.0 for k in BUCKETS}
    t_adm = row.get("t_admit")
    t_ft = row.get("t_first_token")
    a = _clip(float(t_adm), w0, w1) if t_adm is not None else w1
    f = _clip(float(t_ft), w0, w1) if t_ft is not None else a
    f = max(f, a)
    buckets["queue_wait"] = a - w0
    buckets["prefill_compute"] = f - a
    buckets["decode_compute"] = w1 - f
    return buckets


def _residency_aggressors(
    rows: Sequence[Dict[str, Any]],
    pair_s: Dict[Tuple[str, str], Dict[str, Any]],
) -> None:
    """Rows-only fallback: charge each request's queue wait to the
    requests RESIDENT in the engine during it (they held the slots and
    pages admission was waiting for)."""
    residency = []
    for r in rows:
        t_adm = r.get("t_admit")
        end = r.get("t_retire")
        if end is None:
            end = r.get("t_preempt")
        if t_adm is not None and end is not None:
            residency.append((str(r.get("rid")), float(t_adm),
                              float(end)))
    for r in rows:
        w = _window(r)
        if w is None or r.get("t_admit") is None:
            continue
        q0, q1 = w[0], float(r["t_admit"])
        if q1 <= q0:
            continue
        rid = str(r.get("rid"))
        over = [
            (arid, max(0.0, min(q1, a1) - max(q0, a0)))
            for arid, a0, a1 in residency if arid != rid
        ]
        over = [(arid, s) for arid, s in over if s > 0]
        if not over:
            continue
        for arid, s in over:
            ent = pair_s.setdefault(
                (arid, rid), {"seconds": 0.0, "causes": {}}
            )
            share = s / len(over)
            ent["seconds"] += share
            ent["causes"]["residency"] = (
                ent["causes"].get("residency", 0.0) + share
            )


def attribute_requests(
    rows: Sequence[Dict[str, Any]],
    events: Optional[Sequence[Dict[str, Any]]] = None,
    tracer: Any = None,
    *,
    ttft_target_s: Optional[float] = None,
    threshold: float = 0.5,
    top_pairs: int = 10,
) -> InterferenceReport:
    """Decompose each request's e2e into the eight buckets; rank
    aggressor→victim pairs; flag breaching requests dominated by a wait
    bucket.

    ``rows`` — request rows (``dls.requests/1`` rows or the serving
    frontend's arrival-anchored rows).  ``events``/``tracer`` — the
    waterfall event stream (optional; rows-only mode otherwise).
    ``ttft_target_s`` — the SLO target that defines "breaching" (no
    target: no findings, report only).
    """
    if events is None and tracer is not None:
        events = list(tracer.events)
    mode = "spans" if events else "rows"

    by_track: Dict[str, List[Dict[str, Any]]] = {}
    inst: Dict[str, Dict[str, float]] = {}
    if events:
        for ev in events:
            track = ev.get("track", "")
            if not isinstance(track, str) or \
                    not track.startswith(TRACK_PREFIX):
                continue
            if ev.get("type") == "span":
                by_track.setdefault(track, []).append(ev)
            elif (ev.get("type") == "instant"
                    and ev.get("cat") == CAT_LIFE):
                # first submit / first_token, last retire win
                m = inst.setdefault(track, {})
                name = ev.get("name")
                if name in ("submit", "first_token") and name in m:
                    continue
                if name in ("submit", "first_token", "retire",
                            "preempt"):
                    m[name] = float(ev.get("t", 0.0))

    pair_s: Dict[Tuple[str, str], Dict[str, Any]] = {}
    per_request: List[Dict[str, Any]] = []
    totals = {k: 0.0 for k in BUCKETS}
    n_skipped = 0

    for row in rows:
        rid = str(row.get("rid"))
        w = _window(row)
        if w is None:
            n_skipped += 1
            continue
        w0, w1 = w
        track = TRACK_PREFIX + rid
        spans = by_track.get(track, [])
        if spans:
            # offline traces are epoch-normalized: re-anchor this
            # request at its submit instant.  A live event stream has
            # delta == 0.0 exactly (same floats), so nothing moves.
            t_sub = inst.get(track, {}).get("submit")
            delta = (w0 - t_sub) if t_sub is not None else 0.0
            if delta != 0.0:
                spans = [
                    dict(ev, t0=ev["t0"] + delta, t1=ev["t1"] + delta)
                    for ev in spans
                ]
            buckets = _attribute_spans(row, spans, w0, w1, pair_s)
        else:
            buckets = _attribute_row_only(row, w0, w1)
        e2e = w1 - w0
        covered = sum(buckets.values())
        residual = e2e - covered
        dominant = max(BUCKETS, key=lambda k: buckets[k])
        dom_frac = (buckets[dominant] / e2e) if e2e > 0 else 0.0

        ttft = row.get("ttft_s")
        tpot = row.get("tpot_s")
        ttft_bw: Optional[bool] = None
        tpot_bw: Optional[bool] = None
        m = inst.get(track)
        if m and "submit" in m and "first_token" in m:
            span_ttft = m["first_token"] - m["submit"]
            if ttft is not None:
                ttft_bw = bool(span_ttft == float(ttft))
            n = int(row.get("n_tokens") or 0)
            if "retire" in m and n > 1 and tpot is not None:
                span_tpot = (m["retire"] - m["first_token"]) / (n - 1)
                tpot_bw = bool(span_tpot == float(tpot))
        breached = (
            ttft_target_s is not None and ttft is not None
            and float(ttft) > float(ttft_target_s)
        )
        for k in BUCKETS:
            totals[k] += buckets[k]
        per_request.append({
            "rid": rid,
            "state": row.get("state"),
            "cause": row.get("cause"),
            "e2e_s": e2e,
            "buckets_s": buckets,
            "residual_s": residual,
            "dominant": dominant,
            "dominant_frac": dom_frac,
            "ttft_s": ttft,
            "tpot_s": tpot,
            "ttft_bitwise": ttft_bw,
            "tpot_bitwise": tpot_bw,
            "breached": breached,
        })

    if mode == "rows" or not pair_s:
        _residency_aggressors(list(rows), pair_s)

    ranked = sorted(
        (
            {
                "aggressor": a, "victim": v,
                "seconds": ent["seconds"],
                "causes": {
                    c: s for c, s in sorted(ent["causes"].items())
                },
            }
            for (a, v), ent in pair_s.items()
        ),
        key=lambda e: (-e["seconds"], e["aggressor"], e["victim"]),
    )[:top_pairs]

    findings: List[Dict[str, Any]] = []
    for r in per_request:
        if not r["breached"]:
            continue
        if r["dominant"] not in WAIT_BUCKETS:
            continue
        if r["dominant_frac"] <= threshold:
            continue
        top = next(
            (p for p in ranked if p["victim"] == r["rid"]), None
        )
        findings.append({
            "rid": r["rid"],
            "dominant": r["dominant"],
            "dominant_frac": r["dominant_frac"],
            "ttft_s": r["ttft_s"],
            "ttft_target_s": ttft_target_s,
            "top_aggressor": top["aggressor"] if top else None,
        })

    return InterferenceReport(
        mode=mode,
        requests=per_request,
        totals=totals,
        aggressors=ranked,
        findings=findings,
        threshold=threshold,
        ttft_target_s=ttft_target_s,
        n_rows=len(list(rows)),
        n_attributed=len(per_request),
        n_skipped=n_skipped,
    )


__all__ = [
    "BUCKETS",
    "EPS",
    "InterferenceReport",
    "SCHEMA",
    "WAIT_BUCKETS",
    "attribute_requests",
    "events_from_perfetto",
]
