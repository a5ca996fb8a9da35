"""Per-request lifecycle log: the record the serving layer is tuned from.

The aggregate TTFT/TPOT histograms (:mod:`.metrics`) answer "how is the
engine doing overall"; they cannot answer "which request breached, when,
and what was it waiting on" — and a histogram over a whole run cannot
detect an SLO breach *now*.  This module keeps the per-request truth:
every request moves through

    submitted -> queued -> admitted -> prefill_done -> decoding -> retired

with exact timestamps from the engine's injectable clock, yielding
per-request queue-wait, TTFT, the per-segment token-delivery series TPOT
is derived from, and e2e latency as structured :class:`RequestRecord`s.
:mod:`.slo` evaluates sliding-window percentiles and goodput over this
log; the flight recorder (:mod:`.flight`) keeps a bounded ring of the
same records for post-hoc dumps.

Timestamps are the SAME clock reads the engine's ``decode.ttft_s`` /
``decode.tpot_s`` histograms observe (the engine reads the clock once
per event and feeds both surfaces), so derived TTFT/TPOT bitwise-match
the histogram samples for the same run — asserted by
``tests/test_slo.py``.

Token-delivery granularity is the segment fold: the engine observes
tokens only at the per-segment host readback, so a delivery event is
``(t_fold, n_tokens)`` — intra-segment device-side gaps are not host
observable.  TPOT derived from a record is therefore exactly the
histogram's definition: ``(t_retire - t_first_token) / (n_tokens - 1)``.

The JSON snapshot schema is contractual (``dls.requests/1``), validated
and summarized like ``dls.metrics/1``:

```json
{"schema": "dls.requests/1",
 "requests": [{"rid": "r0", "prompt_len": 16, "max_new_tokens": 8,
               "state": "retired", "t_submit": 0.0, "t_admit": 0.1,
               "t_first_token": 0.2, "t_retire": 0.9, "n_tokens": 8,
               "deliveries": [[0.2, 1], [0.5, 4], [0.9, 3]],
               "queue_wait_s": 0.1, "ttft_s": 0.2, "tpot_s": 0.1,
               "e2e_s": 0.9}]}
```

The PyTorch port's copy of ``distributed_llm_scheduler_tpu.obs.reqlog``,
whole: it is framework-free, and its records are part of what the port
is held equal to.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

from .clockutil import resolve_clock

SCHEMA = "dls.requests/1"

#: lifecycle states in order; ``queued`` is entered at submit time (the
#: engine's queue append IS the submission seam) so both carry t_submit.
#: ``preempted`` is a terminal state for the ENGINE's record: the pages
#: went back to the pool and the serving layer re-queues the generated
#: prefix under a new rid (the resumed pass is a fresh record).
STATES = (
    "submitted", "queued", "admitted", "prefill_done", "decoding",
    "preempted", "retired",
)


class RequestRecord:
    """One request's lifecycle: timestamps, token deliveries, and the
    derived latency fields the SLO accounting consumes."""

    __slots__ = (
        "rid", "prompt_len", "max_new_tokens", "state",
        "t_submit", "t_admit", "t_first_token", "t_retire", "t_preempt",
        "n_tokens", "deliveries", "cause",
    )

    def __init__(self, rid: Any, prompt_len: int, max_new_tokens: int,
                 t_submit: float):
        self.rid = rid
        self.prompt_len = int(prompt_len)
        self.max_new_tokens = int(max_new_tokens)
        self.state = "queued"
        # terminal cause code for shed/defer/preempt outcomes (e.g.
        # ``preempt_tier0_victim``); None for the ordinary lifecycle
        self.cause: Optional[str] = None
        self.t_submit = t_submit
        self.t_admit: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_retire: Optional[float] = None
        self.t_preempt: Optional[float] = None
        self.n_tokens = 0
        # (t_fold, n_tokens) per host observation of delivered tokens;
        # the first entry is the prefill readback (the TTFT anchor)
        self.deliveries: List[Tuple[float, int]] = []

    # -- derived latencies (None until the anchoring states are reached) --
    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.t_admit is None:
            return None
        return self.t_admit - self.t_submit

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    @property
    def tpot_s(self) -> Optional[float]:
        """Steady-state inter-token gap — the histogram's definition:
        (last token's arrival - first token's) over n-1 gaps; None for
        unfinished or single-token requests (no gaps)."""
        if (
            self.t_retire is None or self.t_first_token is None
            or self.n_tokens <= 1
        ):
            return None
        return (self.t_retire - self.t_first_token) / (self.n_tokens - 1)

    @property
    def e2e_s(self) -> Optional[float]:
        if self.t_retire is None:
            return None
        return self.t_retire - self.t_submit

    def to_json(self) -> Dict[str, Any]:
        return {
            "rid": str(self.rid),
            "prompt_len": self.prompt_len,
            "max_new_tokens": self.max_new_tokens,
            "state": self.state,
            "t_submit": self.t_submit,
            "t_admit": self.t_admit,
            "t_first_token": self.t_first_token,
            "t_retire": self.t_retire,
            "t_preempt": self.t_preempt,
            "n_tokens": self.n_tokens,
            "deliveries": [[t, n] for t, n in self.deliveries],
            "queue_wait_s": self.queue_wait_s,
            "ttft_s": self.ttft_s,
            "tpot_s": self.tpot_s,
            "e2e_s": self.e2e_s,
            "cause": self.cause,
        }


class RequestLog:
    """Append-mostly lifecycle recorder keyed by request id.

    The engine calls one method per lifecycle seam, passing the clock
    read it already made for the corresponding histogram/trace event —
    the log never reads a clock itself, which is what makes derived
    latencies bitwise-identical to the histogram samples.

    ``capacity`` bounds the number of RETAINED records (oldest retired
    records evicted first — the flight recorder's O(1)-memory mode);
    None keeps everything (benches and the SLO report want the full
    run).  In-flight records are never evicted: eviction scans from the
    oldest entry and removes the first retired one.
    """

    def __init__(
        self,
        clock: Optional[Callable[[], float]] = None,
        capacity: Optional[int] = None,
    ):
        # the clock is only used by callers that want ``log.now()``
        # convenience (the CLI's live mode); the engine passes explicit
        # timestamps everywhere
        self.clock: Callable[[], float] = resolve_clock(clock)
        self.capacity = capacity
        self._records: "OrderedDict[Any, RequestRecord]" = OrderedDict()
        self.evicted = 0

    def now(self) -> float:
        return self.clock()

    # -- lifecycle seams ---------------------------------------------------
    def submit(self, rid: Any, prompt_len: int, max_new_tokens: int,
               t: float) -> RequestRecord:
        rec = RequestRecord(rid, prompt_len, max_new_tokens, t)
        self._records[rid] = rec
        self._evict()
        return rec

    def admit(self, rid: Any, t: float) -> None:
        rec = self._records.get(rid)
        if rec is not None:
            rec.state = "admitted"
            rec.t_admit = t

    def first_token(self, rid: Any, t: float) -> None:
        """The prefill readback: the first token exists NOW."""
        rec = self._records.get(rid)
        if rec is not None:
            rec.state = "prefill_done"
            rec.t_first_token = t
            rec.n_tokens += 1
            rec.deliveries.append((t, 1))

    def deliver(self, rid: Any, t: float, n: int) -> None:
        """``n`` decode tokens observed at a segment fold."""
        rec = self._records.get(rid)
        if rec is not None and n > 0:
            rec.state = "decoding"
            rec.n_tokens += int(n)
            rec.deliveries.append((t, int(n)))

    def retire(self, rid: Any, t: float) -> None:
        rec = self._records.get(rid)
        if rec is not None:
            rec.state = "retired"
            rec.t_retire = t

    def preempt(self, rid: Any, t: float,
                cause: Optional[str] = None) -> None:
        """Eviction seam: the request's pages went back to the pool and
        its generated prefix is re-queued by the serving layer under a
        NEW rid — this record is terminal (tokens it delivered stay
        counted; TTFT evidence stays anchored at the first pass).
        ``cause`` stamps WHY it was evicted (``preempt_tier0_victim``)."""
        rec = self._records.get(rid)
        if rec is not None:
            rec.state = "preempted"
            rec.t_preempt = t
            if cause is not None:
                rec.cause = cause

    def _evict(self) -> None:
        if self.capacity is None:
            return
        while len(self._records) > self.capacity:
            victim = next(
                (rid for rid, r in self._records.items()
                 if r.state in ("retired", "preempted")),
                None,
            )
            if victim is None:  # everything in flight: keep (rare; the
                break           # ring bounds retired history, not load
            del self._records[victim]
            self.evicted += 1

    # -- introspection -----------------------------------------------------
    def records(self) -> List[RequestRecord]:
        return list(self._records.values())

    def get(self, rid: Any) -> Optional[RequestRecord]:
        return self._records.get(rid)

    def __len__(self) -> int:
        return len(self._records)

    def snapshot(self) -> Dict[str, Any]:
        """Stable JSON-ready view (see module docstring for the schema)."""
        return {
            "schema": SCHEMA,
            "requests": [r.to_json() for r in self._records.values()],
            "evicted": self.evicted,
        }


# -- schema ---------------------------------------------------------------

def timestamp_order_errors(row: Dict[str, Any]) -> List[str]:
    """Strict time-travel check over one request row's timestamps.

    Returns one message per violation of the lifecycle ordering
    ``t_submit <= t_admit <= t_first_token <= t_retire/t_preempt`` and
    the non-decreasing delivery series anchored at the first token.
    Only strict DEcreases are violations: the virtual clock legitimately
    stamps consecutive lifecycle events with equal times (e.g. the last
    delivery and the retire share one segment fold).  Shared by
    :func:`validate_request_log` and the lifecycle analysis pass so the
    two can never disagree on what counts as time travel.
    """
    errs: List[str] = []

    def _chain(a_name: str, b_name: str) -> None:
        a, b = row.get(a_name), row.get(b_name)
        if a is not None and b is not None and float(b) < float(a):
            errs.append(
                f"{b_name} ({b}) precedes {a_name} ({a})"
            )

    _chain("t_submit", "t_admit")
    _chain("t_admit", "t_first_token")
    _chain("t_first_token", "t_retire")
    _chain("t_first_token", "t_preempt")
    dl = row.get("deliveries")
    if isinstance(dl, list) and all(
        isinstance(d, (list, tuple)) and len(d) == 2 for d in dl
    ):
        t_ft = row.get("t_first_token")
        prev = None
        for j, (t, _n) in enumerate(dl):
            if t_ft is not None and float(t) < float(t_ft):
                errs.append(
                    f"deliveries[{j}] at {t} precedes t_first_token "
                    f"({t_ft})"
                )
            if prev is not None and float(t) < float(prev):
                errs.append(
                    f"deliveries[{j}] at {t} precedes deliveries"
                    f"[{j - 1}] at {prev}"
                )
            prev = t
        t_ret = row.get("t_retire")
        if dl and t_ret is not None and float(t_ret) < float(dl[-1][0]):
            errs.append(
                f"t_retire ({t_ret}) precedes the last delivery "
                f"({dl[-1][0]})"
            )
    return errs


_REQUIRED = (
    "rid", "prompt_len", "max_new_tokens", "state", "t_submit", "t_admit",
    "t_first_token", "t_retire", "n_tokens", "deliveries", "queue_wait_s",
    "ttft_s", "tpot_s", "e2e_s",
)


def validate_request_log(snap: Any) -> List[str]:
    """Structural check of a ``snapshot()`` dict; returns human-readable
    problems (empty list == valid).  Shared by the artifact schema tests
    and the ``slo`` CLI."""
    errs: List[str] = []
    if not isinstance(snap, dict):
        return [f"request log is {type(snap).__name__}, not dict"]
    if snap.get("schema") != SCHEMA:
        errs.append(f"schema is {snap.get('schema')!r}, want {SCHEMA!r}")
    reqs = snap.get("requests")
    if not isinstance(reqs, list):
        return errs + ["requests block missing or not a list"]
    for i, row in enumerate(reqs):
        if not isinstance(row, dict):
            errs.append(f"requests[{i}] is not a dict")
            continue
        for f in _REQUIRED:
            if f not in row:
                errs.append(f"requests[{i}] missing {f!r}")
        state = row.get("state")
        if state not in STATES:
            errs.append(f"requests[{i}] unknown state {state!r}")
        # ``cause`` is optional (rows from pre-cause snapshots omit it)
        # but when present it must be a code string or null
        if "cause" in row and row["cause"] is not None \
                and not isinstance(row["cause"], str):
            errs.append(
                f"requests[{i}] cause is "
                f"{type(row['cause']).__name__}, not str/null"
            )
        for msg in timestamp_order_errors(row):
            errs.append(f"requests[{i}] {msg}")
        if row.get("state") == "retired":
            for f in ("t_admit", "t_first_token", "t_retire"):
                if row.get(f) is None:
                    errs.append(f"requests[{i}] retired but {f} is null")
        if row.get("state") == "preempted":
            # only an admitted request holds pages to evict, and the
            # prefill delivered its first token before any segment ran
            for f in ("t_admit", "t_first_token"):
                if row.get(f) is None:
                    errs.append(f"requests[{i}] preempted but {f} is null")
            if row.get("t_retire") is not None:
                errs.append(
                    f"requests[{i}] preempted but t_retire is set"
                )
        dl = row.get("deliveries")
        if isinstance(dl, list):
            if not all(
                isinstance(d, (list, tuple)) and len(d) == 2 for d in dl
            ):
                errs.append(f"requests[{i}] malformed deliveries")
            elif row.get("n_tokens") != sum(int(d[1]) for d in dl):
                errs.append(
                    f"requests[{i}] n_tokens != sum of deliveries"
                )
    return errs


def _percentiles(vals: List[float]) -> Dict[str, Optional[float]]:
    if not vals:
        return {"p50": None, "p95": None, "p99": None}
    s = sorted(vals)
    return {
        q: s[min(int(f * len(s)), len(s) - 1)]
        for q, f in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))
    }


_DERIVED_RID = re.compile(r"^(.*)#p(\d+)$")


def stitch_logical_chains(
    reqs: List[Dict[str, Any]],
) -> Dict[str, List[Dict[str, Any]]]:
    """Group rows into LOGICAL requests: a preempted pass and its
    resumed derivatives (``{rid}#pk``) are one chain, ordered by pass
    number.  Rows whose rid carries no suffix and spawned no
    derivatives are singleton chains."""
    chains: Dict[str, Dict[int, Dict[str, Any]]] = {}
    for r in reqs:
        rid = str(r.get("rid"))
        m = _DERIVED_RID.match(rid)
        base, k = (m.group(1), int(m.group(2))) if m else (rid, 0)
        chains.setdefault(base, {})[k] = r
    return {
        base: [passes[k] for k in sorted(passes)]
        for base, passes in chains.items()
    }


def summarize_request_log(snap: Any) -> Dict[str, Any]:
    """Counts + latency percentiles the ``slo`` CLI prints (and the CI
    smoke step asserts).  Accepts a ``snapshot()`` dict."""
    reqs = snap.get("requests", []) if isinstance(snap, dict) else []
    by_state: Dict[str, int] = {}
    by_cause: Dict[str, int] = {}
    for r in reqs:
        by_state[r.get("state", "?")] = by_state.get(r.get("state", "?"), 0) + 1
        cause = r.get("cause")
        if cause:
            by_cause[str(cause)] = by_cause.get(str(cause), 0) + 1
    retired = [r for r in reqs if r.get("state") == "retired"]
    out: Dict[str, Any] = {
        "n_requests": len(reqs),
        "by_state": dict(sorted(by_state.items())),
        "by_cause": dict(sorted(by_cause.items())),
        "n_retired": len(retired),
        "tokens_delivered": sum(int(r.get("n_tokens", 0)) for r in reqs),
        "evicted": snap.get("evicted", 0) if isinstance(snap, dict) else 0,
    }
    for metric in ("queue_wait_s", "ttft_s", "tpot_s", "e2e_s"):
        vals = [
            float(r[metric]) for r in retired
            if r.get(metric) is not None
        ]
        out[metric] = _percentiles(vals)
    # logical view: preempted+resumed derived-rid chains collapse to
    # ONE request each; the preempt->re-admit holes are excluded from
    # the logical TPOT (the engine was not generating then)
    chains = stitch_logical_chains(reqs)
    multi = {b: c for b, c in chains.items() if len(c) > 1}
    pre_times: List[float] = []
    tpots: List[float] = []
    for passes in chains.values():
        pre = 0.0
        complete = True
        for prev, nxt in zip(passes, passes[1:]):
            tp, ta = prev.get("t_preempt"), nxt.get("t_admit")
            if tp is None or ta is None:
                complete = False
                break
            pre += float(ta) - float(tp)
        if not complete:
            continue
        if len(passes) > 1:
            pre_times.append(pre)
        last = passes[-1]
        n = sum(int(p.get("n_tokens", 0)) for p in passes)
        t_ft = passes[0].get("t_first_token")
        t_ret = last.get("t_retire")
        if (last.get("state") == "retired" and t_ft is not None
                and t_ret is not None and n > 1):
            tpots.append(
                (float(t_ret) - float(t_ft) - pre) / (n - 1)
            )
    out["logical"] = {
        "n_logical": len(chains),
        "n_chains": len(multi),
        "preempted_time_s": _percentiles(pre_times),
        "tpot_s": _percentiles(tpots),
    }
    return out


__all__ = [
    "RequestLog",
    "RequestRecord",
    "SCHEMA",
    "STATES",
    "stitch_logical_chains",
    "summarize_request_log",
    "timestamp_order_errors",
    "validate_request_log",
]
