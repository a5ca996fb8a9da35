"""Pass — request-lifecycle protocol checker (LCY001-LCY005).

Replays any per-request lifecycle record — an engine ``dls.requests/1``
snapshot, the frontend's merged serving rows, or a bare row list —
against the request state machine

    submitted -> queued -> admitted -> prefill_done -> decoding
              -> retired | preempted | shed

checking transition legality (each timestamp implies the states that
must precede it), timestamp monotonicity (shared, to the message, with
``obs.reqlog.validate_request_log`` via
:func:`~..obs.reqlog.timestamp_order_errors`), token accounting against
the delivery series, and — for a finished run — terminal-state
exhaustiveness.  Admission and preemption bugs surface here as named
diagnostics instead of digest mismatches three tests away.

======  ==========================================================
LCY001  illegal transition: a timestamp/state combination the state
        machine cannot produce (e.g. first token without admission,
        ``t_retire`` on a preempted record)
LCY002  time travel: a later lifecycle timestamp strictly precedes
        an earlier one (ties are legal — the virtual clock stamps
        coalesced events identically)
LCY003  non-terminal state in a finished log (``final=True``)
LCY004  unknown or missing state name
LCY005  ``n_tokens`` disagrees with the delivery series
======  ==========================================================

The PyTorch port's copy of ``distributed_llm_scheduler_tpu.analysis.
lifecycle_pass``, whole (framework-free).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..obs.reqlog import STATES, timestamp_order_errors
from .diagnostics import AnalysisReport, Severity

#: every state any layer may record: the engine's lifecycle states plus
#: the frontend-only ``shed`` (rejected at admission, never admitted)
KNOWN_STATES = frozenset(STATES) | {"shed"}

#: a finished run leaves every request in one of these
TERMINAL_STATES = frozenset({"retired", "preempted", "shed"})


def _rows_of(source: Any) -> List[Dict[str, Any]]:
    """Normalize a RequestLog, its snapshot dict, or a row list."""
    if source is None:
        return []
    snap = getattr(source, "snapshot", None)
    if callable(snap):
        source = snap()
    if isinstance(source, dict):
        return list(source.get("requests", []))
    return list(source)


def analyze_lifecycle(
    source: Any,
    *,
    final: bool = False,
    label: Optional[str] = None,
) -> AnalysisReport:
    """Protocol-check per-request lifecycle rows.

    ``final=True`` additionally requires every request to have reached a
    terminal state (LCY003) — use it for completed runs/artifacts, not
    live logs.  ``label`` prefixes messages when several logs are linted
    into one report (e.g. per artifact leg).
    """
    rep = AnalysisReport()
    tag = f"{label}: " if label else ""
    for i, row in enumerate(_rows_of(source)):
        if not isinstance(row, dict):
            rep.add(
                "LCY004",
                Severity.ERROR,
                f"{tag}requests[{i}] is not a record",
            )
            continue
        rid = str(row.get("rid", f"requests[{i}]"))
        state = row.get("state")
        if state not in KNOWN_STATES:
            rep.add(
                "LCY004",
                Severity.ERROR,
                f"{tag}request {rid}: unknown state {state!r}",
                task=rid,
                data={"state": state},
            )
            continue

        for msg in timestamp_order_errors(row):
            rep.add(
                "LCY002",
                Severity.ERROR,
                f"{tag}request {rid}: {msg}",
                task=rid,
            )

        t_admit = row.get("t_admit")
        t_ft = row.get("t_first_token")
        t_ret = row.get("t_retire")

        def illegal(why: str) -> None:
            rep.add(
                "LCY001",
                Severity.ERROR,
                f"{tag}request {rid}: {why}",
                task=rid,
                data={"state": state},
            )

        # timestamps imply the states that must have preceded them
        if t_ft is not None and t_admit is None:
            illegal("t_first_token set but t_admit is null "
                    "(prefill without admission)")
        if t_ret is not None and state != "retired":
            illegal(f"t_retire set but state is {state!r}")
        if state == "retired":
            if t_ret is None:
                illegal("retired but t_retire is null")
            if t_ft is None:
                illegal("retired but t_first_token is null")
        elif state == "preempted":
            if t_admit is None:
                illegal("preempted but t_admit is null "
                        "(only admitted requests hold pages)")
            if t_ft is None:
                illegal("preempted but t_first_token is null")
        elif state == "decoding":
            if t_ft is None:
                illegal("decoding but t_first_token is null")
        elif state == "shed":
            if t_admit is not None:
                illegal("shed but t_admit is set "
                        "(shedding happens at admission)")
        elif state in ("submitted", "queued"):
            if t_ft is not None:
                illegal(f"state {state!r} but t_first_token is set")

        # token accounting vs the delivery series
        dl = row.get("deliveries")
        n_tok = row.get("n_tokens", 0) or 0
        if isinstance(dl, list) and all(
            isinstance(d, (list, tuple)) and len(d) == 2 for d in dl
        ):
            delivered = sum(int(d[1]) for d in dl)
            if int(n_tok) != delivered:
                rep.add(
                    "LCY005",
                    Severity.ERROR,
                    f"{tag}request {rid}: n_tokens ({n_tok}) != sum of "
                    f"deliveries ({delivered})",
                    task=rid,
                    data={"n_tokens": n_tok, "delivered": delivered},
                )
        elif int(n_tok) > 0:
            rep.add(
                "LCY005",
                Severity.ERROR,
                f"{tag}request {rid}: {n_tok} tokens counted but the "
                "delivery series is missing or malformed",
                task=rid,
            )

        if final and state not in TERMINAL_STATES:
            rep.add(
                "LCY003",
                Severity.ERROR,
                f"{tag}request {rid}: non-terminal state {state!r} in a "
                "finished log",
                task=rid,
                data={"state": state},
            )
    return rep
