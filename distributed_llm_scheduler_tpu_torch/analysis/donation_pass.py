"""Donation-alias race detection (DON001-DON003): every donated buffer
must be dead after its donating launch.

``DispatchPlan.build`` computes donation from a slot lifetime analysis
(last consuming group, fence/final/keep protection) and
``CompiledSchedule`` donates only the per-run transient graph-input
leaves — both are safe *by construction*.  This pass re-derives the
safety from the plan metadata alone, so a hand-built or mutated plan
(tests, future planners, external tooling) is verified independently of
the builder that produced it, the same defense-in-depth the COL00x pass
gives the lowered collective order.

* **DON001 (error)** — read-after-donation: a slot some launch donated
  is read again later — by a later launch's arguments, by the end-of-run
  fence, as the final output, by the keep list, or at a second argument
  position of the donating launch itself.  XLA freed the buffer; the
  read returns garbage or crashes.
* **DON002 (error)** — double donation: one slot donated by two
  launches (or twice by one), or — compiled path — a donation vector
  touching the parameter slab, whose rows are aliased slices shared by
  every task view and reused across reps.
* **DON003 (error)** — donation across a transfer/collective boundary: a
  donated slot that a launch on a DIFFERENT device still pulls through
  the transfer path (``xfer_slots``), or — compiled path — a donated
  argument that is not a per-run transient input.  The remote read races
  the free; on hardware this corrupts the wire value rather than
  faulting.

Consumes only exposed metadata: :meth:`DispatchPlan.donation_table` /
:meth:`CompiledSchedule.donation_summary` (duck-typed, so plain dicts
work in tests).  Wired into ``analyze()``, the pre-execution gate
(``plan=`` parameter), and both backends' build paths.

PyTorch port's copy of ``distributed_llm_scheduler_tpu.analysis.
donation_pass``.  The port drops a value after its last use instead of
donating it: its :meth:`..backends.dispatch_plan.DispatchPlan.
donation_table` reports, as ``donate_slots``, the slots each step really
drops (``PlanStep.release``), and :meth:`..backends.compiled_schedule.
CompiledSchedule.donation_summary` the captured program's arguments, in
the shapes this pass reads, so the findings on the same metadata are
identical and a drop of a value still read later is refused.
"""

from __future__ import annotations

from typing import Any, Dict

from .diagnostics import AnalysisReport, Severity


def analyze_donation(plan_or_summary: Any) -> AnalysisReport:
    """DON001-DON003 over a :class:`..backends.dispatch_plan.DispatchPlan`,
    a :class:`..backends.compiled_schedule.CompiledSchedule`, or either
    one's exported metadata (``donation_table()`` / ``donation_summary()``
    dict)."""
    obj = plan_or_summary
    if hasattr(obj, "donation_table"):
        obj = obj.donation_table()
    elif hasattr(obj, "donation_summary"):
        obj = obj.donation_summary()
    if isinstance(obj, dict) and "steps" in obj:
        return _analyze_plan_table(obj)
    if isinstance(obj, dict) and "donated_argnums" in obj:
        return _analyze_compiled_summary(obj)
    raise TypeError(
        "analyze_donation wants a DispatchPlan, a CompiledSchedule, or "
        f"their donation metadata dicts; got {type(plan_or_summary)!r}"
    )


def _analyze_plan_table(table: Dict[str, Any]) -> AnalysisReport:
    """Slot-lifetime verification of a DispatchPlan donation table."""
    rep = AnalysisReport()
    steps = table["steps"]
    donated_at: Dict[int, int] = {}  # slot -> donating step index

    def step_name(gi: int) -> str:
        tids = steps[gi]["tids"]
        return tids[0] if len(tids) == 1 else f"group({','.join(tids)})"

    for gi, st in enumerate(steps):
        arg_slots = tuple(st["arg_slots"])
        xfer_slots = set(st.get("xfer_slots", ()))
        # reads of slots donated by an EARLIER launch; checked before
        # this launch's own donations register, because reading and
        # donating the same slot in one launch is the normal last-
        # consumer pattern
        for s in dict.fromkeys(arg_slots):
            gi0 = donated_at.get(s)
            if gi0 is None:
                continue
            donor = steps[gi0]
            if s in xfer_slots and st["node_id"] != donor["node_id"]:
                rep.add(
                    "DON003",
                    Severity.ERROR,
                    f"slot {s} was donated by launch {step_name(gi0)} on "
                    f"{donor['node_id']} but launch {step_name(gi)} on "
                    f"{st['node_id']} still pulls it across the device "
                    "boundary — the transfer races the free",
                    task=st["tids"][0],
                    node=st["node_id"],
                    data={"slot": s, "donor": gi0, "reader": gi},
                )
            else:
                rep.add(
                    "DON001",
                    Severity.ERROR,
                    f"slot {s} is read by launch {step_name(gi)} after "
                    f"launch {step_name(gi0)} donated it — the buffer is "
                    "already freed",
                    task=st["tids"][0],
                    node=st["node_id"],
                    data={"slot": s, "donor": gi0, "reader": gi},
                )
        seen_here: set = set()
        for s in st.get("donate_slots", ()):
            if s in seen_here:
                rep.add(
                    "DON002",
                    Severity.ERROR,
                    f"slot {s} donated twice by launch {step_name(gi)}",
                    task=st["tids"][0],
                    node=st["node_id"],
                    data={"slot": s},
                )
                continue
            seen_here.add(s)
            if s in donated_at:
                rep.add(
                    "DON002",
                    Severity.ERROR,
                    f"slot {s} donated by both launch "
                    f"{step_name(donated_at[s])} and launch "
                    f"{step_name(gi)} — the second donation frees a "
                    "buffer that no longer exists",
                    task=st["tids"][0],
                    node=st["node_id"],
                    data={"slot": s, "first": donated_at[s]},
                )
                continue
            if arg_slots.count(s) > 1:
                rep.add(
                    "DON001",
                    Severity.ERROR,
                    f"launch {step_name(gi)} donates slot {s} it also "
                    "reads at another argument position — one buffer, "
                    "two bindings, one of them freed mid-launch",
                    task=st["tids"][0],
                    node=st["node_id"],
                    data={"slot": s},
                )
            donated_at[s] = gi

    # post-run readers: fence, final output, kept outputs, ext values
    fence_of = {s: n for n, s in table.get("fence_slots", ())}
    for s, gi0 in donated_at.items():
        if s == table.get("final_slot"):
            rep.add(
                "DON001",
                Severity.ERROR,
                f"final output slot {s} was donated by launch "
                f"{step_name(gi0)}; the run would return a freed buffer",
                data={"slot": s},
            )
        if s in fence_of:
            rep.add(
                "DON001",
                Severity.ERROR,
                f"end-of-run fence on {fence_of[s]} reads slot {s}, "
                f"which launch {step_name(gi0)} donated",
                node=fence_of[s],
                data={"slot": s},
            )
        for tid, ks in table.get("keep_list", ()):
            if ks == s:
                rep.add(
                    "DON001",
                    Severity.ERROR,
                    f"kept output {tid!r} (slot {s}) was donated by "
                    f"launch {step_name(gi0)}",
                    task=tid,
                    data={"slot": s},
                )
        for k, es in table.get("ext_slots", ()):
            if es == s:
                rep.add(
                    "DON001",
                    Severity.ERROR,
                    f"externally provided value {k!r} (slot {s}) was "
                    f"donated by launch {step_name(gi0)} — the caller "
                    "still owns that buffer",
                    data={"slot": s},
                )
    return rep


def _analyze_compiled_summary(summary: Dict[str, Any]) -> AnalysisReport:
    """Invariant check of a CompiledSchedule donation vector: only the
    per-run transient input leaves may be donated; the param slab rows
    are aliased slices live across reps."""
    rep = AnalysisReport()
    params = set(summary.get("param_argnums", ()))
    inputs = set(summary.get("input_argnums", ()))
    for a in summary.get("donated_argnums", ()):
        if a in params:
            rep.add(
                "DON002",
                Severity.ERROR,
                f"compiled program donates argument {a}: the parameter "
                "slab — its rows are aliased slices every task view "
                "shares and every rep re-reads; donating it double-frees "
                "the aliases",
                data={"argnum": a},
            )
        elif a not in inputs:
            rep.add(
                "DON003",
                Severity.ERROR,
                f"compiled program donates argument {a}, which is not a "
                "per-run transient input — remote devices still read it "
                "through the program's collectives",
                data={"argnum": a},
            )
    return rep
