"""Per-request waterfall recorder: one Perfetto track per request.

The aggregate decode track (``admission_wave``/``prefill``/``segment``
spans) shows what the ENGINE was doing; it cannot show what one request
was WAITING on.  This module re-projects the same lifecycle seams onto
one track per logical request (``req:<rid>``), as a gapless waterfall of
cause-stamped spans:

* ``wait`` spans (cat ``reqwait``) — every interval the request spent
  not computing, stamped with a ``cause`` code and, where the engine
  knows it, the ``by`` list of requests that caused the wait (the FIFO
  head blocking it, the page holders, the slots that consumed the
  chunk budget, the tier-0 arrival that preempted it);
* compute spans (cat ``reqexec``) — ``prefill``, ``prefill_chunk``,
  ``decode_segment`` (with the co-resident slot set), ``cow_split``;
* lifecycle instants (cat ``reqlife``) — ``submit``, ``admit``,
  ``first_token``, ``retire``, ``preempt``, ``resume``, ``shed``.
  Their timestamps are the SAME hoisted clock reads the request log and
  the TTFT/TPOT histograms observe, so latencies rederived from the
  track are bitwise-equal to the reqlog row (asserted by
  ``tests/test_reqtrace.py``);
* ``interference`` flow arrows from each named aggressor's track to the
  victim's wait span — the Perfetto rendering of "who made me slow".

Wait causes (the :mod:`.interference` bucket key):

=================  =====================================================
``queued``         submitted, engine has not looked at it yet
``head_of_line``   FIFO: a different queue head is blocking admission
``slots_full``     every batch lane is occupied
``page_pool``      the pool cannot cover the needed pages (``by`` =
                   current page holders)
``chunk_budget``   chunked prefill stalled on the per-segment token
                   budget (``by`` = the slots that consumed it)
``defer_tier``     SLO admission deferred a low-tier request while the
                   TTFT window breaches
``preempted``      evicted by a tier-0 arrival, waiting to resume
                   (``by`` = the preemptor)
=================  =====================================================

Derived rids (a resumed pass ``{rid}#p{k}``) map onto the FIRST pass's
track: one logical request is one waterfall row, with the
preempt→resume hole stamped ``preempted`` — exactly the stitching
:meth:`~..serve.frontend.ServingFrontend.request_rows` does for the log.

Zero-overhead contract: the engine wires ``self.reqtrace`` only when a
tracer exists, and every call site guards ``if self.reqtrace is not
None`` — a bare engine does no work at all, and an instrumented one
emits events from clock reads it (or the pure virtual clock) already
made, so tokens, occupancy, and reqlog digests are bitwise-identical
either way.

The PyTorch port's copy of ``distributed_llm_scheduler_tpu.obs.reqtrace``: framework-free,
so the port keeps it without importing the JAX package.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence

CAT_WAIT = "reqwait"
CAT_EXEC = "reqexec"
CAT_LIFE = "reqlife"

TRACK_PREFIX = "req:"

#: wait causes that name other requests; everything else is structural
WAIT_CAUSES = (
    "queued", "head_of_line", "slots_full", "page_pool",
    "chunk_budget", "defer_tier", "preempted",
)

_DERIVED = re.compile(r"^(.*)#p\d+$")

#: cap on interference arrows per (victim wait-span, cause) — a pool
#: wait under load can name every resident; arrows beyond the first few
#: add clutter, not information (the full holder list stays in args)
_MAX_FLOWS = 4


def base_rid(rid: Any) -> str:
    """Logical rid: strips the serving layer's resume suffix
    (``r3#p2`` -> ``r3``)."""
    m = _DERIVED.match(str(rid))
    return m.group(1) if m else str(rid)


def request_track(rid: Any) -> str:
    return TRACK_PREFIX + base_rid(rid)


class RequestTraceRecorder:
    """Stateful re-projector from engine lifecycle seams to per-request
    waterfall tracks on an existing :class:`~.trace.Tracer`.

    All timestamps are caller-provided (the engine's hoisted clock
    reads); the recorder never reads a clock.  Wait spans are emitted
    eagerly and EXTENDED in place on repeat observations of the same
    cause (event dicts are shared by reference with any flight ring, so
    the mutation reaches both sinks) — the track stays gapless without
    per-tick event growth.
    """

    def __init__(self, tracer: Any):
        self.tracer = tracer
        # base rid -> {"track", "t_submit", "cursor", "wait", "done"}
        self._st: Dict[str, Dict[str, Any]] = {}

    def reset(self) -> None:
        self._st.clear()

    # -- internals ---------------------------------------------------------
    def _state(self, rid: Any) -> Optional[Dict[str, Any]]:
        st = self._st.get(base_rid(rid))
        if st is None or st["done"]:
            return None
        return st

    def _close_wait(self, st: Dict[str, Any], t: float) -> None:
        """The open wait (if any) factually ended at ``t``."""
        w = st["wait"]
        if w is not None:
            w["t1"] = max(w["t0"], t)
            st["wait"] = None
        st["cursor"] = max(st["cursor"], t)

    def _open_wait(
        self, st: Dict[str, Any], t: float, cause: str,
        by: Sequence[str] = (),
    ) -> None:
        t0 = st["cursor"]
        victim = st["track"][len(TRACK_PREFIX):]
        by = [b for b in (base_rid(x) for x in by) if b != victim]
        ev = self.tracer.complete(
            cause, t0, max(t, t0), track=st["track"], cat=CAT_WAIT,
            cause=cause, by=list(by),
        )
        st["wait"] = ev
        st["cursor"] = max(st["cursor"], t)
        for agg in by[:_MAX_FLOWS]:
            self.tracer.flow(
                "interference", TRACK_PREFIX + agg, max(t, t0),
                st["track"], max(t, t0), cat=CAT_WAIT, cause=cause,
            )

    # -- lifecycle seams ---------------------------------------------------
    def submit(
        self, rid: Any, t: float, *, prompt_len: int = 0,
        max_new_tokens: int = 0, priority: Optional[int] = None,
    ) -> None:
        """Register a request at its submission anchor.  Idempotent for
        a rid whose logical track already exists: the serving frontend
        registers at ARRIVAL time and the engine's ``submit`` later
        re-announces the same rid (first pass: no-op) or a derived
        resume rid (``resume`` instant; the ``preempted`` wait keeps
        running until re-admission)."""
        base = base_rid(rid)
        st = self._st.get(base)
        if st is not None:
            if not st["done"] and str(rid) != base:
                self.tracer.instant(
                    "resume", track=st["track"], cat=CAT_LIFE, t=t,
                    rid=str(rid),
                )
            return
        track = TRACK_PREFIX + base
        args: Dict[str, Any] = {
            "rid": base, "prompt_len": int(prompt_len),
            "max_new_tokens": int(max_new_tokens),
        }
        if priority is not None:
            args["priority"] = int(priority)
        self.tracer.instant("submit", track=track, cat=CAT_LIFE, t=t,
                            **args)
        st = {"track": track, "t_submit": t, "cursor": t, "wait": None,
              "done": False}
        self._st[base] = st
        self._open_wait(st, t, "queued")

    def wait(
        self, rid: Any, t: float, cause: str, by: Sequence[Any] = (),
    ) -> None:
        """Observe (or re-observe) a wait: same cause extends the open
        span to ``t``; a cause change closes it at ``t`` and opens the
        next, keeping the track gapless."""
        st = self._state(rid)
        if st is None:
            return
        by = [str(b) for b in by]
        w = st["wait"]
        if w is not None and w["args"]["cause"] == cause:
            w["t1"] = max(w["t1"], t)
            st["cursor"] = max(st["cursor"], t)
            known = w["args"]["by"]
            for b in by:
                bb = base_rid(b)
                if bb not in known and bb != base_rid(rid):
                    known.append(bb)
                    if len(known) <= _MAX_FLOWS:
                        self.tracer.flow(
                            "interference", TRACK_PREFIX + bb, t,
                            st["track"], t, cat=CAT_WAIT, cause=cause,
                        )
            return
        self._close_wait(st, t)
        self._open_wait(st, t, cause, by)

    def admitted(
        self, rid: Any, t: float, *, chunked: bool = False,
        wave: Optional[Sequence[Any]] = None,
    ) -> None:
        """The slot (and first pages) are claimed: the queue wait ends
        HERE.  ``wave`` is the co-admitted batch (admission-wave
        membership in the waterfall)."""
        st = self._state(rid)
        if st is None:
            return
        self._close_wait(st, t)
        args: Dict[str, Any] = {"rid": str(rid)}
        if chunked:
            args["chunked"] = True
        if wave is not None:
            args["wave"] = [str(r) for r in wave]
        self.tracer.instant("admit", track=st["track"], cat=CAT_LIFE,
                            t=t, **args)

    def prefill(self, rid: Any, t0: float, t1: float,
                **args: Any) -> None:
        """Whole-prompt (or stitched shared-prefix) prefill compute."""
        self._exec(rid, "prefill", t0, t1, **args)

    def chunk(self, rid: Any, t0: float, t1: float, *, base: int,
              tokens: int) -> None:
        """One chunked-prefill scatter; any open stall wait ends at the
        chunk's dispatch."""
        self._exec(rid, "prefill_chunk", t0, t1, base=base,
                   tokens=tokens)

    def segment(
        self, rid: Any, t0: float, t1: float, *, tokens: int,
        co_resident: Sequence[Any] = (),
    ) -> None:
        """One decode segment's share for this request, stamped with
        the co-resident slot set it shared the wave with."""
        self._exec(rid, "decode_segment", t0, t1, tokens=int(tokens),
                   co_resident=[str(r) for r in co_resident
                                if base_rid(r) != base_rid(rid)])

    def cow(self, rid: Any, t0: float, t1: float, *, src: int,
            dst: int) -> None:
        """A copy-on-write page split charged to the writing request."""
        self._exec(rid, "cow_split", t0, t1, src=int(src), dst=int(dst))

    def _exec(self, rid: Any, name: str, t0: float, t1: float,
              **args: Any) -> None:
        st = self._state(rid)
        if st is None:
            return
        if st["wait"] is not None:
            # the wait factually ended when this compute began
            self._close_wait(st, t0)
        self.tracer.complete(name, t0, max(t1, t0), track=st["track"],
                             cat=CAT_EXEC, rid=str(rid), **args)
        st["cursor"] = max(st["cursor"], t1)

    def first_token(self, rid: Any, t: float) -> None:
        st = self._state(rid)
        if st is None:
            return
        self.tracer.instant("first_token", track=st["track"],
                            cat=CAT_LIFE, t=t, rid=str(rid))
        st["cursor"] = max(st["cursor"], t)

    def retire(self, rid: Any, t: float, *, tokens: int = 0) -> None:
        st = self._state(rid)
        if st is None:
            return
        self._close_wait(st, t)
        self.tracer.instant("retire", track=st["track"], cat=CAT_LIFE,
                            t=t, rid=str(rid), tokens=int(tokens))
        st["done"] = True

    def preempt(self, rid: Any, t: float, *, by: Any = None,
                cause: Optional[str] = None) -> None:
        """Eviction: instant + the ``preempted`` hole opens, charged to
        the preemptor; the derived-rid resume closes it at
        re-admission."""
        st = self._state(rid)
        if st is None:
            return
        self._close_wait(st, t)
        args: Dict[str, Any] = {"rid": str(rid)}
        if by is not None:
            args["by"] = base_rid(by)
        if cause is not None:
            args["cause"] = cause
        self.tracer.instant("preempt", track=st["track"], cat=CAT_LIFE,
                            t=t, **args)
        self._open_wait(st, t, "preempted",
                        [by] if by is not None else [])

    def shed(self, rid: Any, t: float, *, cause: str) -> None:
        """Terminal shed: the wait it died in ends here, stamped with
        the shed cause code."""
        st = self._state(rid)
        if st is None:
            return
        self._close_wait(st, t)
        self.tracer.instant("shed", track=st["track"], cat=CAT_LIFE,
                            t=t, rid=str(rid), cause=cause)
        st["done"] = True

    # -- introspection -----------------------------------------------------
    def tracks(self) -> List[str]:
        return [st["track"] for st in self._st.values()]


__all__ = [
    "CAT_EXEC",
    "CAT_LIFE",
    "CAT_WAIT",
    "RequestTraceRecorder",
    "TRACK_PREFIX",
    "WAIT_CAUSES",
    "base_rid",
    "request_track",
]
