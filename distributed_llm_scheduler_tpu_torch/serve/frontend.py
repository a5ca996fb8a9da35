"""Event-loop serving front-end over the paged continuous-batching engine.

The :class:`~..backends.decode_loop.PagedDecodeEngine` is synchronously
driven: callers pre-stage requests and ``run()`` drains them.  This
module turns it into an ONLINE server: a single-threaded event loop
(:class:`ServingFrontend`) injects open-loop arrivals (:mod:`.loadgen`)
as their deadlines pass, holds the not-yet-admitted work in its own
request queue, and drives the engine one ``step_segment()`` at a time —
the engine's incremental API is the event granularity, so admission,
preemption, and SLO control all act at segment boundaries, exactly
where the engine's host-side state is mutable.

Three policies compose per tick:

* **Admission** — ``"fifo"`` (admit-all: every arrival goes straight to
  the engine's FIFO queue; the baseline that collapses under overload)
  or ``"slo"``: the frontend submits only what the engine can admit at
  THIS boundary (reading :meth:`PagedDecodeEngine.page_occupancy` and
  ``free_slots`` — the same headroom surface the metrics sample), and
  uses :func:`~..obs.slo.evaluate_slo` window stats over the serving
  log as the control signal: while the current p95 TTFT window
  breaches, low-priority (tier > 0) work is DEFERRED, and a low-tier
  request whose wait has already blown the TTFT target is SHED — it can
  no longer produce goodput, so running it would only steal pages from
  requests that still can.
* **Preemption** — a tier-0 arrival that cannot be admitted (no free
  slot / pages) evicts the lowest-tier in-flight victims via
  :meth:`PagedDecodeEngine.preempt`: pages return to the pool, the
  victim's generated prefix becomes the new prompt of a re-queued
  resume pass (engine rid ``{rid}#p{k}``), and greedy determinism makes
  the resumed continuation bitwise-identical to an unpreempted run of
  the same prompt+prefix.
* **Time** — with a :class:`VirtualClock` on the engine, the loop
  advances time itself via a :class:`ServiceTimeModel` (per admission
  wave, per segment, per idle tick), which makes every timestamp,
  every window, every admission/shed/preempt decision, and therefore
  the whole serving run a deterministic function of the seed — the
  property the serve bench's repeat gate asserts.  With a real clock
  the same loop serves wall-clock arrivals (sleeping while idle).

The per-request truth lives in :meth:`request_rows`: one row per
LOGICAL request (passes stitched across preemptions), with ``t_submit``
anchored at the open-loop ARRIVAL time — so queue-wait and TTFT charge
the frontend's own queueing, not just the engine's.

The PyTorch port's copy of ``distributed_llm_scheduler_tpu.serve.
frontend``, whole: it drives the port's ``PagedDecodeEngine`` through the
same calls.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..obs.reqlog import _percentiles
from ..obs.slo import SLOPolicy, SLOReport, evaluate_slo
from .loadgen import Arrival, prompt_token_ids


class VirtualClock:
    """Deterministic logical clock: reads are pure, time moves only via
    :meth:`advance`.  Share one instance between the engine and the
    frontend so lifecycle timestamps and arrival deadlines live on the
    same (simulated) timeline."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def __call__(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"cannot advance clock by {dt}")
        self._t += float(dt)

    def reset(self, t0: float = 0.0) -> None:
        """Rewind to ``t0`` — pair with ``engine.reset()`` so a warmed
        engine (weights and step kept) can replay a scenario on the
        identical timeline it saw the first time."""
        self._t = float(t0)


@dataclass(frozen=True)
class ServiceTimeModel:
    """Virtual service costs the event loop charges per tick: one
    admission (prefill) wave, one K-step decode segment, one idle tick
    (nothing runnable — lets breaching windows roll past).  Only used
    with a :class:`VirtualClock`; real clocks measure instead."""

    wave_s: float = 0.01
    segment_s: float = 0.05
    idle_s: float = 0.005
    #: per-prompt-token prefill cost, charged at each prefill dispatch
    #: (whole-prompt waves pay it in one bulge; chunked admission spreads
    #: it across segments — the interference the chunked bench measures)
    prefill_tok_s: float = 0.0

    def to_json(self) -> Dict[str, float]:
        return {"wave_s": self.wave_s, "segment_s": self.segment_s,
                "idle_s": self.idle_s,
                "prefill_tok_s": self.prefill_tok_s}


class _Req:
    """One logical request's serving state across engine passes."""

    __slots__ = ("a", "cur_prompt", "cur_max_new", "prefix_parts",
                 "preemptions", "state", "passes", "cause")

    def __init__(self, a: Arrival, prompt_ids: np.ndarray):
        self.a = a
        self.cur_prompt = prompt_ids          # (1, P) int32, grows on resume
        self.cur_max_new = a.max_new_tokens
        self.prefix_parts: List[np.ndarray] = []
        self.preemptions = 0
        self.state = "waiting"                # waiting|inflight|shed|done
        self.passes: List[str] = []           # engine rids, in order
        # terminal cause code (shed_deadline | shed_ttft_doomed |
        # preempt_tier0_victim | defer_tier) — why the frontend last
        # acted on this request, None for the untouched happy path
        self.cause: Optional[str] = None

    @property
    def total_rows(self) -> int:
        # invariant across preemptions: prompt grows by exactly the
        # tokens the budget shrank by
        return int(self.cur_prompt.shape[1]) + self.cur_max_new

    def engine_rid(self) -> str:
        return (self.a.rid if self.preemptions == 0
                else f"{self.a.rid}#p{self.preemptions}")

    def record_preemption(self, res: Dict[str, Any]) -> None:
        tokens = np.asarray(res["tokens"], np.int32)
        self.prefix_parts.append(tokens)
        self.cur_prompt = np.concatenate(
            [self.cur_prompt, tokens[None, :]], axis=1
        )
        self.cur_max_new = int(res["remaining"])
        self.preemptions += 1
        self.state = "waiting"


class ServingFrontend:
    """Single-threaded serving event loop over one paged decode engine.

    ``engine`` must be freshly constructed (empty queue/slots) and, for
    deterministic runs, built with a :class:`VirtualClock` — the
    frontend adopts the engine's clock so both sides share a timeline.
    ``arrivals`` is the open-loop schedule (:mod:`.loadgen`); more can
    be injected mid-run via :meth:`submit`.
    """

    def __init__(
        self,
        engine: Any,
        arrivals: Sequence[Arrival],
        policy: Optional[SLOPolicy] = None,
        *,
        admission: str = "slo",
        preemption: bool = True,
        time_model: Optional[ServiceTimeModel] = None,
        prompt_seed: int = 0,
        max_ticks: int = 100_000,
        sleep: Optional[Any] = None,
        prompt_fn: Optional[Any] = None,
    ):
        if admission not in ("fifo", "slo"):
            raise ValueError(
                f"admission must be 'fifo' or 'slo', got {admission!r}"
            )
        if admission == "slo" and (policy is None or policy.ttft_s is None):
            raise ValueError(
                "slo admission needs a policy with a ttft_s target "
                "(it is the shed/defer control signal)"
            )
        self.engine = engine
        self.policy = policy
        self.admission = admission
        self.preemption = preemption and admission == "slo"
        self.clock = engine._clock
        self._virtual = hasattr(self.clock, "advance")
        if time_model is not None and not self._virtual:
            raise ValueError(
                "a ServiceTimeModel needs a VirtualClock on the engine"
            )
        self.tm = time_model or ServiceTimeModel()
        if (self._virtual and self.tm.prefill_tok_s > 0
                and hasattr(engine, "prefill_time_charge")):
            # charge prefill by REAL token count at each dispatch: the
            # engine calls back before every prefill (whole, shared or
            # chunk), so long prompts cost virtual time where they run
            engine.prefill_time_charge = (
                lambda n: self.clock.advance(self.tm.prefill_tok_s * n)
            )
        # injectable idle sleep (real-clock mode only): tests script a
        # fake clock + recording sleep to cover the wall-clock path
        # without spending wall time
        self._sleep = sleep if sleep is not None else time.sleep
        # pluggable prompt materializer (rid, prompt_len, vocab, seed) ->
        # (1, P) int32 — how the shared-prefix workload derives session
        # prompts; the default is the pre-existing per-rid generator, so
        # existing callers are bit-identical
        self.prompt_fn = (
            prompt_fn if prompt_fn is not None else prompt_token_ids
        )
        self.prompt_seed = prompt_seed
        self.max_ticks = max_ticks
        self.vocab_size = int(getattr(engine.config, "vocab_size", 256))
        self._pending: List[Arrival] = sorted(
            arrivals, key=lambda a: (a.t, a.rid)
        )
        if len({a.rid for a in self._pending}) != len(self._pending):
            raise ValueError("duplicate rids in arrival schedule")
        self._backlog: List[_Req] = []
        self._inflight: Dict[str, _Req] = {}
        self._reqs: "Dict[str, _Req]" = {}    # logical rid -> state
        self.results: Dict[str, np.ndarray] = {}
        self.slo_report: Optional[SLOReport] = None
        self.t0: Optional[float] = None
        self.ticks = 0

    # -- external intake ---------------------------------------------------
    def submit(self, arrival: Arrival) -> None:
        """Inject an arrival after construction (its ``t`` is still an
        offset from scenario start)."""
        if arrival.rid in self._reqs or any(
            a.rid == arrival.rid for a in self._pending
        ):
            raise ValueError(f"duplicate rid {arrival.rid!r}")
        self._pending.append(arrival)
        self._pending.sort(key=lambda a: (a.t, a.rid))

    # -- the event loop ----------------------------------------------------
    def run(
        self,
        *,
        deadline: Optional[float] = None,
        on_tick: Optional[Any] = None,
    ) -> Dict[str, Any]:
        """Serve the arrival schedule to completion; returns
        :meth:`report`.

        ``deadline`` bounds the run in seconds since ``t0`` (virtual or
        wall, whichever clock the engine carries) — the soak harness's
        ``--duration``.  At the deadline, not-yet-injected arrivals are
        dropped and the backlog is shed (they can produce no goodput in
        the remaining window), then in-flight work drains normally so
        page accounting ends clean.  ``on_tick(frontend)`` runs after
        every tick — the soak sampler's hook; it must only READ (a
        callback that advances the clock or mutates the engine would
        fork the deterministic timeline).
        """
        if self.t0 is None:
            self.t0 = self.clock()
        while self._pending or self._backlog or self._inflight:
            if (deadline is not None
                    and self.clock() - self.t0 >= deadline):
                self._shed_remaining()
                if not self._inflight:
                    break
            self.ticks += 1
            if self.ticks > self.max_ticks:
                raise RuntimeError(
                    f"serving loop stalled after {self.max_ticks} ticks: "
                    f"{len(self._pending)} pending, "
                    f"{len(self._backlog)} backlogged, "
                    f"{len(self._inflight)} in flight"
                )
            self._tick()
            if on_tick is not None:
                on_tick(self)
        return self.report()

    def _reqtrace(self):
        """The engine's per-request waterfall recorder, or None — the
        same zero-overhead guard the engine hot paths use."""
        return getattr(self.engine, "reqtrace", None)

    def _shed_remaining(self) -> None:
        """Deadline passed: drop arrivals that never happened and shed
        the backlog; in-flight work keeps draining."""
        self._pending.clear()
        rt = self._reqtrace()
        now = self.clock() if (self._backlog and rt is not None) else None
        for req in self._backlog:
            req.state = "shed"
            req.cause = "shed_deadline"
            if rt is not None:
                rt.shed(req.a.rid, now, cause="shed_deadline")
        self._backlog.clear()

    def _tick(self) -> None:
        now = self.clock()
        rel = now - self.t0
        # 1. inject arrivals whose deadline has passed
        rt = self._reqtrace()
        while self._pending and self._pending[0].t <= rel + 1e-9:
            a = self._pending.pop(0)
            req = self._make_req(a)
            self._reqs[a.rid] = req
            if rt is not None:
                # waterfall anchor = ARRIVAL time, matching the serving
                # row's t_submit; the engine's later submit() for the
                # same rid is an idempotent no-op on this track
                rt.submit(
                    a.rid, self.t0 + a.t, prompt_len=a.prompt_len,
                    max_new_tokens=a.max_new_tokens,
                    priority=a.priority,
                )
            if self.admission == "fifo":
                self._submit_to_engine(req)   # admit-all: engine FIFO queues
            else:
                self._backlog.append(req)
        # 2. admission control (slo mode submits exactly what fits NOW)
        if self.admission == "slo":
            waves = self._admit_backlog(now)
        else:
            waves = 1 if (self.engine._queue and self.engine.free_slots) else 0
        # 3. drive the engine one segment; charge virtual service time.
        #    The wave cost lands BEFORE the engine's admission clock
        #    reads so prefill has nonzero virtual duration.
        if self._virtual and waves:
            self.clock.advance(self.tm.wave_s * waves)
        engine_busy = (bool(self.engine._queue)
                       or self.engine.free_slots < self.engine.slots)
        if engine_busy:
            seg_before = self.engine.segments_run
            self.engine.step_segment()
            if self._virtual and self.engine.segments_run > seg_before:
                self.clock.advance(self.tm.segment_s)
        # 4. collect completions (stitch resumed passes)
        done = [e for e in self._inflight if e in self.engine.results]
        for erid in done:
            req = self._inflight.pop(erid)
            req.state = "done"
            toks = self.engine.results[erid]
            if req.prefix_parts:
                toks = np.concatenate(
                    [np.asarray(p, np.int32) for p in req.prefix_parts]
                    + [np.asarray(toks, np.int32)]
                )
            self.results[req.a.rid] = np.asarray(toks, np.int32)
        # 5. idle: nothing ran — move time toward the next arrival (or
        #    just forward, so a breaching window can roll past a
        #    deferred backlog)
        if not engine_busy and not waves:
            if self._virtual:
                if self._pending:
                    gap = (self._pending[0].t - rel)
                    self.clock.advance(max(gap, self.tm.idle_s))
                elif self._backlog:
                    self.clock.advance(self.tm.idle_s)
            else:
                # real clock: actually sleep until the next arrival's
                # deadline (floor keeps the loop from busy-spinning on
                # an imminent arrival; cap keeps mid-run submit()s and
                # soak deadlines responsive within 50 ms)
                wait = 0.001
                if self._pending:
                    wait = max(self._pending[0].t - rel, 0.0005)
                self._sleep(min(wait, 0.05))

    def _make_req(self, a: Arrival) -> _Req:
        """Materialize the serving state for a just-injected arrival
        (the fleet router's subclass swaps in a migration-aware type)."""
        return _Req(a, self.prompt_fn(
            a.rid, a.prompt_len, self.vocab_size, self.prompt_seed
        ))

    # -- admission / preemption -------------------------------------------
    def _submit_to_engine(self, req: _Req) -> None:
        erid = req.engine_rid()
        self.engine.submit(erid, req.cur_prompt, req.cur_max_new)
        req.passes.append(erid)
        req.state = "inflight"
        self._inflight[erid] = req

    def _admit_backlog(self, now: float) -> int:
        """SLO-aware admission at one segment boundary; returns the
        number of prefill waves (distinct prompt lengths) submitted."""
        if not self._backlog:
            return 0
        from ..models.kv_pages import pages_needed

        breaching = self._ttft_breaching(now)
        target = self.policy.ttft_s
        rt = self._reqtrace()
        keep: List[_Req] = []
        for req in self._backlog:
            waited = now - (self.t0 + req.a.t)
            if (req.a.priority > 0 and not req.passes
                    and waited > target):
                # already blew its TTFT budget: zero possible goodput,
                # so shed instead of spending pages on it
                req.state = "shed"
                req.cause = "shed_ttft_doomed"
                if rt is not None:
                    rt.shed(req.a.rid, now, cause="shed_ttft_doomed")
                continue
            keep.append(req)
        self._backlog = keep
        free_slots = self.engine.free_slots
        free_pages = self.engine.page_occupancy()["free_pages"]
        order = sorted(
            self._backlog, key=lambda r: (r.a.priority, r.a.t, r.a.rid)
        )
        submitted: List[_Req] = []
        lens = set()
        sharing = bool(getattr(self.engine, "sharing", False))
        for req in order:
            if breaching and req.a.priority > 0 and not req.passes:
                # defer low tier while the TTFT window breaches
                req.cause = "defer_tier"
                if rt is not None:
                    rt.wait(req.a.rid, now, "defer_tier")
                continue
            adm_need = getattr(
                self.engine, "admission_pages_needed", None
            )
            if adm_need is not None:
                # the engine's own headroom arithmetic: first-chunk-only
                # for chunk-eligible prompts (later chunks alloc lazily),
                # fresh-tail footprint under sharing, full footprint
                # otherwise
                need = adm_need(req.cur_prompt, req.cur_max_new)
            elif sharing:
                # fresh-tail footprint only: resident shared prefix
                # chunks cost no new pages, so admission sees the same
                # headroom the engine's allocator will
                need = self.engine.fresh_pages_needed(
                    req.cur_prompt, req.cur_max_new
                )
            else:
                need = pages_needed(req.total_rows, self.engine.page_size)
            if free_slots < 1 or need > free_pages:
                if rt is not None:
                    # who is the capacity? the in-flight page holders
                    # (pure occupancy read — the same surface the
                    # admission arithmetic above already consumed)
                    holders = sorted(
                        self.engine.page_occupancy()["per_request"]
                    )
                    rt.wait(
                        req.a.rid, now,
                        "slots_full" if free_slots < 1 else "page_pool",
                        by=holders,
                    )
                if not (self.preemption and req.a.priority == 0):
                    continue
                got = self._try_preempt(req, need, free_slots, free_pages)
                if got is None:
                    continue
                free_slots, free_pages = got
            self._submit_to_engine(req)
            submitted.append(req)
            free_slots -= 1
            free_pages -= need
            lens.add(int(req.cur_prompt.shape[1]))
        for req in submitted:
            self._backlog.remove(req)
        return len(lens)

    def _try_preempt(
        self, req: _Req, need: int, free_slots: int, free_pages: int
    ):
        """Evict lower-tier in-flight victims until ``req`` fits;
        returns the new (free_slots, free_pages) or None when no victim
        set suffices (then nothing is evicted)."""
        occ = self.engine.page_occupancy()
        # under sharing, evicting a victim frees only its EXCLUSIVE
        # pages (aliased prefix chunks stay resident for their other
        # owners) — the conservative count keeps the estimate honest
        per_req = occ.get("per_request_exclusive", occ["per_request"])
        prefilling = getattr(self.engine, "is_prefilling", None)
        victims = [
            v for v in self._inflight.values()
            if v.a.priority > req.a.priority and v.passes
            # mid-chunked-prefill slots are not preemptible: no first
            # token yet means no resumable prefix, only wasted chunks
            and not (prefilling is not None
                     and prefilling(v.engine_rid()))
        ]
        # most recently arrived, lowest tier first: evict the work with
        # the least sunk queue-wait
        victims.sort(key=lambda v: (-v.a.priority, -v.a.t, v.a.rid))
        chosen: List[_Req] = []
        gs, gp = free_slots, free_pages
        for v in victims:
            if gs >= 1 and gp >= need:
                break
            chosen.append(v)
            gs += 1
            gp += int(per_req.get(v.engine_rid(), 0))
        if not (gs >= 1 and gp >= need):
            return None
        for v in chosen:
            erid = v.engine_rid()
            res = self.engine.preempt(
                erid, cause="preempt_tier0_victim", by=str(req.a.rid)
            )
            del self._inflight[erid]
            v.record_preemption(res)
            v.cause = "preempt_tier0_victim"
            self._backlog.append(v)
        return gs, gp

    def _ttft_breaching(self, now: float) -> bool:
        """The control signal: does a recent window's TTFT percentile
        breach the policy target?  Evaluated over the serving log
        (arrival-anchored), not the engine log — in slo mode queueing
        happens HERE, before the engine ever sees the request."""
        if self.policy is None or self.policy.ttft_s is None:
            return False
        report = evaluate_slo(
            {"requests": self._rows()}, self.policy, t_end=now
        )
        if not report.breaches:
            return False
        n = len(report.windows)
        return any(
            b["metric"] == "ttft_s" and b["window"] >= n - 2
            for b in report.breaches
        )

    # -- the serving log ---------------------------------------------------
    def _pass_records(self, req: _Req) -> List[Any]:
        """Lifecycle records for each engine pass of ``req``, in pass
        order (the fleet subclass also consults records frozen before a
        replica restart wiped its log)."""
        return [
            r for r in (self.engine.reqlog.get(e) for e in req.passes)
            if r is not None
        ]

    def _row(self, req: _Req) -> Dict[str, Any]:
        t_arr = (self.t0 or 0.0) + req.a.t
        row: Dict[str, Any] = {
            "rid": str(req.a.rid),
            "priority": req.a.priority,
            "prompt_len": req.a.prompt_len,
            "max_new_tokens": req.a.max_new_tokens,
            "state": "queued",
            "t_submit": t_arr,
            "t_admit": None,
            "t_first_token": None,
            "t_retire": None,
            "n_tokens": 0,
            "deliveries": [],
            "preemptions": req.preemptions,
            "cause": req.cause,
        }
        if req.state == "shed":
            row["state"] = "shed"
        else:
            recs = self._pass_records(req)
            if recs:
                row["t_admit"] = recs[0].t_admit
                row["t_first_token"] = recs[0].t_first_token
                deliveries = [d for r in recs for d in r.deliveries]
                row["deliveries"] = [[t, int(n)] for t, n in deliveries]
                row["n_tokens"] = int(sum(n for _, n in deliveries))
                last = recs[-1]
                if last.state == "retired":
                    row["state"] = "retired"
                    row["t_retire"] = last.t_retire
                elif last.state == "preempted":
                    row["state"] = "preempted"
                elif row["t_first_token"] is not None:
                    row["state"] = "decoding"
        row["queue_wait_s"] = (
            row["t_admit"] - t_arr if row["t_admit"] is not None else None
        )
        row["ttft_s"] = (
            row["t_first_token"] - t_arr
            if row["t_first_token"] is not None else None
        )
        row["e2e_s"] = (
            row["t_retire"] - t_arr
            if row["t_retire"] is not None else None
        )
        n = row["n_tokens"]
        row["tpot_s"] = (
            (row["t_retire"] - row["t_first_token"]) / (n - 1)
            if row["t_retire"] is not None
            and row["t_first_token"] is not None and n > 1 else None
        )
        return row

    def _rows(self) -> List[Dict[str, Any]]:
        return [self._row(self._reqs[rid]) for rid in self._reqs]

    def request_rows(self) -> List[Dict[str, Any]]:
        """One row per logical request, ``dls.requests/1``-shaped plus
        ``priority``/``preemptions`` and the serving-only states
        ``shed``/``preempted``; ``t_submit`` is the ARRIVAL time."""
        return self._rows()

    def lint(self, *, final: bool = True):
        """Run the request-lifecycle protocol checker (LCY00x) over this
        frontend's live request rows; returns the
        :class:`~..analysis.diagnostics.AnalysisReport`.  ``final=True``
        (the default) additionally requires every request to have
        reached a terminal state — pass ``False`` mid-run."""
        from ..analysis.lifecycle_pass import analyze_lifecycle

        return analyze_lifecycle(
            self._rows(), final=final, label="serving"
        )

    # -- reporting ---------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        """Serving-leg summary: goodput (tokens/s of SLO-meeting
        completed requests), arrival-anchored latency percentiles, shed
        and preemption counts, and the page-leak check.  Idempotent."""
        t_end = self.clock()
        rows = self._rows()
        makespan = max(t_end - (self.t0 if self.t0 is not None else t_end),
                       1e-12)
        tokens_total = sum(r["n_tokens"] for r in rows)
        tokens_good = tokens_total
        breached = False
        slo_summary = None
        if self.policy is not None:
            rep = evaluate_slo(
                {"requests": rows}, self.policy, t_end=t_end
            )
            self.slo_report = rep
            tokens_good = rep.tokens_good
            breached = rep.exceeds()
            slo_summary = rep.summary()
        completed = [r for r in rows if r["state"] == "retired"]

        def pct_ms(metric: str) -> Dict[str, Optional[float]]:
            vals = [
                float(r[metric]) for r in completed
                if r.get(metric) is not None
            ]
            return {
                k: (v * 1e3 if v is not None else None)
                for k, v in _percentiles(vals).items()
            }

        ttft = pct_ms("ttft_s")
        qwait = pct_ms("queue_wait_s")
        tpot = pct_ms("tpot_s")
        occ = self.engine.page_occupancy()
        return {
            "admission": self.admission,
            "preemption": self.preemption,
            "n_requests": len(rows),
            "completed": len(completed),
            "shed": sum(1 for r in rows if r["state"] == "shed"),
            "preempted_requests": sum(
                1 for r in rows if r["preemptions"] > 0
            ),
            "preemptions": sum(r["preemptions"] for r in rows),
            "tokens_total": int(tokens_total),
            "tokens_good": int(tokens_good),
            "makespan_s": makespan,
            "goodput_tok_s": tokens_good / makespan,
            "throughput_tok_s": tokens_total / makespan,
            "ttft_p50_ms": ttft["p50"],
            "ttft_p95_ms": ttft["p95"],
            "ttft_p99_ms": ttft["p99"],
            "queue_wait_p50_ms": qwait["p50"],
            "queue_wait_p95_ms": qwait["p95"],
            "tpot_p50_ms": tpot["p50"],
            "tpot_p95_ms": tpot["p95"],
            "tpot_p99_ms": tpot["p99"],
            "pages_leaked": occ["n_pages"] - occ["free_pages"],
            "breached": breached,
            "slo": slo_summary,
            "requests": rows,
        }

    def digest(self) -> str:
        """sha256 over the serving log AND every generated token — two
        same-seed virtual-time runs must match exactly (the serve
        bench's determinism gate)."""
        import hashlib
        import json

        payload = json.dumps(
            {
                "requests": self._rows(),
                "tokens": {
                    rid: self.results[rid].tolist()
                    for rid in sorted(self.results)
                },
            },
            sort_keys=True,
        ).encode("utf-8")
        return hashlib.sha256(payload).hexdigest()


__all__ = [
    "ServiceTimeModel",
    "ServingFrontend",
    "VirtualClock",
]
