"""Fleet router: health-driven placement over an engine registry.

:class:`FleetFrontend` runs N per-replica serving event loops
(:class:`~.frontend.ServingFrontend` instances, one per
:class:`~.registry.ReplicaHandle`) in deterministic lockstep on
parallel virtual clocks:

* **Routing** — each arrival is placed when its deadline passes, by
  scoring every admitting replica on the same headroom surface the
  admission policies read (``page_occupancy()`` free-page fraction +
  free-slot fraction, minus queue pressure: backlog + engine queue +
  not-yet-injected pending).  Highest score wins, ties break to the
  lowest replica id — placement is a pure function of observable
  state.  ``routing="round_robin"`` is the health-blind baseline the
  fleet bench must beat.
* **Affinity** — preempt/resume stays replica-local by construction: a
  preempted request re-enters ITS OWN replica's backlog and resumes
  under ``{rid}#p{k}`` against the prefix pages it already paid for.
  Only an explicit drain migrates work across replicas.
* **Health policing** — when a detector battery is given (default
  :func:`~..obs.fleet.fleet_detectors`: HLT001 page-leak only), each
  replica's own series store is sampled on a fixed virtual cadence and
  re-judged whenever new samples exist, with warmup measured from the
  replica's CURRENT obs epoch.  A breaching replica is **drained**
  (``engine.begin_drain()``; its backlog is re-routed, eligible
  in-flight work is preempt-migrated, mid-prefill work finishes in
  place), then **restarted** through the registry once empty (same
  compiled engine, fresh obs epoch, pristine pool — the cure for an
  injected leak), then held in **probation** (serving nothing new)
  until the window passes.
* **Migration** — a preempt-migrated request is resubmitted on the
  target as ``{rid}#m{m}`` (``#p{k}`` still appended per preemption)
  with its generated prefix stitched into the prompt, exactly like a
  local resume — greedy determinism makes the continuation bitwise
  identical to an uninterrupted run on the target.  Records from the
  source replica are frozen on the request before the source's log is
  wiped, so merged serving rows survive the restart.

**Lockstep time.**  Every round routes due arrivals, polices health,
ticks each replica that has runnable work exactly once, then advances
every replica clock to the maximum ("barrier") — parallel timelines
never drift, which is what makes cross-replica timestamps comparable
and same-seed runs digest-identical.  With a single replica and no
detectors the loop reduces exactly to the standalone
``ServingFrontend`` schedule (the N=1 digest-parity gate).

Global rid uniqueness is enforced HERE (each engine only guards its
own log): a rid seen by any replica — including one that migrated away
— can never be resubmitted (:class:`DuplicateRidError`).

The PyTorch port's copy of ``distributed_llm_scheduler_tpu.serve.router``: framework-free,
so the port keeps it without importing the JAX package.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..obs.slo import SLOPolicy
from ..obs.timeseries import SoakSampler, TimeSeriesStore
from .frontend import ServiceTimeModel, ServingFrontend, _Req
from .loadgen import Arrival
from .registry import EngineRegistry, ReplicaHandle


class DuplicateRidError(ValueError):
    """A logical rid was submitted twice anywhere in the fleet."""


class _FleetReq(_Req):
    """A logical request that can additionally hop replicas."""

    __slots__ = ("migrations", "frozen_recs")

    def __init__(self, a: Arrival, prompt_ids: np.ndarray):
        super().__init__(a, prompt_ids)
        self.migrations = 0
        # engine rid -> RequestRecord captured before a source replica's
        # log was wiped (migration or restart); _pass_records prefers
        # these over the live log
        self.frozen_recs: Dict[str, Any] = {}

    def engine_rid(self) -> str:
        base = (self.a.rid if self.migrations == 0
                else f"{self.a.rid}#m{self.migrations}")
        return (base if self.preemptions == 0
                else f"{base}#p{self.preemptions}")

    def record_migration(self, res: Dict[str, Any]) -> None:
        """Fold a preempt-for-migration result into the request: the
        generated prefix joins the prompt (same stitching as a local
        preemption) but the derived rid advances ``#m`` not ``#p`` —
        the move was the fleet's decision, not SLO pressure, and the
        serving row must not count it as a preemption."""
        tokens = np.asarray(res["tokens"], np.int32)
        self.prefix_parts.append(tokens)
        self.cur_prompt = np.concatenate(
            [self.cur_prompt, tokens[None, :]], axis=1
        )
        self.cur_max_new = int(res["remaining"])
        self.migrations += 1
        self.state = "waiting"


class _ReplicaFrontend(ServingFrontend):
    """Per-replica event loop: migration-aware request state, frozen
    record lookup, and a drain guard on admission."""

    def _make_req(self, a: Arrival) -> _FleetReq:
        return _FleetReq(a, self.prompt_fn(
            a.rid, a.prompt_len, self.vocab_size, self.prompt_seed
        ))

    def _pass_records(self, req: _Req) -> List[Any]:
        frozen = getattr(req, "frozen_recs", None)
        recs = []
        for e in req.passes:
            r = frozen.get(e) if frozen else None
            if r is None:
                r = self.engine.reqlog.get(e)
            if r is not None:
                recs.append(r)
        return recs

    def _row(self, req: _Req) -> Dict[str, Any]:
        row = super()._row(req)
        m = getattr(req, "migrations", 0)
        if m:
            # only on hopped rows: N=1 fleet rows stay byte-identical
            # to the standalone frontend's
            row["migrations"] = m
        return row

    def _admit_backlog(self, now: float) -> int:
        # a draining engine hard-rejects submit(); its backlog is being
        # re-routed by the fleet — never admit into the drain
        if getattr(self.engine, "draining", False):
            return 0
        return super()._admit_backlog(now)


class FleetFrontend:
    """Deterministic fleet serving loop over an
    :class:`~.registry.EngineRegistry` (see module docstring).

    ``detectors=None`` disables policing AND per-replica sampling
    entirely (the zero-overhead/baseline mode); pass
    :func:`~..obs.fleet.fleet_detectors` (or any battery) to turn the
    observability layer into the control plane.  ``warmup_s`` and
    ``probation_s`` are in virtual seconds; ``sample_every_s`` is the
    per-replica series cadence.
    """

    def __init__(
        self,
        registry: EngineRegistry,
        arrivals: Sequence[Arrival],
        policy: Optional[SLOPolicy] = None,
        *,
        admission: str = "slo",
        preemption: bool = True,
        time_model: Optional[ServiceTimeModel] = None,
        prompt_seed: int = 0,
        prompt_fn: Optional[Any] = None,
        routing: str = "score",
        detectors: Optional[List[Any]] = None,
        warmup_s: float = 0.25,
        sample_every_s: float = 0.05,
        probation_s: float = 1.0,
        max_rounds: int = 200_000,
    ):
        if routing not in ("score", "round_robin"):
            raise ValueError(
                f"routing must be 'score' or 'round_robin', "
                f"got {routing!r}"
            )
        if len(registry) == 0:
            raise ValueError("registry has no replicas")
        self.registry = registry
        self.routing = routing
        self.admission = admission
        self.detectors = list(detectors) if detectors else []
        self.warmup_s = float(warmup_s)
        self.sample_every_s = float(sample_every_s)
        self.probation_s = float(probation_s)
        self.max_rounds = int(max_rounds)
        self.tm = time_model or ServiceTimeModel()
        self._fes: Dict[str, _ReplicaFrontend] = {}
        self._samplers: Dict[str, SoakSampler] = {}
        self._next_sample: Dict[str, float] = {}
        self._eval_samples: Dict[str, int] = {}
        for h in registry.replicas():
            fe = _ReplicaFrontend(
                h.engine, [], policy,
                admission=admission, preemption=preemption,
                time_model=self.tm, prompt_seed=prompt_seed,
                prompt_fn=prompt_fn,
            )
            self._fes[h.rid] = fe
            self._bind_sampler(h)
        self._unrouted: List[Arrival] = sorted(
            arrivals, key=lambda a: (a.t, a.rid)
        )
        self._rids: set = set()
        for a in self._unrouted:
            if a.rid in self._rids:
                raise DuplicateRidError(
                    f"duplicate rid {a.rid!r} in arrival schedule"
                )
            self._rids.add(a.rid)
        self._owner: Dict[str, str] = {}   # logical rid -> replica rid
        self._rr = 0
        # fleet-level series (counters + per-replica tokens); recorded
        # only when policing is on, always with explicit fleet time
        self.fleet_store = TimeSeriesStore()
        self.history: List[Dict[str, Any]] = []
        self.migrations = 0
        self.rounds = 0
        self.t0: Optional[float] = None

    # -- external intake ---------------------------------------------------
    def submit(self, arrival: Arrival) -> None:
        """Inject an arrival mid-run; rid must be fleet-unique for all
        time (a migrated-away rid is still spent)."""
        if arrival.rid in self._rids:
            raise DuplicateRidError(
                f"duplicate rid {arrival.rid!r}: already known to the "
                f"fleet (owner: {self._owner.get(arrival.rid, 'unrouted')})"
            )
        self._rids.add(arrival.rid)
        self._unrouted.append(arrival)
        self._unrouted.sort(key=lambda a: (a.t, a.rid))

    # -- plumbing ----------------------------------------------------------
    def _bind_sampler(self, h: ReplicaHandle) -> None:
        """(Re)bind the per-replica sampler to the handle's CURRENT
        store/metrics — called at construction and after each restart
        (the old epoch's series must not leak into the new one)."""
        if self.detectors:
            self._samplers[h.rid] = SoakSampler(
                h.store, engine=h.engine, metrics=h.metrics,
                frontend=self._fes[h.rid],
            )
        self._next_sample.setdefault(h.rid, 0.0)
        self._eval_samples[h.rid] = 0

    def _fe_busy(self, fe: _ReplicaFrontend) -> bool:
        return bool(fe._pending or fe._backlog or fe._inflight)

    def _fe_runnable(self, fe: _ReplicaFrontend, rel: float) -> bool:
        """Work it could advance THIS round (a future-only pending
        arrival is not runnable — ticking it would jump its clock past
        busier replicas)."""
        return bool(
            fe._backlog or fe._inflight
            or (fe._pending and fe._pending[0].t <= rel + 1e-9)
        )

    def _event(self, t: float, event: str, rid: str,
               detail: str = "") -> None:
        self.history.append(
            {"t": float(t), "event": event, "replica": rid,
             "detail": detail}
        )

    # -- routing -----------------------------------------------------------
    def _score(self, h: ReplicaHandle) -> float:
        fe = self._fes[h.rid]
        occ = h.engine.page_occupancy()
        pressure = (len(fe._backlog) + len(h.engine._queue)
                    + len(fe._pending))
        return (occ["free_pages"] / max(occ["n_pages"], 1)
                + h.engine.free_slots / max(h.engine.slots, 1)
                - 0.25 * pressure)

    def _pick_target(
        self, exclude: Optional[str] = None
    ) -> Optional[str]:
        cands = [
            h for h in self.registry.replicas()
            if h.admitting and h.rid != exclude
        ]
        if not cands:
            return None
        if self.routing == "round_robin":
            h = cands[self._rr % len(cands)]
            self._rr += 1
            return h.rid
        # max score, ties to lowest rid (replicas() is rid-sorted and
        # max() keeps the first of equals)
        return max(cands, key=self._score).rid

    def _route_due(self, rel: float) -> None:
        while self._unrouted and self._unrouted[0].t <= rel + 1e-9:
            target = self._pick_target()
            if target is None:
                return   # whole fleet draining/probation; time must pass
            a = self._unrouted.pop(0)
            h = self.registry.get(target)
            self._fes[target].submit(a)
            self._owner[a.rid] = target
            h.routed += 1

    # -- drain / migrate / restart ----------------------------------------
    def _freeze_records(self, fe: _ReplicaFrontend,
                        req: _FleetReq) -> None:
        for e in req.passes:
            if e not in req.frozen_recs:
                r = fe.engine.reqlog.get(e)
                if r is not None:
                    req.frozen_recs[e] = r

    def _receive_migrant(self, target: str, req: _FleetReq) -> None:
        fe = self._fes[target]
        fe._reqs[req.a.rid] = req
        self._owner[req.a.rid] = target
        self.registry.get(target).routed += 1
        if fe.admission == "fifo":
            fe._submit_to_engine(req)
        else:
            fe._backlog.append(req)

    def _drain(self, h: ReplicaHandle, rel: float, why: str) -> None:
        fe = self._fes[h.rid]
        h.state = "draining"
        h.drains += 1
        h.engine.begin_drain()
        self._event(rel, "drain", h.rid, why)
        # 1. backlogged (never-submitted) work re-routes whole
        for req in list(fe._backlog):
            target = self._pick_target(exclude=h.rid)
            if target is None:
                break
            fe._backlog.remove(req)
            del fe._reqs[req.a.rid]
            self._receive_migrant(target, req)
            self.migrations += 1
            self._event(rel, "migrate", h.rid,
                        f"{req.a.rid} -> {target} (backlog)")
        # 2. decoding in-flight work preempt-migrates with its prefix;
        #    mid-prefill and engine-queued work finishes in place (no
        #    resumable prefix yet / submit order is engine-internal)
        prefilling = getattr(h.engine, "is_prefilling", None)
        for erid in sorted(fe._inflight):
            req = fe._inflight[erid]
            if erid not in h.engine._slot_req:
                continue
            if prefilling is not None and prefilling(erid):
                continue
            target = self._pick_target(exclude=h.rid)
            if target is None:
                break
            res = h.engine.preempt(
                erid, cause="preempt_migrate", by=f"fleet:{why}"
            )
            self._freeze_records(fe, req)
            req.record_migration(res)
            del fe._inflight[erid]
            del fe._reqs[req.a.rid]
            self._receive_migrant(target, req)
            self.migrations += 1
            self._event(rel, "migrate", h.rid,
                        f"{req.a.rid} -> {target} as "
                        f"{req.engine_rid()} (in-flight)")

    def _maybe_restart(self, h: ReplicaHandle, rel: float) -> None:
        fe = self._fes[h.rid]
        eng = h.engine
        if fe._inflight or eng._queue or eng.free_slots < eng.slots:
            return   # still emptying
        # the restart wipes the engine's request log — freeze every
        # surviving request's pass records first so merged serving rows
        # (and the LCY lint over them) outlive the epoch
        for req in fe._reqs.values():
            self._freeze_records(fe, req)
        self.registry.restart(h.rid)
        self._bind_sampler(h)
        h.state = "probation"
        h.probation_until = rel + self.probation_s
        self._event(rel, "restart", h.rid,
                    f"restart #{h.restarts}; probation until "
                    f"{h.probation_until:g}")

    def _police(self, rel: float) -> None:
        if not self.detectors:
            return
        for h in self.registry.replicas():
            if h.state == "probation":
                if (h.probation_until is not None
                        and rel >= h.probation_until - 1e-9):
                    h.state = "active"
                    h.probation_until = None
                    self._event(rel, "readmit", h.rid, "probation over")
                continue
            if h.state == "draining":
                self._maybe_restart(h, rel)
                continue
            sampler = self._samplers.get(h.rid)
            if sampler is None or sampler.samples <= self._eval_samples[h.rid]:
                continue   # nothing new to judge
            self._eval_samples[h.rid] = sampler.samples
            for d in self.detectors:
                f = d.evaluate(h.store, h.epoch_t0 + self.warmup_s)
                if f.severity == "error":
                    self._event(rel, "breach", h.rid,
                                f"{f.code} {f.message}")
                    self._drain(h, rel, f.code)
                    break

    # -- the fleet loop ----------------------------------------------------
    def run(self, *, deadline: Optional[float] = None) -> Dict[str, Any]:
        """Serve the schedule to completion (or ``deadline`` virtual
        seconds: unrouted arrivals drop, backlogs shed, in-flight work
        drains); returns :meth:`report`."""
        fes = [self._fes[r] for r in sorted(self._fes)]
        for fe in fes:
            if fe.t0 is None:
                fe.t0 = fe.clock()
        if self.t0 is None:
            self.t0 = min(fe.t0 for fe in fes)
        while self._unrouted or any(self._fe_busy(fe) for fe in fes):
            self.rounds += 1
            if self.rounds > self.max_rounds:
                raise RuntimeError(
                    f"fleet loop stalled after {self.max_rounds} "
                    f"rounds: {len(self._unrouted)} unrouted, "
                    f"{sum(self._fe_busy(fe) for fe in fes)} busy "
                    f"replica(s)"
                )
            rel = max(fe.clock() - fe.t0 for fe in fes)
            if deadline is not None and rel >= deadline:
                self._unrouted.clear()
                for fe in fes:
                    fe._shed_remaining()
                if not any(fe._inflight for fe in fes):
                    break
            self._route_due(rel)
            self._police(rel)
            ticked = False
            for fe in fes:
                if self._fe_runnable(fe, fe.clock() - fe.t0):
                    fe.ticks += 1
                    fe._tick()
                    ticked = True
            # barrier: pull every timeline up to the furthest one so
            # cross-replica timestamps stay comparable and idle
            # replicas keep receiving arrivals
            tmax = max(fe.clock() for fe in fes)
            for fe in fes:
                fe.clock.advance(tmax - fe.clock())
            if not ticked:
                # nothing runnable: jump to the next arrival (or just
                # forward, so probation/SLO windows can roll past)
                rel = tmax - self.t0
                nexts = [a.t for a in self._unrouted[:1]] + [
                    fe._pending[0].t for fe in fes if fe._pending
                ]
                dt = (max(min(nexts) - rel, self.tm.idle_s)
                      if nexts else self.tm.idle_s)
                for fe in fes:
                    fe.clock.advance(dt)
            self._sample(max(fe.clock() for fe in fes))
        return self.report()

    def _sample(self, now: float) -> None:
        if not self.detectors:
            return
        rel = now - (self.t0 or 0.0)
        for h in self.registry.replicas():
            if rel + 1e-9 >= self._next_sample[h.rid]:
                self._samplers[h.rid].sample(t=now)
        due = rel + 1e-9 >= min(self._next_sample.values())
        for rid in self._next_sample:
            if rel + 1e-9 >= self._next_sample[rid]:
                self._next_sample[rid] = rel + self.sample_every_s
        if due:
            rec = self.fleet_store.record
            for h in self.registry.replicas():
                tok = h.metrics.counter("decode.tokens_delivered").value
                rec(f"tokens.{h.rid}", tok, t=now, unit="tokens")
                rec(f"routed.{h.rid}", h.routed, t=now, unit="requests")
                rec(f"drained.{h.rid}", h.drains, t=now, unit="events")
                rec(f"restarted.{h.rid}", h.restarts, t=now,
                    unit="events")

    # -- merged views ------------------------------------------------------
    @property
    def results(self) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for r in sorted(self._fes):
            out.update(self._fes[r].results)
        return out

    def request_rows(self) -> List[Dict[str, Any]]:
        """One row per logical request across the whole fleet, sorted
        by (t_submit, rid) — for N=1 this is exactly the standalone
        frontend's insertion order."""
        rows = [
            row for r in sorted(self._fes)
            for row in self._fes[r].request_rows()
        ]
        rows.sort(key=lambda r: (r["t_submit"], r["rid"]))
        return rows

    def lint(self, *, final: bool = True):
        """LCY lifecycle pass over the merged request rows (migrated
        rows included — their source-epoch records are frozen on the
        request)."""
        from ..analysis.lifecycle_pass import analyze_lifecycle

        return analyze_lifecycle(
            self.request_rows(), final=final, label="fleet"
        )

    def health_report(self):
        """Current :class:`~..obs.fleet.FleetHealthReport`: live
        detector verdicts per replica plus the full event history."""
        from ..obs.fleet import FleetHealthReport

        replicas: Dict[str, Dict[str, Any]] = {}
        for h in self.registry.replicas():
            warmup = h.epoch_t0 + self.warmup_s
            replicas[h.rid] = {
                "state": h.state,
                "restarts": h.restarts,
                "drains": h.drains,
                "warmup_s": warmup,
                "findings": [
                    d.evaluate(h.store, warmup) for d in self.detectors
                ],
            }
        return FleetHealthReport(replicas, history=self.history)

    def report(self) -> Dict[str, Any]:
        """Fleet serving summary: merged rows, fleet goodput, failover
        counters, per-replica reports (sans row duplication), health
        block, and the fleet series snapshot.  Idempotent."""
        fes = self._fes
        t_end = max(fes[r].clock() for r in fes)
        t0 = self.t0 if self.t0 is not None else t_end
        makespan = max(t_end - t0, 1e-12)
        rows = self.request_rows()
        per_replica: Dict[str, Any] = {}
        tokens_total = tokens_good = 0
        pages_leaked = 0
        for rid in sorted(fes):
            rep = fes[rid].report()
            rep.pop("requests")
            h = self.registry.get(rid)
            rep["replica"] = h.summary()
            per_replica[rid] = rep
            tokens_total += rep["tokens_total"]
            tokens_good += rep["tokens_good"]
            pages_leaked += rep["pages_leaked"]
        completed = sum(1 for r in rows if r["state"] == "retired")
        return {
            "n_replicas": len(fes),
            "routing": self.routing,
            "admission": self.admission,
            "detectors": [d.name for d in self.detectors],
            "n_requests": len(rows),
            "completed": completed,
            "shed": sum(1 for r in rows if r["state"] == "shed"),
            "migrations": self.migrations,
            "drains": sum(
                h.drains for h in self.registry.replicas()
            ),
            "restarts": sum(
                h.restarts for h in self.registry.replicas()
            ),
            "tokens_total": int(tokens_total),
            "tokens_good": int(tokens_good),
            "makespan_s": makespan,
            "goodput_tok_s": tokens_good / makespan,
            "throughput_tok_s": tokens_total / makespan,
            "pages_leaked": int(pages_leaked),
            "replicas": per_replica,
            "fleet_health": self.health_report().to_json(),
            "fleet_series": self.fleet_store.snapshot(),
            "requests": rows,
        }

    def digest(self) -> str:
        """sha256 over the merged serving log and every generated
        token — same payload shape as ``ServingFrontend.digest()``, so
        an N=1 detector-less fleet must reproduce the standalone digest
        bit for bit."""
        payload = json.dumps(
            {
                "requests": self.request_rows(),
                "tokens": {
                    rid: toks.tolist()
                    for rid, toks in sorted(self.results.items())
                },
            },
            sort_keys=True,
        ).encode("utf-8")
        return hashlib.sha256(payload).hexdigest()


__all__ = [
    "DuplicateRidError",
    "FleetFrontend",
]
