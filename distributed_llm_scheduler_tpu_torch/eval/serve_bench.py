"""Open-loop serving benchmark: SLO-aware admission + priority
preemption vs FIFO admit-all at equal offered load.

The decode bench (:mod:`.decode_bench`) measures the paged engine with
pre-staged requests — it cannot see the failure mode serving actually
has, which is QUEUEING: under overload, admit-all keeps every request
but blows every TTFT, so almost none of the delivered tokens count as
goodput.  This bench runs the same Poisson arrival schedule
(:mod:`..serve.loadgen`) through the :class:`~..serve.frontend.
ServingFrontend` twice — ``fifo`` admit-all, then ``slo`` admission
with priority preemption — on a shared :class:`~..serve.frontend.
VirtualClock` + :class:`~..serve.frontend.ServiceTimeModel`, so the
whole run (timestamps, windows, shed/preempt decisions, tokens) is a
deterministic function of the seed: the comparison is a property of the
POLICIES, not of host jitter, and CI can gate it exactly.

Gates (exit 1 from ``main`` on violation):

* goodput: the slo leg's tokens/s-within-SLO strictly exceeds fifo's
  at equal offered load,
* mechanism: the slo leg actually preempted (the scenario is tuned so
  tier-0 arrivals hit a full pool),
* zero leaked pages on both legs,
* determinism: a same-seed repeat of the slo leg digests identically.

The artifact schema is ``dls.serve/1`` (validated by
:func:`validate_serve_artifact`; schema-gated in
``tests/test_artifacts_schema.py``), with the regression-gated metrics
flattened at top level: ``serve.goodput_tok_s`` (higher-better),
``serve.ttft_p99_ms`` / ``serve.queue_wait_p95_ms`` (lower-better) —
wired into :mod:`.regress` defaults.

The PyTorch port of ``distributed_llm_scheduler_tpu.eval.serve_bench``'s
serving, prefix and chunked legs: the same scenarios, legs, gates and
artifact, over the port's engine (on the card unless told otherwise).
Because the legs run on a virtual clock, every ``serve.*`` metric is a
function of the engine's decisions alone and equals the JAX bench's.
``--fleet`` runs the fleet chaos comparison instead (three replicas of the
engine behind the health-routed :class:`~..serve.router.FleetFrontend`,
one with a leaking pool; ``dls.fleet/1``), whose ``fleet.*`` values equal
the JAX bench's for the same reason.

    python -m distributed_llm_scheduler_tpu_torch.eval.serve_bench [--fleet] [--device cpu]
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

SCHEMA = "dls.serve/1"

#: the tuned overload scenario: ~2x the virtual-time service capacity
#: (4 slots x 4 tokens / 50 ms segment), page-contended (12 allocatable
#: pages vs 3-4 per request) so tier-0 arrivals exercise preemption
SCENARIO = {
    "slots": 4,
    "page_size": 8,
    "n_pages": 13,
    "pages_per_seq": 4,
    "seg_steps": 4,
    "rate_rps": 40.0,
    "n_requests": 32,
    "prompt_lens": (8, 16),
    "max_new_tokens": (8, 16),
    "priorities": (0, 1),
    "priority_weights": (0.3, 0.7),
    "ttft_s": 0.15,
    "window_s": 0.2,
    "percentile": "p95",
    "wave_s": 0.01,
    "segment_s": 0.05,
    "idle_s": 0.005,
}

#: the prefix-heavy chat scenario layered on the SCENARIO geometry:
#: multi-turn sessions share an 8-token (one-page) system prompt and
#: each turn's prompt extends the previous turn's, so under the same
#: page contention (12 allocatable pages) the sharing engine admits
#: earlier — the whole goodput/TTFT win is page-contention relief,
#: which is exactly what virtual time can measure deterministically
PREFIX_SCENARIO = {
    "system_len": 8,
    "user_len": 8,
    "turns": 2,
    "n_sessions": 16,
    "prefix_rate_rps": 40.0,
    "prefix_max_new_tokens": (8,),
    "think_time_s": 0.05,
}


#: the mixed-long-prompt interference scenario layered on the SCENARIO
#: geometry: Poisson short-prompt traffic with a sparse very-long prompt
#: every ``long_every``-th arrival.  ``prefill_tok_s`` makes prefill
#: cost virtual time proportional to its REAL token count, so
#: whole-prompt admission pays the long prompt in one bulge that every
#: in-flight decode sees (the TPOT cliff), while chunked admission
#: spreads the same total across segments — the comparison is pure
#: scheduling, the total work charged is identical in both legs.
#: Multi-segment short decodes (8–12 new tokens) keep pages occupied
#: across segments, so the whole-prompt long's 4-page up-front claim
#: blocks at the FIFO head while free slots idle behind it — the
#: head-of-line stall chunked admission (first-chunk pages only)
#: removes, which is where the p99 TTFT relief comes from
CHUNKED_SCENARIO = {
    "mlp_rate_rps": 8.0,
    "mlp_n_requests": 26,
    "short_lens": (5, 8),
    "long_len": 24,
    "long_every": 6,
    "mlp_max_new_tokens": (8, 12),
    "long_max_new_tokens": 4,
    "chunk_tokens": 8,
    "prefill_tok_s": 0.02,
    "chunk_ttft_s": 10.0,
}


FLEET_SCHEMA = "dls.fleet/1"

#: the fleet chaos scenario layered on the SCENARIO geometry: N=3
#: replicas of the serve engine behind the FleetFrontend, offered 1.5x
#: the single-engine schedule (the fleet should absorb it), with a
#: ``_LeakyPool`` injected on one replica.  The health-routed leg must
#: detect the leak (HLT001 on the sick replica's own series), drain,
#: restart, and still strictly beat health-blind round-robin on goodput
#: at equal offered load; the no-injection leg must see zero drains.
FLEET_SCENARIO = {
    "n_replicas": 3,
    "sick_replica": "n1",
    "leak_every": 1,
    "fleet_rate_rps": 30.0,
    "fleet_n_requests": 96,
    "fleet_deadline_s": 10.0,
    "fleet_warmup_s": 0.25,
    "fleet_sample_every_s": 0.05,
    "fleet_probation_s": 0.5,
}


def build_serve_engine(
    slots: int = 4,
    page_size: int = 8,
    n_pages: int = 13,
    pages_per_seq: int = 4,
    seg_steps: int = 4,
    clock: Any = None,
    flight: Any = None,
    metrics: Any = None,
    attention_impl: Any = None,
    sharing: bool = False,
    chunk_tokens: Any = None,
    device: Any = "cuda",
):
    """One tiny-GPT2 f32 paged engine on ``device`` (the card unless told
    otherwise), built through ``DeviceBackend.paged_decode_engine`` with
    weights from numpy seed 0 — the construction the tests use too.

    ``attention_impl`` is baked into the DAG's layer tasks (one of
    ``ops.attention.PAGED_IMPLS``; None = op auto).  ``sharing`` enables
    the pool's prefix-chunk intern table (the flag can also be toggled on
    ``engine.pool.sharing`` between reset legs — how the bench compares
    the two modes on one warmed engine)."""
    import torch

    from ..backends.device import DeviceBackend
    from ..core.cluster import Cluster
    from ..frontend.decode_dag import build_paged_decode_dag
    from ..models import gpt2
    from ..models.kv_pages import PagePool
    from ..sched.policies import get_scheduler

    device = torch.device(device)
    cfg = gpt2.GPT2Config.tiny()
    dag = build_paged_decode_dag(
        cfg, slots=slots, page_size=page_size, n_pages=n_pages,
        pages_per_seq=pages_per_seq, attention_impl=attention_impl,
    )
    weights = gpt2.params_from_numpy(
        gpt2.init_params_numpy(cfg, 0), device, cfg.dtype)
    cluster = Cluster.from_torch_devices([device])
    sched = get_scheduler("greedy").schedule(dag.graph, cluster)
    pool = PagePool(n_pages=n_pages, page_size=page_size, sharing=sharing)
    eng = DeviceBackend(cluster).paged_decode_engine(
        dag.graph, sched, cfg, weights, pool,
        slots=slots, pages_per_seq=pages_per_seq, seg_steps=seg_steps,
        clock=clock, flight=flight, metrics=metrics,
        attention_impl=attention_impl, chunk_tokens=chunk_tokens,
    )
    return eng, pool


def run_serving_leg(
    arrivals: Sequence[Any],
    policy: Any,
    admission: str,
    preemption: bool,
    time_model: Any,
    scenario: Optional[Dict[str, Any]] = None,
    engine: Any = None,
    prompt_fn: Any = None,
    device: Any = "cuda",
) -> Dict[str, Any]:
    """One frontend run over a clean engine + VirtualClock at t=0;
    returns the frontend report with the run digest attached.

    Pass a warmed ``engine`` (built with a VirtualClock) to skip
    building one — it is reset, and its clock rewound to 0, so the leg
    sees exactly the state a fresh build would.  ``prompt_fn`` overrides
    the frontend's prompt materializer (the shared-prefix legs); ``device``
    is where an engine built here runs."""
    from ..serve.frontend import ServingFrontend, VirtualClock

    if engine is None:
        sc = dict(SCENARIO, **(scenario or {}))
        engine, _pool = build_serve_engine(
            slots=sc["slots"], page_size=sc["page_size"],
            n_pages=sc["n_pages"], pages_per_seq=sc["pages_per_seq"],
            seg_steps=sc["seg_steps"], clock=VirtualClock(), device=device,
        )
    else:
        engine.reset()
        engine._clock.reset()
    fe = ServingFrontend(
        engine, arrivals, policy, admission=admission,
        preemption=preemption, time_model=time_model,
        prompt_fn=prompt_fn,
    )
    leg = fe.run()
    leg["digest"] = fe.digest()
    return leg


def measure_serving(seed: int = 7,
                    scenario: Optional[Dict[str, Any]] = None,
                    engine: Optional[Any] = None,
                    prefix: bool = True,
                    chunked: bool = True,
                    device: Any = "cuda",
                    ) -> Dict[str, Any]:
    """The full comparison: fifo admit-all vs slo+preemption on the
    same arrival schedule, plus a same-seed determinism repeat of the
    slo leg, plus (``prefix=True``) the shared-prefix leg pair from
    :func:`measure_prefix_sharing`, plus (``chunked=True``) the
    mixed-long-prompt chunked-prefill leg pair from
    :func:`measure_chunked_prefill`.  Returns the ``dls.serve/1``
    artifact dict.

    ``engine`` (test seam) reuses an already-built engine instead of
    building one; the caller must have rebound it to a fresh
    ``VirtualClock`` (``rebind_obs``) and its geometry must match the
    scenario's — only the default SCENARIO geometry qualifies.
    ``device`` is where an engine built here runs."""
    from ..obs.slo import SLOPolicy
    from ..serve.frontend import ServiceTimeModel
    from ..serve.loadgen import poisson_arrivals, schedule_digest

    sc = dict(SCENARIO, **(scenario or {}))
    arrivals = poisson_arrivals(
        sc["rate_rps"], sc["n_requests"], seed,
        prompt_lens=sc["prompt_lens"],
        max_new_tokens=sc["max_new_tokens"],
        priorities=sc["priorities"],
        priority_weights=sc["priority_weights"],
    )
    policy = SLOPolicy(
        ttft_s=sc["ttft_s"], window_s=sc["window_s"],
        percentile=sc["percentile"],
    )
    tm = ServiceTimeModel(
        wave_s=sc["wave_s"], segment_s=sc["segment_s"],
        idle_s=sc["idle_s"],
    )
    from ..serve.frontend import VirtualClock

    if engine is not None:
        eng = engine
    else:
        eng, _pool = build_serve_engine(
            slots=sc["slots"], page_size=sc["page_size"],
            n_pages=sc["n_pages"], pages_per_seq=sc["pages_per_seq"],
            seg_steps=sc["seg_steps"], clock=VirtualClock(), device=device,
        )
    fifo = run_serving_leg(arrivals, policy, "fifo", False, tm, sc,
                           engine=eng)
    slo = run_serving_leg(arrivals, policy, "slo", True, tm, sc,
                          engine=eng)
    repeat = run_serving_leg(arrivals, policy, "slo", True, tm, sc,
                             engine=eng)
    deterministic = slo["digest"] == repeat["digest"]
    from ..obs.interference import attribute_requests

    attribution = {
        name: attribute_requests(
            leg["requests"], ttft_target_s=sc["ttft_s"]
        ).summary(requests=False)
        for name, leg in (("fifo_admit_all", fifo), ("slo_preempt", slo))
    }
    art = {
        "schema": SCHEMA,
        "seed": seed,
        "scenario": {
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in sc.items()
        },
        "offered_load": {
            "rate_rps": sc["rate_rps"],
            "n_requests": sc["n_requests"],
            "arrival_span_s": arrivals[-1].t,
            "schedule_digest": schedule_digest(arrivals),
        },
        "policy": policy.to_json(),
        "time_model": tm.to_json(),
        "attention_impl": eng.summary()["attention_impl"],
        "legs": {"fifo_admit_all": fifo, "slo_preempt": slo},
        "attribution": attribution,
        "deterministic": deterministic,
        "goodput_gain_vs_fifo": (
            slo["goodput_tok_s"] / fifo["goodput_tok_s"]
            if fifo["goodput_tok_s"] else None
        ),
        "pages_leaked": fifo["pages_leaked"] + slo["pages_leaked"],
        # the regression-gated serve metric family (eval/regress.py)
        "serve.goodput_tok_s": slo["goodput_tok_s"],
        "serve.ttft_p99_ms": slo["ttft_p99_ms"],
        "serve.queue_wait_p95_ms": slo["queue_wait_p95_ms"],
        # the tiling invariant, flattened so regress can pin it at 0
        "serve.attribution.max_residual_s": max(
            a["max_residual_s"] for a in attribution.values()
        ),
    }
    if prefix:
        art["prefix"] = measure_prefix_sharing(
            seed=seed, scenario=scenario, engine=eng, device=device
        )
        px = art["prefix"]
        shared = px["legs"]["shared"]
        acct = px["accounting"]["shared"]
        art["serve.prefix.goodput_tok_s"] = shared["goodput_tok_s"]
        art["serve.prefix.ttft_p99_ms"] = shared["ttft_p99_ms"]
        art["serve.prefix.goodput_gain"] = px["goodput_gain"]
        art["serve.prefix.shared_page_hits"] = acct["shared_page_hits"]
        art["serve.prefix.pages_leaked"] = (
            shared["pages_leaked"]
            + px["legs"]["unshared"]["pages_leaked"]
        )
    if chunked:
        art["chunked"] = measure_chunked_prefill(
            seed=seed, scenario=scenario, engine=eng, device=device
        )
        ck = art["chunked"]
        cleg = ck["legs"]["chunked"]
        art["serve.chunked.tpot_p99_ms"] = cleg["tpot_p99_ms"]
        art["serve.chunked.ttft_p99_ms"] = cleg["ttft_p99_ms"]
        art["serve.chunked.goodput_tok_s"] = cleg["goodput_tok_s"]
        art["serve.chunked.tpot_p99_gain"] = ck["tpot_p99_gain"]
        art["serve.chunked.token_parity"] = ck["token_parity"]
        art["serve.chunked.pages_leaked"] = (
            cleg["pages_leaked"] + ck["legs"]["whole"]["pages_leaked"]
        )
    return art


def _page_peaks(events: Sequence[Dict[str, Any]]) -> Dict[str, int]:
    """Replay alloc/free/share/unshare into the logical-vs-physical
    accounting the prefix gate asserts: peaks, end counts (both must be
    zero on a clean drain), and the number of aliasing hits."""
    phys = logical = ppeak = lpeak = hits = 0
    for e in events:
        k, n = e["kind"], len(e["pages"])
        if k == "alloc":
            phys += n
            logical += n
        elif k == "free":
            phys -= n
            logical -= n
        elif k == "share":
            logical += n
            hits += n
        elif k == "unshare":
            logical -= n
        ppeak = max(ppeak, phys)
        lpeak = max(lpeak, logical)
    return {
        "physical_pages_peak": ppeak,
        "logical_pages_peak": lpeak,
        "physical_pages_end": phys,
        "logical_pages_end": logical,
        "shared_page_hits": hits,
    }


def measure_prefix_sharing(
    seed: int = 7,
    scenario: Optional[Dict[str, Any]] = None,
    engine: Optional[Any] = None,
    device: Any = "cuda",
) -> Dict[str, Any]:
    """The prefix-heavy comparison: the SAME multi-turn session schedule
    served with prefix sharing on vs off, on one warmed engine (the
    pool's ``sharing`` flag is toggled between reset legs, and restored
    — with a final reset — before returning, so a session-shared engine
    leaves exactly as it arrived).

    Every leg runs with an ownership log attached; the log is replayed
    through the page-lifetime prover (zero findings required) and
    folded into the logical-vs-physical accounting block the gates
    check.  A same-seed repeat of the shared leg must digest
    identically."""
    import functools

    from ..analysis.page_pass import analyze_pages
    from ..models.kv_pages import PageOwnershipLog
    from ..obs.slo import SLOPolicy
    from ..serve.frontend import ServiceTimeModel, VirtualClock
    from ..serve.loadgen import (
        schedule_digest,
        session_arrivals,
        session_prompt_token_ids,
    )

    sc = dict(SCENARIO, **PREFIX_SCENARIO, **(scenario or {}))
    arrivals = session_arrivals(
        sc["prefix_rate_rps"], sc["n_sessions"], seed,
        system_len=sc["system_len"], user_len=sc["user_len"],
        turns=sc["turns"],
        max_new_tokens=sc["prefix_max_new_tokens"],
        priorities=sc["priorities"],
        priority_weights=sc["priority_weights"],
        think_time_s=sc["think_time_s"],
    )
    prompt_fn = functools.partial(
        session_prompt_token_ids,
        system_len=sc["system_len"], user_len=sc["user_len"],
    )
    policy = SLOPolicy(
        ttft_s=sc["ttft_s"], window_s=sc["window_s"],
        percentile=sc["percentile"],
    )
    tm = ServiceTimeModel(
        wave_s=sc["wave_s"], segment_s=sc["segment_s"],
        idle_s=sc["idle_s"],
    )
    if engine is not None:
        eng = engine
    else:
        eng, _pool = build_serve_engine(
            slots=sc["slots"], page_size=sc["page_size"],
            n_pages=sc["n_pages"], pages_per_seq=sc["pages_per_seq"],
            seg_steps=sc["seg_steps"], clock=VirtualClock(), device=device,
        )
    prev_sharing = bool(getattr(eng.pool, "sharing", False))
    legs: Dict[str, Dict[str, Any]] = {}
    logs: Dict[str, PageOwnershipLog] = {}
    try:
        for name, mode in (("unshared", False), ("shared", True),
                           ("repeat", True)):
            eng.pool.sharing = mode
            log = PageOwnershipLog()
            eng.attach_ownership_log(log)
            legs[name] = run_serving_leg(
                arrivals, policy, "slo", True, tm, sc,
                engine=eng, prompt_fn=prompt_fn,
            )
            logs[name] = log
    finally:
        eng.attach_ownership_log(None)
        eng.pool.sharing = prev_sharing
        eng.reset()
    accounting = {
        name: _page_peaks(logs[name].events)
        for name in ("shared", "unshared")
    }
    page_pass = {
        name: [d.code for d in analyze_pages(logs[name]).diagnostics]
        for name in ("shared", "unshared")
    }
    cow_splits = sum(
        1 for e in logs["shared"].events if e["kind"] == "cow"
    )
    unshared_gp = legs["unshared"]["goodput_tok_s"]
    return {
        "scenario": {
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in sc.items()
        },
        "offered_load": {
            "rate_rps": sc["prefix_rate_rps"],
            "n_requests": len(arrivals),
            "n_sessions": sc["n_sessions"],
            "arrival_span_s": arrivals[-1].t,
            "schedule_digest": schedule_digest(arrivals),
        },
        "legs": {
            "shared": legs["shared"], "unshared": legs["unshared"],
        },
        "deterministic": (
            legs["shared"]["digest"] == legs["repeat"]["digest"]
        ),
        "accounting": accounting,
        "page_pass": page_pass,
        "cow_splits": cow_splits,
        "goodput_gain": (
            legs["shared"]["goodput_tok_s"] / unshared_gp
            if unshared_gp else None
        ),
    }


def measure_chunked_prefill(
    seed: int = 7,
    scenario: Optional[Dict[str, Any]] = None,
    engine: Optional[Any] = None,
    device: Any = "cuda",
) -> Dict[str, Any]:
    """The mixed-long-prompt comparison: the SAME arrival schedule
    served with whole-prompt admission (``chunk_tokens=None``) vs
    chunked prefill, on one warmed engine (``engine.chunk_tokens`` is
    toggled between reset legs and restored — with the prefill-time
    hook cleared and a final reset — before returning).

    Both legs run the identical :class:`ServiceTimeModel` with
    ``prefill_tok_s > 0``: prefill costs virtual time where it actually
    runs, so the whole leg's long-prompt bulge lands inside one segment
    while the chunked leg amortizes it.  Every request's generated
    tokens are kept per leg — the bitwise-parity gate compares them
    directly — and a same-seed repeat of the chunked leg must digest
    identically."""
    from ..obs.slo import SLOPolicy
    from ..serve.frontend import (
        ServiceTimeModel,
        ServingFrontend,
        VirtualClock,
    )
    from ..serve.loadgen import mixed_long_prompt_arrivals, schedule_digest

    sc = {**SCENARIO, **CHUNKED_SCENARIO, **(scenario or {})}
    arrivals = mixed_long_prompt_arrivals(
        sc["mlp_rate_rps"], sc["mlp_n_requests"], seed,
        short_lens=sc["short_lens"], long_len=sc["long_len"],
        long_every=sc["long_every"],
        max_new_tokens=sc["mlp_max_new_tokens"],
        long_max_new_tokens=sc["long_max_new_tokens"],
    )
    policy = SLOPolicy(
        ttft_s=sc["chunk_ttft_s"], window_s=sc["window_s"],
        percentile=sc["percentile"],
    )
    tm = ServiceTimeModel(
        wave_s=sc["wave_s"], segment_s=sc["segment_s"],
        idle_s=sc["idle_s"], prefill_tok_s=sc["prefill_tok_s"],
    )
    if engine is not None:
        eng = engine
    else:
        eng, _pool = build_serve_engine(
            slots=sc["slots"], page_size=sc["page_size"],
            n_pages=sc["n_pages"], pages_per_seq=sc["pages_per_seq"],
            seg_steps=sc["seg_steps"], clock=VirtualClock(), device=device,
        )
    prev_ct = eng.chunk_tokens
    legs: Dict[str, Dict[str, Any]] = {}
    tokens: Dict[str, Dict[str, List[int]]] = {}
    chunk_counts: Dict[str, int] = {}

    def _ctr(name: str) -> int:
        return int(eng.metrics.counter(name).value)

    try:
        for name, ct in (("whole", None),
                         ("chunked", sc["chunk_tokens"]),
                         ("repeat", sc["chunk_tokens"])):
            eng.reset()
            eng._clock.reset()
            eng.chunk_tokens = ct
            adm0 = _ctr("decode.chunk_admitted")
            fe = ServingFrontend(
                eng, arrivals, policy, admission="slo",
                preemption=False, time_model=tm,
            )
            leg = fe.run()
            leg["digest"] = fe.digest()
            legs[name] = leg
            tokens[name] = {
                rid: [int(t) for t in toks]
                for rid, toks in fe.results.items()
            }
            chunk_counts[name] = _ctr("decode.chunk_admitted") - adm0
    finally:
        eng.chunk_tokens = prev_ct
        eng.prefill_time_charge = None
        eng.reset()
    return {
        "scenario": {
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in sc.items()
        },
        "offered_load": {
            "rate_rps": sc["mlp_rate_rps"],
            "n_requests": len(arrivals),
            "n_long": sum(
                1 for a in arrivals if a.prompt_len == sc["long_len"]
            ),
            "arrival_span_s": arrivals[-1].t,
            "schedule_digest": schedule_digest(arrivals),
        },
        "time_model": tm.to_json(),
        "legs": {"whole": legs["whole"], "chunked": legs["chunked"]},
        "deterministic": (
            legs["chunked"]["digest"] == legs["repeat"]["digest"]
        ),
        "token_parity": tokens["whole"] == tokens["chunked"],
        "chunk_admitted": chunk_counts["chunked"],
        "whole_leg_chunk_admitted": chunk_counts["whole"],
        "tpot_p99_gain": (
            legs["whole"]["tpot_p99_ms"] / legs["chunked"]["tpot_p99_ms"]
            if legs["chunked"]["tpot_p99_ms"] else None
        ),
    }


def chunked_gate_failures(ck: Dict[str, Any]) -> List[str]:
    """The chunked-prefill gates (``SERVE_r18.json``): at equal offered
    load chunked admission must strictly beat whole-prompt on p99 TPOT
    and be no worse on p99 TTFT, deliver bitwise-identical tokens per request,
    leak nothing on either leg, actually chunk at least one prompt, and
    repeat digest-identically."""
    failures: List[str] = []
    whole = ck["legs"]["whole"]
    chunked = ck["legs"]["chunked"]
    if not chunked["tpot_p99_ms"] < whole["tpot_p99_ms"]:
        failures.append(
            f"chunked tpot p99 {chunked['tpot_p99_ms']:.1f} ms not "
            f"strictly below whole-prompt {whole['tpot_p99_ms']:.1f} ms"
        )
    if not chunked["ttft_p99_ms"] <= whole["ttft_p99_ms"]:
        failures.append(
            f"chunked ttft p99 {chunked['ttft_p99_ms']:.1f} ms worse "
            f"than whole-prompt {whole['ttft_p99_ms']:.1f} ms"
        )
    for name in ("whole", "chunked"):
        leg = ck["legs"][name]
        if leg["completed"] != leg["n_requests"]:
            failures.append(
                f"chunked-bench {name} leg completed {leg['completed']} "
                f"of {leg['n_requests']} requests (parity needs all)"
            )
        if leg["pages_leaked"]:
            failures.append(
                f"chunked-bench {name} leg leaked "
                f"{leg['pages_leaked']} pages"
            )
    if not ck["token_parity"]:
        failures.append(
            "chunked leg tokens differ from whole-prompt leg (bitwise)"
        )
    if ck["chunk_admitted"] < 1:
        failures.append(
            "chunked leg never chunk-admitted a prompt (mis-tuned)"
        )
    if ck["whole_leg_chunk_admitted"]:
        failures.append("whole-prompt leg chunk-admitted a prompt")
    if not ck["deterministic"]:
        failures.append(
            "chunked same-seed repeat diverged (digest mismatch)"
        )
    return failures


def run_fleet_leg(
    arrivals: Sequence[Any],
    policy: Any,
    time_model: Any,
    sc: Dict[str, Any],
    *,
    routing: str,
    detectors: Optional[List[Any]],
    leak: bool,
    engines: Optional[Dict[str, Any]] = None,
    device: Any = "cuda",
) -> Dict[str, Any]:
    """One :class:`~..serve.router.FleetFrontend` run over a fresh
    registry of ``n_replicas`` engines; returns the fleet report with
    the run digest attached.

    ``engines`` (test/CLI warm seam) maps replica id -> an
    already-warmed engine; the factory ``rebind_obs``-es each one
    onto the registry's per-replica clock + prefixed metrics, so the
    leg is indistinguishable from a cold build.  ``leak=True`` injects
    the ``_LeakyPool`` on ``sc["sick_replica"]`` AFTER registration
    (the rebind would otherwise swap it back out).  ``device`` is where
    engines built here run."""
    from ..serve.registry import EngineRegistry
    from ..serve.router import FleetFrontend
    from ..serve.soak import inject_page_leak

    rids = [f"n{i}" for i in range(sc["n_replicas"])]

    def factory(rid: str, *, clock: Any, metrics: Any):
        if engines is not None:
            eng = engines[rid]
            eng.rebind_obs(clock=clock, metrics=metrics)
            return eng
        eng, _pool = build_serve_engine(
            slots=sc["slots"], page_size=sc["page_size"],
            n_pages=sc["n_pages"], pages_per_seq=sc["pages_per_seq"],
            seg_steps=sc["seg_steps"], clock=clock, metrics=metrics,
            device=device,
        )
        return eng

    reg = EngineRegistry(factory)
    for rid in rids:
        reg.add(rid)
    if leak:
        inject_page_leak(
            reg.get(sc["sick_replica"]).engine,
            every=sc["leak_every"],
        )
    fleet = FleetFrontend(
        reg, arrivals, policy,
        admission="slo", preemption=True, time_model=time_model,
        routing=routing, detectors=detectors,
        warmup_s=sc["fleet_warmup_s"],
        sample_every_s=sc["fleet_sample_every_s"],
        probation_s=sc["fleet_probation_s"],
    )
    leg = fleet.run(deadline=sc["fleet_deadline_s"])
    leg["digest"] = fleet.digest()
    return leg


def measure_fleet(
    seed: int = 7,
    scenario: Optional[Dict[str, Any]] = None,
    engines: Optional[Dict[str, Any]] = None,
    device: Any = "cuda",
) -> Dict[str, Any]:
    """The fleet chaos comparison (``dls.fleet/1`` artifact):

    * ``rr_blind`` — health-blind round-robin over N=3 with the leak
      injected: the baseline that keeps feeding the sick replica;
    * ``health`` — occupancy-scored routing + the HLT001 battery on the
      same schedule and injection: must drain + restart the sick
      replica and strictly beat ``rr_blind`` on goodput;
    * a same-seed repeat of ``health`` (digest gate);
    * ``healthy`` — scored routing + detectors with NO injection: the
      false-positive guard (zero drains, zero restarts, zero leaks).

    ``engines`` (test seam) maps ``n0..n{N-1}`` to warmed engines of
    SCENARIO geometry; every leg re-registers them through
    ``rebind_obs``, so no leg sees another's state; without them each
    leg builds its replicas on ``device``."""
    from ..obs.fleet import fleet_detectors
    from ..obs.slo import SLOPolicy
    from ..serve.frontend import ServiceTimeModel
    from ..serve.loadgen import poisson_arrivals, schedule_digest

    sc = dict(SCENARIO, **FLEET_SCENARIO, **(scenario or {}))
    arrivals = poisson_arrivals(
        sc["fleet_rate_rps"], sc["fleet_n_requests"], seed,
        prompt_lens=sc["prompt_lens"],
        max_new_tokens=sc["max_new_tokens"],
        priorities=sc["priorities"],
        priority_weights=sc["priority_weights"],
    )
    policy = SLOPolicy(
        ttft_s=sc["ttft_s"], window_s=sc["window_s"],
        percentile=sc["percentile"],
    )
    tm = ServiceTimeModel(
        wave_s=sc["wave_s"], segment_s=sc["segment_s"],
        idle_s=sc["idle_s"],
    )
    common = dict(engines=engines, device=device)
    rr = run_fleet_leg(arrivals, policy, tm, sc, routing="round_robin",
                       detectors=None, leak=True, **common)
    health = run_fleet_leg(arrivals, policy, tm, sc, routing="score",
                           detectors=fleet_detectors(), leak=True,
                           **common)
    repeat = run_fleet_leg(arrivals, policy, tm, sc, routing="score",
                           detectors=fleet_detectors(), leak=True,
                           **common)
    healthy = run_fleet_leg(arrivals, policy, tm, sc, routing="score",
                            detectors=fleet_detectors(), leak=False,
                            **common)
    deterministic = health["digest"] == repeat["digest"]
    return {
        "schema": FLEET_SCHEMA,
        "seed": seed,
        "scenario": {
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in sc.items()
        },
        "offered_load": {
            "rate_rps": sc["fleet_rate_rps"],
            "n_requests": sc["fleet_n_requests"],
            "arrival_span_s": arrivals[-1].t,
            "schedule_digest": schedule_digest(arrivals),
        },
        "policy": policy.to_json(),
        "time_model": tm.to_json(),
        "legs": {
            "rr_blind": rr, "health": health, "healthy": healthy,
        },
        "deterministic": deterministic,
        "fleet_health": health["fleet_health"],
        # the regression-gated fleet metric family (eval/regress.py)
        "fleet.goodput_tok_s": health["goodput_tok_s"],
        "fleet.goodput_gain_vs_rr": (
            health["goodput_tok_s"] / rr["goodput_tok_s"]
            if rr["goodput_tok_s"] else None
        ),
        "fleet.drains": health["drains"],
        "fleet.restarts": health["restarts"],
        "fleet.migrations": health["migrations"],
        "fleet.pages_leaked": (
            health["pages_leaked"] + healthy["pages_leaked"]
        ),
        "fleet.healthy_drains": healthy["drains"] + healthy["restarts"],
        "fleet.deterministic": deterministic,
    }


def fleet_gate_failures(art: Dict[str, Any]) -> List[str]:
    """The r20 fleet gates: health-driven routing must strictly beat
    health-blind round-robin on goodput with the same sick replica at
    equal offered load; failover must actually fire (>=1 drain, exactly
    1 restart, HLT001 named in the breach history) yet the fleet must
    END healthy (no current breach — self-healing worked); survivors
    end with zero leaked pages; the no-injection leg must see zero
    drains/restarts/leaks; same-seed repeat digest-identical."""
    failures: List[str] = []
    rr = art["legs"]["rr_blind"]
    health = art["legs"]["health"]
    healthy = art["legs"]["healthy"]
    if not health["goodput_tok_s"] > rr["goodput_tok_s"]:
        failures.append(
            f"health-routed goodput {health['goodput_tok_s']:.1f} tok/s "
            f"not strictly above round-robin {rr['goodput_tok_s']:.1f}"
        )
    if health["drains"] < 1:
        failures.append("health leg never drained the sick replica")
    if health["restarts"] != 1:
        failures.append(
            f"health leg restarted {health['restarts']} time(s), "
            f"want exactly 1"
        )
    fh = art["fleet_health"]
    if fh.get("exceeds"):
        failures.append(
            "fleet ends unhealthy (current breach) despite failover"
        )
    if not any(
        ev.get("event") == "breach" and "HLT001" in ev.get("detail", "")
        for ev in fh.get("history", [])
    ):
        failures.append("breach history never names HLT001")
    if health["pages_leaked"]:
        failures.append(
            f"health leg ends with {health['pages_leaked']} leaked "
            f"page(s) on surviving replicas"
        )
    if healthy["pages_leaked"]:
        failures.append(
            f"healthy leg leaked {healthy['pages_leaked']} page(s)"
        )
    if healthy["drains"] or healthy["restarts"]:
        failures.append(
            f"healthy leg drained {healthy['drains']} / restarted "
            f"{healthy['restarts']} (false positive)"
        )
    if not art["deterministic"]:
        failures.append(
            "fleet same-seed repeat diverged (digest mismatch)"
        )
    return failures


_FLEET_LEG_REQUIRED = (
    "n_replicas", "routing", "admission", "detectors", "n_requests",
    "completed", "shed", "migrations", "drains", "restarts",
    "tokens_total", "tokens_good", "makespan_s", "goodput_tok_s",
    "throughput_tok_s", "pages_leaked", "replicas", "fleet_health",
    "fleet_series", "requests", "digest",
)
_FLEET_TOP_REQUIRED = (
    "schema", "seed", "scenario", "offered_load", "policy",
    "time_model", "legs", "deterministic", "fleet_health",
    "fleet.goodput_tok_s", "fleet.goodput_gain_vs_rr", "fleet.drains",
    "fleet.restarts", "fleet.migrations", "fleet.pages_leaked",
    "fleet.healthy_drains", "fleet.deterministic",
)


def validate_fleet_artifact(art: Any) -> List[str]:
    """Structural check of a ``dls.fleet/1`` artifact; returns
    human-readable problems (empty list == valid)."""
    from ..obs.fleet import validate_fleet_health

    errs: List[str] = []
    if not isinstance(art, dict):
        return [f"artifact is {type(art).__name__}, not dict"]
    if art.get("schema") != FLEET_SCHEMA:
        errs.append(
            f"schema is {art.get('schema')!r}, want {FLEET_SCHEMA!r}"
        )
    for f in _FLEET_TOP_REQUIRED:
        if f not in art:
            errs.append(f"missing top-level field {f!r}")
    legs = art.get("legs")
    if not isinstance(legs, dict):
        return errs + ["legs block missing or not a dict"]
    for name in ("rr_blind", "health", "healthy"):
        leg = legs.get(name)
        if not isinstance(leg, dict):
            errs.append(f"legs.{name} missing or not a dict")
            continue
        for f in _FLEET_LEG_REQUIRED:
            if f not in leg:
                errs.append(f"legs.{name} missing {f!r}")
        if isinstance(leg.get("fleet_health"), dict):
            errs.extend(
                f"legs.{name}.fleet_health: {e}"
                for e in validate_fleet_health(leg["fleet_health"])[:3]
            )
        reqs = leg.get("requests")
        if not isinstance(reqs, list) or not reqs:
            errs.append(f"legs.{name}.requests missing or empty")
    if isinstance(art.get("fleet_health"), dict):
        errs.extend(
            f"fleet_health: {e}"
            for e in validate_fleet_health(art["fleet_health"])[:5]
        )
    elif "fleet_health" in art:
        errs.append("fleet_health is not a dict")
    for f in ("fleet.goodput_tok_s", "fleet.goodput_gain_vs_rr"):
        if f in art and not isinstance(art.get(f), (int, float)):
            errs.append(f"{f} is not numeric")
    if ("fleet.deterministic" in art
            and not isinstance(art["fleet.deterministic"], bool)):
        errs.append("fleet.deterministic is not a bool")
    return errs


def gate_failures(art: Dict[str, Any]) -> List[str]:
    """The acceptance gates, as human-readable failure strings."""
    failures: List[str] = []
    fifo = art["legs"]["fifo_admit_all"]
    slo = art["legs"]["slo_preempt"]
    if not slo["goodput_tok_s"] > fifo["goodput_tok_s"]:
        failures.append(
            f"slo goodput {slo['goodput_tok_s']:.1f} tok/s not strictly "
            f"above fifo {fifo['goodput_tok_s']:.1f} tok/s"
        )
    if slo["preemptions"] < 1:
        failures.append("slo leg never preempted (scenario mis-tuned)")
    if art["pages_leaked"]:
        failures.append(f"{art['pages_leaked']} pages leaked")
    if not art["deterministic"]:
        failures.append("same-seed repeat diverged (digest mismatch)")
    if "prefix" in art:
        failures.extend(prefix_gate_failures(art["prefix"]))
    if "chunked" in art:
        failures.extend(chunked_gate_failures(art["chunked"]))
    return failures


def prefix_gate_failures(px: Dict[str, Any]) -> List[str]:
    """The shared-prefix gates (``SERVE_r17.json``): sharing must strictly
    beat the sharing-disabled leg on BOTH goodput and TTFT p99 at equal
    offered load, actually alias pages, keep the refcount books exact (logical
    >= physical, both legs drain to zero physical pages, the
    page-lifetime prover finds nothing), and repeat digest-identically."""
    failures: List[str] = []
    shared = px["legs"]["shared"]
    unshared = px["legs"]["unshared"]
    if not shared["goodput_tok_s"] > unshared["goodput_tok_s"]:
        failures.append(
            f"prefix sharing goodput {shared['goodput_tok_s']:.1f} tok/s "
            f"not strictly above sharing-disabled "
            f"{unshared['goodput_tok_s']:.1f} tok/s"
        )
    if not shared["ttft_p99_ms"] < unshared["ttft_p99_ms"]:
        failures.append(
            f"prefix sharing ttft p99 {shared['ttft_p99_ms']:.1f} ms not "
            f"strictly below sharing-disabled "
            f"{unshared['ttft_p99_ms']:.1f} ms"
        )
    if shared["completed"] < 1 or unshared["completed"] < 1:
        failures.append("a prefix leg completed zero requests")
    for name in ("shared", "unshared"):
        if px["legs"][name]["pages_leaked"]:
            failures.append(
                f"prefix {name} leg leaked "
                f"{px['legs'][name]['pages_leaked']} pages"
            )
        acct = px["accounting"][name]
        if acct["physical_pages_end"] or acct["logical_pages_end"]:
            failures.append(
                f"prefix {name} leg accounting did not drain to zero "
                f"(physical {acct['physical_pages_end']}, logical "
                f"{acct['logical_pages_end']})"
            )
        if acct["logical_pages_peak"] < acct["physical_pages_peak"]:
            failures.append(
                f"prefix {name} leg logical peak "
                f"{acct['logical_pages_peak']} below physical peak "
                f"{acct['physical_pages_peak']}"
            )
        if px["page_pass"][name]:
            failures.append(
                f"prefix {name} leg page pass found "
                f"{px['page_pass'][name]}"
            )
    if px["accounting"]["shared"]["shared_page_hits"] < 1:
        failures.append("prefix shared leg never aliased a page")
    if px["accounting"]["unshared"]["shared_page_hits"]:
        failures.append("sharing-disabled leg recorded share events")
    if not px["deterministic"]:
        failures.append(
            "prefix shared same-seed repeat diverged (digest mismatch)"
        )
    return failures


# -- artifact schema -------------------------------------------------------
_LEG_REQUIRED = (
    "admission", "preemption", "n_requests", "completed", "shed",
    "preemptions", "tokens_total", "tokens_good", "makespan_s",
    "goodput_tok_s", "throughput_tok_s", "ttft_p50_ms", "ttft_p99_ms",
    "queue_wait_p95_ms", "pages_leaked", "breached", "requests",
    "digest",
)
_TOP_REQUIRED = (
    "schema", "seed", "scenario", "offered_load", "policy", "time_model",
    "attention_impl", "legs", "deterministic", "pages_leaked",
    "serve.goodput_tok_s", "serve.ttft_p99_ms", "serve.queue_wait_p95_ms",
)
#: required inside the (optional) top-level ``prefix`` block; when the
#: block is present the four flattened ``serve.prefix.*`` regression
#: metrics must be present too
_PREFIX_REQUIRED = (
    "scenario", "offered_load", "legs", "deterministic", "accounting",
    "page_pass", "cow_splits", "goodput_gain",
)
_PREFIX_ACCT_REQUIRED = (
    "physical_pages_peak", "logical_pages_peak", "physical_pages_end",
    "logical_pages_end", "shared_page_hits",
)
#: required inside the (optional) top-level ``chunked`` block; when the
#: block is present the flattened ``serve.chunked.*`` regression
#: metrics must be present too
_CHUNKED_REQUIRED = (
    "scenario", "offered_load", "time_model", "legs", "deterministic",
    "token_parity", "chunk_admitted", "whole_leg_chunk_admitted",
    "tpot_p99_gain",
)


def validate_serve_artifact(art: Any) -> List[str]:
    """Structural check of a ``dls.serve/1`` artifact; returns
    human-readable problems (empty list == valid).  Shared by the
    artifact schema tests and the CI serve-smoke step."""
    errs: List[str] = []
    if not isinstance(art, dict):
        return [f"artifact is {type(art).__name__}, not dict"]
    if art.get("schema") != SCHEMA:
        errs.append(f"schema is {art.get('schema')!r}, want {SCHEMA!r}")
    for f in _TOP_REQUIRED:
        if f not in art:
            errs.append(f"missing top-level field {f!r}")
    legs = art.get("legs")
    if not isinstance(legs, dict):
        return errs + ["legs block missing or not a dict"]
    for name in ("fifo_admit_all", "slo_preempt"):
        leg = legs.get(name)
        if not isinstance(leg, dict):
            errs.append(f"legs.{name} missing or not a dict")
            continue
        for f in _LEG_REQUIRED:
            if f not in leg:
                errs.append(f"legs.{name} missing {f!r}")
        reqs = leg.get("requests")
        if not isinstance(reqs, list) or not reqs:
            errs.append(f"legs.{name}.requests missing or empty")
            continue
        for i, row in enumerate(reqs):
            if not isinstance(row, dict):
                errs.append(f"legs.{name}.requests[{i}] not a dict")
                continue
            for f in ("rid", "priority", "state", "t_submit", "n_tokens",
                      "preemptions"):
                if f not in row:
                    errs.append(f"legs.{name}.requests[{i}] missing {f!r}")
    for f in ("serve.goodput_tok_s", "serve.ttft_p99_ms",
              "serve.queue_wait_p95_ms"):
        v = art.get(f)
        if f in art and not isinstance(v, (int, float)):
            errs.append(f"{f} is not numeric")
    if "prefix" in art:
        px = art["prefix"]
        if not isinstance(px, dict):
            return errs + ["prefix block is not a dict"]
        for f in _PREFIX_REQUIRED:
            if f not in px:
                errs.append(f"prefix missing {f!r}")
        plegs = px.get("legs")
        if isinstance(plegs, dict):
            for name in ("shared", "unshared"):
                leg = plegs.get(name)
                if not isinstance(leg, dict):
                    errs.append(f"prefix.legs.{name} missing or not a dict")
                    continue
                for f in _LEG_REQUIRED:
                    if f not in leg:
                        errs.append(f"prefix.legs.{name} missing {f!r}")
        else:
            errs.append("prefix.legs block missing or not a dict")
        acct = px.get("accounting")
        if isinstance(acct, dict):
            for name in ("shared", "unshared"):
                block = acct.get(name)
                if not isinstance(block, dict):
                    errs.append(
                        f"prefix.accounting.{name} missing or not a dict"
                    )
                    continue
                for f in _PREFIX_ACCT_REQUIRED:
                    if f not in block:
                        errs.append(f"prefix.accounting.{name} missing {f!r}")
        else:
            errs.append("prefix.accounting block missing or not a dict")
        for f in ("serve.prefix.goodput_tok_s", "serve.prefix.ttft_p99_ms",
                  "serve.prefix.goodput_gain",
                  "serve.prefix.shared_page_hits",
                  "serve.prefix.pages_leaked"):
            if f not in art:
                errs.append(f"missing top-level field {f!r}")
            elif not isinstance(art[f], (int, float)):
                errs.append(f"{f} is not numeric")
    if "chunked" in art:
        ck = art["chunked"]
        if not isinstance(ck, dict):
            return errs + ["chunked block is not a dict"]
        for f in _CHUNKED_REQUIRED:
            if f not in ck:
                errs.append(f"chunked missing {f!r}")
        clegs = ck.get("legs")
        if isinstance(clegs, dict):
            for name in ("whole", "chunked"):
                leg = clegs.get(name)
                if not isinstance(leg, dict):
                    errs.append(
                        f"chunked.legs.{name} missing or not a dict"
                    )
                    continue
                for f in _LEG_REQUIRED + ("tpot_p99_ms",):
                    if f not in leg:
                        errs.append(f"chunked.legs.{name} missing {f!r}")
        else:
            errs.append("chunked.legs block missing or not a dict")
        for f in ("serve.chunked.tpot_p99_ms", "serve.chunked.ttft_p99_ms",
                  "serve.chunked.goodput_tok_s",
                  "serve.chunked.tpot_p99_gain",
                  "serve.chunked.pages_leaked"):
            if f not in art:
                errs.append(f"missing top-level field {f!r}")
            elif not isinstance(art[f], (int, float)):
                errs.append(f"{f} is not numeric")
        if "serve.chunked.token_parity" not in art:
            errs.append(
                "missing top-level field 'serve.chunked.token_parity'"
            )
        elif not isinstance(art["serve.chunked.token_parity"], bool):
            errs.append("serve.chunked.token_parity is not a bool")
    return errs


def _main_fleet(args: Any, overrides: Optional[Dict[str, Any]]) -> int:
    """The ``--fleet`` CLI leg: run, print (rows/series stripped),
    optionally write the full ``dls.fleet/1`` artifact, gate."""
    import json
    import sys

    art = measure_fleet(seed=args.seed, scenario=overrides,
                        device=args.device)

    def _strip_leg(leg: Dict[str, Any]) -> Dict[str, Any]:
        return {
            k: v for k, v in leg.items()
            if k not in ("requests", "fleet_series", "replicas")
        }

    shown = {k: v for k, v in art.items() if k != "legs"}
    shown["legs"] = {
        name: _strip_leg(leg) for name, leg in art["legs"].items()
    }
    print(json.dumps(shown, indent=1, sort_keys=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(art, f, indent=1, sort_keys=True)
    failures = fleet_gate_failures(art)
    for f_ in failures:
        print(f"FLEET GATE FAIL: {f_}", file=sys.stderr)
    if failures:
        return 1
    health = art["legs"]["health"]
    rr = art["legs"]["rr_blind"]
    print(
        f"FLEET GATES PASS: {health['goodput_tok_s']:.0f} tok/s goodput "
        f"(health-routed) vs {rr['goodput_tok_s']:.0f} (round-robin) "
        f"over {health['n_replicas']} replicas at "
        f"{art['scenario']['fleet_rate_rps']:.0f} req/s offered, "
        f"{health['drains']} drain / {health['restarts']} restart / "
        f"{health['migrations']} migration(s) on "
        f"{art['scenario']['sick_replica']}, 0 pages leaked, "
        "deterministic",
        file=sys.stderr,
    )
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(
        description="open-loop serving bench: slo+preempt vs fifo "
                    "admit-all (exit 1 when a gate fails)"
    )
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--rate", type=float, default=None,
                    help="override offered load (requests/s)")
    ap.add_argument("--requests", type=int, default=None, dest="n_requests",
                    help="override request count")
    ap.add_argument("--out", default=None,
                    help="also write the dls.serve/1 artifact here")
    ap.add_argument("--no-prefix", action="store_true",
                    help="skip the shared-prefix leg pair")
    ap.add_argument("--no-chunked", action="store_true",
                    help="skip the mixed-long-prompt chunked leg pair")
    ap.add_argument("--fleet", action="store_true",
                    help="run the N-replica fleet chaos bench instead "
                         "(dls.fleet/1 artifact, fleet gates)")
    ap.add_argument("--device", default="cuda",
                    help="where the engines run (default: the card)")
    args = ap.parse_args(argv)

    overrides: Dict[str, Any] = {}
    if args.rate is not None:
        overrides["rate_rps" if not args.fleet else "fleet_rate_rps"] = (
            args.rate
        )
    if args.n_requests is not None:
        overrides[
            "n_requests" if not args.fleet else "fleet_n_requests"
        ] = args.n_requests
    if args.fleet:
        return _main_fleet(args, overrides or None)
    art = measure_serving(seed=args.seed, scenario=overrides or None,
                          prefix=not args.no_prefix,
                          chunked=not args.no_chunked, device=args.device)

    def _strip(legs: Dict[str, Any]) -> Dict[str, Any]:
        return {
            name: {k: v for k, v in leg.items() if k != "requests"}
            for name, leg in legs.items()
        }

    shown = {k: v for k, v in art.items()
             if k not in ("legs", "prefix", "chunked")}
    shown["legs"] = _strip(art["legs"])
    if "prefix" in art:
        shown["prefix"] = (
            {k: v for k, v in art["prefix"].items() if k != "legs"}
            | {"legs": _strip(art["prefix"]["legs"])}
        )
    if "chunked" in art:
        shown["chunked"] = (
            {k: v for k, v in art["chunked"].items() if k != "legs"}
            | {"legs": _strip(art["chunked"]["legs"])}
        )
    print(json.dumps(shown, indent=1, sort_keys=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(art, f, indent=1, sort_keys=True)
    failures = gate_failures(art)
    for f_ in failures:
        print(f"SERVE GATE FAIL: {f_}", file=sys.stderr)
    if failures:
        return 1
    slo = art["legs"]["slo_preempt"]
    fifo = art["legs"]["fifo_admit_all"]
    print(
        f"SERVE GATES PASS: {slo['goodput_tok_s']:.0f} tok/s goodput "
        f"(slo+preempt) vs {fifo['goodput_tok_s']:.0f} (fifo admit-all) "
        f"at {art['scenario']['rate_rps']:.0f} req/s offered, "
        f"{slo['preemptions']} preemptions, {slo['shed']} shed, "
        "0 pages leaked, deterministic",
        file=sys.stderr,
    )
    if "prefix" in art:
        px = art["prefix"]
        sh = px["legs"]["shared"]
        un = px["legs"]["unshared"]
        print(
            f"PREFIX GATES PASS: {sh['goodput_tok_s']:.0f} tok/s / "
            f"{sh['ttft_p99_ms']:.0f} ms ttft p99 (sharing) vs "
            f"{un['goodput_tok_s']:.0f} tok/s / {un['ttft_p99_ms']:.0f} ms "
            f"(disabled), {px['accounting']['shared']['shared_page_hits']} "
            f"pages aliased, {px['cow_splits']} cow splits, page pass "
            "clean, 0 pages leaked, deterministic",
            file=sys.stderr,
        )
    if "chunked" in art:
        ck = art["chunked"]
        cl = ck["legs"]["chunked"]
        wl = ck["legs"]["whole"]
        print(
            f"CHUNKED GATES PASS: tpot p99 {cl['tpot_p99_ms']:.0f} ms "
            f"(chunked) vs {wl['tpot_p99_ms']:.0f} ms (whole), ttft p99 "
            f"{cl['ttft_p99_ms']:.0f} vs {wl['ttft_p99_ms']:.0f} ms, "
            f"{ck['chunk_admitted']} prompts chunked, bitwise token "
            "parity, 0 pages leaked, deterministic",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
