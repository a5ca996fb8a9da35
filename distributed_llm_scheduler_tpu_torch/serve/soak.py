"""Soak harness: duration-bounded serving under sustained load, with
health sampling and leak/degradation gating.

The serve bench answers "which policy wins at this offered load"; a
soak answers the operator's question — *does the engine stay healthy
over sustained traffic?*  This module runs the
:class:`~.frontend.ServingFrontend` against a seeded Poisson schedule
for ``--duration`` seconds (virtual by default, wall-clock with
``real_clock=True``), samples the engine's health surfaces every
``--sample-every`` seconds into a bounded
:class:`~..obs.timeseries.TimeSeriesStore`, and gates the run with the
:class:`~..obs.health.HealthMonitor` detector battery (HLT001–HLT006),
excluding the ``--warmup`` prefix where pool fill and compile-class
growth are expected.  A mid-soak breach triggers the flight recorder,
so the anomaly's events are dumped while they are still in the ring.

The virtual-time leg is fully deterministic: sampling only READS
(occupancy dicts, counter values, completed-row percentiles), never
advances the clock or touches engine state, so an instrumented soak is
bit-identical in served tokens to an un-instrumented same-seed run —
the property ``tests/test_soak.py`` asserts by digest.

The artifact is ``dls.soak/1``: config + clock mode, the embedded
timeseries snapshot (re-gateable offline via ``doctor --soak``), the
serving summary, steady-state goodput, per-detector slopes, and the
verdict.  The regression-gated metrics are flattened at top level:
``soak.goodput_tok_s`` (higher-better) and the ``soak.*_slope_*``
family (lower-better, clamped at 0.0 so the deterministic healthy leg
regresses on ANY positive slope at 0.0 tolerance).

Two test-only fault injectors live here because the detectors need
golden true-positive coverage without a real leak: :func:`
inject_page_leak` swaps the engine's pool for a delegating wrapper
that withholds one page from every N-th ``free`` (occupancy creeps —
HLT001), and :func:`inject_jit_churn` wraps ``step_segment`` to plant
a fresh synthetic compile-class key per segment (cache grows without
building anything — HLT003).

The PyTorch port's copy of ``distributed_llm_scheduler_tpu.serve.soak``: framework-free,
so the port keeps it without importing the JAX package.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional

SCHEMA = "dls.soak/1"

#: detector name -> flattened regress metric (lower-better, 0-clamped)
SLOPE_METRICS = {
    "page_leak": "soak.page_leak_slope_pages_s",
    "hbm_growth": "soak.hbm_slope_bytes_s",
    "jit_cache_growth": "soak.jit_cache_slope_entries_s",
    "ttft_degradation": "soak.ttft_p95_slope_s_per_s",
    "queue_wait_degradation": "soak.queue_wait_p95_slope_s_per_s",
    "throughput_decay": "soak.throughput_decay_tok_s2",
}


@dataclass(frozen=True)
class SoakConfig:
    """One soak's knobs.  The engine geometry is the serve bench's
    tuned tiny-GPT2 scenario; the default load (12 req/s against ~26
    req/s of virtual service capacity) is comfortably STEADY — the
    healthy leg must not breach, so overload-induced degradation is
    opt-in via ``rate_rps``."""

    duration_s: float = 4.0
    sample_every_s: float = 0.1
    warmup_s: float = 1.0
    rate_rps: float = 12.0
    seed: int = 7
    admission: str = "slo"
    ttft_s: float = 0.3
    window_s: float = 0.2
    percentile: str = "p95"
    capacity: int = 512
    real_clock: bool = False
    #: paged attention impl baked into the engine's DAG (None = op auto)
    attention_impl: Optional[str] = None
    #: chunked-prefill chunk size (None = whole-prompt admission); the
    #: soak arrival mix is short prompts, so this mostly exercises the
    #: chunk scheduler's steady-state accounting under sustained load
    chunk_tokens: Optional[int] = None

    def validate(self) -> None:
        """Raises ``ValueError`` on a malformed config (CLI exit 2)."""
        if self.duration_s <= 0:
            raise ValueError(f"duration_s must be > 0, got {self.duration_s}")
        if self.sample_every_s <= 0:
            raise ValueError(
                f"sample_every_s must be > 0, got {self.sample_every_s}"
            )
        if not 0 <= self.warmup_s < self.duration_s:
            raise ValueError(
                f"warmup_s must be in [0, duration_s={self.duration_s:g}), "
                f"got {self.warmup_s}"
            )
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")
        if self.admission not in ("fifo", "slo"):
            raise ValueError(
                f"admission must be 'fifo' or 'slo', got {self.admission!r}"
            )
        if self.capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {self.capacity}")
        if self.attention_impl is not None:
            from ..ops.attention import PAGED_IMPLS

            if self.attention_impl not in PAGED_IMPLS:
                raise ValueError(
                    f"attention_impl must be one of {PAGED_IMPLS}, got "
                    f"{self.attention_impl!r}"
                )
        if self.chunk_tokens is not None and self.chunk_tokens < 1:
            raise ValueError(
                f"chunk_tokens must be >= 1, got {self.chunk_tokens}"
            )


# -- test-only fault injectors ---------------------------------------------
class _LeakyPool:
    """Delegating pool wrapper that withholds one page from every
    ``every``-th ``free`` — the withheld pages stay allocated forever,
    so ``used_pages`` creeps exactly the way a real retire-path leak
    would present."""

    def __init__(self, pool: Any, every: int):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self._inner = pool
        self._every = int(every)
        self._frees = 0
        self.withheld: List[int] = []

    def free(self, pages: Any) -> None:
        self._frees += 1
        pages = list(pages)
        if pages and self._frees % self._every == 0:
            self.withheld.append(pages.pop())
        self._inner.free(pages)

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)


def inject_page_leak(engine: Any, every: int = 2) -> Any:
    """Swap the engine's pool for a :class:`_LeakyPool` (the engine
    reads ``self.pool`` at runtime, so the swap takes effect
    immediately); returns the wrapper for inspection."""
    leaky = _LeakyPool(engine.pool, every)
    engine.pool = leaky
    return leaky


class _UnderflowPool:
    """Delegating pool wrapper that loses the reference taken by the
    first ``share`` — the classic refcount-underflow bug: the alias is
    handed out but never counted, so the LAST release frees a page
    other requests still read.  A buggy pool would also swallow the
    resulting release-of-freed-page errors, so the wrapper does too,
    page by page (otherwise the run crashes instead of being
    convicted)."""

    def __init__(self, pool: Any):
        self._inner = pool
        self.dropped: List[int] = []

    def share(self, pages: Any) -> None:
        pages = list(pages)
        self._inner.share(pages)
        if pages and not self.dropped:
            p = int(pages[0])
            self._inner._refs[p] -= 1
            self.dropped.append(p)

    def release_ref(self, pages: Any) -> None:
        for p in pages:
            try:
                self._inner.release_ref([p])
            except ValueError:
                pass

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)


def inject_refcount_underflow(engine: Any) -> Any:
    """Swap the engine's pool for an :class:`_UnderflowPool`; returns
    the wrapper for inspection.  The page-lifetime prover convicts the
    bug statically: carried refcount witnesses disagree with the
    replayed counts and the premature free lands on a page with live
    references — PGL006 (plus PGL003 for the still-live owner)."""
    pool = _UnderflowPool(engine.pool)
    engine.pool = pool
    return pool


def inject_jit_churn(engine: Any) -> None:
    """Plant one fresh synthetic compile-class key per segment: the
    prefill cache grows exactly as if every wave hit a new (P, b)
    compile class, without building anything.  Only ``len()`` of
    the cache is observed, so the None entries are inert."""
    orig = engine.step_segment
    n = [0]

    def step_segment() -> int:
        n[0] += 1
        engine._prefill_cache[("churn", n[0])] = None
        return orig()

    engine.step_segment = step_segment


# -- the soak run ----------------------------------------------------------
def run_soak(
    config: Optional[SoakConfig] = None,
    *,
    flight_dir: Optional[str] = None,
    instrument: bool = True,
    inject_leak_every: Optional[int] = None,
    inject_churn: bool = False,
    engine_factory: Optional[Any] = None,
    device: Any = "cuda",
) -> Dict[str, Any]:
    """Run one duration-bounded soak; returns the ``dls.soak/1`` dict.

    ``instrument=False`` runs the identical serving schedule with no
    sampler, flight recorder, or health evaluation — the bare leg of
    the bit-identity gate.  The injectors are test/CI-only and recorded
    in the artifact's ``injection`` block.

    ``engine_factory`` (test seam) supplies the engine instead of
    building one: called as ``engine_factory(clock=..., flight=...,
    attention_impl=...)`` and expected to hand back an engine already
    rebound to those surfaces (``PagedDecodeEngine.rebind_obs``) — how
    the test suite shares one compiled engine across every soak leg.
    ``device`` is where an engine built here runs (the card unless told
    otherwise).
    """
    from ..obs import FlightRecorder, HealthMonitor, SoakSampler, \
        TimeSeriesStore
    from ..obs.slo import SLOPolicy
    from .frontend import ServiceTimeModel, ServingFrontend, VirtualClock
    from .loadgen import poisson_arrivals, schedule_digest

    cfg = config or SoakConfig()
    cfg.validate()

    clock = None if cfg.real_clock else VirtualClock()
    flight = (
        FlightRecorder(clock=clock) if instrument and flight_dir else None
    )
    from ..eval.serve_bench import SCENARIO, build_serve_engine

    if engine_factory is not None:
        eng = engine_factory(
            clock=clock, flight=flight, attention_impl=cfg.attention_impl
        )
        eng.chunk_tokens = cfg.chunk_tokens
    else:
        eng, _pool = build_serve_engine(
            slots=SCENARIO["slots"], page_size=SCENARIO["page_size"],
            n_pages=SCENARIO["n_pages"],
            pages_per_seq=SCENARIO["pages_per_seq"],
            seg_steps=SCENARIO["seg_steps"], clock=clock, flight=flight,
            attention_impl=cfg.attention_impl,
            chunk_tokens=cfg.chunk_tokens, device=device,
        )
    injection: Dict[str, Any] = {}
    if inject_leak_every is not None:
        inject_page_leak(eng, every=inject_leak_every)
        injection["page_leak_every"] = int(inject_leak_every)
    if inject_churn:
        inject_jit_churn(eng)
        injection["jit_churn"] = True

    # enough arrivals to span the whole window; the deadline sheds any
    # tail the generator overshot past the duration
    n_req = max(4, int(cfg.rate_rps * cfg.duration_s * 2) + 8)
    arrivals = poisson_arrivals(
        cfg.rate_rps, n_req, cfg.seed,
        prompt_lens=SCENARIO["prompt_lens"],
        max_new_tokens=SCENARIO["max_new_tokens"],
        priorities=SCENARIO["priorities"],
        priority_weights=SCENARIO["priority_weights"],
    )
    in_window = [a for a in arrivals if a.t < cfg.duration_s]
    arrivals = in_window if in_window else arrivals[:1]
    policy = SLOPolicy(
        ttft_s=cfg.ttft_s, window_s=cfg.window_s,
        percentile=cfg.percentile,
    )
    tm = (None if cfg.real_clock else ServiceTimeModel(
        wave_s=SCENARIO["wave_s"], segment_s=SCENARIO["segment_s"],
        idle_s=SCENARIO["idle_s"],
    ))
    fe = ServingFrontend(
        eng, arrivals, policy, admission=cfg.admission,
        time_model=tm,
    )

    monitor = HealthMonitor(warmup_s=cfg.warmup_s)
    store = TimeSeriesStore(capacity=cfg.capacity, clock=eng._clock)
    memprof = None
    if instrument:
        # record-only: kv-page alloc/free events fold onto the memory
        # timeline without touching any engine decision
        from ..obs import MemoryProfiler

        memprof = MemoryProfiler(clock=eng._clock)
        eng.memprof = memprof
    sampler = SoakSampler(store, engine=eng, metrics=eng.metrics,
                          memprof=memprof, frontend=fe)
    next_sample = [0.0]

    def on_tick(fe: Any) -> None:
        rel = fe.clock() - fe.t0
        if rel < next_sample[0] - 1e-9:
            return
        if rel > cfg.duration_s + 1e-9:
            # the post-deadline drain is not load: its falling
            # throughput and settling queues would read as decay
            return
        sampler.sample(t=rel)
        next_sample[0] = rel + cfg.sample_every_s
        # first mid-soak breach dumps the ring while the anomaly's
        # events are still in it; later samples skip (dump-once)
        if flight is not None and not flight.dumps and rel > cfg.warmup_s:
            flight.maybe_dump(flight_dir, health=monitor.evaluate(store))

    report = fe.run(
        deadline=cfg.duration_s,
        on_tick=on_tick if instrument else None,
    )
    health = monitor.evaluate(store) if instrument else None
    if (flight is not None and not flight.dumps
            and health is not None and health.exceeds()):
        flight.maybe_dump(flight_dir, health=health)

    # attribution runs over the full rows BEFORE they are stripped from
    # the serving block (the soak artifact keeps per-request rows out of
    # the summary; the bucket totals + aggressor ranking survive)
    from ..obs.interference import attribute_requests

    interference = attribute_requests(
        report["requests"], ttft_target_s=cfg.ttft_s
    ).summary(requests=False)
    serving = {k: v for k, v in report.items() if k != "requests"}
    art: Dict[str, Any] = {
        "schema": SCHEMA,
        "seed": cfg.seed,
        "config": asdict(cfg),
        "clock": "wall" if cfg.real_clock else "virtual",
        "injection": injection,
        "offered_load": {
            "rate_rps": cfg.rate_rps,
            "n_requests": len(arrivals),
            "schedule_digest": schedule_digest(arrivals),
        },
        "attention_impl": eng.summary()["attention_impl"],
        "serving": serving,
        "interference": interference,
        "digest": fe.digest(),
        "flight_dumps": list(flight.dumps) if flight else [],
    }
    if instrument:
        steady = _steady_state(store, cfg.warmup_s)
        art["timeseries"] = store.snapshot()
        art["health"] = health.to_json()
        art["steady_state"] = steady
        art["verdict"] = "breach" if health.exceeds() else "healthy"
        art["soak.goodput_tok_s"] = (
            steady["goodput_tok_s"]
            if steady["goodput_tok_s"] is not None
            else report["goodput_tok_s"]
        )
        slopes = health.slopes()
        for det, metric in SLOPE_METRICS.items():
            slope = slopes.get(det)
            if slope is None:
                art[metric] = 0.0
            elif det == "throughput_decay":
                # decay magnitude: only a FALLING rate is bad
                art[metric] = max(0.0, -slope)
            else:
                art[metric] = max(0.0, slope)
    return art


def _steady_state(store: Any, warmup_s: float) -> Dict[str, Any]:
    """Post-warmup goodput from the cumulative token series: tokens
    delivered after warmup over the time they took — the number a
    marketing-free soak summary leads with."""
    series = store._series.get("tok.delivered_total")
    if series is None:
        return {"goodput_tok_s": None, "span_s": 0.0, "tokens": 0}
    ts, vs = series.window(since_t=warmup_s)
    if len(ts) < 2 or ts[-1] <= ts[0]:
        return {"goodput_tok_s": None, "span_s": 0.0, "tokens": 0}
    span = ts[-1] - ts[0]
    tokens = vs[-1] - vs[0]
    return {
        "goodput_tok_s": tokens / span,
        "span_s": span,
        "tokens": int(tokens),
    }


# -- artifact schema -------------------------------------------------------
_TOP_REQUIRED = (
    "schema", "seed", "config", "clock", "injection", "offered_load",
    "attention_impl", "serving", "digest", "timeseries", "health",
    "steady_state", "verdict", "soak.goodput_tok_s",
)


def validate_soak_artifact(art: Any) -> List[str]:
    """Structural check of a ``dls.soak/1`` artifact; returns
    human-readable problems (empty list == valid)."""
    from ..obs.timeseries import validate_timeseries

    errs: List[str] = []
    if not isinstance(art, dict):
        return [f"artifact is {type(art).__name__}, not dict"]
    if art.get("schema") != SCHEMA:
        errs.append(f"schema is {art.get('schema')!r}, want {SCHEMA!r}")
    for f in _TOP_REQUIRED:
        if f not in art:
            errs.append(f"missing top-level field {f!r}")
    if art.get("clock") not in ("virtual", "wall"):
        errs.append(f"clock is {art.get('clock')!r}, want virtual|wall")
    if art.get("verdict") not in ("healthy", "breach"):
        errs.append(
            f"verdict is {art.get('verdict')!r}, want healthy|breach"
        )
    ts = art.get("timeseries")
    if ts is not None:
        errs.extend(validate_timeseries(ts))
    health = art.get("health")
    if health is not None:
        if not isinstance(health, dict) or "findings" not in health:
            errs.append("health block missing findings")
        else:
            for i, f in enumerate(health["findings"]):
                if not isinstance(f, dict):
                    errs.append(f"health.findings[{i}] not a dict")
                    continue
                for k in ("code", "severity", "detector", "series",
                          "slope", "threshold", "message"):
                    if k not in f:
                        errs.append(f"health.findings[{i}] missing {k!r}")
    for metric in ("soak.goodput_tok_s",) + tuple(SLOPE_METRICS.values()):
        v = art.get(metric)
        if metric in art and not isinstance(v, (int, float)):
            errs.append(f"{metric} is not numeric")
    for metric in SLOPE_METRICS.values():
        if metric not in art:
            errs.append(f"missing slope metric {metric!r}")
    return errs


def load_soak_artifact(path: str) -> Dict[str, Any]:
    """Load + validate a ``dls.soak/1`` artifact; raises ``ValueError``
    on malformed content (the CLIs map that to exit 2)."""
    with open(path) as f:
        obj = json.load(f)
    errs = validate_soak_artifact(obj)
    if errs:
        raise ValueError(
            f"malformed soak artifact {path}: " + "; ".join(errs[:5])
        )
    return obj


__all__ = [
    "SCHEMA",
    "SLOPE_METRICS",
    "SoakConfig",
    "inject_jit_churn",
    "inject_page_leak",
    "inject_refcount_underflow",
    "load_soak_artifact",
    "run_soak",
    "validate_soak_artifact",
]
