"""The port's fleet tier (``serve/registry.py``, ``serve/router.py``,
``obs/fleet.py`` and the serve bench's ``--fleet`` leg) against the JAX
package's, on the CPU.

* the port's ``measure_fleet(seed=7)`` over three port engines
  reproduces all eight banked ``fleet.*`` values of ``FLEET_r20.json``
  and its ``fleet_health`` history exactly, passes every fleet gate and
  validates;
* a small chaos run (a leaking replica, score routing, the HLT001
  battery) drains, migrates and restarts as the JAX router does over a
  JAX engine built from the same numpy weights: equal reports, history,
  digests and rows; each migrated request's tokens equal an
  uninterrupted run's, bit for bit;
* a two-replica round-robin registry run equals the JAX one;
* snapshot merging, replica restart and the engine's drain guard behave
  as the JAX package's.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_llm_scheduler_tpu as J
from distributed_llm_scheduler_tpu import obs as JO
from distributed_llm_scheduler_tpu.backends.device import (
    DeviceBackend as JaxBackend,
)
from distributed_llm_scheduler_tpu.frontend.decode_dag import (
    build_paged_decode_dag as jax_decode_build,
)
from distributed_llm_scheduler_tpu.models import gpt2 as jgpt2
from distributed_llm_scheduler_tpu.models.kv_pages import PagePool as JPool
from distributed_llm_scheduler_tpu.obs.slo import SLOPolicy as JPolicy
from distributed_llm_scheduler_tpu.serve import frontend as JF
from distributed_llm_scheduler_tpu.serve import loadgen as JL
from distributed_llm_scheduler_tpu.serve import registry as JR
from distributed_llm_scheduler_tpu.serve import router as JRT
from distributed_llm_scheduler_tpu.serve import soak as JS
from distributed_llm_scheduler_tpu_torch import obs as TO
from distributed_llm_scheduler_tpu_torch.eval import serve_bench as SB
from distributed_llm_scheduler_tpu_torch.models import gpt2 as tgpt2
from distributed_llm_scheduler_tpu_torch.obs.slo import SLOPolicy
from distributed_llm_scheduler_tpu_torch.serve import frontend as TF
from distributed_llm_scheduler_tpu_torch.serve import loadgen as TL
from distributed_llm_scheduler_tpu_torch.serve import registry as TR
from distributed_llm_scheduler_tpu_torch.serve import router as TRT
from distributed_llm_scheduler_tpu_torch.serve import soak as TS

BANKED = json.loads(
    (Path(__file__).resolve().parents[1] / "FLEET_r20.json").read_text())
SC = SB.SCENARIO
GEOM = {k: SC[k] for k in ("slots", "page_size", "n_pages", "pages_per_seq",
                           "seg_steps")}
RIDS = ("n0", "n1", "n2")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: its tensors are tiny, and the
    test run's workers share the host's cores, where many threads per
    worker spin more than they compute."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# the JAX fleet tests' chaos scenario: long decode budgets keep requests
# in flight when the leaky replica breaches, so the drain migrates
CHAOS = dict(seed=7, n_requests=48, rate_rps=30.0, prompt_lens=(8,),
             max_new_tokens=(16, 24), warmup_s=0.1, sample_every_s=0.02,
             probation_s=0.3, deadline_s=10.0)


@pytest.fixture(scope="module")
def port_engines():
    return {rid: SB.build_serve_engine(**GEOM, clock=TF.VirtualClock(),
                                       device="cpu")[0] for rid in RIDS}


@pytest.fixture(scope="module")
def jax_engines():
    """JAX engines of the bench's geometry from the port's numpy
    weights, so tokens (and so digests) match the port's."""
    np_w = tgpt2.init_params_numpy(tgpt2.GPT2Config.tiny(), 0)
    g = {k: GEOM[k] for k in ("slots", "page_size", "n_pages",
                              "pages_per_seq")}
    jd = jax_decode_build(jgpt2.GPT2Config.tiny(), **g)
    jc = J.Cluster.from_jax_devices(jax.devices()[:1])
    sched = J.get_scheduler("greedy").schedule(jd.graph, jc)
    w = {k: jnp.asarray(v) for k, v in np_w.items()}
    return {rid: JaxBackend(jc).paged_decode_engine(
        jd.graph, sched, jd.config, w,
        JPool(n_pages=g["n_pages"], page_size=g["page_size"]),
        slots=g["slots"], pages_per_seq=g["pages_per_seq"],
        seg_steps=GEOM["seg_steps"], clock=JF.VirtualClock())
        for rid in RIDS}


def _factory(engines):
    def factory(rid, *, clock=None, metrics=None):
        eng = engines[rid]
        eng.rebind_obs(clock=clock, metrics=metrics)
        return eng
    return factory


@pytest.fixture(scope="module")
def fleet_art(port_engines):
    return SB.measure_fleet(seed=7, engines=port_engines, device="cpu")


def test_banked_fleet_values_reproduced(fleet_art):
    keys = sorted(k for k in BANKED if k.startswith("fleet."))
    assert len(keys) == 8
    assert {k: fleet_art[k] for k in keys} == {k: BANKED[k] for k in keys}
    assert fleet_art["fleet.goodput_tok_s"] == 335.52068473609194
    assert fleet_art["fleet.goodput_gain_vs_rr"] == 3.5243769405052414
    assert fleet_art["fleet_health"] == BANKED["fleet_health"]
    assert fleet_art["offered_load"] == BANKED["offered_load"]
    assert SB.fleet_gate_failures(fleet_art) == []
    assert SB.validate_fleet_artifact(fleet_art) == []
    assert SB.validate_fleet_artifact({"schema": "x"})


def _chaos(R, RT, L, F, Policy, soak, O, engines):
    arrivals = L.poisson_arrivals(
        CHAOS["rate_rps"], CHAOS["n_requests"], CHAOS["seed"],
        prompt_lens=CHAOS["prompt_lens"],
        max_new_tokens=CHAOS["max_new_tokens"],
        priorities=SC["priorities"], priority_weights=SC["priority_weights"])
    reg = R.EngineRegistry(_factory(engines))
    for rid in RIDS:
        reg.add(rid)
    soak.inject_page_leak(reg.get("n0").engine, every=1)
    fleet = RT.FleetFrontend(
        reg, arrivals,
        Policy(ttft_s=SC["ttft_s"], window_s=SC["window_s"],
               percentile=SC["percentile"]),
        admission="slo", preemption=True,
        time_model=F.ServiceTimeModel(wave_s=SC["wave_s"],
                                      segment_s=SC["segment_s"],
                                      idle_s=SC["idle_s"]),
        routing="score", detectors=O.fleet_detectors(),
        warmup_s=CHAOS["warmup_s"], sample_every_s=CHAOS["sample_every_s"],
        probation_s=CHAOS["probation_s"])
    report = fleet.run(deadline=CHAOS["deadline_s"])
    return dict(arrivals=arrivals, fleet=fleet, report=report,
                history=list(fleet.history), digest=fleet.digest(),
                lint=fleet.lint(),
                results={k: np.asarray(v) for k, v in fleet.results.items()})


@pytest.fixture(scope="module")
def chaos(port_engines, jax_engines):
    j = _chaos(JR, JRT, JL, JF, JPolicy, JS, JO, jax_engines)
    t = _chaos(TR, TRT, TL, TF, SLOPolicy, TS, TO, port_engines)
    return j, t


def test_chaos_run_equals_jax(chaos):
    j, t = chaos
    assert t["digest"] == j["digest"]
    assert t["history"] == j["history"]
    assert t["report"] == j["report"]
    rep = t["report"]
    assert rep["drains"] == 1 and rep["restarts"] == 1
    order = [e["event"] for e in t["history"] if e["replica"] == "n0"
             and e["event"] in ("breach", "drain", "restart", "readmit")]
    assert order == ["breach", "drain", "restart", "readmit"]
    assert rep["pages_leaked"] == 0 and t["lint"].errors == []
    health = rep["fleet_health"]
    assert TO.validate_fleet_health(health) == []
    rt = TO.FleetHealthReport.from_json(health)
    assert rt.to_json() == health and not rt.exceeds()
    assert not TO.report_from_fleet_artifact({"fleet_health": health}).exceeds()


def test_chaos_migration_bitwise_token_parity(chaos, port_engines):
    _, t = chaos
    rows = t["report"]["requests"]
    done = [r for r in rows if r.get("migrations") and r["state"] == "retired"]
    assert done, "the chaos scenario must migrate and finish a request"
    by_rid = {a.rid: a for a in t["arrivals"]}
    eng = port_engines["n2"]
    eng.rebind_obs(clock=TF.VirtualClock())
    vocab = int(eng.config.vocab_size)
    for r in done:
        a = by_rid[r["rid"]]
        eng.submit(a.rid, TL.prompt_token_ids(a.rid, a.prompt_len, vocab, 0),
                   a.max_new_tokens)
        while a.rid not in eng.results:
            eng.step_segment()
        np.testing.assert_array_equal(
            t["results"][r["rid"]], np.asarray(eng.results[a.rid], np.int32))
    with pytest.raises(TRT.DuplicateRidError):
        t["fleet"].submit(TL.Arrival(rid=done[0]["rid"], t=99.0,
                                     prompt_len=8, max_new_tokens=4))


def _round_robin(R, RT, L, F, Policy, engines):
    arrivals = L.poisson_arrivals(
        SC["rate_rps"], 16, 7, prompt_lens=SC["prompt_lens"],
        max_new_tokens=SC["max_new_tokens"], priorities=SC["priorities"],
        priority_weights=SC["priority_weights"])
    reg = R.EngineRegistry(_factory(engines))
    for rid in RIDS[:2]:
        reg.add(rid)
    fleet = RT.FleetFrontend(
        reg, arrivals,
        Policy(ttft_s=SC["ttft_s"], window_s=SC["window_s"],
               percentile=SC["percentile"]),
        admission="slo", preemption=True,
        time_model=F.ServiceTimeModel(wave_s=SC["wave_s"],
                                      segment_s=SC["segment_s"],
                                      idle_s=SC["idle_s"]),
        routing="round_robin")
    report = fleet.run()
    return report, fleet.digest(), reg.merged_metrics()


def test_round_robin_registry_run_equals_jax(port_engines, jax_engines):
    jrep, jdig, jm = _round_robin(JR, JRT, JL, JF, JPolicy, jax_engines)
    trep, tdig, tm = _round_robin(TR, TRT, TL, TF, SLOPolicy, port_engines)
    assert tdig == jdig and trep == jrep
    # the port's engine also times each prefill wave's host wall
    # (``decode.prefill_s``, a histogram the JAX engine does not keep)
    extra = {k for k in tm["histograms"] if k.endswith(".decode.prefill_s")}
    assert extra == {"n0.decode.prefill_s", "n1.decode.prefill_s"}
    tm = dict(tm, histograms={k: v for k, v in tm["histograms"].items()
                              if k not in extra})
    assert tm == jm and tm["replicas"] == ["n0", "n1"]


def test_registry_restart_and_merge(port_engines):
    reg = TR.EngineRegistry(_factory(port_engines))
    for rid in RIDS[:2]:
        reg.add(rid)
    with pytest.raises(ValueError, match="duplicate replica id"):
        reg.add("n0")
    with pytest.raises(KeyError):
        reg.get("n9")
    h = reg.get("n0")
    h.metrics.counter("decode.tokens_delivered")
    snap = h.metrics.snapshot()
    assert "n0.decode.tokens_delivered" in snap["counters"]
    assert snap["replica"] == "n0" and h.engine.metrics is h.metrics
    old = (h.metrics, h.store)
    h.clock.advance(3.0)
    h.engine.begin_drain()
    reg.restart("n0")
    assert h.restarts == 1 and h.epoch_t0 == pytest.approx(3.0)
    assert h.metrics is not old[0] and h.store is not old[1]
    assert not h.engine.draining
    a = TO.MetricsRegistry(prefix="n0.", replica="n0")
    b = TO.MetricsRegistry(prefix="n0.", replica="n1")
    a.counter("x").inc()
    b.counter("x").inc()
    with pytest.raises(ValueError, match="n0"):
        TO.merge_snapshots([a.snapshot(), b.snapshot()])
    with pytest.raises(ValueError):
        TO.merge_snapshots([TO.MetricsRegistry().snapshot()])


def test_engine_drain_guard(port_engines):
    eng = port_engines["n1"]
    eng.rebind_obs(clock=TF.VirtualClock())
    vocab = int(eng.config.vocab_size)
    eng.begin_drain()
    assert eng.draining and eng.summary()["draining"] is True
    with pytest.raises(RuntimeError, match="draining"):
        eng.submit("rX", TL.prompt_token_ids("rX", 8, vocab, 0), 4)
    eng.end_drain()
    eng.submit("rX", TL.prompt_token_ids("rX", 8, vocab, 0), 4)
    while "rX" not in eng.results:
        eng.step_segment()
    assert len(eng.results["rX"]) == 4
