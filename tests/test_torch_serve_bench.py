"""The port's serve bench against the JAX package's, on the CPU.

The bench's legs run on a virtual clock, so every ``serve.*`` metric is a
function of the engine's and the frontend's decisions alone: the port's
``measure_serving(seed=7)`` must reproduce every one banked in
``SERVE_r18.json`` exactly, pass every gate, and (a metric the banked file
predates) attribute each request's latency with no residual.  On a
reduced schedule of 8 requests, both frontend legs (fifo admit-all; slo
with preemption) over the port's engine must give the JAX frontend's
digests and request rows over the JAX engine, both built from the same
numpy weights.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

import distributed_llm_scheduler_tpu as J
from distributed_llm_scheduler_tpu.backends.device import DeviceBackend as JaxBackend
from distributed_llm_scheduler_tpu.eval import serve_bench as JSB
from distributed_llm_scheduler_tpu.frontend.decode_dag import (
    build_paged_decode_dag as jax_build,
)
from distributed_llm_scheduler_tpu.models import gpt2 as jgpt2
from distributed_llm_scheduler_tpu.models.kv_pages import PagePool as JPool
from distributed_llm_scheduler_tpu.obs.slo import SLOPolicy as JPolicy
from distributed_llm_scheduler_tpu.serve import frontend as JF
from distributed_llm_scheduler_tpu.serve import loadgen as JL
from distributed_llm_scheduler_tpu_torch.eval import serve_bench as SB
from distributed_llm_scheduler_tpu_torch.models import gpt2 as tgpt2
from distributed_llm_scheduler_tpu_torch.obs.slo import SLOPolicy
from distributed_llm_scheduler_tpu_torch.serve import frontend as TF
from distributed_llm_scheduler_tpu_torch.serve import loadgen as TL

BANKED = Path(__file__).resolve().parents[1] / "SERVE_r18.json"


@pytest.fixture(scope="module")
def art():
    return SB.measure_serving(seed=7, device="cpu")


def test_every_banked_serve_metric_is_reproduced(art):
    banked = json.loads(BANKED.read_text())
    keys = sorted(k for k in banked if k.startswith("serve."))
    assert len(keys) == 14
    assert {k: art[k] for k in keys} == {k: banked[k] for k in keys}
    # the same offered load and scenario as the banked run
    for block in ("offered_load", "scenario", "policy", "time_model"):
        assert art[block] == banked[block], block
    for name in ("prefix", "chunked"):
        assert art[name]["offered_load"] == banked[name]["offered_load"], name


def test_gates_pass_and_the_artifact_validates(art):
    assert SB.gate_failures(art) == []
    assert SB.validate_serve_artifact(art) == []
    assert art["deterministic"] and art["prefix"]["deterministic"]
    assert art["chunked"]["deterministic"] and art["chunked"]["token_parity"]
    assert art["serve.attribution.max_residual_s"] == 0.0
    assert art["legs"]["slo_preempt"]["preemptions"] >= 1
    assert art["prefix"]["page_pass"] == {"shared": [], "unshared": []}
    # the banked leg rows, request by request (arrival-anchored times,
    # states, preemptions; the banked file predates the rows' ``cause``)
    banked = json.loads(BANKED.read_text())
    for leg in ("fifo_admit_all", "slo_preempt"):
        rows = [{k: v for k, v in r.items() if k != "cause"}
                for r in art["legs"][leg]["requests"]]
        assert rows == banked["legs"][leg]["requests"], leg


def test_gate_failures_name_what_broke(art):
    bad = json.loads(json.dumps(art))
    bad["legs"]["slo_preempt"]["preemptions"] = 0
    bad["chunked"]["token_parity"] = False
    bad["prefix"]["accounting"]["shared"]["shared_page_hits"] = 0
    fails = SB.gate_failures(bad)
    assert any("never preempted" in f for f in fails)
    assert any("tokens differ" in f for f in fails)
    assert any("never aliased" in f for f in fails)
    assert SB.validate_serve_artifact({"schema": "x"})


REDUCED = dict(SB.SCENARIO, n_requests=8)


@pytest.fixture(scope="module")
def engines():
    """The JAX and port serve engines at the bench's geometry, from the
    port's bench weights (numpy seed 0)."""
    sc = SB.SCENARIO
    geom = {k: sc[k] for k in ("slots", "page_size", "n_pages", "pages_per_seq")}
    teng, _ = SB.build_serve_engine(**geom, seg_steps=sc["seg_steps"],
                                    clock=TF.VirtualClock(), device="cpu")
    np_w = tgpt2.init_params_numpy(tgpt2.GPT2Config.tiny(), 0)
    jd = jax_build(jgpt2.GPT2Config.tiny(), **geom)
    jc = J.Cluster.from_jax_devices(jax.devices()[:1])
    jeng = JaxBackend(jc).paged_decode_engine(
        jd.graph, J.get_scheduler("greedy").schedule(jd.graph, jc), jd.config,
        {k: jnp.asarray(v) for k, v in np_w.items()},
        JPool(n_pages=geom["n_pages"], page_size=geom["page_size"]),
        slots=geom["slots"], pages_per_seq=geom["pages_per_seq"],
        seg_steps=sc["seg_steps"], clock=JF.VirtualClock())
    return jeng, teng


@pytest.mark.parametrize("admission,preemption", [("fifo", False), ("slo", True)])
def test_frontend_legs_equal_jax(engines, admission, preemption):
    jeng, teng = engines
    sc = REDUCED
    kw = dict(prompt_lens=sc["prompt_lens"], max_new_tokens=sc["max_new_tokens"],
              priorities=sc["priorities"], priority_weights=sc["priority_weights"])
    jarr = JL.poisson_arrivals(sc["rate_rps"], sc["n_requests"], 7, **kw)
    tarr = TL.poisson_arrivals(sc["rate_rps"], sc["n_requests"], 7, **kw)
    assert TL.schedule_digest(tarr) == JL.schedule_digest(jarr)
    pol = dict(ttft_s=sc["ttft_s"], window_s=sc["window_s"],
               percentile=sc["percentile"])
    tm = dict(wave_s=sc["wave_s"], segment_s=sc["segment_s"], idle_s=sc["idle_s"])
    jleg = JSB.run_serving_leg(jarr, JPolicy(**pol), admission, preemption,
                               JF.ServiceTimeModel(**tm), sc, engine=jeng)
    tleg = SB.run_serving_leg(tarr, SLOPolicy(**pol), admission, preemption,
                              TF.ServiceTimeModel(**tm), sc, engine=teng)
    assert tleg["digest"] == jleg["digest"]
    assert tleg["requests"] == jleg["requests"]
    assert {k: v for k, v in tleg.items() if k != "requests"} == {
        k: v for k, v in jleg.items() if k != "requests"}
    assert tleg["completed"] + tleg["shed"] == 8 and tleg["pages_leaked"] == 0


def test_main_prints_the_artifact_and_passes(capsys):
    assert SB.main(["--device", "cpu", "--no-prefix", "--no-chunked"]) == 0
    out, err = capsys.readouterr()
    shown = json.loads(out)
    assert shown["schema"] == SB.SCHEMA
    assert "requests" not in shown["legs"]["slo_preempt"]
    assert shown["serve.goodput_tok_s"] == json.loads(
        BANKED.read_text())["serve.goodput_tok_s"]
    assert "SERVE GATES PASS" in err and "PREFIX" not in err


def test_engine_builds_on_the_card_by_default(monkeypatch):
    """Without ``device`` the bench's engine is built for the card: here,
    with no card, that build fails instead of landing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        SB.build_serve_engine()
