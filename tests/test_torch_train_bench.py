"""The port's training-step bench against the JAX package's, on the CPU.

``eval/train_bench.measure_train_dag`` runs at test scale (GPT-2 tiny,
batch 2, seq 16) with an injected cost model and link, since it measures
only on a card.  The JAX package's ``measure_train_dag`` runs the same
scale with the same task seconds and link patched into its cost-model
and link choosers.  The replay half carries no tensor arithmetic, so
every policy's makespan and completion, the best policy, ``vs_roundrobin``
and the winner's modeled peak must be equal; the executed step runs the
kernels' plain versions here, so of the measured half only the oracle's
verdict and the line's keys are checked.
"""

import tempfile

import pytest
import torch

import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu.eval import benchlib as JB
from distributed_llm_scheduler_tpu.eval.train_bench import (
    measure_train_dag as jax_measure,
)
from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config as JaxConfig
from distributed_llm_scheduler_tpu.sched.policies import ALL_SCHEDULERS as JALL
from distributed_llm_scheduler_tpu.backends.sim import LinkModel as JLink
from distributed_llm_scheduler_tpu.utils.costmodel import CostModel as JCost
from distributed_llm_scheduler_tpu_torch.eval import train_bench as TB
from distributed_llm_scheduler_tpu_torch.frontend.train_dag import (
    build_gpt2_train_dag,
)
from distributed_llm_scheduler_tpu_torch.utils.costmodel import CostModel as TCost

SHAPE = dict(batch=2, seq_len=16)
LINK = dict(param_load_gbps=20.0, interconnect_gbps=300.0, latency_s=8e-6)
DISPATCH_S = 3e-6


def task_seconds(graph):
    """Injected per-task times: varied, so the policies disagree."""
    return {t.task_id: 1e-4 * (1 + (7 * i) % 11) for i, t in enumerate(graph)}


@pytest.fixture(scope="module")
def secs():
    return task_seconds(build_gpt2_train_dag(P.GPT2Config.tiny(), **SHAPE).graph)


@pytest.fixture(scope="module")
def port_line(secs):
    return TB.measure_train_dag(
        P.GPT2Config.tiny(), device="cpu", pressure_frac=0.5,
        cost_model=TCost("gpt2_train_2l_d128_b2_t16", "injected", secs,
                         dispatch_s=DISPATCH_S),
        link=P.LinkModel(**LINK), log=lambda m: None, **SHAPE)


@pytest.fixture(scope="module")
def jax_line(secs):
    mp = pytest.MonkeyPatch()
    mp.setattr(JB, "choose_cost_model", lambda graph, *a, **k: (
        JCost(graph.name, "x", secs, dispatch_s=DISPATCH_S), "_injected"))
    mp.setattr(JB, "choose_link",
               lambda *a, **k: (JLink(**LINK), "injected"))
    try:
        with tempfile.TemporaryDirectory() as td:
            return jax_measure(JaxConfig.tiny(), pressure_frac=0.5,
                               cache_dir=td, log=lambda m: None, **SHAPE)
    finally:
        mp.undo()


def test_policies_replay_equal_to_jax(port_line, jax_line):
    assert sorted(port_line["policies"]) == sorted(JALL)
    assert len(port_line["policies"]) == 10
    assert port_line["policies"] == jax_line["policies"]
    # the injected costs make the policies disagree, so the pick is real
    assert len({p["makespan_ms"] for p in port_line["policies"].values()}) > 1


@pytest.mark.parametrize("key", [
    "model", "n_tasks", "total_param_gb", "step_footprint_gb",
    "modeled_budget_gb_per_core", "best_policy", "best_makespan_ms",
    "vs_roundrobin", "baseline_complete", "winner_peak_hbm_gb",
    "link_provenance",
])
def test_line_value_equal_to_jax(port_line, jax_line, key):
    assert port_line[key] == jax_line[key]


def test_oracle_and_keys(port_line, jax_line):
    assert port_line["oracle_ok"] is True and jax_line["oracle_ok"] is True
    assert set(port_line) == set(jax_line) | {"device"}
    assert port_line["platform"] == port_line["device"] == "cpu"
    assert port_line["cost_provenance"] == "injected"
    assert port_line["executed_step_ms"] > 0
    assert port_line["policies"][port_line["best_policy"]]["completion"] == 1.0


def test_off_the_card_needs_injected_costs():
    with pytest.raises(ValueError, match="injected"):
        TB.measure_train_dag(P.GPT2Config.tiny(), device="cpu", **SHAPE)


def test_full_precision_f32_restores_the_setting():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with TB.full_precision_f32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_step_matches_tolerances():
    want = {"loss": torch.tensor(2.0), "params": {"w": torch.ones(4)}}
    near = {"loss": torch.tensor(2.0001), "params": {"w": torch.ones(4) + 4e-5}}
    far = {"loss": torch.tensor(2.0), "params": {"w": torch.ones(4) + 1e-3}}
    assert TB.step_matches(near, want)
    assert not TB.step_matches(far, want)
