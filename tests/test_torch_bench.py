"""The port's north-star bench, as a whole, against the JAX package.

``eval/bench.run`` runs on the CPU at the tiny f32 config with an injected
cost model and link (it measures only on a card).  Its replay half must
equal a replay driven by the JAX package's policies, ``SimulatedBackend``
and ``benchlib`` with the same task seconds and link: every policy's
makespan and completion, the best policy, ``vs_baseline``, the
interconnect sweep, the single-node replay and the winner's modeled
per-node peak.  Its measured half runs the port's kernels' plain versions
here, so only the oracle's verdict (placed output against the port's
fused forward, which ``test_torch_gpt2.py`` holds against the JAX
forward) and the line's shape are checked.
"""

import json

import jax
import numpy as np
import pytest
import torch

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu.eval import benchlib as JB
from distributed_llm_scheduler_tpu.frontend.gpt2_dag import (
    build_gpt2_dag as jax_build,
)
from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config as JaxConfig
from distributed_llm_scheduler_tpu.utils.costmodel import CostModel as JCost
from distributed_llm_scheduler_tpu_torch.eval import bench
from distributed_llm_scheduler_tpu_torch.utils.costmodel import CostModel as TCost
from distributed_llm_scheduler_tpu_torch.utils.costmodel import median_cost_model

_, _, SHAPE = bench.CONFIGS["tiny"]
LINK = dict(param_load_gbps=20.0, interconnect_gbps=300.0, latency_s=8e-6)
DISPATCH_S = 3e-6


def task_seconds(graph):
    """Injected per-task times: varied, so the policies disagree."""
    return {t.task_id: 1e-4 * (1 + (7 * i) % 11) for i, t in enumerate(graph)}


@pytest.fixture(scope="module")
def ran():
    tg = P.fuse_linear_chains(P.build_gpt2_dag(P.GPT2Config.tiny(), **SHAPE).graph)
    secs = task_seconds(tg)
    result = bench.run(
        "tiny", "cpu", dtype=torch.float32,
        cost_model=TCost(tg.name, "injected", secs, dispatch_s=DISPATCH_S),
        link=P.LinkModel(**LINK), reps=1,
    )
    return result, secs


@pytest.fixture(scope="module")
def jax_replay(ran):
    """The bench's replay, driven by the JAX package on its own graph."""
    result, secs = ran
    jdag = jax_build(JaxConfig.tiny(), **SHAPE)
    jg = J.fuse_linear_chains(jdag.graph)
    assert JCost(jg.name, "x", secs).apply(jg) == len(jg)
    gb = result.node_hbm_gb
    one = J.Cluster([J.DeviceState("core_0", gb)])
    sched_one = J.get_scheduler("greedy").schedule(jg, one)
    # what the port's pre-flight sets on the CPU: each task's output bytes
    params, ids = jdag.init_params(), jdag.make_inputs()
    specs = {}
    for tid in jg.topo_order:
        t = jg[tid]
        pd = {loc: params[glob] for loc, glob in t.param_items()}
        args = [specs[d] for d in (t.arg_tasks or t.dependencies)] or [ids]
        specs[tid] = jax.eval_shape(t.fn, pd, *args)
        t.out_bytes = int(np.prod(specs[tid].shape)) * specs[tid].dtype.itemsize

    link = J.LinkModel(**LINK)
    sim = J.SimulatedBackend(fidelity="full", link=link, dispatch_s=DISPATCH_S)
    cluster = J.Cluster([J.DeviceState(f"core_{i}", gb) for i in range(8)])
    single = sim.execute(jg, one, sched_one, dag_type="gpt2_tiny").makespan
    makespans, schedules = {}, {}
    for name in sorted(P.ALL_SCHEDULERS):
        s = J.get_scheduler(name, link=link).schedule(jg, cluster)
        r = sim.execute(jg, cluster, s, dag_type="gpt2_tiny")
        makespans[name] = (r.makespan, r.completed_tasks / r.num_tasks)
        schedules[name] = s
    best_name, best, rr = JB.pick_best(makespans)
    sens = JB.ici_sensitivity(jg, cluster, schedules, link,
                              dispatch_s=DISPATCH_S, dag_type="gpt2_tiny")
    v = J.validate_schedule(jg, cluster, schedules[best_name])
    return dict(single=single, makespans=makespans, best=(best_name, best, rr),
                sens=sens, peaks=v.peak_no_evict_gb)


def test_policies_replay_equal_to_jax(ran, jax_replay):
    result, _ = ran
    assert result.policies == jax_replay["makespans"]
    assert sorted(result.policies) == sorted(P.ALL_SCHEDULERS)
    assert len(result.policies) == result.n_policies == 8
    # the injected costs make the policies disagree, so the pick is real
    assert len({m for m, _ in result.policies.values()}) > 1


def test_best_policy_and_vs_baseline_equal_jax(ran, jax_replay):
    result, _ = ran
    name, best, rr = jax_replay["best"]
    assert (result.best_policy, result.best_makespan_s,
            result.baseline_makespan_s) == (name, best, rr)
    assert result.vs_baseline == rr / best


def test_ici_sensitivity_equals_jax(ran, jax_replay):
    result, _ = ran
    assert result.ici_sensitivity == jax_replay["sens"]
    assert sorted(result.ici_sensitivity) == ["x0.25", "x4"]


def test_single_node_replay_and_modeled_peak_equal_jax(ran, jax_replay):
    result, _ = ran
    assert result.singlechip_replay_s == jax_replay["single"]
    peaks = jax_replay["peaks"]
    assert result.peak_hbm_gb_modeled == max(peaks.values())
    assert result.peak_hbm_bytes == {
        n: int(round(gb * 1024**3)) for n, gb in sorted(peaks.items())}
    assert result.kv_pages_peak == JB.modeled_kv_pages_peak(
        slots=2, prompt_len=8, max_new=6, page_size=8)


def test_placed_output_meets_the_oracle(ran):
    result, _ = ran
    assert result.oracle_ok is True


def test_json_line(ran):
    result, secs = ran
    line = json.loads(json.dumps(result.to_json()))
    assert line["metric"] == "gpt2t_fwd_dag_makespan_best_of_8_policies_cpu"
    assert line["unit"] == "ms" and line["modeled"] is True
    assert line["fallback"] is True and line["device"] == "cpu"
    assert line["node_hbm_gb"] == bench.CPU_NODE_GB
    # not measured: the fence (CUDA events need none) and, off the card,
    # the MFUs and footprints
    for key in ("mfu_segmented", "mfu_compiled", "fence_rtt_ms",
                "mfu_single_chip", "mfu_fused", "preflight_max_gb"):
        assert key not in line, key
    for null in ("mfu_segmented", "mfu_compiled", "fence_rtt_s"):
        assert getattr(result, null) is None, null
    for key in ("fused_forward_ms", "fused_scalar_ms", "singlechip_replay_ms",
                "dispatch_overhead_ms", "value", "vs_baseline",
                "segmented_makespan_ms", "compiled_makespan_ms",
                "compiled_dispatch_overhead_ms"):
        assert line[key] > 0, key
    assert line["link"] == "injected"
    assert set(line["spread"]) == {"quotes", "pt_makespan", "fused_scalar",
                                   "fused_forward", "segmented", "compiled",
                                   "value", "calibrated_task_sum"}
    assert all(line["spread"][k]["n"] == bench.WINDOWS
               for k in ("pt_makespan", "fused_scalar", "fused_forward",
                         "segmented", "compiled"))
    # one injected calibration: one window, replaying the headline itself
    assert line["spread"]["value"] == {
        "median_ms": line["value"], "min_ms": line["value"],
        "max_ms": line["value"], "n": 1}
    assert line["calibrated_task_ms"] == round(
        sum(secs.values()) * 1e3, 4)
    assert line["spread"]["calibrated_task_sum"]["median_ms"] == (
        line["calibrated_task_ms"])
    assert "calibration_runs" not in line
    # legs counted; the plain versions on the CPU launch no kernel
    assert line["launches"] == {
        "per_task": {}, "fused": {}, "segmented_eager": {}, "segmented": {},
        "compiled_eager": {}, "compiled": {}, "preflight": {}}
    assert set(line["policies"]) == set(P.ALL_SCHEDULERS)


def test_calibration_windows_reduce_to_each_tasks_median():
    windows = [
        TCost("g", "cuda", {"a": a, "b": b}, measured_at=f"t{i}")
        for i, (a, b) in enumerate([(3.0, 1.0), (1.0, 5.0), (2.0, 4.0)])
    ]
    cm = median_cost_model(windows)
    assert cm.task_seconds == {"a": 2.0, "b": 4.0}
    assert (cm.graph_name, cm.platform, cm.dispatch_s, cm.measured_at) == (
        "g", "cuda", 0.0, "t2")


def test_off_the_card_it_needs_injected_costs():
    with pytest.raises(ValueError, match="injected cost model"):
        bench.run("tiny", "cpu", dtype=torch.float32)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run("tiny", "cuda")


def test_main_takes_only_the_bench_configs():
    with pytest.raises(SystemExit, match="usage"):
        bench.main(["tiny"])


def test_segmented_and_compiled_legs_fill_their_fields(ran):
    """The two captured legs run here eagerly (no card): each fills its
    makespan and spread, the compiled leg its host wall per run, and each
    leg's oracle joins ``oracle_ok``."""
    result, _ = ran
    assert result.segmented_makespan_s > 0
    assert result.compiled_makespan_s > 0
    assert result.compiled_dispatch_overhead_ms > 0
    assert result.spread["segmented"]["median_ms"] == round(
        result.segmented_makespan_s * 1e3, 4)
    assert result.spread["compiled"]["median_ms"] == round(
        result.compiled_makespan_s * 1e3, 4)
    assert result.oracle_ok is True
