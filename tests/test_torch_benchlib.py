"""The port's bench library against the JAX package's.

Policy picks, spreads, FLOP counts, the modeled page peak and the
interconnect sweep carry no tensors, so they must be equal.  The output
oracle must give the same verdict on the same values: the JAX rule reads
numpy arrays on the host, the port's reads tensors on their own device.
"""

import json

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
from distributed_llm_scheduler_tpu_torch.eval import benchlib as TB
from distributed_llm_scheduler_tpu_torch.frontend.gpt2_dag import (
    build_gpt2_dag as torch_build,
)
from distributed_llm_scheduler_tpu_torch.models.gpt2 import (
    GPT2Config as TorchConfig,
)
from distributed_llm_scheduler_tpu_torch.utils.costmodel import CostModel as TCost

MAKESPANS = {
    "all_complete": {"roundrobin": (3.0, 1.0), "greedy": (2.0, 1.0),
                     "heft": (2.5, 1.0)},
    "best_incomplete": {"roundrobin": (3.0, 1.0), "greedy": (1.0, 0.9),
                        "heft": (2.5, 1.0)},
    "none_complete": {"roundrobin": (3.0, 0.5), "greedy": (1.0, 0.9)},
    "tie": {"roundrobin": (2.0, 1.0), "greedy": (2.0, 1.0), "dfs": (2.0, 1.0)},
}


@pytest.mark.parametrize("name", sorted(MAKESPANS))
def test_pick_best_equals_jax(name):
    assert TB.pick_best(MAKESPANS[name]) == JB.pick_best(MAKESPANS[name])


@pytest.mark.parametrize("samples", [[0.0631, 0.0655, 0.0649],
                                     [1.0], [3e-3, 1e-3, 2e-3, 4e-3]])
def test_spread_stats_equal_jax(samples):
    assert TB.spread_stats(samples) == JB.spread_stats(samples)


def test_best_of_is_the_minimum():
    it = iter([3.0, 1.0, 2.0])
    assert TB.best_of(3, lambda: next(it)) == 1.0


def _graphs(mb=2, vs=4):
    kw = dict(batch=4, seq_len=32, microbatches=mb, vocab_shards=vs)
    return (J.fuse_linear_chains(jax_build(JaxConfig.tiny(), **kw).graph),
            P.fuse_linear_chains(torch_build(TorchConfig.tiny(), **kw).graph))


@pytest.mark.parametrize("mb,vs", [(1, 1), (2, 4)])
def test_graph_flops_equal_jax(mb, vs):
    jg, tg = _graphs(mb, vs)
    assert TB.graph_flops(tg) == JB.graph_flops(jg) > 0


def _bf16_values(a):
    """``a`` rounded to bf16: the values a bf16 output holds."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _oracle_case(name, n=1000, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n).astype(np.float32)
    b = a.copy()
    if name == "equal":
        pass
    elif name == "shape_mismatch":
        b = b[:-1]
    elif name.startswith("outliers_"):
        k = int(name.split("_")[1])
        idx = np.argsort(np.abs(a))[:k]  # near zero: outside the band
        b[idx] += 0.25
    elif name == "systematic_3pct":
        b = a * np.float32(1.03)
    elif name == "systematic_1pct":
        b = a * np.float32(1.01)
    elif name == "noise_1e-5":
        b = a + np.float32(1e-5)
    elif name == "noise_1e-3":
        b = a + np.float32(1e-3)
    return a, b


CASES = ["equal", "shape_mismatch", "outliers_1", "outliers_2",
         "systematic_3pct", "systematic_1pct", "noise_1e-5", "noise_1e-3"]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_oracle_close_decides_as_jax(case, dtype_name):
    a, b = _oracle_case(case)
    if dtype_name == "bfloat16":
        a, b = _bf16_values(a), _bf16_values(b)
        ta, tb = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, b))
    else:
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    want = JB.oracle_close(a, b, dtype_name)
    assert TB.oracle_close(ta, tb, dtype_name) == want
    # numpy in, as the JAX rule takes it
    assert TB.oracle_close(a, b, dtype_name) == want


def test_oracle_close_covers_both_verdicts():
    verdicts = {
        (c, d): JB.oracle_close(*_oracle_case(c), d)
        for c in CASES for d in ("float32", "bfloat16")
    }
    assert verdicts["outliers_1", "bfloat16"] and not verdicts["outliers_2", "bfloat16"]
    assert not verdicts["systematic_3pct", "bfloat16"]
    assert verdicts["systematic_1pct", "bfloat16"]
    assert not verdicts["outliers_1", "float32"]


@pytest.mark.parametrize("k,want", [(2, True), (3, False)])
def test_oracle_close_allows_max_of_one_and_the_fraction(k, want):
    """At 2,000,000 elements the rule allows 2 elements outside the band:
    2 pass, 3 fail, in both packages."""
    a, b = _oracle_case(f"outliers_{k}", n=2_000_000, seed=1)
    a, b = _bf16_values(a), _bf16_values(b)
    assert JB.oracle_close(a, b, "bfloat16") is want
    assert TB.oracle_close(torch.from_numpy(a).to(torch.bfloat16),
                           torch.from_numpy(b).to(torch.bfloat16),
                           "bfloat16") is want


def test_compute_mfu_is_none_off_the_card():
    assert TB.compute_mfu(1e12, 1e-3, "cpu", "bfloat16") is None
    assert TB.compute_mfu(1e12, 1e-3, "NVIDIA A100-SXM4-80GB", "bfloat16") is None
    h100 = "NVIDIA H100 80GB HBM3"
    assert TB.compute_mfu(989e9, 1e-3, h100, "bfloat16") == pytest.approx(1.0)
    assert TB.compute_mfu(67e9, 1e-3, h100, "float32") == pytest.approx(1.0)
    assert TB.compute_mfu(0.0, 1e-3, h100, "bfloat16") is None
    assert TB.device_kind(torch.device("cpu")) == "cpu"


@pytest.mark.parametrize("slots", [1, 2, 8])
@pytest.mark.parametrize("prompt_len,max_new", [(1, 0), (8, 6), (16, 16), (100, 28)])
@pytest.mark.parametrize("page_size", [1, 8, 16])
def test_modeled_kv_pages_peak_equals_jax(slots, prompt_len, max_new, page_size):
    kw = dict(slots=slots, prompt_len=prompt_len, max_new=max_new,
              page_size=page_size)
    assert TB.modeled_kv_pages_peak(**kw) == JB.modeled_kv_pages_peak(**kw)


def test_ici_sensitivity_equals_jax():
    """The same task seconds applied to both packages' graphs, the same
    link: every placement, replayed at x0.25 and x4 the interconnect, gives
    the same dict."""
    jg, tg = _graphs()
    secs = {t.task_id: 1e-4 * (1 + i % 5) for i, t in enumerate(tg)}
    assert JCost(jg.name, "x", secs).apply(jg) == TCost(tg.name, "x", secs).apply(tg)
    jl = J.LinkModel(param_load_gbps=20.0, interconnect_gbps=300.0, latency_s=8e-6)
    tl = P.LinkModel(param_load_gbps=20.0, interconnect_gbps=300.0, latency_s=8e-6)
    jc = J.Cluster([J.DeviceState(f"core_{i}", 16.0) for i in range(8)])
    tc = P.Cluster([P.DeviceState(f"core_{i}", 16.0) for i in range(8)])
    js = {n: J.get_scheduler(n, link=jl).schedule(jg, jc) for n in P.ALL_SCHEDULERS}
    ts = {n: P.get_scheduler(n, link=tl).schedule(tg, tc) for n in P.ALL_SCHEDULERS}
    want = JB.ici_sensitivity(jg, jc, js, jl, dispatch_s=2e-6, dag_type="gpt2_tiny")
    got = TB.ici_sensitivity(tg, tc, ts, tl, dispatch_s=2e-6, dag_type="gpt2_tiny")
    assert got == want
    with pytest.raises(ValueError, match="roundrobin"):
        TB.ici_sensitivity(tg, tc, {"greedy": ts["greedy"]}, tl)


def _fields():
    return dict(
        n_policies=8, best_policy="pack", best_makespan_s=0.0123456,
        baseline_makespan_s=0.0234567, oracle_ok=True, fallback=False,
        peak_hbm_gb_measured=1.23456, peak_hbm_gb_modeled=0.5,
        peak_hbm_bytes={"core_1": 123, "core_0": 456}, kv_pages_peak=4,
        mfu_single_chip=0.012345, dispatch_overhead=5.4321,
        link_provenance="cuda:measured,interconnect=x,param_load=measured",
        fused_forward_s=0.0099, fused_scalar_s=0.0088,
        singlechip_replay_s=0.0077,
        ici_sensitivity={"x0.25": {"best_policy": "pack",
                                   "best_makespan_s": 0.012,
                                   "vs_baseline": 1.9}},
        spread={"pt_makespan": {"median_ms": 1.0, "min_ms": 0.9,
                                "max_ms": 1.1, "n": 3}},
        dispatch_overhead_ms=55.5, model_tag="gpt2s",
    )


def test_bench_result_json_equals_jax():
    """Equal fields give the JAX line's keys and values, the metric's
    platform suffix aside; the port adds the card and the node budget, and
    leaves out what is None, as the JAX line does."""
    j = JB.BenchResult(platform_suffix="", **_fields()).to_json()
    t = TB.BenchResult(platform_suffix="_cuda", device="NVIDIA H100 80GB HBM3, 700.00 W",
                       node_hbm_gb=78.5, **_fields()).to_json()
    assert t.pop("metric") == j.pop("metric") + "_cuda" == (
        "gpt2s_fwd_dag_makespan_best_of_8_policies_cuda")
    extra = {k: t.pop(k) for k in list(t) if k not in j}
    assert t == j
    assert extra == {"device": "NVIDIA H100 80GB HBM3, 700.00 W",
                     "node_hbm_gb": 78.5}
    json.dumps(t)
