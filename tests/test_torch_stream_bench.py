"""The port's stream bench (``eval/stream_bench.py``) against the JAX
package's, on the CPU at the tiny config.

Mirrors ``tests/test_stream_bench.py``.  The port's bench measures the
link only on a card, so here a calibration is injected.  Its dict carries
every key of the JAX dict, and the framework-free fields (the model, the
budget, every streaming counter, the peaks of the ledger and the oracles'
verdicts) are equal to the JAX run's at the same config.
"""

import pytest

import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu.eval.stream_bench import (
    measure_streaming as jax_measure,
)
from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config as JaxConfig
from distributed_llm_scheduler_tpu_torch.eval.stream_bench import (
    measure_streaming,
)
from distributed_llm_scheduler_tpu_torch.utils.linkmodel import LinkCalibration

SHAPE = dict(batch=2, seq_len=32, budget_frac=0.3)
LINK = LinkCalibration("cpu", param_load_gbps=20.0, sustained_gbps=10.0)
# fields that do not depend on the framework or the clock
SAME = ("model", "n_tasks", "n_params", "total_param_gb", "budget_frac",
        "budget_gb", "param_loads", "param_load_calls", "param_load_gb",
        "param_evictions", "peak_resident_param_gb", "budget_respected",
        "oracle_ok", "segmented_oracle_ok", "segmented_peak_resident_gb",
        "segmented_n_dispatches", "segmented_load_calls",
        "quantized_oracle_ok", "quantized_param_load_gb",
        "quantized_total_param_gb", "quantized_peak_resident_gb",
        "quantized_budget_respected")


@pytest.fixture(scope="module")
def both():
    res = measure_streaming(config=P.GPT2Config.tiny(), device="cpu",
                            link=LINK, log=lambda m: None, **SHAPE)
    jres = jax_measure(config=JaxConfig.tiny(), log=lambda m: None, **SHAPE)
    return res, jres


def test_measure_streaming_tiny(both):
    res, _ = both
    assert res["oracle_ok"], res
    assert res["param_loads"] > 0
    assert res["param_evictions"] > 0
    assert res["budget_respected"], res
    assert res["capped_makespan_ms"] > 0
    assert res["total_param_gb"] > res["budget_gb"]
    assert res["param_load_calls"] <= res["param_loads"]
    assert res["param_load_gb"] > 0
    assert res["host_link_gbps"] == 20.0 and res["sustained_gbps"] == 10.0
    assert res["floor_source"] in ("sustained_probe",
                                   "achieved(probe under-read)")
    expect = res["param_load_gb"] / (res["capped_makespan_ms"] / 1e3)
    assert abs(res["achieved_gbps"] - expect) < 0.01 * max(expect, 1.0)
    assert res["bound_utilization"] > 0
    # int8: same budget, about half the bytes, its own oracle, budget held
    assert res["quantized_oracle_ok"], res
    assert res["quantized_param_load_gb"] < 0.6 * res["param_load_gb"]
    assert res["quantized_capped_makespan_ms"] > 0
    assert res["quantized_budget_respected"], res
    assert res["quantized_peak_resident_gb"] <= res["budget_gb"] * 1.03
    assert res["segmented_oracle_ok"] and res["segmented_n_dispatches"] > 1
    # the CPU reports no allocator peak, and its plain versions count no
    # kernel launch
    assert res["uncapped_peak_hbm_gb"] is None
    assert res["capped_peak_hbm_gb"] is None
    assert res["platform"] == res["device"] == "cpu"
    assert set(res["launches"]) >= {"uncapped", "fused", "capped",
                                    "segmented", "quantized",
                                    "quantized_fused"}


def test_keys_and_framework_free_fields_equal_jax(both):
    res, jres = both
    assert set(jres) <= set(res)
    assert set(res) - set(jres) == {"device", "uncapped_peak_hbm_gb",
                                    "capped_peak_hbm_gb", "launches"}
    for key in SAME:
        assert res[key] == jres[key], key


def test_the_cpu_needs_an_injected_link():
    with pytest.raises(ValueError, match="injected link"):
        measure_streaming(config=P.GPT2Config.tiny(), device="cpu",
                          log=lambda m: None, **SHAPE)
