"""The port's decode bench against the JAX package's, on the CPU.

The roofline's byte counts must equal the JAX formula's (at GPT-2 small
and Llama-3 8B, bf16, each with its bandwidth given: the H100's in the
port, the v5e's in the JAX package).  Each ``measure_*`` function runs on
a tiny config on the CPU, where its times mean nothing, and must return
the JAX function's documented keys (listed here from the JAX source) plus
``device``, the name of what it ran on; its framework-free verdicts
(oracle, token agreement, exact tokens, leaked pages, parity) must hold.
No test here calls a JAX ``measure_*`` function.
"""

import jax.numpy as jnp
import pytest
import torch

from distributed_llm_scheduler_tpu.eval import decode_bench as JB
from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config as JGPT2Config
from distributed_llm_scheduler_tpu.models.llama import LlamaConfig as JLlamaConfig
from distributed_llm_scheduler_tpu_torch import GPT2Config, LlamaConfig
from distributed_llm_scheduler_tpu_torch.eval import decode_bench as DB

CPU = torch.device("cpu")
H100 = "NVIDIA H100 80GB HBM3"

# the JAX functions' documented keys (distributed_llm_scheduler_tpu/eval/
# decode_bench.py), by leg; the port adds "device" to each result
DECODE_KEYS = {"batch", "prompt_len", "new_tokens", "wall_s",
               "prefill_plus_one_s", "decode_tok_s", "ms_per_token_step"}
LOSSY_KEYS = {"token_agreement", "first_token_agreement", "weights",
              "kv_cache"}
QUANT_KEYS = {"quant_scheme", "argmax_flip_rate", "logit_rmse"}
ROOF_KEYS = {"hbm_gbps_assumed", "param_bytes", "kv_cache_bytes",
             "bytes_per_step", "step_bound_ms", "bound_tok_s"}
ATTRIBUTION_KEYS = {
    "platform", "family", "batch", "cache_len", "step_ms",
    "forward_donated_ms", "forward_undonated_ms", "cache_copy_ms", "head_ms",
    "attn_ms", "sample_ms", "loop_overhead_ms", "head_bytes",
    "head_bound_ms", "attn_bound_ms", "decode_tok_s"}
ATTRIBUTION_ROOF_KEYS = {"step_bound_ms", "bound_utilization",
                         "head_bound_utilization", "attn_bound_utilization"}
DAG_KEYS = {
    "family", "platform", "batch", "prompt_len", "new_tokens", "policy",
    "n_tasks_decode_step", "graph_classes_compiled", "oracle_ok",
    "token_agreement", "step_ms_per_task", "tok_s_per_task",
    "step_ms_segmented", "tok_s_segmented", "tok_s_end_to_end",
    "host_rtt_ms", "n_timed_steps", "looped"}
LOOPED_KEYS = {"steps_per_dispatch", "tok_s", "ms_per_token",
               "dispatch_plus_readback_ms",
               "token_agreement_vs_whole_program", "int8_weights"}
INT8_LOOP_KEYS = {"tok_s", "ms_per_token", "weight_bytes",
                  "token_agreement_vs_bf16_loop"}
PAGED_KEYS = {
    "n_requests", "slots", "page_size", "pages_per_seq", "n_pages",
    "seg_steps", "capacity", "useful_tokens", "dense_slot_steps",
    "paged_slot_steps", "segments", "pages_allocated_total", "pages_leaked",
    "dense_tok_s", "paged_tok_s", "speedup", "tokens_exact", "metrics",
    "requests", "slo"}
KERNEL_KEYS = {
    "platform", "kernel_impl", "kernel_geometry_eligible", "n_requests",
    "useful_tokens", "page_size", "pages_per_seq", "gather_tok_s",
    "kernel_tok_s", "tokens_exact", "pages_leaked_gather",
    "pages_leaked_kernel", "parity", "parity_ok", "ragged_parity",
    "ragged_parity_ok", "disclosure"}
# off the TPU the JAX kernel leg runs Pallas in interpret mode and says
# so in "cpu_interpret_parity_only"; the port's CPU run takes the plain
# version, says so in "cpu_parity_only", and names its gather leg's impl
KERNEL_JAX_ONLY = {"cpu_interpret_parity_only"}
KERNEL_PORT_ONLY = {"cpu_parity_only", "gather_impl"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: several spin against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_peak_rate_table_names_the_card():
    assert DB.PEAK_HBM_GBPS == {H100: 3350.0}


@pytest.mark.parametrize("model", ["gpt2_small", "llama3_8b"])
def test_roofline_bytes_equal_the_jax_formula(model):
    if model == "gpt2_small":
        jcfg = JGPT2Config.small(dtype=jnp.bfloat16)
        tcfg = GPT2Config.small(dtype=torch.bfloat16)
    else:
        jcfg = JLlamaConfig.llama3_8b(dtype=jnp.bfloat16)
        tcfg = LlamaConfig.llama3_8b(dtype=torch.bfloat16)
    want = JB.decode_roofline(jcfg, 8, 576, "tpu")
    got = DB.decode_roofline(tcfg, 8, 576, H100)
    for key in ("param_bytes", "kv_cache_bytes", "bytes_per_step"):
        assert got[key] == want[key], key
    assert set(got) == set(want)
    assert got["hbm_gbps_assumed"] == 3350.0
    assert got["step_bound_ms"] == pytest.approx(
        got["bytes_per_step"] / 3350e9 * 1e3, rel=1e-12)
    assert got["bound_tok_s"] == pytest.approx(8 / got["step_bound_ms"] * 1e3,
                                               rel=1e-12)


def test_roofline_is_none_off_the_known_cards():
    cfg = GPT2Config.tiny()
    assert DB.decode_roofline(cfg, 2, 16, "cpu") is None
    assert DB.decode_roofline(cfg, 2, 16, "NVIDIA A100-SXM4-80GB") is None


@pytest.mark.parametrize("leg", ["dense", "int8", "kv_int8"])
def test_measure_decode_keys(leg):
    res = DB.measure_decode(
        LlamaConfig.tiny() if leg == "int8" else GPT2Config.tiny(),
        batch=2, prompt_len=8, new_tokens=3, reps=1, device=CPU,
        quantize=leg == "int8", kv_int8=leg != "dense")
    want = DECODE_KEYS | {"device"}
    if leg != "dense":
        want |= LOSSY_KEYS
    if leg == "int8":
        want |= QUANT_KEYS
    assert set(res) == want
    assert res["device"] == "cpu"
    if leg != "dense":
        assert 0.0 <= res["token_agreement"] <= 1.0
        assert res["kv_cache"] == "int8"


def test_measure_decode_roofline_counts_the_int8_bytes(monkeypatch):
    """With the card's name (stubbed: the CPU has no roofline), the
    roofline keys appear and an int8 cache counts one byte per value plus
    a 4-byte scale per row."""
    monkeypatch.setattr(DB, "_device_kind", lambda device: H100)
    cfg = GPT2Config.tiny()
    dense = DB.measure_decode(cfg, batch=2, prompt_len=8, new_tokens=3,
                              reps=1, device=CPU)
    q8 = DB.measure_decode(cfg, batch=2, prompt_len=8, new_tokens=3, reps=1,
                           device=CPU, kv_int8=True)
    assert set(dense) == DECODE_KEYS | ROOF_KEYS | {"bound_utilization",
                                                   "device"}
    elems = dense["kv_cache_bytes"] / 4
    assert q8["kv_cache_bytes"] == elems + elems / cfg.head_dim * 4
    assert q8["param_bytes"] == dense["param_bytes"]


@pytest.mark.parametrize("card", [False, True])
def test_decode_attribution_keys(monkeypatch, card):
    """On the CPU the bounds are None; with the card's name (stubbed) the
    roofline's keys join them."""
    if card:
        monkeypatch.setattr(DB, "_device_kind", lambda device: H100)
    res = DB.decode_attribution(GPT2Config.tiny(), batch=2, prompt_len=8,
                                new_tokens=3, reps=1, device=CPU)
    want = ATTRIBUTION_KEYS | {"device"}
    assert set(res) == (want | ATTRIBUTION_ROOF_KEYS if card else want)
    assert (res["head_bound_ms"] is None) is (not card)


def test_measure_decode_dag_keys_and_oracle():
    res = DB.measure_decode_dag(GPT2Config.tiny(), batch=2, prompt_len=16,
                                new_tokens=4, reps=2, device=CPU)
    assert set(res) == DAG_KEYS | {"device"}
    assert set(res["looped"]) == LOOPED_KEYS
    assert set(res["looped"]["int8_weights"]) == INT8_LOOP_KEYS
    assert res["oracle_ok"] is True
    assert res["token_agreement"] == 1.0  # f32 tiny: no argmax near-ties
    assert res["graph_classes_compiled"] == 2  # prefill + one step class
    assert res["n_timed_steps"] == 2
    assert res["looped"]["token_agreement_vs_whole_program"] == 1.0
    assert 0.0 <= res["looped"]["int8_weights"][
        "token_agreement_vs_bf16_loop"] <= 1.0


def test_measure_paged_decode_keys_and_tokens():
    res = DB.measure_paged_decode(device=CPU, reps=1)
    assert set(res) == PAGED_KEYS | {"device"}
    assert res["tokens_exact"] is True
    assert res["pages_leaked"] == 0


def test_measure_paged_kernel_keys_and_parity():
    res = DB.measure_paged_kernel(device=CPU, reps=1)
    jax_cpu_keys = KERNEL_KEYS | KERNEL_JAX_ONLY
    assert set(res) == (jax_cpu_keys - KERNEL_JAX_ONLY) | KERNEL_PORT_ONLY \
        | {"device"}
    assert res["gather_impl"] == "plain"
    assert res["tokens_exact"] and res["parity_ok"] and res["ragged_parity_ok"]
    assert res["pages_leaked_gather"] == res["pages_leaked_kernel"] == 0
    assert len(res["parity"]["fixtures"]) == 7
    assert len(res["ragged_parity"]["fixtures"]) == 5


# the JAX bench's documented keys of measure_decode_sharded
SHARDED_KEYS = {"tp", "batch", "prompt_len", "new_tokens", "wall_s",
                "tok_s_end_to_end", "platform", "functional_only"}


def test_tensor_parallel_decode_raises_naming_the_roadmap_item(monkeypatch):
    """``measure_decode_sharded`` runs (parallel/, ROADMAP.md A.11, is
    ported): on the CPU (``DLS_PLATFORM=cpu``) a world of 2 gloo ranks
    gives functional numbers with the JAX bench's keys; with the seam
    unset (the cards) it raises where the world cannot start (2 cards
    asked for, none visible), and the command line without a card exits
    2."""
    monkeypatch.setenv("DLS_PLATFORM", "cpu")
    res = DB.measure_decode_sharded(GPT2Config.tiny(), tp=2, batch=2,
                                    prompt_len=8, new_tokens=3, reps=1)
    assert SHARDED_KEYS <= set(res)
    assert res["tp"] == 2.0 and res["functional_only"] is True
    assert res["platform"] == "cpu" and res["wall_s"] > 0
    monkeypatch.delenv("DLS_PLATFORM")
    monkeypatch.delenv("DLS_FORCE_CPU", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 2 cards"):
            DB.measure_decode_sharded(tp=2)
        for argv in (["--tp", "2"], ["--tp=2"]):
            assert DB.main(argv) == 2


def test_the_command_line_needs_the_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert DB.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
