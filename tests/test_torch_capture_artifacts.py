"""The port's one-shot record capture (``eval/capture_artifacts.py``): the
JAX package's wiring cases (``tests/test_capture_artifacts.py``) on the
port's module, the fields the JAX records' schema test asks of each
record, and the card-only default.  Records go under ``tmp_path``."""

from __future__ import annotations

import json
import time

import pytest
import torch

import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu_torch.eval import capture_artifacts as ca
from distributed_llm_scheduler_tpu_torch.eval import stream_bench, train_bench
from distributed_llm_scheduler_tpu_torch.models.gpt2 import GPT2Config
from distributed_llm_scheduler_tpu_torch.utils.costmodel import CostModel
from distributed_llm_scheduler_tpu_torch.utils.linkmodel import LinkCalibration


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch, tmp_path):
    monkeypatch.setenv("DLS_PLATFORM", "cpu")
    monkeypatch.delenv("DLS_FORCE_CPU", raising=False)
    monkeypatch.delenv("DLS_TRACE", raising=False)
    monkeypatch.setattr(ca, "REPO_ROOT", str(tmp_path))


def test_capture_writes_stamped_artifacts(tmp_path, monkeypatch):
    monkeypatch.setitem(ca.LEGS, "stream", ("STREAM", lambda: {"slowdown": 2.0}))
    assert ca.main(["7", "stream"]) == 0
    data = json.loads((tmp_path / "STREAM_TORCH_r07.json").read_text())
    assert data["slowdown"] == 2.0
    assert data["round"] == 7
    assert data["platform"] == "cpu" and data["card"] == "cpu"
    assert data["capture_wall_s"] >= 0
    assert [p.name for p in tmp_path.iterdir()] == ["STREAM_TORCH_r07.json"]


def test_capture_failing_leg_degrades_to_stub(tmp_path, monkeypatch):
    def boom():
        raise RuntimeError("card lost")

    monkeypatch.setitem(ca.LEGS, "decode", ("DECODE", boom))
    monkeypatch.setitem(ca.LEGS, "stream", ("STREAM", lambda: {"slowdown": 1.0}))
    assert ca.main(["4", "decode", "stream"]) == 1
    stub = json.loads((tmp_path / "DECODE_TORCH_r04.json").read_text())
    assert "card lost" in stub["error"]
    ok = json.loads((tmp_path / "STREAM_TORCH_r04.json").read_text())
    assert ok["slowdown"] == 1.0


def test_capture_hanging_leg_times_out_to_stub(tmp_path, monkeypatch):
    def wedge():
        time.sleep(30)
        return {"never": 1}

    monkeypatch.setenv("DLS_CAPTURE_LEG_TIMEOUT", "1")
    monkeypatch.setitem(ca.LEGS, "decode", ("DECODE", wedge))
    monkeypatch.setitem(ca.LEGS, "stream", ("STREAM", lambda: {"slowdown": 1.0}))
    t0 = time.time()
    rc = ca.main(["4", "decode", "stream"])
    assert time.time() - t0 < 10  # the wedge was cut short
    assert rc == 1
    stub = json.loads((tmp_path / "DECODE_TORCH_r04.json").read_text())
    assert "exceeded" in stub["error"]
    ok = json.loads((tmp_path / "STREAM_TORCH_r04.json").read_text())
    assert ok["slowdown"] == 1.0


def test_nested_leg_timeout_rearms_outer_timer(monkeypatch):
    monkeypatch.setenv("DLS_CAPTURE_LEG_TIMEOUT", "2")

    def outer():
        inner = ca._guarded("inner", lambda: {"ok": 1})
        assert "error" not in inner
        time.sleep(30)  # outer wedge AFTER the inner leg finished
        return {"never": 1}

    t0 = time.time()
    out = ca._guarded("outer", outer)
    assert time.time() - t0 < 10
    assert "exceeded" in out["error"]


def test_capture_nested_suberror_surfaces_in_exit_code(tmp_path, monkeypatch):
    monkeypatch.setitem(ca.LEGS, "decode", (
        "DECODE", lambda: {"decode_tok_s": 1.0,
                           "attribution": {"error": "card lost"}}))
    assert ca.main(["4", "decode"]) == 1
    data = json.loads((tmp_path / "DECODE_TORCH_r04.json").read_text())
    assert data["decode_tok_s"] == 1.0  # healthy parts still recorded


def test_capture_rejects_bad_args(tmp_path):
    assert ca.main([]) == 2
    assert ca.main(["x"]) == 2
    assert ca.main(["4", "nosuchleg"]) == 2
    assert list(tmp_path.iterdir()) == []


def test_no_card_and_no_cpu_request_exits_2(tmp_path, monkeypatch, capsys):
    """Nothing falls back to the CPU: with no card visible and
    ``DLS_PLATFORM`` unset, ``main`` exits 2 with one line and writes
    nothing."""
    monkeypatch.delenv("DLS_PLATFORM")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setitem(ca.LEGS, "stream", ("STREAM", lambda: {"slowdown": 1.0}))
    assert ca.main(["4", "stream"]) == 2
    (line,) = capsys.readouterr().err.strip().splitlines()
    assert line.startswith("capture: no CUDA device visible")
    assert list(tmp_path.iterdir()) == []


def test_the_cache_is_the_port_s():
    assert ca.CACHE_DIR.endswith(".costmodel_torch")
    assert ca.LEGS.keys() == {"stream", "decode", "train"}


# -- the records' fields, at test scale -----------------------------------------

#: the keys ``tests/test_artifacts_schema.py`` asks of the JAX records
STREAM_KEYS = (
    "platform", "budget_frac", "uncapped_makespan_ms", "capped_makespan_ms",
    "slowdown", "param_loads", "param_evictions", "peak_resident_param_gb",
    "budget_respected", "oracle_ok", "bound_utilization", "achieved_gbps",
    "sustained_gbps", "floor_source", "quantized_capped_makespan_ms",
    "quantized_oracle_ok", "quantized_budget_respected",
)
TRAIN_KEYS = ("model", "platform", "oracle_ok", "policies", "executed_step_ms")
#: GPT-2 "small" narrowed for the CPU: its positions still hold the
#: rehearsal's 128-token prompts
NARROW = dict(vocab_size=256, n_positions=256, n_embd=64, n_layer=2, n_head=2)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """All three legs through ``main`` at test scale: GPT-2 "small"
    narrowed, the stream and train legs with an injected link and cost
    model (on the CPU they refuse without them)."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("records")
    try:
        mp.setenv("DLS_PLATFORM", "cpu")
        mp.setenv("DLS_CPU_WORLD", "1")
        mp.delenv("DLS_TRACE", raising=False)
        mp.setattr(ca, "REPO_ROOT", str(root))
        mp.setattr(GPT2Config, "small", classmethod(
            lambda cls, **kw: cls(**{**NARROW, **kw})))
        link = LinkCalibration("cpu", param_load_gbps=20.0, sustained_gbps=10.0)
        stream = stream_bench.measure_streaming
        mp.setattr(stream_bench, "measure_streaming", lambda **kw: stream(
            **{**kw, "batch": 2, "seq_len": 32, "link": link}))
        train = train_bench.measure_train_dag

        def tiny_train(**kw):
            from distributed_llm_scheduler_tpu_torch.frontend.train_dag import (
                build_gpt2_train_dag,
            )

            cfg = P.GPT2Config.tiny()
            graph = build_gpt2_train_dag(cfg, batch=2, seq_len=16).graph
            secs = {t.task_id: 1e-4 * (1 + i % 5) for i, t in enumerate(graph)}
            return train(**{**kw, "config": cfg, "batch": 2, "seq_len": 16,
                            "cost_model": CostModel(graph.name, "injected", secs),
                            "link": P.LinkModel(), "log": lambda m: None})

        mp.setattr(train_bench, "measure_train_dag", tiny_train)
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            rc = ca.main(["23"])
        finally:
            torch.set_num_threads(n)
        return rc, {p: json.loads((root / f"{p}_TORCH_r23.json").read_text())
                    for p in ("STREAM", "DECODE", "TRAIN")}
    finally:
        mp.undo()


def test_every_leg_captured_without_a_stub(records):
    rc, recs = records
    assert rc == 0, {p: r for p, r in recs.items() if ca._has_error(r)}
    for rec in recs.values():
        assert rec["platform"] == "cpu" and rec["card"] == "cpu"
        assert rec["round"] == 23 and rec["capture_wall_s"] >= 0


def test_stream_and_train_records_carry_the_schema_fields(records):
    _, recs = records
    for k in STREAM_KEYS:
        assert k in recs["STREAM"], k
    assert recs["STREAM"]["budget_respected"] is True
    assert recs["STREAM"]["oracle_ok"] is True
    for k in TRAIN_KEYS:
        assert k in recs["TRAIN"], k
    assert recs["TRAIN"]["oracle_ok"] is True
    for name, row in recs["TRAIN"]["policies"].items():
        assert "makespan_ms" in row and "completion" in row, name


def test_decode_record_carries_the_schema_fields(records):
    _, recs = records
    d = recs["DECODE"]
    for k in ("platform", "decode_tok_s", "ms_per_token_step"):
        assert k in d, k
    for k in ("step_ms", "head_ms", "attn_ms", "sample_ms", "loop_overhead_ms"):
        assert k in d["attribution"], k
    tg = d["task_graph"]
    for k in ("oracle_ok", "token_agreement", "step_ms_per_task",
              "graph_classes_compiled"):
        assert k in tg, k
    assert tg["oracle_ok"] is True
    assert "tok_s" in tg["looped"] and "token_agreement_vs_whole_program" in tg["looped"]
    for leg in ("quantized", "quantized_kv"):
        q = d[leg]
        assert q["weights"] == "int8"
        for k in ("decode_tok_s", "token_agreement", "first_token_agreement"):
            assert k in q, (leg, k)
    assert d["quantized_kv"]["kv_cache"] == "int8"
    assert "argmax_flip_rate" in d["quantized"] and "logit_rmse" in d["quantized"]
    for fam in ("llama", "mixtral"):
        assert d[fam]["model"].startswith(fam) and "decode_tok_s" in d[fam]
    assert "skipped" in d["tp_sharded"]
    paged = d["paged"]
    for k in ("n_requests", "slots", "page_size", "pages_per_seq", "capacity",
              "useful_tokens", "dense_tok_s", "paged_tok_s", "speedup",
              "tokens_exact", "pages_leaked"):
        assert k in paged, k
    assert paged["tokens_exact"] is True and paged["pages_leaked"] == 0
    assert d["decode.paged_tokens_exact"] is True
    assert d["decode.kernel_tokens_exact"] is True
