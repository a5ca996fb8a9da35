"""The port's pretrained-weight ingestion (``frontend/pretrained.py``)
against the JAX package's.

State dicts in HF layout are synthetic: every tensor is drawn from one
numpy seed at the shapes the HF checkpoint of the config would hold
(``hf_state_dict``), saved with ``torch.save`` and loaded back, so no
weights are downloaded.  The port's parameters must equal the JAX
mapper's name for name, bit for bit in f32; every rejection must raise
the same ``ValueError`` text; ``execute --weights`` with a checkpoint of
the wrong width must exit 2 with the "shape mismatch" line and no
traceback.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from distributed_llm_scheduler_tpu.frontend import pretrained as JP
from distributed_llm_scheduler_tpu.models import gpt2 as jgpt2
from distributed_llm_scheduler_tpu.models import llama as jllama
from distributed_llm_scheduler_tpu.models import mixtral as jmixtral
from distributed_llm_scheduler_tpu_torch.frontend import pretrained as PP
from distributed_llm_scheduler_tpu_torch.models import gpt2 as pgpt2
from distributed_llm_scheduler_tpu_torch.models import llama as pllama
from distributed_llm_scheduler_tpu_torch.models import mixtral as pmixtral

FAMILIES = {
    # family: (JAX config, port config, JAX mapper, port mapper)
    "gpt2": (jgpt2.GPT2Config.tiny(), pgpt2.GPT2Config.tiny(),
             JP.gpt2_params_from_state_dict, PP.gpt2_params_from_state_dict),
    "llama": (jllama.LlamaConfig.tiny(), pllama.LlamaConfig.tiny(),
              JP.llama_params_from_state_dict,
              PP.llama_params_from_state_dict),
    "mixtral": (jmixtral.MixtralConfig.tiny(), pmixtral.MixtralConfig.tiny(),
                JP.mixtral_params_from_state_dict,
                PP.mixtral_params_from_state_dict),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: several spin against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf_names(family: str, config):
    """Our flat name -> (HF name, HF stores it transposed), for every
    parameter of ``config`` (the inverse of the JAX package's maps)."""
    from distributed_llm_scheduler_tpu_torch.models.family import module_for

    out = {}
    if family == "gpt2":
        inv_top = {v: k for k, v in JP._TOP_LEVEL.items()}
        inv_layer = {v: k for k, v in JP._PER_LAYER.items()}
        for name in module_for("gpt2").param_shapes(config):
            if name in inv_top:
                out[name] = ("transformer." + inv_top[name], False)
            else:
                idx, per = name[1:].split("_", 1)
                out[name] = (f"transformer.h.{idx}.{inv_layer[per]}", False)
        return out
    per_layer = {v[0]: (k, v[1]) for k, v in JP._LLAMA_PER_LAYER.items()}
    if family == "mixtral":
        per_layer = {k: v for k, v in per_layer.items()
                     if not v[0].startswith("mlp.")}
        per_layer["router"] = ("block_sparse_moe.gate.weight", True)
        for e in range(config.n_experts):
            pre = f"block_sparse_moe.experts.{e}."
            per_layer[f"e{e}_w_gate"] = (pre + "w1.weight", True)
            per_layer[f"e{e}_w_down"] = (pre + "w2.weight", True)
            per_layer[f"e{e}_w_up"] = (pre + "w3.weight", True)
    top = {"tok_emb": ("model.embed_tokens.weight", False),
           "final_norm_g": ("model.norm.weight", False),
           "lm_head": ("lm_head.weight", True)}
    for name in module_for(family).param_shapes(config):
        if name in top:
            out[name] = top[name]
        else:
            idx, per = name[1:].split("_", 1)
            hf, t = per_layer[per]
            out[name] = (f"model.layers.{idx}.{hf}", t)
    return out


def hf_state_dict(family: str, config, seed: int = 0, scale: float = 0.2):
    """A synthetic HF-layout state dict for ``config`` (a port config):
    N(0, scale) weights, norm gains 1 + N(0, 0.1), from one numpy seed,
    as torch tensors; GPT-2 also carries its tied ``lm_head`` and a mask
    buffer, which the mapper drops."""
    from distributed_llm_scheduler_tpu_torch.models.family import module_for

    rng = np.random.default_rng(seed)
    shapes = module_for(family).param_shapes(config)
    sd = {}
    for name, (hf, transposed) in _hf_names(family, config).items():
        shape = shapes[name][0]
        shape = tuple(reversed(shape)) if transposed else shape
        if name.endswith("_g"):
            arr = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            arr = scale * rng.standard_normal(shape)
        sd[hf] = torch.from_numpy(arr.astype(np.float32))
    if family == "gpt2":
        sd["lm_head.weight"] = sd["transformer.wte.weight"]
        P = config.n_positions
        sd["transformer.h.0.attn.bias"] = torch.tril(torch.ones(1, 1, P, P))
    return sd


def saved_weights(tmp_path, family: str, config=None, seed: int = 0) -> str:
    """``hf_state_dict`` written with ``torch.save``; returns the path."""
    config = config or FAMILIES[family][1]
    path = tmp_path / f"{family}_{seed}.pt"
    torch.save(hf_state_dict(family, config, seed), str(path))
    return str(path)


def _jax_params_numpy(jparams):
    return {k: np.asarray(v) for k, v in jparams.items()}


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """Each family's checkpoint through both mappers, from a torch.save
    file, in f32."""
    tmp = tmp_path_factory.mktemp("weights")
    out = {}
    for family, (jcfg, pcfg, jmap, pmap) in FAMILIES.items():
        sd = torch.load(saved_weights(tmp, family), map_location="cpu",
                        weights_only=True)
        out[family] = (sd, _jax_params_numpy(jmap(sd, jcfg)), pmap(sd, pcfg))
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_params_equal_the_jax_mapper(loaded, family):
    _sd, jp, pp = loaded[family]
    assert sorted(pp) == sorted(jp)
    for k in jp:
        assert isinstance(pp[k], torch.Tensor) and pp[k].device.type == "cpu"
        assert pp[k].dtype == torch.float32 and pp[k].is_contiguous()
        assert tuple(pp[k].shape) == jp[k].shape, k
        np.testing.assert_array_equal(pp[k].numpy(), jp[k], err_msg=k)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bf16_ingestion_rounds_as_the_jax_mapper(loaded, family):
    import ml_dtypes

    sd, _, _ = loaded[family]
    jcfg, pcfg, jmap, pmap = FAMILIES[family]
    jp = jmap(sd, jcfg, dtype=ml_dtypes.bfloat16)
    pp = pmap(sd, pcfg, dtype=torch.bfloat16)
    for k, v in jp.items():
        assert pp[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            pp[k].float().numpy(), np.asarray(v).astype(np.float32),
            err_msg=k)


def test_rope_interleave_equals_the_jax_permutation():
    w = np.random.default_rng(3).standard_normal((16, 32)).astype(np.float32)
    np.testing.assert_array_equal(
        PP._interleave_rope_columns(torch.from_numpy(w), 4).numpy(),
        JP._interleave_rope_columns(w, 4))


def _error(fn, *a) -> str:
    with pytest.raises(ValueError) as e:
        fn(*a)
    return str(e.value)


def _rejections(family, sd):
    """(label, state dict, JAX config, port config) cases that must raise."""
    jcfg, pcfg, _, _ = FAMILIES[family]
    first = next(iter(sd))
    cases = [
        ("missing", {k: v for k, v in sd.items() if k != first}, jcfg, pcfg),
        ("unknown", dict(sd, **{"model.bogus.weight": torch.zeros(2)}),
         jcfg, pcfg),
    ]
    width = {"gpt2": "n_embd", "llama": "d_model", "mixtral": "d_model"}[family]
    layers = {"gpt2": "n_layer", "llama": "n_layers",
              "mixtral": "n_layers"}[family]
    cases.append(("narrow", sd,
                  dataclasses.replace(jcfg, **{width: 64 if family != "mixtral"
                                               else 32}),
                  dataclasses.replace(pcfg, **{width: 64 if family != "mixtral"
                                               else 32})))
    cases.append(("shallow", sd, dataclasses.replace(jcfg, **{layers: 1}),
                  dataclasses.replace(pcfg, **{layers: 1})))
    return cases


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_rejections_raise_the_jax_messages(loaded, family):
    sd, _, _ = loaded[family]
    _, _, jmap, pmap = FAMILIES[family]
    msgs = []
    for label, case_sd, jcfg, pcfg in _rejections(family, sd):
        msg = _error(pmap, case_sd, pcfg)
        assert msg == _error(jmap, case_sd, jcfg), label
        msgs.append(msg)
    assert msgs[0].startswith("state dict is missing parameters: ")
    assert msgs[1].startswith("unrecognized state-dict entries: ")
    assert msgs[2].startswith("shape mismatch for ")
    assert "which is not a parameter of this config" in msgs[3]


def test_llama_tied_embeddings_fall_back(loaded):
    sd, _, _ = loaded["llama"]
    sd = {k: v for k, v in sd.items() if k != "lm_head.weight"}
    jcfg, pcfg, jmap, pmap = FAMILIES["llama"]
    pp, jp = pmap(sd, pcfg), jmap(sd, jcfg)
    np.testing.assert_array_equal(pp["lm_head"].numpy(), np.asarray(jp["lm_head"]))
    assert pp["lm_head"].is_contiguous()


@pytest.mark.parametrize("model,kw", [
    ("gpt2-tiny", dict(vocab_shards=2)),
    ("llama-tiny", dict(vocab_shards=2)),
])
def test_fit_params_to_dag_equals_the_jax_shards(loaded, model, kw):
    from distributed_llm_scheduler_tpu.utils.config import RunConfig as JRC
    from distributed_llm_scheduler_tpu_torch.utils.config import RunConfig

    family = model.split("-")[0]
    _sd, jp, pp = loaded[family]
    rc = dict(model=model, batch=1, seq_len=16, **kw)
    pdag, jdag = RunConfig(**rc).build_graph(), JRC(**rc).build_graph()
    pf = PP.fit_params_to_dag(pdag, pp)
    jf = JP.fit_params_to_dag(jdag, {k: v for k, v in jp.items()})
    assert sorted(pf) == sorted(jf)
    for k in jf:
        np.testing.assert_array_equal(pf[k].numpy(), np.asarray(jf[k]), err_msg=k)
    drop = ("wpe", "final_norm_g")
    with pytest.raises(ValueError) as pe:
        PP.fit_params_to_dag(pdag, {k: v for k, v in pp.items() if k not in drop})
    with pytest.raises(ValueError) as je:
        JP.fit_params_to_dag(jdag, {k: v for k, v in jp.items() if k not in drop})
    assert str(pe.value) == str(je.value)
    assert str(pe.value).startswith("params missing for DAG ")


def test_config_from_hf_helpers_match():
    from types import SimpleNamespace

    g = SimpleNamespace(vocab_size=512, n_positions=128, n_embd=128,
                        n_layer=2, n_head=4, layer_norm_epsilon=1e-5)
    assert PP.config_from_hf(g) == pgpt2.GPT2Config.tiny()
    ll = SimpleNamespace(vocab_size=512, max_position_embeddings=128,
                         hidden_size=128, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         intermediate_size=256, rope_theta=10000.0,
                         rms_norm_eps=1e-5)
    assert PP.llama_config_from_hf(ll) == pllama.LlamaConfig.tiny()
    mx = SimpleNamespace(**dict(vars(ll), hidden_size=64, intermediate_size=128,
                                num_local_experts=4, num_experts_per_tok=2))
    assert PP.mixtral_config_from_hf(mx) == pmixtral.MixtralConfig.tiny()


def test_execute_rejects_a_checkpoint_of_the_wrong_width(tmp_path, monkeypatch):
    """``execute --weights`` with a narrower checkpoint: exit 2, the
    "shape mismatch" line on stderr, no traceback, nothing executed."""
    from distributed_llm_scheduler_tpu_torch.__main__ import main

    monkeypatch.setenv("DLS_PLATFORM", "cpu")
    narrow = dataclasses.replace(pgpt2.GPT2Config.tiny(), n_embd=64)
    path = saved_weights(tmp_path, "gpt2", narrow)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["execute", "--model", "gpt2-tiny", "--weights", path,
                   "--batch", "1", "--seq-len", "16", "--num-nodes", "2"])
    assert rc == 2
    assert "shape mismatch" in err.getvalue()
    assert "Traceback" not in err.getvalue() and out.getvalue() == ""
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["execute", "--model", "gpt2-tiny", "--weights",
                   str(tmp_path / "nope.pt"), "--num-nodes", "2"])
    assert rc == 2 and "nope.pt" in err.getvalue()


def test_execute_runs_a_checkpoint(tmp_path, monkeypatch):
    """The 28 mapped GPT-2 params drive ``execute``: the placed run equals
    the fused forward of the same weights."""
    import json

    from distributed_llm_scheduler_tpu_torch.__main__ import main
    from distributed_llm_scheduler_tpu_torch.backends import device as D

    monkeypatch.setenv("DLS_PLATFORM", "cpu")
    seen = {}
    orig = D.DeviceBackend.execute

    def spy(self, graph, schedule, params, ids, **kw):
        rep = orig(self, graph, schedule, params, ids, **kw)
        seen.update(params=params, ids=ids, rep=rep)
        return rep

    monkeypatch.setattr(D.DeviceBackend, "execute", spy)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["execute", "--model", "gpt2-tiny", "--weights",
                   saved_weights(tmp_path, "gpt2"), "--batch", "1",
                   "--seq-len", "16", "--num-nodes", "2"])
    assert rc == 0, err.getvalue()
    assert "loaded 28 params" in err.getvalue()
    assert json.loads(out.getvalue())["n_devices"] == 2
    fused = pgpt2.forward(seen["params"], seen["ids"], pgpt2.GPT2Config.tiny())
    torch.testing.assert_close(seen["rep"].output, fused, rtol=2e-4, atol=2e-4)
