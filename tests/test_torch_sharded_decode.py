"""The port's tensor-parallel decoding (``parallel/decode.py`` over the
TP blocks of ``parallel/blocks.py``) against the JAX package's
``generate_sharded`` and single-device ``generate``.

One world of 4 gloo ranks runs every port case (``parallel.runs``); the
weights are each family's JAX ``init_params`` bridged as numpy, the
prompts numpy draws.  Greedy tokens must be equal: the JAX test's
contract (``tests/test_sharded_decode.py``), since partitioned sums in
f32 move logits far below argmax resolution on these models.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_llm_scheduler_tpu.models import gpt2 as jgpt2
from distributed_llm_scheduler_tpu.models import llama as jllama
from distributed_llm_scheduler_tpu.models import mixtral as jmixtral
from distributed_llm_scheduler_tpu.parallel import decode as jdecode
from distributed_llm_scheduler_tpu.parallel import mesh as jmesh
from distributed_llm_scheduler_tpu_torch.models import gpt2, llama, mixtral
from distributed_llm_scheduler_tpu_torch.parallel import launch, runs

WORLD = 4
FAMILIES = {
    "gpt2": (jgpt2, jgpt2.GPT2Config.tiny(), gpt2.GPT2Config.tiny()),
    "llama": (jllama, jllama.LlamaConfig.tiny(), llama.LlamaConfig.tiny()),
    "mixtral": (jmixtral, jmixtral.MixtralConfig.tiny(),
                mixtral.MixtralConfig.tiny()),
}
# (label, family, mesh axes, batch, new tokens, generate keywords)
CASES = [
    ("gpt2_tp2", "gpt2", dict(tp=2), 2, 5, {}),
    ("llama_tp2", "llama", dict(tp=2), 2, 5, {}),
    ("mixtral_tp2", "mixtral", dict(tp=2), 2, 5, {}),
    ("llama_tp2_kv_int8", "llama", dict(tp=2), 2, 5, dict(kv_int8=True)),
    ("gpt2_dp2_tp2", "gpt2", dict(dp=2, tp=2), 4, 3, {}),
    ("llama_tp4_refused", "llama", dict(tp=4), 2, 5, {}),  # 2 kv heads
    ("gpt2_tp3_refused", "gpt2", dict(tp=3), 2, 5, {}),    # 4 heads
]


def _ids(config, batch, T=6):
    return np.random.default_rng(1).integers(0, config.vocab_size, (batch, T),
                                             dtype=np.int32)


@pytest.fixture(scope="module")
def weights():
    return {fam: {k: np.asarray(v) for k, v in
                  jmod.init_params(jcfg, jax.random.PRNGKey(0)).items()}
            for fam, (jmod, jcfg, _) in FAMILIES.items()}


@pytest.fixture(scope="module")
def world(weights):
    legs = [("decode", dict(config=FAMILIES[fam][2], axes=axes,
                            params=weights[fam], ids=_ids(FAMILIES[fam][2], B),
                            max_new_tokens=n, **kw))
            for _, fam, axes, B, n, kw in CASES]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DLS_PLATFORM", "cpu")
        out = launch.spawn(runs.run_legs, WORLD, args=(legs,), timeout=300)
    return dict(zip((c[0] for c in CASES), out))


def _jax_tokens(weights, fam, axes, B, n, kw):
    jmod, jcfg, _ = FAMILIES[fam]
    params = {k: jnp.asarray(v) for k, v in weights[fam].items()}
    ids = jnp.asarray(_ids(jcfg, B))
    single = np.asarray(jmod.generate(params, ids, jcfg, max_new_tokens=n, **kw))
    sharded = np.asarray(jdecode.generate_sharded(
        params, ids, jcfg, jmesh.make_mesh(**axes), max_new_tokens=n, **kw))
    return single, sharded


@pytest.mark.parametrize("label", [c[0] for c in CASES[:5]])
def test_tp_generation_matches_jax(world, weights, label):
    _, fam, axes, B, n, kw = next(c for c in CASES if c[0] == label)
    single, sharded = _jax_tokens(weights, fam, axes, B, n, kw)
    got = world[label]["tokens"]
    assert got.shape == (B, 6 + n)
    assert np.array_equal(got, sharded)
    assert np.array_equal(got, single)


def test_tp_generation_matches_port_single_device(world, weights):
    """The port's own unsharded ``generate`` gives the same tokens."""
    import torch

    for label in ("gpt2_tp2", "llama_tp2", "mixtral_tp2"):
        _, fam, _, B, n, _ = next(c for c in CASES if c[0] == label)
        cfg = FAMILIES[fam][2]
        mod = {"gpt2": gpt2, "llama": llama, "mixtral": mixtral}[fam]
        params = mod.params_from_numpy(weights[fam], "cpu")
        single = mod.generate(params, torch.from_numpy(_ids(cfg, B)), cfg, n)
        assert np.array_equal(world[label]["tokens"], single.numpy()), label


def test_llama_params_actually_sharded(world):
    """Each rank holds JAX's block shapes: wq/wk/wv and lm_head column
    blocks, wo/w_down row blocks, norms and the embedding whole; its KV
    cache holds its own KV heads."""
    cfg = FAMILIES["llama"][2]
    got = world["llama_tp2"]["shard_shapes"]
    d, hd = cfg.d_model, cfg.head_dim
    assert got["l0_wq"] == (d, cfg.n_heads * hd // 2)
    assert got["l0_wk"] == (d, cfg.n_kv_heads * hd // 2)
    assert got["l0_wo"] == (cfg.n_heads * hd // 2, d)
    assert got["l0_w_down"] == (cfg.ffn_hidden // 2, d)
    assert got["lm_head"] == (d, cfg.vocab_size // 2)
    assert got["final_norm_g"] == (d,)
    assert got["tok_emb"] == (cfg.vocab_size, d)
    assert world["llama_tp2"]["kv_heads_local"] == cfg.n_kv_heads // 2


def test_mixtral_expert_ffns_shard_like_dense(world):
    cfg = FAMILIES["mixtral"][2]
    got = world["mixtral_tp2"]["shard_shapes"]
    assert got["l0_e0_w_gate"] == (cfg.d_model, cfg.ffn_hidden // 2)
    assert got["l0_e1_w_down"] == (cfg.ffn_hidden // 2, cfg.d_model)
    assert got["l0_router"] == (cfg.d_model, cfg.n_experts)


@pytest.mark.parametrize("label,fam,axes", [
    ("llama_tp4_refused", "llama", dict(tp=4)),
    ("gpt2_tp3_refused", "gpt2", dict(tp=3)),
])
def test_tp_must_divide_kv_heads(world, weights, label, fam, axes):
    """The JAX package's refusal, message for message."""
    msg = world[label]["ValueError"]
    assert "head count" in msg
    jmod, jcfg, _ = FAMILIES[fam]
    with pytest.raises(ValueError) as e:
        jdecode.shard_decode_params(jmesh.make_mesh(**axes),
                                    {k: jnp.asarray(v) for k, v in weights[fam].items()},
                                    jcfg)
    assert str(e.value) == msg
