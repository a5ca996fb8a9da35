"""The port's KV-cache decoding of every family against the JAX package's,
on the CPU.

The counterparts of ``tests/test_decode.py`` for Llama and Mixtral, and of
its int8 cache cases for all three families.  Weights come from the
port's numpy initializer (seed 0) and go to both packages; token ids from
numpy seeds.  Prefill logits and the stacked-layer forward are held at
rtol = atol = 2e-4 (the repo's placed-vs-fused tolerance), each decode
step's logits against the growing JAX forward at 5e-4 (the JAX test's),
int8 cache scales at 1e-6; greedy tokens and int8 cache values on the f32
tiny configs must be equal.  Each JAX generation runs once per family
(module-scoped fixtures): each compiles a scan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_scheduler_tpu.frontend.decode_dag import (
    cache_dims as jax_cache_dims,
)
from distributed_llm_scheduler_tpu.models import decode as jdecode
from distributed_llm_scheduler_tpu.models import gpt2 as jgpt2
from distributed_llm_scheduler_tpu.models import llama as jllama
from distributed_llm_scheduler_tpu.models import mixtral as jmixtral
from distributed_llm_scheduler_tpu.parallel.decode import _family_of
from distributed_llm_scheduler_tpu_torch.frontend.decode_dag import cache_dims
from distributed_llm_scheduler_tpu_torch.models import decode as tdecode
from distributed_llm_scheduler_tpu_torch.models import gpt2 as tgpt2
from distributed_llm_scheduler_tpu_torch.models import llama as tllama
from distributed_llm_scheduler_tpu_torch.models import mixtral as tmixtral
from distributed_llm_scheduler_tpu_torch.models.family import family_of, module_for

CPU = torch.device("cpu")
TOL = 2e-4
STEP_TOL = 5e-4
SCALE_TOL = 1e-6
FAMILIES = {
    "gpt2": (jgpt2, tgpt2, jgpt2.GPT2Config.tiny(), tgpt2.GPT2Config.tiny()),
    "llama": (jllama, tllama, jllama.LlamaConfig.tiny(),
              tllama.LlamaConfig.tiny()),
    "mixtral": (jmixtral, tmixtral, jmixtral.MixtralConfig.tiny(),
                tmixtral.MixtralConfig.tiny()),
}
BACKBONES = ["llama", "mixtral"]
B, T, NEW, M = 2, 8, 5, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: several spin against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jitted(jmod, jcfg):
    """The JAX family's forward and cached forward, jitted once each (its
    eager ops would compile one by one)."""
    fwd = jax.jit(lambda w, ids: jmod.forward(w, ids, jcfg))
    cached = jax.jit(lambda w, ids, c, pos: jmod.forward_cached(
        w, ids, c, pos, jcfg))
    return fwd, cached


@pytest.fixture(scope="module")
def families():
    """Builds, once per family: the weights and prompt in both packages,
    the jitted JAX forwards, and the JAX package's int8-cache (every
    family) and dense (the backbones) greedy generations."""
    built = {}

    def get(name):
        if name in built:
            return built[name]
        jmod, tmod, jcfg, tcfg = FAMILIES[name]
        np_w = tmod.init_params_numpy(tcfg, 0)
        jw = {k: jnp.asarray(v) for k, v in np_w.items()}
        ids = np.random.default_rng(1).integers(0, tcfg.vocab_size, (B, T),
                                                dtype=np.int32)
        out = dict(name=name, jmod=jmod, tmod=tmod, jcfg=jcfg, tcfg=tcfg,
                   jw=jw, tw=tmod.params_from_numpy(np_w, CPU), ids=ids)
        out["jfwd"], out["jcached"] = _jitted(jmod, jcfg)
        out["j_int8"] = np.asarray(jmod.generate(
            jw, jnp.asarray(ids), jcfg, max_new_tokens=NEW, kv_int8=True))
        if name in BACKBONES:
            out["j_dense"] = np.asarray(jmod.generate(
                jw, jnp.asarray(ids), jcfg, max_new_tokens=NEW))
        built[name] = out
        return out

    return get


@pytest.fixture(params=sorted(FAMILIES))
def fam(request, families):
    return families(request.param)


@pytest.fixture(params=BACKBONES)
def bb(request, families):
    """The Llama-backbone families (GPT-2's dense cached path has its own
    tests in ``test_torch_decode.py``)."""
    return families(request.param)


def test_family_resolution_and_cache_dims_equal_jax():
    for name, (_, tmod, jcfg, tcfg) in FAMILIES.items():
        assert family_of(tcfg) == _family_of(jcfg) == name
        assert module_for(name) is tmod
        assert cache_dims(tcfg) == jax_cache_dims(jcfg)
    with pytest.raises(ValueError, match="unknown model family"):
        family_of(object())


def test_prefill_logits_and_cache_match_jax(bb):
    f = bb
    jc = f["jmod"].init_cache(f["jcfg"], B, M)
    tc = f["tmod"].init_cache(f["tcfg"], B, M, device=CPU)
    jl, jc = f["jcached"](f["jw"], jnp.asarray(f["ids"]), jc, 0)
    tl, tc = f["tmod"].forward_cached(f["tw"], torch.from_numpy(f["ids"]), tc,
                                      0, f["tcfg"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    for kind in ("k", "v"):
        np.testing.assert_allclose(tc[kind].numpy(), np.asarray(jc[kind]),
                                   rtol=TOL, atol=TOL)
        assert not tc[kind][:, :, :, T:].any()  # rows past the prompt: zeros


def test_stepwise_decode_matches_the_growing_jax_forward(bb):
    """Token by token through the cache, each step's last-position logits
    against the JAX fused forward over the sequence so far.  The forward
    is causal, so the sequence-so-far logits are the rows of one forward
    over the final sequence (one JAX compile instead of one per length)."""
    f = bb
    ids = f["ids"][:1, :4]
    tc = f["tmod"].init_cache(f["tcfg"], 1, M, device=CPU)
    logits, tc = f["tmod"].forward_cached(f["tw"], torch.from_numpy(ids), tc,
                                          0, f["tcfg"])
    seq, got = ids, []
    for pos in range(4, 8):
        nxt = logits[:, -1, :].argmax(-1).to(torch.int32)
        seq = np.concatenate([seq, nxt.numpy()[:, None]], axis=1)
        logits, tc = f["tmod"].forward_cached(f["tw"], nxt[:, None], tc, pos,
                                              f["tcfg"])
        got.append(logits[:, -1].numpy())
    ref = np.asarray(f["jfwd"](f["jw"], jnp.asarray(seq)))
    for i, pos in enumerate(range(4, 8)):
        np.testing.assert_allclose(got[i], ref[:, pos], rtol=STEP_TOL,
                                   atol=STEP_TOL)


def test_greedy_tokens_equal_jax_generate(bb):
    f = bb
    got = f["tmod"].generate(f["tw"], torch.from_numpy(f["ids"]), f["tcfg"],
                             max_new_tokens=NEW)
    assert got.dtype == torch.int32 and got.shape == (B, T + NEW)
    np.testing.assert_array_equal(got.numpy(), f["j_dense"])


def test_stacked_layers_and_forward_scan_match_jax(bb):
    f = bb
    js = f["jmod"].stack_layer_params(f["jw"], f["jcfg"])
    ts = f["tmod"].stack_layer_params(f["tw"], f["tcfg"])
    assert sorted(ts) == sorted(js)
    for k, v in ts.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(js[k]))
    ids = f["ids"]
    jl = f["jmod"].forward_scan(js, jnp.asarray(ids), f["jcfg"])
    tl = f["tmod"].forward_scan(ts, torch.from_numpy(ids), f["tcfg"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    # the scanned layout gives the flat forward's numbers
    assert torch.equal(tl, f["tmod"].forward(f["tw"], torch.from_numpy(ids),
                                             f["tcfg"]))


def test_int8_cache_contents_equal_jax(fam):
    """Prefill into an int8 cache: the int8 values equal JAX's and the
    per-row scales within 1e-6, on every written row."""
    f = fam
    jc = jdecode.quantize_cache(f["jmod"].init_cache(f["jcfg"], B, M))
    tc = tdecode.quantize_cache(f["tmod"].init_cache(f["tcfg"], B, M,
                                                     device=CPU))
    jl, jc = f["jcached"](f["jw"], jnp.asarray(f["ids"]), jc, 0)
    tl, tc = f["tmod"].forward_cached(f["tw"], torch.from_numpy(f["ids"]), tc,
                                      0, f["tcfg"])
    for kind in ("k", "v"):
        np.testing.assert_array_equal(tc[kind].numpy(), np.asarray(jc[kind]))
        np.testing.assert_allclose(tc[kind + "_scale"].numpy(),
                                   np.asarray(jc[kind + "_scale"]),
                                   rtol=SCALE_TOL, atol=SCALE_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)


def test_int8_generation_tokens_equal_jax(fam):
    f = fam
    got = f["tmod"].generate(f["tw"], torch.from_numpy(f["ids"]), f["tcfg"],
                             max_new_tokens=NEW, kv_int8=True)
    np.testing.assert_array_equal(got.numpy(), f["j_int8"])


def test_int8_cache_container(fam):
    """JAX ``test_kv_int8_decode_matches_dense``'s container check: int8
    values, one scale per row, under 0.75 of the dense cache's bytes."""
    f = fam
    cache = f["tmod"].init_cache(f["tcfg"], 2, 16, device=CPU)
    qc = tdecode.quantize_cache(cache)
    assert qc["k"].dtype == torch.int8 and qc["v"].dtype == torch.int8
    assert qc["k_scale"].shape == cache["k"].shape[:-1] + (1,)
    assert qc["k_scale"].dtype == torch.float32
    q_bytes = sum(v.nbytes for v in qc.values())
    d_bytes = sum(v.nbytes for v in cache.values())
    assert q_bytes < 0.75 * d_bytes


def test_a_tensor_position_gives_the_int_positions_numbers(fam):
    """A 0-d tensor position (the decode DAG's) and an int give the same
    logits and cache, bit for bit, in prefill and in a decode step, dense
    and int8."""
    f = fam
    ids = torch.from_numpy(f["ids"])
    for kv_int8 in (False, True):
        caches = [f["tmod"].init_cache(f["tcfg"], B, M, device=CPU)
                  for _ in range(2)]
        if kv_int8:
            caches = [tdecode.quantize_cache(c) for c in caches]
        outs = []
        for cache, wrap in zip(caches, (int, lambda p: torch.tensor(
                p, dtype=torch.int32))):
            a, cache = f["tmod"].forward_cached(f["tw"], ids, cache, wrap(0),
                                                f["tcfg"])
            b, cache = f["tmod"].forward_cached(f["tw"], ids[:, :1], cache,
                                                wrap(T), f["tcfg"])
            outs.append((a, b, cache))
        (a1, b1, c1), (a2, b2, c2) = outs
        assert torch.equal(a1, a2) and torch.equal(b1, b2)
        assert all(torch.equal(c1[k], c2[k]) for k in c1)


def test_int8_rows_round_trip_and_masked_rows_stay_out():
    """The JAX package's ``test_kv_int8_update_and_attention_roundtrip``:
    a written row survives quantize -> dequantize within int8's per-row
    resolution, and rows never written contribute nothing."""
    cache = tdecode.quantize_cache(tdecode.init_cache(1, 1, 2, 8, 4,
                                                      torch.float32, CPU))
    rng = np.random.default_rng(0)
    k = torch.from_numpy(rng.standard_normal((1, 2, 3, 4)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 2, 3, 4)).astype(np.float32))
    tdecode.update_layer_cache(cache, 0, k, v, 0)
    kq, vq, ks, vs = tdecode.layer_view(cache, 0)
    deq = kq[:, :, :3].float() * ks[:, :, :3]
    assert (deq - k).abs().max() <= ks[:, :, :3].max() / 2 + 1e-7
    q = torch.from_numpy(rng.standard_normal((1, 2, 1, 4)).astype(np.float32))
    got = tdecode.cached_attention(q, kq, vq, 2, 0.5, k_scale=ks, v_scale=vs)
    dense = tdecode.cached_attention(
        q, kq[:, :, :3].float() * ks[:, :, :3], vq[:, :, :3].float() * vs[:, :, :3],
        2, 0.5)
    torch.testing.assert_close(got, dense, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="outside the cache"):
        tdecode.update_layer_cache(cache, 0, k, v, 6)
