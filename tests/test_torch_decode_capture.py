"""The capture-ready decode loops of the port against the JAX package's
compiled ones, on the CPU.

On a card each loop runs as a CUDA graph; here the same bodies run
eagerly over the same state.  Greedy ``generate`` runs over a stored
:class:`DecodeProgram` (cache, token, position and token buffer at fixed
addresses, advanced by each step): its tokens must equal the JAX
package's ``generate`` (one jitted ``lax.scan``) in all three families,
f32, with the plain and the int8 cache, on a fresh program and again on
the same program with another prompt.  Sampling and ``capture=False``
stay eager by rule, and the store is bounded by bytes.  The dense K-step
loop, chained over windows on one set of slabs, and the paged segment
inside an engine reused through ``reset()`` must give the JAX loops'
tokens and caches or pools (rtol = atol = 2e-4, the repo's placed-vs-fused
tolerance), and the reset engine the fresh engine's tokens and
``decode.jit_cache_entries`` series.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_scheduler_tpu.models import gpt2 as jgpt2
from distributed_llm_scheduler_tpu.models import llama as jllama
from distributed_llm_scheduler_tpu.models import mixtral as jmixtral
from distributed_llm_scheduler_tpu_torch import Cluster, DeviceBackend, get_scheduler
from distributed_llm_scheduler_tpu_torch.backends.decode_loop import (
    build_decode_loop,
    compose_step_fn,
    split_cache_params,
)
from distributed_llm_scheduler_tpu_torch.frontend.decode_dag import (
    apply_cache_updates,
    build_decode_dag_any,
    decode_inputs,
)
from distributed_llm_scheduler_tpu_torch.models import decode as tdecode
from distributed_llm_scheduler_tpu_torch.models import gpt2 as tgpt2
from distributed_llm_scheduler_tpu_torch.models import llama as tllama
from distributed_llm_scheduler_tpu_torch.models import mixtral as tmixtral
from test_torch_serve_engine import _jax_engine, _torch_engine, drive, workload

CPU = torch.device("cpu")
TOL = 2e-4
FAMILIES = {
    "gpt2": (jgpt2, tgpt2, jgpt2.GPT2Config.tiny(), tgpt2.GPT2Config.tiny()),
    "llama": (jllama, tllama, jllama.LlamaConfig.tiny(),
              tllama.LlamaConfig.tiny()),
    "mixtral": (jmixtral, tmixtral, jmixtral.MixtralConfig.tiny(),
                tmixtral.MixtralConfig.tiny()),
}
B, T, NEW = 2, 8, 6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: several spin against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def empty_store():
    tdecode.clear_programs()
    yield
    tdecode.clear_programs()


def prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, size=(B, T), dtype=np.int32)
            for _ in range(2)]


@pytest.fixture(scope="module")
def jax_tokens():
    """(family, kv_int8) -> the JAX package's greedy tokens for both
    prompts (one compiled scan per key), and the weights of both packages."""
    out = {}

    def get(family, kv_int8):
        if (family, kv_int8) not in out:
            jmod, tmod, jcfg, tcfg = FAMILIES[family]
            np_w = tmod.init_params_numpy(tcfg, 0)
            jw = {k: jnp.asarray(v) for k, v in np_w.items()}
            tw = tmod.params_from_numpy(np_w, CPU)
            toks = [np.asarray(jmod.generate(jw, jnp.asarray(ids), jcfg,
                                             max_new_tokens=NEW,
                                             kv_int8=kv_int8))
                    for ids in prompts(tcfg.vocab_size)]
            out[family, kv_int8] = (tw, toks)
        return out[family, kv_int8]

    return get


@pytest.mark.parametrize("kv_int8", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_generate_program_equals_jax_generate(jax_tokens, family, kv_int8):
    """Two generations on one stored program (the second reuses its cache,
    reset in place) give the JAX tokens; so does the eager path."""
    _, tmod, _, tcfg = FAMILIES[family]
    tw, want = jax_tokens(family, kv_int8)
    caches = []
    for ids, ref in zip(prompts(tcfg.vocab_size), want):
        got = tmod.generate(tw, torch.from_numpy(ids), tcfg,
                            max_new_tokens=NEW, kv_int8=kv_int8)
        np.testing.assert_array_equal(got.numpy(), ref)
        (prog,) = tdecode._programs.values()
        caches.append({k: v.data_ptr() for k, v in prog.cache.items()})
        eager = tmod.generate(tw, torch.from_numpy(ids), tcfg,
                              max_new_tokens=NEW, kv_int8=kv_int8,
                              capture=False)
        assert torch.equal(eager, got)
    assert caches[0] == caches[1]
    assert len(tdecode._programs) == 1
    assert int(prog.pos) == T + NEW - 1


def test_sampling_and_capture_false_stay_eager():
    """The rule in ``generate``'s docstring: ``temperature > 0`` and
    ``capture=False`` make no program; greedy makes one per static key."""
    tw = tgpt2.params_from_numpy(
        tgpt2.init_params_numpy(tgpt2.GPT2Config.tiny(), 0), CPU)
    cfg = tgpt2.GPT2Config.tiny()
    ids = torch.from_numpy(prompts(cfg.vocab_size)[0])
    g = torch.Generator().manual_seed(0)
    out = tgpt2.generate(tw, ids, cfg, max_new_tokens=NEW, temperature=0.8,
                         top_k=5, generator=g)
    assert out.shape == (B, T + NEW) and not tdecode._programs
    tgpt2.generate(tw, ids, cfg, max_new_tokens=NEW, capture=False)
    assert not tdecode._programs
    tgpt2.generate(tw, ids, cfg, max_new_tokens=NEW)
    tgpt2.generate(tw, ids, cfg, max_new_tokens=NEW - 2)  # same key: M differs
    tgpt2.generate(tw, ids, cfg, max_new_tokens=NEW - 2, max_len=T + NEW)
    assert len(tdecode._programs) == 2


def test_program_store_is_bounded_by_bytes(monkeypatch):
    """Past ``PROGRAM_BYTES`` the least recently used programs go; the
    one in use stays even alone over the bound."""
    tw = tgpt2.params_from_numpy(
        tgpt2.init_params_numpy(tgpt2.GPT2Config.tiny(), 0), CPU)
    cfg = tgpt2.GPT2Config.tiny()
    ids = torch.from_numpy(prompts(cfg.vocab_size)[0])
    for n in (2, 3, 4):
        tgpt2.generate(tw, ids, cfg, max_new_tokens=n)
    sizes = [p.nbytes for p in tdecode._programs.values()]
    assert len(sizes) == 3
    # room for the newest two (sizes grow linearly with the cache length)
    monkeypatch.setattr(tdecode, "PROGRAM_BYTES",
                        2 * sizes[-1] + (sizes[-1] - sizes[-2]))
    tgpt2.generate(tw, ids, cfg, max_new_tokens=5)
    assert [p.out.shape[1] for p in tdecode._programs.values()] == [
        T + 4, T + 5]
    monkeypatch.setattr(tdecode, "PROGRAM_BYTES", 1)
    tgpt2.generate(tw, ids, cfg, max_new_tokens=5)
    assert len(tdecode._programs) == 1


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dense_loop_windows_equal_jax(jax_tokens, family):
    """A DAG prefill, then the K-step loop in three windows on one set of
    slabs (fed back as a captured loop is): the JAX tokens, and slabs
    equal to the whole-model cache after the same steps."""
    _, tmod, _, tcfg = FAMILIES[family]
    tw, want = jax_tokens(family, False)
    ids = prompts(tcfg.vocab_size)[0]
    M = T + NEW
    cluster = Cluster.from_torch_devices([CPU])
    backend = DeviceBackend(cluster)
    pdag = build_decode_dag_any(tcfg, batch=B, step_len=T, max_len=M)
    ddag = build_decode_dag_any(tcfg, batch=B, step_len=1, max_len=M)
    sched = get_scheduler("greedy").schedule(ddag.graph, cluster)
    params = pdag.derive_params(tw)
    rep = backend.execute(
        pdag.graph, get_scheduler("greedy").schedule(pdag.graph, cluster),
        params, decode_inputs(torch.from_numpy(ids), 0), keep_outputs=True)
    apply_cache_updates(params, rep.task_outputs, tcfg, 0)
    weights, caches = split_cache_params(params)
    slabs = {k: v.data_ptr() for k, v in caches.items()}
    toks = [rep.output[:, -1].argmax(-1).to(torch.int32)[:, None]]
    pos = T
    loop = build_decode_loop(ddag.graph, sched, tcfg, steps=2)
    for _ in range(2):
        out, caches = loop(weights, caches, toks[-1][:, -1:], pos)
        toks.append(out)
        pos += 2
    tail = build_decode_loop(ddag.graph, sched, tcfg, steps=NEW - 5)
    out, caches = tail(weights, caches, toks[-1][:, -1:], pos)
    toks.append(out)
    got = torch.cat(toks, dim=1)
    np.testing.assert_array_equal(got.numpy(), want[0][:, T:])
    assert {k: v.data_ptr() for k, v in caches.items()} == slabs
    # the whole-model cache after prefill + NEW - 1 steps
    cache = tmod.init_cache(tcfg, B, M, device=CPU)
    _, cache = tmod.forward_cached(tw, torch.from_numpy(ids), cache, 0, tcfg)
    for i in range(NEW - 1):
        _, cache = tmod.forward_cached(tw, got[:, i:i + 1], cache, T + i, tcfg)
    for i in range(cache["k"].shape[0]):
        for kind in ("k", "v"):
            torch.testing.assert_close(
                caches[f"cache_{kind}_{i}"][:, :, :T + NEW - 1],
                cache[kind][i][:, :, :T + NEW - 1], rtol=TOL, atol=TOL)


def test_the_step_composer_writes_slabs_in_place():
    """The loop's one step leaves every slab at its address."""
    cfg = tgpt2.GPT2Config.tiny()
    tw = tgpt2.params_from_numpy(tgpt2.init_params_numpy(cfg, 0), CPU)
    ddag = build_decode_dag_any(cfg, batch=B, step_len=1, max_len=T + 2)
    cluster = Cluster.from_torch_devices([CPU])
    step = compose_step_fn(
        ddag.graph, get_scheduler("greedy").schedule(ddag.graph, cluster), cfg)
    weights, caches = split_cache_params(ddag.derive_params(tw))
    before = {k: v.data_ptr() for k, v in caches.items()}
    pos = torch.full((), T, dtype=torch.int32)
    _, caches = step(weights, caches, torch.zeros((B, 1), dtype=torch.int32), pos)
    assert {k: v.data_ptr() for k, v in caches.items()} == before


@pytest.fixture(scope="module")
def jax_engine_run():
    np_w = tgpt2.init_params_numpy(tgpt2.GPT2Config.tiny(), 0)
    jw = {k: jnp.asarray(v) for k, v in np_w.items()}
    eng = _jax_engine(jw, False, 8)
    toks = drive(eng, workload("chunked"))
    pools = {k: np.asarray(v) for k, v in eng.pools.items()}
    return toks, pools, np_w


def test_engine_reused_through_reset_equals_a_fresh_one(jax_engine_run):
    """The segment's pools are zeroed in place by ``reset()`` (the captured
    segment's fixed input); a reset engine gives a fresh engine's tokens
    and ``decode.jit_cache_entries`` series, and the fresh engine the JAX
    engine's tokens and pools.  (A reused pool hands pages out in the
    order they came back, so the reset engine's physical pages differ.)"""
    jtoks, jpools, np_w = jax_engine_run
    tw = tgpt2.params_from_numpy(np_w, CPU)
    runs = []
    for reuse in (False, True):
        eng = _torch_engine(tw, False, 8)
        if reuse:
            drive(eng, workload("whole"))
        addr = {k: v.data_ptr() for k, v in eng.pools.items()}
        series = []  # the gauge's value at each segment boundary
        toks = drive(eng, workload("chunked"), on_segment=lambda e, n:
                     series.append(len(e._prefill_cache)))
        series.append(len(eng._prefill_cache))
        assert {k: v.data_ptr() for k, v in eng.pools.items()} == addr
        runs.append((toks, {k: v.clone() for k, v in eng.pools.items()},
                     series))
    (ft, fp, fs), (rt, _, rs) = runs
    assert fs and rs == fs
    assert rt.keys() == ft.keys() == jtoks.keys()
    for rid in ft:
        np.testing.assert_array_equal(rt[rid], ft[rid])
        np.testing.assert_array_equal(ft[rid], jtoks[rid])
    for k in fp:
        np.testing.assert_allclose(fp[k].numpy(), jpools[k], rtol=TOL, atol=TOL)
