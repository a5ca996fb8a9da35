"""The port's pipeline parallelism (``parallel/pipeline_pp.py``: GPipe over
a ``pp`` axis, a stage a rank) against the JAX package's plain forward,
gradients and ``make_pp_train_step``.

The counterpart of ``tests/test_pipeline_pp.py``.  One world of 8 gloo
ranks runs every pipelined case as legs of ``parallel.runs.run_legs``
(the ranks past the ``pp`` mesh sit out); the JAX oracle runs once per
case in this process.  Weights are the JAX initializers' bridged as
numpy, ids numpy draws.

Tolerances are the JAX test's: logits at 2e-5 (bf16 at 5e-2), gradients
at rtol 1e-4 and atol 1e-5, training losses at 1e-4.  Where the JAX test
reads ``ppermute`` in the jaxpr, this one counts each stage rank's sends
and receives of the successor hop.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from distributed_llm_scheduler_tpu.models import gpt2 as jgpt2
from distributed_llm_scheduler_tpu.models import llama as jllama
from distributed_llm_scheduler_tpu.models import mixtral as jmixtral
from distributed_llm_scheduler_tpu.parallel import pipeline_pp as jpp
from distributed_llm_scheduler_tpu_torch.models import gpt2, llama, mixtral
from distributed_llm_scheduler_tpu_torch.parallel import launch, runs
from distributed_llm_scheduler_tpu_torch.parallel import pipeline_pp as PP

WORLD = 8
SM = [(1, 2), (2, 2), (2, 4), (4, 4), (4, 2)]
FWD_TOL = 2e-5
BF16_TOL = 5e-2
LOSS_TOL = 1e-4
STEPS = 3
FAMILIES = ("llama", "mixtral")


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _port(jcfg, dtype=torch.float32):
    """The port's config of the same widths as JAX's GPT-2 ``jcfg``."""
    return gpt2.GPT2Config(vocab_size=jcfg.vocab_size, n_positions=jcfg.n_positions,
                           n_embd=jcfg.n_embd, n_layer=jcfg.n_layer,
                           n_head=jcfg.n_head, dtype=dtype)


@pytest.fixture(scope="module")
def setup():
    """GPT-2 tiny at 4 layers (JAX config, numpy weights), ids (4, 16)."""
    config = dataclasses.replace(jgpt2.GPT2Config.tiny(), n_layer=4)
    params = _np(jgpt2.init_params(config, jax.random.PRNGKey(0)))
    ids = np.random.default_rng(1).integers(0, config.vocab_size, (4, 16),
                                            dtype=np.int32)
    return config, params, ids


@pytest.fixture(scope="module")
def families():
    """Llama and Mixtral tiny: (JAX config, port config, weights, ids)."""
    out = {}
    for fam, jmod, tmod in (("llama", jllama, llama), ("mixtral", jmixtral, mixtral)):
        jcfg = (jllama.LlamaConfig if fam == "llama" else jmixtral.MixtralConfig).tiny()
        tcfg = (llama.LlamaConfig if fam == "llama" else mixtral.MixtralConfig).tiny()
        params = _np(jmod.init_params(jcfg, jax.random.PRNGKey(2)))
        ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, (4, 16),
                                                dtype=np.int32)
        out[fam] = (jcfg, tcfg, params, ids)
    return out


@pytest.fixture(scope="module")
def started(setup, families):
    """Every pipelined port case of this file, in one world of 8 ranks,
    started in the background: the JAX oracle runs meanwhile."""
    jcfg, params, ids = setup
    cfg = _port(jcfg)
    tgt = np.roll(ids, -1, axis=1)
    base = dict(config=cfg, params=params, ids=ids)
    legs = [("pipeline", dict(base, stages=S, microbatches=M)) for S, M in SM]
    legs += [("pipeline", dict(base, stages=2, microbatches=2, targets=tgt,
                               grads=True, steps=STEPS)),
             ("pipeline", dict(base, stages=2, microbatches=2, targets=tgt,
                               grads=True, remat=True)),
             ("pipeline", dict(base, stages=3, microbatches=2)),
             ("pipeline", dict(base, stages=2, microbatches=3)),
             ("pipeline", dict(base, config=_port(jcfg, torch.bfloat16),
                               stages=2, microbatches=2))]
    legs += [("pipeline", dict(config=tcfg, params=p, ids=i, stages=2,
                               microbatches=2))
             for _, tcfg, p, i in (families[f] for f in FAMILIES)]
    legs += [("reshard", dict(base, targets=tgt, save=dict(pp=2),
                              loads=[dict(pp=1), dict(dp=1, tp=2)]))]
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(1) as pool:
        mp.setenv("DLS_PLATFORM", "cpu")
        yield pool.submit(launch.spawn, runs.run_legs, WORLD, (legs,), 300)


@pytest.fixture(scope="module")
def world(started, oracle):
    """The world's results, once the JAX oracle has run."""
    out = started.result()
    n = len(SM)
    return {"fwd": dict(zip(SM, out[:n])), "grads": out[n], "remat": out[n + 1],
            "bad_layers": out[n + 2], "bad_mb": out[n + 3], "bf16": out[n + 4],
            "families": dict(zip(FAMILIES, out[n + 5:n + 7])),
            "reshard": out[n + 7]}


@pytest.fixture(scope="module")
def oracle(setup):
    """JAX's plain forward, its loss and gradients, and the losses of
    ``make_pp_train_step`` on a 2-stage mesh from the same weights."""
    config, params, ids = setup
    jp, jids = {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(ids)
    tgt = jnp.roll(jids, -1, axis=1)
    logits = np.asarray(jax.jit(lambda p: jgpt2.forward(p, jids, config))(jp))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jgpt2.loss_fn(p, jids, tgt, config)))(jp)
    step, init = jpp.make_pp_train_step(
        config, Mesh(np.array(jax.devices()[:2]), ("pp",)), microbatches=2)
    state = init(jax.random.PRNGKey(0))
    losses = []
    for _ in range(STEPS):
        state, lv = step(state, jids, tgt)
        losses.append(float(lv))
    return {"logits": logits, "loss": float(loss), "grads": _np(grads),
            "losses": losses}


@pytest.mark.parametrize("S,M", SM)
def test_pipeline_matches_plain_forward(world, oracle, S, M):
    """Stages on different ranks, microbatches through the successor hops:
    the logits of JAX's plain forward (the pipeline changes WHERE layers
    run, not what they compute)."""
    np.testing.assert_allclose(world["fwd"][(S, M)]["logits"], oracle["logits"],
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("S,M", [sm for sm in SM if sm[0] > 1])
def test_pipeline_hops_between_stage_ranks(world, S, M):
    """The activations travel by sends and receives between the stage
    ranks: each of the ``M + S - 2`` hops sends from every stage but the
    last and receives on every stage but the first."""
    hops = world["fwd"][(S, M)]["hops"]
    n = M + S - 2
    assert hops == [{"send": n if s < S - 1 else 0, "recv": n if s > 0 else 0}
                    for s in range(S)]


def test_backward_hops_reverse_the_forward(world):
    """Autograd runs every hop's backward on every stage, in reverse: a
    receive where the forward sent and a send where it received."""
    n = 2 + 2 - 2
    assert world["grads"]["hops"] == [{"send": n, "recv": n}] * 2


def test_pipeline_validates_divisibility(world, setup):
    """The JAX refusals, on every stage rank."""
    config, params, ids = setup
    with pytest.raises(ValueError, match="n_layer") as e:
        jpp.pipeline_forward({k: jnp.asarray(v) for k, v in params.items()},
                             jnp.asarray(ids), config,
                             Mesh(np.array(jax.devices()[:3]), ("pp",)), 2)
    assert world["bad_layers"] == {"ValueError": str(e.value)}
    assert world["bad_mb"] == {"ValueError": "batch 4 not divisible by microbatches 3"}


def test_pipeline_bf16(world, setup):
    """bf16 stages against the plain bf16 forward (the JAX test's 5e-2)."""
    config, params, ids = setup
    cfg = _port(config, torch.bfloat16)
    with torch.no_grad():
        want = gpt2.forward(gpt2.params_from_numpy(params, "cpu", torch.bfloat16),
                            torch.from_numpy(ids), cfg).float().numpy()
    np.testing.assert_allclose(world["bf16"]["logits"], want,
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_pipeline_llama_backbone_families(world, families, family):
    """The same pipeline serves the Llama backbone and its MoE variant:
    only the embedding, head and layer names differ per family."""
    jcfg, _, params, ids = families[family]
    jmod = jllama if family == "llama" else jmixtral
    want = np.asarray(jax.jit(lambda p: jmod.forward(p, jnp.asarray(ids), jcfg))(
        {k: jnp.asarray(v) for k, v in params.items()}))
    np.testing.assert_allclose(world["families"][family]["logits"], want,
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("leg", ["grads", "remat"])
def test_pipeline_backward_matches_plain_grads(world, oracle, leg):
    """The backward pipeline (the hops' backwards, the shared params'
    parts summed over pp) gives the plain loss's gradients, ``wte`` (the
    embedding on stage 0 plus the tied head) included; remat changes
    memory, not math."""
    got = world[leg]
    assert abs(got["loss"] - oracle["loss"]) < LOSS_TOL
    assert sorted(got["grads"]) == sorted(oracle["grads"])
    for k, want in oracle["grads"].items():
        np.testing.assert_allclose(got["grads"][k], want, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_pp_train_step_matches_jax(world, oracle):
    """``make_pp_train_step`` on 2 stages: JAX's losses at 1e-4."""
    np.testing.assert_allclose(world["grads"]["losses"], oracle["losses"],
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    assert world["grads"]["losses"][-1] < world["grads"]["losses"][0]


@pytest.mark.parametrize("target", [1, 2], ids=["pp1", "dp1_tp2"])
def test_a_pipeline_checkpoint_loads_elsewhere(world, target):
    """Saved by 2 stages after two steps, each writing its own layers as
    whole flat leaves; restored into a fresh state of another seed on one
    stage, and into the dp x tp step at tp=2 (each fused qkv cut into
    whole heads): every leaf equal, the step count restored, and the next
    two losses, which read the restored Adam moments, the saving run's."""
    rows = world["reshard"]["rows"]
    saved, loaded = rows[0], rows[target]
    assert loaded["step"] == saved["step"] == 2
    assert sorted(loaded["params"]) == sorted(saved["params"])
    for k, v in saved["params"].items():
        np.testing.assert_array_equal(loaded["params"][k], v, err_msg=k)
    np.testing.assert_allclose(loaded["losses"], saved["losses"],
                               rtol=1e-5, atol=1e-5)


def test_stage_stacks_and_names(setup):
    """``_stack_stage_params`` folds the scanned layout into (stage,
    layer-in-stage), as JAX's does; a stage rank holds its layers' flat
    params and the shared ones."""
    config, params, _ = setup
    cfg = _port(config)
    got = PP._stack_stage_params(gpt2, gpt2.params_from_numpy(params, "cpu"),
                                 cfg, 2, 4)
    want = jpp._stack_stage_params(jgpt2, {k: jnp.asarray(v) for k, v in params.items()},
                                   config, 2, 4)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    names = PP.stage_param_names(cfg, 2, 1)
    assert [k for k in names if k.startswith("h")] == [
        f"h{i}_{k}" for i in (2, 3) for k in gpt2._BLOCK_KEYS]
    assert {"wte", "wpe", "ln_f_g", "ln_f_b"} <= set(names)
