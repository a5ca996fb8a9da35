"""The port's expert parallelism (``parallel/expert.py``: stacked experts
cut over ``ep``, dense and routed dispatch, the dp x ep training step)
against the JAX package's on its 8-device CPU mesh.

The counterparts of ``tests/test_expert_parallel.py`` and of the routed
cases of ``tests/test_moe_routed.py``.  One world of 8 gloo ranks runs
every sharded case of this file as legs of ``parallel.runs.run_legs``;
the JAX oracle runs once per case in this process.  The weights are the
JAX package's ``mixtral.init_params`` bridged as numpy, the batches numpy
draws.

Tolerances are the JAX tests' own: forwards at 2e-5, losses at 1e-4,
remat against plain at 1e-5 (loss) and 2e-5 (gradients); each leaf's
change over 3 Adam steps within 1e-2 of JAX's relative to its 2-norm (the
test of ``tests/test_torch_parallel.py``, which sees a partial or doubled
gradient, the router's included); the dp-averaged gradients of one step
against JAX's at rtol 1e-4 and atol 1e-5 (the pipeline test's).  Dropped
slot counts must be equal.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from distributed_llm_scheduler_tpu.models import mixtral as jm
from distributed_llm_scheduler_tpu.parallel import expert as jexp
from distributed_llm_scheduler_tpu_torch.models import mixtral as tm
from distributed_llm_scheduler_tpu_torch.parallel import expert as E
from distributed_llm_scheduler_tpu_torch.parallel import launch, runs

WORLD = 8
STEPS = 3
AXES = dict(dp=2, ep=4)
FWD_TOL = 2e-5
LOSS_TOL = 1e-4
UPDATE_REL_TOL = 1e-2
SQUEEZE = 0.5  # a capacity factor below the average load: slots drop
# (label, make_moe_train_step keywords)
TRAINS = [("dense", {}), ("routed", dict(routed=True, capacity_factor=2.0))]


def _full_capacity(cfg):
    """Capacity factor at which nothing can drop (C == N)."""
    return cfg.n_experts / cfg.top_k


@pytest.fixture(scope="module")
def tiny():
    """JAX tiny config and weights (numpy), ids and targets (4, 16)."""
    cfg = jm.MixtralConfig.tiny()
    params = {k: np.asarray(v)
              for k, v in jm.init_params(cfg, jax.random.PRNGKey(0)).items()}
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, (4, 16), dtype=np.int32)
    targets = rng.integers(0, cfg.vocab_size, (4, 16), dtype=np.int32)
    return cfg, params, ids, targets


def _jmesh(dp=2, ep=4):
    return Mesh(np.array(jax.devices()[:dp * ep]).reshape(dp, ep), ("dp", "ep"))


@pytest.fixture(scope="module")
def started(tiny):
    """Every sharded port case of this file, in one world of 8 ranks,
    started in the background: the JAX oracle runs meanwhile."""
    _, params, ids, targets = tiny
    cfg = tm.MixtralConfig.tiny()
    base = dict(config=cfg, params=params, ids=ids, targets=targets)
    legs = [("expert", dict(base, axes=AXES, steps=STEPS, grads=True,
                            stats_capacity=(2.0, SQUEEZE), **kw))
            for _, kw in TRAINS]
    legs += [("expert", dict(base, axes=AXES, steps=1, grads=True, remat=True)),
             ("expert", dict(base, axes=dict(dp=1, ep=8), steps=1)),
             ("reshard", dict(base, save=AXES, loads=[dict(dp=4, ep=2)]))]
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(1) as pool:
        mp.setenv("DLS_PLATFORM", "cpu")
        yield pool.submit(launch.spawn, runs.run_legs, WORLD, (legs,), 300)


@pytest.fixture(scope="module")
def world(started, jax_mesh_runs):
    """The world's results, once the JAX oracle has run."""
    out = started.result()
    n = len(TRAINS)
    return {"train": dict(zip((t[0] for t in TRAINS), out[:n])),
            "remat": out[n], "indivisible": out[n + 1], "reshard": out[n + 2]}


@pytest.fixture(scope="module")
def jax_mesh_runs(tiny):
    """The JAX package on its dp2 x ep4 mesh: per case the shard shapes,
    the start and end params, 3 losses and the first step's gradients;
    the routed forward and its stats at capacity 2.0 and the squeeze."""
    cfg, params, ids, targets = tiny
    mesh = _jmesh()
    stacked = jexp.stack_expert_params(
        {k: jnp.asarray(v) for k, v in params.items()}, cfg)
    jids, jtgt = jnp.asarray(ids), jnp.asarray(targets)
    out = {}
    for label, kw in TRAINS:
        step, init = jexp.make_moe_train_step(cfg, mesh, **kw)
        state = init(jax.random.PRNGKey(0))
        shards = {k: {s.data.shape for s in v.addressable_shards}
                  for k, v in state.params.items()}
        start = {k: np.asarray(v) for k, v in state.params.items()}
        grads = jax.jit(jax.grad(lambda p: jexp.loss_fn_ep(
            p, jids, jtgt, cfg, mesh=mesh, **kw)))(
                jexp.shard_ep_params(mesh, stacked))
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, jids, jtgt)
            losses.append(float(loss))
        out[label] = {"losses": losses, "shards": shards, "start": start,
                      "grads": {k: np.asarray(v) for k, v in grads.items()},
                      "params": {k: np.asarray(v) for k, v in state.params.items()}}
    sharded = jexp.shard_ep_params(mesh, stacked)
    out["stats"] = {}
    for cf in (2.0, SQUEEZE):
        logits, st = jax.jit(lambda p: jexp.forward_ep_stats(
            p, jids, cfg, capacity_factor=cf, mesh=mesh))(sharded)
        out["stats"][cf] = (np.asarray(logits), int(st["dropped_slots"]),
                            int(st["total_slots"]), st["capacity"])
    out["dense_logits"] = np.asarray(jax.jit(
        lambda p: jexp.forward_ep(p, jids, cfg, mesh=mesh))(sharded))
    return out


def _port_single(params, cfg):
    return E.stack_expert_params(tm.params_from_numpy(params, "cpu"), cfg)


def test_stack_unstack_round_trip(tiny):
    """Numpy arrays and tensors stack and unstack back to the same
    per-expert leaves; the stacked tensors equal JAX's stacking."""
    jcfg, params, _, _ = tiny
    cfg = tm.MixtralConfig.tiny()
    want = {k: np.asarray(v) for k, v in jexp.stack_expert_params(
        {k: jnp.asarray(v) for k, v in params.items()}, jcfg).items()}
    stacked = E.stack_expert_params(params, cfg)
    assert list(stacked) == list(want)
    for k in want:
        np.testing.assert_array_equal(stacked[k], want[k])
    for rt in (E.unstack_expert_params(stacked, cfg),
               {k: v.numpy() for k, v in E.unstack_expert_params(
                   _port_single(params, cfg), cfg).items()}):
        assert set(rt) == set(params)
        for k in params:
            np.testing.assert_array_equal(np.asarray(rt[k]), params[k])


def test_stacked_shapes():
    cfg = tm.MixtralConfig.tiny()
    shapes = E.stacked_shapes(cfg)
    stacked = E.stack_expert_params(tm.init_params_numpy(cfg, 0), cfg)
    n, d, f = cfg.n_experts, cfg.d_model, cfg.ffn_hidden
    assert shapes["l0_moe_gate"] == stacked["l0_moe_gate"].shape == (n, d, f)
    assert shapes["l0_moe_up"] == (n, d, f)
    assert shapes["l0_moe_down"] == stacked["l0_moe_down"].shape == (n, f, d)
    assert not any("_e0_" in k for k in stacked)
    assert {k: v.shape for k, v in stacked.items()} == shapes


def test_stacked_forward_matches_oracle(tiny):
    """One device: the stacked forward == JAX's per-expert forward."""
    jcfg, params, ids, _ = tiny
    cfg = tm.MixtralConfig.tiny()
    want = np.asarray(jm.forward({k: jnp.asarray(v) for k, v in params.items()},
                                 jnp.asarray(ids), jcfg))
    with torch.no_grad():
        got = E.forward_ep(_port_single(params, cfg), torch.from_numpy(ids), cfg)
        block = E.moe_block_stacked(_port_single(params, cfg),
                                    torch.ones(2, 3, cfg.d_model), 0, cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)
    assert block.shape == (2, 3, cfg.d_model)


def test_ep_loss_matches_single_device(tiny):
    jcfg, params, ids, targets = tiny
    cfg = tm.MixtralConfig.tiny()
    want = float(jm.loss_fn({k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(ids), jnp.asarray(targets), jcfg))
    got = float(E.loss_fn_ep(_port_single(params, cfg), torch.from_numpy(ids),
                             torch.from_numpy(targets), cfg))
    assert abs(got - want) < LOSS_TOL


@pytest.mark.parametrize("label", [t[0] for t in TRAINS])
def test_shard_shapes_match_jax(world, jax_mesh_runs, label):
    """Each rank's block has the shape of JAX's ``addressable_shards``:
    one expert of four a rank on ep=4, every other param whole."""
    got = world["train"][label]["shard_shapes"]
    want = jax_mesh_runs[label]["shards"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert want[k] == {got[k]}, k
    assert got["l0_moe_gate"][0] == 1


def test_sharded_forward_matches_jax(world, jax_mesh_runs):
    """dp2 x ep4 sharded forwards == JAX's ``forward_ep`` on its mesh:
    dense, and routed at capacity 2.0."""
    np.testing.assert_allclose(world["train"]["dense"]["logits"],
                               jax_mesh_runs["dense_logits"],
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(world["train"]["routed"]["logits"],
                               jax_mesh_runs["stats"][2.0][0],
                               rtol=FWD_TOL, atol=FWD_TOL)


def test_first_step_loss_matches_unsharded(world, tiny):
    """The first step's loss on the dp x ep mesh equals the plain
    single-device loss of the same weights."""
    jcfg, params, ids, targets = tiny
    want = float(jm.loss_fn({k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(ids), jnp.asarray(targets), jcfg))
    assert abs(world["train"]["dense"]["losses"][0] - want) < LOSS_TOL


@pytest.mark.parametrize("label", [t[0] for t in TRAINS])
def test_train_losses_match_jax(world, jax_mesh_runs, label):
    got, want = world["train"][label], jax_mesh_runs[label]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    assert got["step"] == STEPS
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("label", [t[0] for t in TRAINS])
def test_train_updates_match_jax(world, jax_mesh_runs, label):
    """Each leaf's change over the steps against JAX's, relative to its
    2-norm: a gradient counted on one ep rank only (the router's, if it
    were not summed over ep) or twice (the dp mean on top of a sum)
    moves a leaf by a wrong amount."""
    want = jax_mesh_runs[label]
    got = world["train"][label]["params"]
    assert sorted(got) == sorted(want["params"])
    worst = {}
    for k, start in want["start"].items():
        d_jax = want["params"][k] - start
        worst[k] = float(np.linalg.norm(got[k] - start - d_jax)
                         / np.linalg.norm(d_jax))
    assert max(worst.values()) < UPDATE_REL_TOL, worst
    assert worst["l0_router"] < UPDATE_REL_TOL


@pytest.mark.parametrize("label", [t[0] for t in TRAINS])
def test_step_grads_match_jax(world, jax_mesh_runs, label):
    """The dp-averaged gradients of one step, each expert block gathered
    over ep, against ``jax.grad(loss_fn_ep)`` on the JAX mesh."""
    got = world["train"][label]["grads"]
    want = jax_mesh_runs[label]["grads"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_remat_losses_and_grads_equal(world):
    """Remat changes memory, not math: the checkpointed layers' loss and
    gradients on the mesh equal the plain ones."""
    plain, remat = world["train"]["dense"], world["remat"]
    assert abs(remat["losses"][0] - plain["losses"][0]) < 1e-5
    for k, g in plain["grads"].items():
        np.testing.assert_allclose(remat["grads"][k], g, rtol=2e-5, atol=2e-5,
                                   err_msg=k)


def test_routed_ep_matches_dense_at_full_capacity(tiny):
    """Non-dropping capacity: routed == dense stacked == JAX's per-expert
    oracle, with no slot dropped."""
    jcfg, params, ids, _ = tiny
    cfg = tm.MixtralConfig.tiny()
    stacked = _port_single(params, cfg)
    ids_t = torch.from_numpy(ids)
    with torch.no_grad():
        dense = E.forward_ep(stacked, ids_t, cfg)
        routed, st = E.forward_ep_stats(stacked, ids_t, cfg,
                                        capacity_factor=_full_capacity(cfg))
    np.testing.assert_allclose(routed.numpy(), dense.numpy(), rtol=FWD_TOL, atol=FWD_TOL)
    want = np.asarray(jm.forward({k: jnp.asarray(v) for k, v in params.items()},
                                 jnp.asarray(ids), jcfg))
    np.testing.assert_allclose(routed.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)
    assert int(st["dropped_slots"]) == 0
    assert st["total_slots"] == cfg.n_layers * ids.size * cfg.top_k


@pytest.mark.parametrize("cf", [2.0, SQUEEZE])
def test_routed_ep_on_mesh_matches_jax(world, jax_mesh_runs, cf):
    """The routed forward on the dp x ep mesh places each token in the
    JAX global view's slot: its logits, dropped-slot count, slot total and
    capacity equal JAX's mesh at the capacity factor, and the squeeze
    drops something."""
    (got,) = [s for s, c in zip(world["train"]["routed"]["stats"], (2.0, SQUEEZE))
              if c == cf]
    logits, dropped, total, capacity = jax_mesh_runs["stats"][cf]
    np.testing.assert_allclose(got["logits"], logits, rtol=FWD_TOL, atol=FWD_TOL)
    assert (got["dropped_slots"], got["total_slots"], got["capacity"]) \
        == (dropped, total, capacity)
    if cf == SQUEEZE:
        assert dropped > 0


def test_indivisible_ep_refused(world, tiny):
    """ep=8 over 4 experts: the JAX refusal, on every rank of the world."""
    cfg = tiny[0]
    with pytest.raises(ValueError, match="must divide n_experts") as e:
        jexp.make_moe_train_step(cfg, _jmesh(dp=1, ep=8))
    assert world["indivisible"] == {"ValueError": str(e.value)}


def test_a_checkpoint_loads_at_another_ep(world):
    """Saved on dp2 x ep4 after two steps, restored into a fresh state of
    another seed on dp4 x ep2: every whole leaf (each stacked expert
    block gathered over ep) equal, the step count restored, and the next
    two losses, which read the restored Adam moments, the saving run's."""
    saved, loaded = world["reshard"]["rows"]
    assert loaded["step"] == saved["step"] == 2
    assert sorted(loaded["params"]) == sorted(saved["params"])
    for k, v in saved["params"].items():
        np.testing.assert_array_equal(loaded["params"][k], v, err_msg=k)
    np.testing.assert_allclose(loaded["losses"], saved["losses"],
                               rtol=1e-5, atol=1e-5)


def test_stats_with_remat_refused(tiny):
    _, params, ids, _ = tiny
    cfg = tm.MixtralConfig.tiny()
    with pytest.raises(ValueError, match="stats collection is incompatible "
                                         "with remat"):
        E.forward_ep(_port_single(params, cfg), torch.from_numpy(ids), cfg,
                     remat=True, routed=True, _stats_sink=[])


def test_expert_mesh_axes():
    """The ``train`` command's rule: the widest ep dividing both counts."""
    assert E.expert_mesh_axes(8, 1) == (1, 1)
    assert E.expert_mesh_axes(8, 4) == (1, 4)
    assert E.expert_mesh_axes(4, 8) == (2, 4)
    assert E.expert_mesh_axes(8, 6) == (3, 2)
