"""The port's parallel layer (``parallel/``: mesh, sharding, train, ring
attention) against the JAX package's on its 8-device CPU mesh.

One world of 8 gloo ranks (``parallel.launch.spawn``) runs every case of
this file as legs of ``parallel.runs.run_legs``; the JAX oracle runs
once per case in this process.  The weights are the JAX package's
``gpt2.init_params`` bridged as numpy, the batches numpy draws.

Tolerances: the sharded forward at the JAX test's own 2e-5
(``tests/test_parallel.py:58-70``); training losses at 1e-4 (three Adam
steps of f32 sums taken in another order); params within 2 * lr * steps
absolute, since Adam's normalized update can flip the sign of a
coordinate whose gradient is rounding noise; each leaf's change within
1e-2 of JAX's change relative to its 2-norm (measured: at most 8.6e-4,
the qkv bias), which an update left out or reversed exceeds by far; ring
attention at the JAX test's 2e-5, causality at 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_scheduler_tpu.models import gpt2 as jgpt2
from distributed_llm_scheduler_tpu.parallel import mesh as jmesh
from distributed_llm_scheduler_tpu.parallel import ring_attention as jring
from distributed_llm_scheduler_tpu.parallel import train as jtrain
from distributed_llm_scheduler_tpu_torch.models import gpt2
from distributed_llm_scheduler_tpu_torch.parallel import launch, runs
from distributed_llm_scheduler_tpu_torch.parallel import mesh as M
from distributed_llm_scheduler_tpu_torch.parallel import ring_attention as R
from distributed_llm_scheduler_tpu_torch.parallel import sharding as S

WORLD = 8
STEPS = 3
LR = 3e-4
LOSS_TOL = 1e-4
FWD_TOL = 2e-5
UPDATE_REL_TOL = 1e-2
RING_SPS = (2, 4, 8)
# (label, mesh axes, make_train_step keywords)
TRAINS = [
    ("dp2_tp4", dict(dp=2, tp=4), {}),
    ("dp2_sp2_tp2_seq_parallel", dict(dp=2, sp=2, tp=2), dict(seq_parallel=True)),
    ("dp2_tp4_remat_scan", dict(dp=2, tp=4), dict(remat=True, scan=True)),
]


def _batch(seed=1, B=8, T=32, vocab=512):
    ids = np.random.default_rng(seed).integers(0, vocab, (B, T), dtype=np.int32)
    return ids, np.roll(ids, -1, axis=1)


def _qkv(seed, B=2, H=4, T=64, hd=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, H, T, hd)).astype(np.float32)
                 for _ in range(3))


@pytest.fixture(scope="module")
def jax_params():
    cfg = jgpt2.GPT2Config.tiny()
    return {k: np.asarray(v)
            for k, v in jgpt2.init_params(cfg, jax.random.PRNGKey(0)).items()}


@pytest.fixture(scope="module")
def world(jax_params):
    """Every port case of this file, in one world of 8 ranks."""
    cfg = gpt2.GPT2Config.tiny()
    ids, tgt = _batch()
    q, k, v = _qkv(0)
    cq, ck, cv = _qkv(5, B=1, H=2, T=32, hd=8)
    ck2, cv2 = ck.copy(), cv.copy()
    ck2[:, :, -1] += 10.0
    cv2[:, :, -1] += 10.0
    legs = [("train", dict(config=cfg, axes=axes, params=jax_params, ids=ids,
                           targets=tgt, steps=STEPS, **kw))
            for _, axes, kw in TRAINS]
    legs += [("attention", dict(kind="ring", q=q, k=k, v=v, sp=sp))
             for sp in RING_SPS]
    legs += [("attention", dict(kind="ring", q=cq, k=a, v=b, sp=4))
             for a, b in ((ck, cv), (ck2, cv2))]
    legs += [("train", dict(config=cfg, axes=dict(dp=4, tp=4), params=jax_params,
                            ids=ids, targets=tgt, steps=1))]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DLS_PLATFORM", "cpu")
        out = launch.spawn(runs.run_legs, WORLD, args=(legs,), timeout=300)
    n = len(TRAINS)
    return {"train": dict(zip((t[0] for t in TRAINS), out[:n])),
            "ring": dict(zip(RING_SPS, out[n:n + len(RING_SPS)])),
            "causal": out[n + len(RING_SPS):n + len(RING_SPS) + 2],
            "too_big": out[-1],
            "qkv": (q, k, v)}


@pytest.fixture(scope="module")
def jax_train(jax_params):
    """The JAX package's losses, final params and shard shapes per case."""
    cfg = jgpt2.GPT2Config.tiny()
    ids, tgt = _batch()
    out = {}
    for label, axes, kw in TRAINS:
        mesh = jmesh.make_mesh(**axes)
        step, init = jtrain.make_train_step(cfg, mesh, **kw)
        state = init(jax.random.PRNGKey(0))
        shards = {k: {s.data.shape for s in v.addressable_shards}
                  for k, v in state.params.items()}
        start = {k: np.asarray(v) for k, v in state.params.items()}
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, jnp.asarray(ids), jnp.asarray(tgt))
            losses.append(float(loss))
        out[label] = {"losses": losses, "shards": shards, "start": start,
                      "params": {k: np.asarray(v) for k, v in state.params.items()}}
    return out


@pytest.mark.parametrize("label", [t[0] for t in TRAINS])
def test_train_step_losses_match_jax(world, jax_train, label):
    got, want = world["train"][label], jax_train[label]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    assert got["step"] == STEPS
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("label", [t[0] for t in TRAINS])
def test_train_step_params_match_jax(world, jax_train, label):
    got, want = world["train"][label]["params"], jax_train[label]["params"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=2 * LR * STEPS, err_msg=k)


@pytest.mark.parametrize("label", [t[0] for t in TRAINS])
def test_train_step_updates_match_jax(world, jax_train, label):
    """Each leaf's change over the steps, from the same start, against
    JAX's: ``|d_port - d_jax| / |d_jax|`` per leaf (2-norms).  The
    absolute bound of ``test_train_step_params_match_jax`` is wider than
    the whole update, so this is the test that sees an optimizer fault:
    a leaf left unchanged gives 1, a leaf moved the wrong way 2."""
    want = jax_train[label]
    got = world["train"][label]["params"]
    worst = {}
    for k, start in want["start"].items():
        d_jax = want["params"][k] - start
        d_port = got[k] - start
        worst[k] = float(np.linalg.norm(d_port - d_jax) / np.linalg.norm(d_jax))
    assert max(worst.values()) < UPDATE_REL_TOL, worst


@pytest.mark.parametrize("label", [t[0] for t in TRAINS])
def test_shard_shapes_match_jax(world, jax_train, label):
    """Each rank's block has the shape of JAX's ``addressable_shards``.
    The fused qkv's block holds the same number of columns in another
    order (``test_fused_qkv_block_is_whole_heads``)."""
    got = world["train"][label]["shard_shapes"]
    want = jax_train[label]["shards"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert want[k] == {got[k]}, k


def test_sharded_forward_matches_jax(world, jax_params):
    """dp2 x tp4 sharded forward == JAX ``make_eval_step`` on its mesh."""
    cfg = jgpt2.GPT2Config.tiny()
    ids, _ = _batch()
    mesh = jmesh.make_mesh(dp=2, tp=4)
    want = jtrain.make_eval_step(cfg, mesh)(
        {k: jnp.asarray(v) for k, v in jax_params.items()}, jnp.asarray(ids))
    for label in ("dp2_tp4", "dp2_sp2_tp2_seq_parallel"):
        np.testing.assert_allclose(world["train"][label]["logits"],
                                   np.asarray(want), rtol=FWD_TOL, atol=FWD_TOL)


def test_fused_qkv_block_is_whole_heads(jax_params):
    """GSPMD's block of the fused qkv (``P(None, "tp")``) is a contiguous
    run of columns (for tp=2: all of q and half of k); the port's block
    of tp rank r is the r-th column block of q, of k and of v, so the rank
    computes whole heads.  Same shape, columns permuted."""
    w = torch.from_numpy(np.array(jax_params["h0_attn_qkv_w"]))
    D = w.shape[0]
    for tp in (2, 4):
        for r in range(tp):
            mesh = _fake_mesh(dp=1, tp=tp, rank=r)
            block = S.param_shardings(mesh, {"h0_attn_qkv_w": w})["h0_attn_qkv_w"].shard(w)
            c = D // tp
            want = torch.cat([w[:, part * D + r * c: part * D + (r + 1) * c]
                              for part in range(3)], dim=1)
            assert block.shape == (D, 3 * D // tp)
            assert torch.equal(block, want)
            gspmd = w[:, r * 3 * D // tp:(r + 1) * 3 * D // tp]
            assert not torch.equal(block, gspmd)


def _fake_mesh(dp=1, tp=1, sp=1, rank=0):
    """A rank's Mesh view without a process group (shapes and blocks only)."""
    arr = np.arange(dp * sp * tp).reshape(dp, sp, tp)
    d, s, t = (int(i) for i in np.argwhere(arr == rank)[0])
    groups = {axes: None for axes in M.GROUP_AXES}
    return M.Mesh({"dp": dp, "sp": sp, "tp": tp}, rank,
                  {"dp": d, "sp": s, "tp": t}, groups)


@pytest.mark.parametrize("sp", RING_SPS)
def test_ring_attention_matches_oracle(world, sp):
    q, k, v = world["qkv"]
    want = np.asarray(jring.reference_causal_attention(
        *(jnp.asarray(t) for t in (q, k, v))))
    np.testing.assert_allclose(world["ring"][sp], want, rtol=2e-5, atol=2e-5)
    mine = R.reference_causal_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    np.testing.assert_allclose(mine.numpy(), want, rtol=2e-5, atol=2e-5)


def test_ring_attention_is_causal(world):
    """Perturbing the last token's K/V never changes earlier outputs."""
    out1, out2 = world["causal"]
    np.testing.assert_allclose(out1[:, :, :-1], out2[:, :, :-1],
                               rtol=1e-5, atol=1e-5)
    assert not np.allclose(out1[:, :, -1], out2[:, :, -1])


def test_mesh_too_big_rejected(world):
    with pytest.raises(ValueError, match="exceeds"):
        M.make_mesh(dp=4, tp=4)  # one process, no group: a world of 1
    assert "exceeds 8 available devices" in world["too_big"]["ValueError"]
    with pytest.raises(ValueError, match="exceeds 8 available devices"):
        jmesh.make_mesh(dp=4, tp=4)


def test_real_gpt2_small_params_shardable():
    """The flagship (odd vocab 50257) shards on dp2 x tp4 without a
    divisibility error: the embedding stays replicated, every block's
    shape is JAX's."""
    cfg = gpt2.GPT2Config.small()
    shapes = {k: s for k, (s, _) in gpt2.param_shapes(cfg).items()}
    mesh = _fake_mesh(dp=2, tp=4)
    for name, sh in S.param_shardings(mesh, shapes).items():
        shape = shapes[name]
        local = sh.local_shape(shape)
        for dim, (full, part) in enumerate(zip(shape, local)):
            assert full % part == 0 and (full == part or sh.spec[dim] == "tp"), name
    assert S.param_shardings(mesh, shapes)["wte"].local_shape(shapes["wte"]) \
        == (50257, 768)


def test_batch_and_activation_shardings():
    mesh = _fake_mesh(dp=2, sp=2, tp=2, rank=5)  # dp 1, sp 0, tp 1
    ids = torch.arange(8 * 6).reshape(8, 6)
    assert torch.equal(S.batch_sharding(mesh).shard(ids), ids[4:])
    assert torch.equal(S.batch_sharding(mesh, seq_parallel=True).shard(ids),
                       ids[4:, :3])
    x = torch.zeros(8, 6, 3)
    assert S.activation_sharding(mesh, True).local_shape(tuple(x.shape)) == (4, 3, 3)


def test_a_failing_rank_stops_the_world_with_its_traceback(monkeypatch):
    """A leg that raises (here an unknown leg's ``KeyError``) comes back
    as ``WorkerError`` carrying the rank's traceback, long before the
    world's timeout."""
    monkeypatch.setenv("DLS_PLATFORM", "cpu")
    with pytest.raises(launch.WorkerError) as e:
        launch.spawn(runs.run_legs, 2, args=([("no_such_leg", {})],),
                     timeout=120)
    assert "raised" in str(e.value) and "KeyError: 'no_such_leg'" in str(e.value)
