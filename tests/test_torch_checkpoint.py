"""The port's checkpoints (``utils/checkpoint.py``) against the JAX
package's: a resumed sharded training run equal to an uninterrupted one
(``tests/test_checkpoint_resume.py``), ``load_state``'s refusals with the
JAX messages, and ``.npz`` params that either package reads from the
other.

The sharded cases run in one world of 4 gloo ranks (dp2 x tp2,
``parallel.runs.resume``); the rest in this process.  Resume is exact
(atol 0): the restored state is the saved one, bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_scheduler_tpu.models import gpt2 as jgpt2
from distributed_llm_scheduler_tpu.parallel import mesh as jmesh
from distributed_llm_scheduler_tpu.parallel import train as jtrain
from distributed_llm_scheduler_tpu.utils import checkpoint as jckpt
from distributed_llm_scheduler_tpu_torch.models import gpt2
from distributed_llm_scheduler_tpu_torch.parallel import launch, runs
from distributed_llm_scheduler_tpu_torch.parallel.mesh import make_mesh
from distributed_llm_scheduler_tpu_torch.parallel.train import make_train_step
from distributed_llm_scheduler_tpu_torch.utils import checkpoint as C

WORLD = 4
# the JAX test's wrong target: another depth (so another leaf count), and
# one of the same depth at another width (so other leaf shapes)
DEEPER = gpt2.GPT2Config(vocab_size=512, n_positions=128, n_embd=128,
                         n_layer=1, n_head=4)
WIDER = gpt2.GPT2Config(vocab_size=512, n_positions=128, n_embd=64,
                        n_layer=2, n_head=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: several spin against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(B=4, T=16):
    ids = np.random.default_rng(1).integers(0, 512, (B, T), dtype=np.int32)
    return ids, np.roll(ids, -1, axis=1)


@pytest.fixture(scope="module")
def jax_params():
    cfg = jgpt2.GPT2Config.tiny()
    return {k: np.asarray(v)
            for k, v in jgpt2.init_params(cfg, jax.random.PRNGKey(0)).items()}


@pytest.fixture(scope="module")
def world(jax_params):
    ids, tgt = _batch()
    leg = ("resume", dict(config=gpt2.GPT2Config.tiny(), axes=dict(dp=2, tp=2),
                          params=jax_params, ids=ids, targets=tgt,
                          other_configs=(DEEPER, WIDER)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DLS_PLATFORM", "cpu")
        return launch.spawn(runs.run_legs, WORLD, args=([leg],),
                            timeout=300)[0]


def test_resume_matches_uninterrupted(world):
    assert world["restored_step"] == 2
    np.testing.assert_allclose(world["resumed"], world["uninterrupted"][2:],
                               rtol=0, atol=0)


def test_resumed_losses_match_jax(world, tmp_path, jax_params):
    """The JAX package's own resume test on the same mesh shape: its four
    losses equal the port's at the training tolerance (1e-4)."""
    cfg = jgpt2.GPT2Config.tiny()
    step, init = jtrain.make_train_step(cfg, jmesh.make_mesh(dp=2, tp=2))
    ids, tgt = (jnp.asarray(a) for a in _batch())
    state = init(jax.random.PRNGKey(0))
    want = []
    for _ in range(4):
        state, loss = step(state, ids, tgt)
        want.append(float(loss))
    np.testing.assert_allclose(world["uninterrupted"], want, rtol=1e-4, atol=1e-4)


def test_load_state_requires_matching_target(world, tmp_path):
    """A wrong-config target is refused before anything is read, with the
    messages of the JAX package's ``load_state``: the leaf count, then
    each leaf's shape.  (The JAX package's Orbax refuses the deeper target
    first, with a ``ValueError`` of its own.)"""
    deeper, wider = world["refusals"]
    assert "leaves; the target state has" in deeper
    assert "wrong model/optimizer config?" in deeper
    assert "has shape" in wider and "wrong model config?" in wider
    # the JAX package refuses the same target
    cfg = jgpt2.GPT2Config.tiny()
    mesh = jmesh.make_mesh(dp=2, tp=4)
    _, init = jtrain.make_train_step(cfg, mesh)
    path = str(tmp_path / "jckpt")
    jckpt.save_state(init(jax.random.PRNGKey(0)), path)
    _, other_init = jtrain.make_train_step(jgpt2.GPT2Config(
        vocab_size=512, n_positions=128, n_embd=128, n_layer=1, n_head=4), mesh)
    with pytest.raises(ValueError):
        jckpt.load_state(path, other_init(jax.random.PRNGKey(0)))


def test_single_process_resume(tmp_path, monkeypatch):
    """Without a process group (one rank, on the CPU by the platform
    seam): save after two steps, resume, and the next step's loss equals
    the uninterrupted run's exactly."""
    monkeypatch.setenv("DLS_PLATFORM", "cpu")
    cfg = gpt2.GPT2Config.tiny()
    mesh = make_mesh()
    step, init = make_train_step(cfg, mesh)
    ids, tgt = (torch.from_numpy(a) for a in _batch())
    state = init(0)
    losses = [float(step(state, ids, tgt)[1]) for _ in range(3)]
    state = init(0)
    for _ in range(2):
        step(state, ids, tgt)
    path = C.save_state(state, str(tmp_path / "ckpt"))
    resumed = C.load_state(path, init(0))
    assert resumed.step == 2
    assert float(step(resumed, ids, tgt)[1]) == losses[2]


def test_a_single_process_defaults_to_the_card(monkeypatch):
    """Without a process group the step binds the platform seam's device:
    the card unless ``DLS_PLATFORM=cpu``; with no card that raises."""
    from distributed_llm_scheduler_tpu_torch.utils.config import ConfigError

    monkeypatch.delenv("DLS_PLATFORM", raising=False)
    monkeypatch.delenv("DLS_FORCE_CPU", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the step would bind it")
    with pytest.raises(ConfigError, match="no CUDA device"):
        make_train_step(gpt2.GPT2Config.tiny(), make_mesh())


def test_npz_params_cross_load(tmp_path, jax_params):
    """``.npz`` params written by either package load in the other, array
    for array."""
    port_path = str(tmp_path / "port.npz")
    C.save_params(gpt2.params_from_numpy(jax_params, "cpu"), port_path)
    loaded = jckpt.load_params(port_path)
    assert sorted(loaded) == sorted(jax_params)
    for k, v in jax_params.items():
        assert np.array_equal(np.asarray(loaded[k]), v), k
    jax_path = str(tmp_path / "jax.npz")
    jckpt.save_params({k: jnp.asarray(v) for k, v in jax_params.items()}, jax_path)
    back = C.load_params(jax_path)
    assert sorted(back) == sorted(jax_params)
    for k, v in jax_params.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    assert open(port_path, "rb").read(4) == open(jax_path, "rb").read(4)


def test_directory_params_round_trip(tmp_path, jax_params):
    """A path that is not ``.npz``: a ``torch.distributed.checkpoint``
    directory, read back tensor for tensor."""
    params = gpt2.params_from_numpy(jax_params, "cpu")
    path = C.save_params(params, str(tmp_path / "params"))
    back = C.load_params(path)
    assert sorted(back) == sorted(params)
    for k, v in params.items():
        assert torch.equal(back[k], v), k
