"""The port's Ulysses attention (``parallel/ulysses.py``) against the JAX
package's oracle and against ring attention, on the JAX test's inputs
(``tests/test_ulysses.py``) drawn with numpy.

One world of 4 gloo ranks runs every port case (``parallel.runs``); on
the CPU the local attention is ``ops.attention.mha``'s plain version.
Tolerances are the JAX test's: 2e-5 against the oracle and ring, 1e-5
for causality.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_llm_scheduler_tpu.parallel import mesh as jmesh
from distributed_llm_scheduler_tpu.parallel import ring_attention as jring
from distributed_llm_scheduler_tpu.parallel import ulysses as jul
from distributed_llm_scheduler_tpu_torch.parallel import launch, runs

WORLD = 4
SPS = (2, 4)


def qkv(B=2, H=4, T=64, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, H, T, hd)).astype(np.float32)
                 for _ in range(3))


def _leg(kind, inputs, sp, causal=True):
    q, k, v = inputs
    return ("attention", dict(kind=kind, q=q, k=k, v=v, sp=sp, causal=causal))


@pytest.fixture(scope="module")
def world():
    base, ring_in, causal_in, full_in = qkv(), qkv(seed=3), qkv(1, 4, 32, 8, 1), qkv(T=32, seed=2)
    q, k, v = causal_in
    k2, v2 = k.copy(), v.copy()
    k2[:, :, -1] += 10.0
    v2[:, :, -1] += 10.0
    legs = [_leg("ulysses", base, sp) for sp in SPS]
    legs += [_leg("ulysses", ring_in, 4), _leg("ring", ring_in, 4)]
    legs += [_leg("ulysses", causal_in, 4), _leg("ulysses", (q, k2, v2), 4)]
    legs += [_leg("ulysses", full_in, 2, causal=False)]
    legs += [_leg("ulysses", qkv(H=2), 4)]  # 2 heads over sp=4
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DLS_PLATFORM", "cpu")
        out = launch.spawn(runs.run_legs, WORLD, args=(legs,), timeout=300)
    return {"oracle": dict(zip(SPS, out[:2])), "vs_ring": out[2:4],
            "causal": out[4:6], "non_causal": out[6], "refused": out[7],
            "inputs": {"base": base, "ring": ring_in, "full": full_in}}


@pytest.mark.parametrize("sp", SPS)
def test_ulysses_matches_oracle(world, sp):
    q, k, v = (jnp.asarray(t) for t in world["inputs"]["base"])
    want = np.asarray(jring.reference_causal_attention(q, k, v))
    np.testing.assert_allclose(world["oracle"][sp], want, rtol=2e-5, atol=2e-5)
    jax_got = np.asarray(jul.ulysses_attention_sharded(
        q, k, v, jmesh.make_mesh(dp=1, tp=1, sp=sp)))
    np.testing.assert_allclose(world["oracle"][sp], jax_got, rtol=2e-5, atol=2e-5)


def test_ulysses_matches_ring(world):
    u, r = world["vs_ring"]
    np.testing.assert_allclose(u, r, rtol=2e-5, atol=2e-5)
    q, k, v = (jnp.asarray(t) for t in world["inputs"]["ring"])
    jr = np.asarray(jring.ring_attention_sharded(q, k, v,
                                                 jmesh.make_mesh(sp=4)))
    np.testing.assert_allclose(r, jr, rtol=2e-5, atol=2e-5)


def test_ulysses_is_causal(world):
    out1, out2 = world["causal"]
    np.testing.assert_allclose(out1[:, :, :-1], out2[:, :, :-1],
                               rtol=1e-5, atol=1e-5)


def test_ulysses_non_causal(world):
    """causal=False: full bidirectional attention (no mask)."""
    q, k, v = world["inputs"]["full"]
    hd = q.shape[-1]
    scores = jnp.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
    probs = jax.nn.softmax(scores.astype(jnp.float32), axis=-1)
    want = np.asarray(jnp.einsum("bhqk,bhkd->bhqd", probs, v))
    np.testing.assert_allclose(world["non_causal"], want, rtol=2e-5, atol=2e-5)


def test_ulysses_rejects_indivisible_heads(world):
    """The JAX package's refusal, message for message."""
    msg = world["refused"]["ValueError"]
    assert "divisible" in msg and "(2)" in msg and "(4)" in msg
    q, k, v = (jnp.asarray(t) for t in qkv(H=2))
    with pytest.raises(ValueError) as e:
        jul.ulysses_attention_sharded(q, k, v, jmesh.make_mesh(sp=4))
    assert str(e.value) == msg
