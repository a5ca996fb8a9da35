"""The bf16 tensor-core flash kernel's arithmetic, emulated on the CPU.

``csrc/flash_attention.cu`` computes bf16 attention on the tensor cores:
64-row Q tiles walk 64-key K/V tiles; S = Q K^T is a product of bf16
operands summed in f32, scaled by scale * log2(e) in f32; the online
softmax works in the exp2 domain; P is split as hi = bf16(P) and lo =
bf16(P - hi) so that O += hi V + lo V keeps ~16 bits of P; the output is
rounded to bf16 once.  ``_emulate`` repeats those steps tile by tile in
plain torch (f32 products of bf16-valued operands are exact, as on the
tensor cores), and the tests hold it to the rule ``chip_smoke.py`` holds
the kernel to on the card: no output element more than 2^-8 |x| + 1e-4
from the f32 function, here the JAX package's ``reference_mha`` and its
Pallas kernel in interpret mode, both in f32 on the same bf16 values.
The un-split P (one bf16 rounding, the usual FlashAttention-2 step)
breaks that rule on the same inputs; that case is why the split exists.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_scheduler_tpu.ops.attention import gqa_mha as jax_gqa_mha
from distributed_llm_scheduler_tpu.ops.attention import (
    reference_mha as jax_reference,
)

TILE = 64  # Q rows and keys per tile, as the kernel's TC_BM and TC_BN
LOG2E = 1.4426950408889634
ROUNDOFF, SLACK = 2.0 ** -8, 1e-4  # chip_smoke's BF16_ROUNDOFF, F32_SLACK

# (B, Hq, T, hd, Hkv): one head per KV head; and GQA 4:1 with T ending
# inside a tile
SHAPES = [(1, 2, 128, 64, 2), (1, 4, 200, 128, 1)]


def _emulate(q, k, v, causal, split=True):
    """The kernel's tile arithmetic on bf16 (B, Hq, T, hd) q and (B, Hkv,
    T, hd) k, v; returns bf16 (B, Hq, T, hd)."""
    B, H, T, hd = q.shape
    group = H // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scale_log2 = torch.tensor((1.0 / math.sqrt(hd)) * LOG2E, dtype=torch.float32)
    out = torch.empty(B, H, T, hd, dtype=torch.bfloat16)
    for q0 in range(0, T, TILE):
        rows = torch.arange(q0, min(q0 + TILE, T))
        Q = qf[:, :, q0:q0 + TILE]
        m = torch.full((B, H, len(rows)), -math.inf)
        l = torch.zeros(B, H, len(rows))
        acc = torch.zeros(B, H, len(rows), hd)
        kv_end = min(q0 + TILE, T) if causal else T
        for k0 in range(0, kv_end, TILE):
            cols = torch.arange(k0, min(k0 + TILE, T))
            K, V = kf[:, :, k0:k0 + TILE], vf[:, :, k0:k0 + TILE]
            s = (Q @ K.transpose(-1, -2)) * scale_log2
            if causal:
                s = s.masked_fill(cols[None, :] > rows[:, None], -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            hi = p.bfloat16().float()
            if split:
                lo = (p - hi).bfloat16().float()
                pv = hi @ V + lo @ V
            else:
                pv = hi @ V
            acc = acc * alpha[..., None] + pv
            m = m_new
        out[:, :, q0:q0 + TILE] = (acc / l[..., None]).bfloat16()
    return out


def _inputs(shape, seed=0):
    """bf16 q, k, v from numpy ``seed``, and their values as f32 JAX
    arrays."""
    B, H, T, hd, Hkv = shape
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .bfloat16() for s in ((B, H, T, hd), (B, Hkv, T, hd),
                                     (B, Hkv, T, hd)))
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    return (q, k, v), (jq, jk, jv)


def _exact(jq, jk, jv, causal, oracle):
    """The f32 function: JAX ``reference_mha`` on K/V repeated across each
    group, or the Pallas kernel in interpret mode through JAX ``gqa_mha``."""
    if oracle == "reference":
        group = jq.shape[1] // jk.shape[1]
        jk, jv = (jnp.repeat(t, group, axis=1) for t in (jk, jv))
        return np.asarray(jax_reference(jq, jk, jv, causal=causal))
    return np.asarray(
        jax_gqa_mha(jq, jk, jv, causal=causal, impl="pallas_interpret"))


def _beyond_rule(got, want):
    got = got.float().numpy()
    return int((np.abs(got - want) > ROUNDOFF * np.abs(want) + SLACK).sum())


@pytest.mark.parametrize("oracle", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_split_p_meets_the_bf16_rule(shape, causal, oracle):
    (q, k, v), (jq, jk, jv) = _inputs(shape)
    got = _emulate(q, k, v, causal)
    want = _exact(jq, jk, jv, causal, oracle)
    assert got.shape == tuple(want.shape)
    assert _beyond_rule(got, want) == 0


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_unsplit_p_breaks_the_bf16_rule(shape):
    """One bf16 rounding of P, on the same inputs: many elements land
    more than 2^-8 |x| + 1e-4 off the f32 function."""
    (q, k, v), (jq, jk, jv) = _inputs(shape)
    want = _exact(jq, jk, jv, True, "reference")
    assert _beyond_rule(_emulate(q, k, v, True, split=False), want) > 0.01 * want.size
    assert _beyond_rule(_emulate(q, k, v, True), want) == 0


def test_emulation_matches_the_port_plain_version_in_f32():
    """In f32 arithmetic the tile walk is the plain softmax attention: the
    emulation's output equals the port's ``gqa_mha`` on the CPU within
    one bf16 rounding (guards the emulation's own masks and walk)."""
    from distributed_llm_scheduler_tpu_torch.ops import attention as A

    (q, k, v), _ = _inputs(SHAPES[1], seed=3)
    for causal in (True, False):
        want = A.gqa_mha(q.float(), k.float(), v.float(), causal=causal)
        assert _beyond_rule(_emulate(q, k, v, causal), want.numpy()) == 0
