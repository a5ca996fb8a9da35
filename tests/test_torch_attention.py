"""The port's attention against the JAX package's.

On the CPU, ``mha`` takes the plain version, which is held against the
JAX package's plain ``reference_mha`` and against its Pallas kernel run in
interpret mode (how ``tests/test_ops.py`` runs it here).  Inputs come from
one numpy seed and go to both packages.  Tolerances are those of
``tests/test_ops.py``: 1e-4 in float32 (summation order only), 3e-2 in
bfloat16 (scores and probabilities are rounded to bf16 on both sides, at
different points).  The CUDA kernel itself is compared on the card
(``chip_smoke.py`` and ``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_scheduler_tpu.ops.attention import gqa_mha as jax_gqa_mha
from distributed_llm_scheduler_tpu.ops.attention import mha as jax_mha
from distributed_llm_scheduler_tpu.ops.attention import (
    reference_mha as jax_reference,
)
from distributed_llm_scheduler_tpu_torch.ops import attention as A
from distributed_llm_scheduler_tpu_torch.ops import kernels

TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _qkv(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return (
        [torch.from_numpy(a).to(tdt) for a in arrs],
        [jnp.asarray(a, dtype=jdt) for a in arrs],
    )


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("T", [64, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_mha_matches_jax(causal, T, hd, dtype):
    (q, k, v), (jq, jk, jv) = _qkv((1, 2, T, hd), dtype)
    got = _np(A.mha(q, k, v, causal=causal))
    ref = _np(jax_reference(jq, jk, jv, causal=causal))
    pallas = _np(jax_mha(jq, jk, jv, causal=causal, impl="pallas_interpret"))
    assert np.abs(got - ref).max() < TOL[dtype]
    assert np.abs(got - pallas).max() < TOL[dtype]


def test_plain_mha_takes_strided_views():
    """GPT-2 hands ``mha`` head views of a fused qkv product."""
    (x, _, _), _ = _qkv((2, 8, 3 * 32), "float32")
    q, k, v = (t.reshape(2, 8, 2, 16).transpose(1, 2) for t in x.split(32, -1))
    want = A.mha(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(A.mha(q, k, v), want)


def test_meta_tensors_take_the_plain_path():
    q = torch.empty(2, 4, 50, 32, dtype=torch.bfloat16, device="meta")
    before = kernels.launches[A.KERNEL]
    out = A.mha(q, q, q)
    assert out.device.type == "meta"
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert kernels.launches[A.KERNEL] == before


def test_kernel_wrapper_refuses_non_cuda_tensors():
    q = torch.zeros(1, 1, 8, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        A.flash_attention(q, q, q)


def test_kernel_wrapper_checks_inputs_before_building():
    q = torch.zeros(1, 4, 8, 32)
    with pytest.raises(ValueError, match="multiple"):
        A.flash_attention(q, q[:, :3], q[:, :3])
    with pytest.raises(ValueError, match="shape"):
        A.flash_attention(q, q[:, :, :4], q[:, :, :4])
    with pytest.raises(ValueError, match="dtype"):
        A.flash_attention(q, q.double(), q)
    # the bf16 kernel copies 16-byte chunks: a row stride of 66 bytes and
    # a base 2 bytes off are refused
    qb = q.bfloat16()
    wide = torch.zeros(1, 4, 8, 33, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        A.flash_attention(qb, wide[..., :32], qb)
    with pytest.raises(ValueError, match="16-byte"):
        A.flash_attention(qb, qb, wide[..., 1:33])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_gqa_mha_matches_jax(causal, dtype):
    """8 query heads on 2 KV heads: the port's ``gqa_mha`` on the CPU
    against the JAX package's, both repeating each KV head across its
    group."""
    rng = np.random.default_rng(4)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((2, 8, 64, 32), (2, 2, 64, 32), (2, 2, 64, 32))]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrs)
    before = kernels.launches[A.KERNEL]
    got = _np(A.gqa_mha(q, k, v, causal=causal))
    assert kernels.launches[A.KERNEL] == before
    want = _np(jax_gqa_mha(*(jnp.asarray(a, dtype=jdt) for a in arrs),
                           causal=causal, impl="xla"))
    assert got.shape == want.shape
    assert np.abs(got - want).max() < TOL[dtype]
    with pytest.raises(ValueError, match="multiple"):
        A.gqa_mha(q, k[:, :1].expand(2, 3, 64, 32), v)
