"""The port's CUDA flash-attention kernel against its plain version, on a GPU.

Marked ``cuda``: skips without a CUDA device.  This file imports neither
JAX nor the JAX package, so it also runs on a GPU host that has only
PyTorch: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from distributed_llm_scheduler_tpu_torch.ops import attention as A
from distributed_llm_scheduler_tpu_torch.ops import kernels


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            device=device, dtype=dtype
        )
        for _ in range(3)
    ]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,causal,dtype",
    [((1, 12, 512, 64), True, torch.bfloat16),
     ((1, 12, 512, 64), True, torch.float32),
     ((2, 3, 100, 32), False, torch.float32),
     ((1, 2, 77, 128), True, torch.float32),
     ((2, 2, 1, 64), True, torch.bfloat16)],
)
def test_kernel_matches_plain(cuda, shape, causal, dtype):
    q, k, v = _qkv(shape, dtype, cuda)
    before = kernels.launches[A.KERNEL]
    got = A.mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernels.launches[A.KERNEL] == before + 1
    want = A.reference_mha(q, k, v, causal=causal)
    # f32: summation order only.  bf16: the plain version rounds scores
    # and probabilities to bf16 and both round the output (5e-2 is the
    # bf16 element band of the JAX package's benchlib.oracle_close)
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    assert (got.float() - want.float()).abs().max().item() < tol


@pytest.mark.cuda
def test_kernel_reads_strided_head_views(cuda):
    (x,) = _qkv((2, 64, 3 * 128), torch.float32, cuda)[:1]
    q, k, v = (t.reshape(2, 64, 2, 64).transpose(1, 2) for t in x.split(128, -1))
    got = A.mha(q, k, v)
    want = A.mha(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, want)
