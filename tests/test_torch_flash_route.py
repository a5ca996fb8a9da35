"""The flash path's resolver: which shapes and types ``mha``/``gqa_mha``
hand the CUDA kernel as they are, which on contiguous copies and which on
copies padded to the next head dim the kernel is built for.  As the JAX
package's Pallas kernel takes every head dim and type that
``resolve_attention_impl`` hands it, no answer is the plain version.

The resolver reads dtype, head dim and layout only, so it is exercised
here on CPU tensors, and the padding's arithmetic through the plain
version; the routes' outputs on a card are in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from distributed_llm_scheduler_tpu_torch.ops import attention as A
from distributed_llm_scheduler_tpu_torch.ops import kernels


@pytest.mark.parametrize(
    "hd,dtype,path",
    [(16, torch.float32, "kernel"), (16, torch.bfloat16, "kernel"),
     (32, torch.bfloat16, "kernel"), (64, torch.float32, "kernel"),
     (128, torch.bfloat16, "kernel"),
     (48, torch.float32, "kernel:padded"), (48, torch.bfloat16, "kernel:padded"),
     (80, torch.float32, "kernel:padded"), (80, torch.bfloat16, "kernel:padded"),
     (8, torch.bfloat16, "kernel:padded"),
     (64, torch.float16, "kernel"), (16, torch.float16, "kernel"),
     (96, torch.float16, "kernel:padded")],
)
def test_resolver_by_head_dim_and_dtype(hd, dtype, path):
    q = torch.zeros(1, 2, 8, hd, dtype=dtype)
    assert A.resolve_flash_path(q, q, q) == path


@pytest.mark.parametrize("hd,dtype", [(64, torch.float64), (192, torch.float32),
                                      (256, torch.bfloat16)])
def test_resolver_refuses_what_no_instance_holds(hd, dtype):
    """A type the kernel has no instance for, and a head dim above the
    largest (128), raise: nothing goes to the plain version on a card."""
    q = torch.zeros(1, 2, 8, hd, dtype=dtype)
    with pytest.raises(ValueError):
        A.resolve_flash_path(q, q, q)


@pytest.mark.parametrize("hd,inst", [(1, 16), (8, 16), (16, 16), (17, 32),
                                     (48, 64), (80, 128), (128, 128)])
def test_padded_head_dim(hd, inst):
    assert A.padded_head_dim(hd) == inst


@pytest.mark.parametrize("hd", [8, 48, 80, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_padding_computes_the_same_function(hd, causal):
    """Zero columns in q, k and v at the true head dim's scale, sliced off
    the output, give attention at the true head dim (through the plain
    version, which is what the padded kernel call is held to)."""
    rng = np.random.default_rng(hd)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, 19, hd)))
               for _ in range(3))
    got = A.on_padded_head_dim(A.reference_mha, q, k, v, causal)
    assert got.shape == q.shape
    assert torch.allclose(got, A.reference_mha(q, k, v, causal=causal),
                          atol=1e-12, rtol=0)


def test_resolver_copies_misaligned_bf16_views():
    """A bf16 or f16 view whose base is 2 bytes off, or whose row stride
    is not a whole 16-byte chunk, goes to the kernel on contiguous copies;
    the same views in f32 (the kernel reads them element by element) and
    aligned qkv head views go to the kernel as they are."""
    for dt in (torch.bfloat16, torch.float16):
        q = torch.zeros(1, 2, 8, 16, dtype=dt)
        wide = torch.zeros(1, 2, 8, 17, dtype=dt)
        assert A.resolve_flash_path(q, q, wide[..., 1:17]) == "kernel:contiguous"
        assert A.resolve_flash_path(q, wide[..., :16], q) == "kernel:contiguous"
    wide32 = wide.float()
    assert A.resolve_flash_path(q.float(), q.float(), wide32[..., 1:17]) == "kernel"
    qkv = torch.zeros(2, 8, 3 * 4 * 16, dtype=torch.bfloat16)
    views = [t.reshape(2, 8, 4, 16).transpose(1, 2) for t in qkv.split(64, -1)]
    assert A.resolve_flash_path(*views) == "kernel"


def test_routes_are_counted_and_zeroed():
    for path in A.FLASH_PATHS[1:]:
        assert f"{A.KERNEL}.{path}" in kernels.routes
    kernels.routes[f"{A.KERNEL}.kernel:padded"] += 3
    kernels.reset_launches()
    assert all(v == 0 for v in kernels.routes.values())


def test_cpu_tensors_are_not_routed():
    """Off the card every shape takes the plain version without counting a
    route: routes count only how a card's kernel took a call."""
    kernels.reset_launches()
    q = torch.randn(1, 2, 8, 48)
    out = A.mha(q, q, q)
    assert out.shape == q.shape
    assert sum(kernels.routes.values()) == 0


def test_direct_kernel_call_still_refuses_other_head_dims():
    """``flash_attention`` (the kernel's own wrapper) keeps raising on a
    head dim it has no instance for: only ``mha``/``gqa_mha`` pad."""
    q = torch.zeros(1, 2, 8, 48)
    with pytest.raises(ValueError, match="head dim"):
        A.flash_attention(q, q, q)
