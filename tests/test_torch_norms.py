"""The port's LayerNorm and RMSNorm against the JAX package's, on the CPU.

On CPU tensors ``ops.norms.layer_norm``/``rms_norm`` run their plain
versions (the CUDA kernels are held against those on the card, in
``test_torch_cuda.py`` and ``chip_smoke.py``).  The oracle is the JAX
package's ``ops.layer_norm``/``ops.rms_norm`` under both of its impls:
``xla`` and the Pallas kernel in interpret mode.  Inputs come from numpy
seeds.

Tolerances: f32 at 1e-5, the JAX package's own between its two impls
(``tests/test_ops.py``).  The offset rows sit at 1e4 + k/8 for integers k
whose row sum is a multiple of D: the mean and every partial sum are exact
in f32 in any order, so implementations agree, and the rows test the
two-pass variance (a one-pass E[x^2] - mean^2 loses a variance of ~1 to
f32 rounding at 1e8).  bf16: equal up to one bf16 rounding of the f32
result, 2^-7 |y| (plus 1e-5 for f32 differences before rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_scheduler_tpu.ops import norms as JN
from distributed_llm_scheduler_tpu_torch import ops
from distributed_llm_scheduler_tpu_torch.ops import kernels
from distributed_llm_scheduler_tpu_torch.ops import norms as TN

JAX_IMPLS = ("xla", "pallas_interpret")
F32_TOL = 1e-5


def _offset_rows(rng, shape):
    """1e4 + k/8 with integer k ~ 8 * N(0, 1), each row's k summing to a
    multiple of D: the mean (1e4 + j/8) and every partial sum of x and of
    (x - mean)^2 are exact in f32, in any order."""
    D = shape[-1]
    k = np.round(8.0 * rng.standard_normal(shape)).reshape(-1, D)
    for row in k:
        row[: int(row.sum()) % D] -= 1
    return (1e4 + k.reshape(shape) / 8.0).astype(np.float32)


def _case(kind, shape, seed):
    rng = np.random.default_rng(seed)
    D = shape[-1]
    if kind == "offset":
        x = _offset_rows(rng, shape)
    else:
        x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(D).astype(np.float32)
    b = rng.standard_normal(D).astype(np.float32)
    return x, g, b


# test_ops.py's shapes, a ragged width with 77 rows, and offset rows
LN_CASES = [("normal", (4, 16, 128)), ("normal", (2, 77, 100)),
            ("offset", (3, 128)), ("offset", (2, 5, 100))]
RMS_CASES = [("normal", (8, 128)), ("normal", (2, 77, 100)),
             ("normal", (1, 3, 4096))]


def _jax(fn, impl, *arrays, dtype=jnp.float32):
    return np.asarray(
        fn(*(jnp.asarray(a, dtype) for a in arrays), impl=impl), np.float32
    )


def _torch(fn, *arrays, dtype=torch.float32):
    return fn(*(torch.from_numpy(a).to(dtype) for a in arrays)).float().numpy()


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("kind,shape", LN_CASES)
def test_layer_norm_matches_jax_f32(kind, shape, impl):
    x, g, b = _case(kind, shape, seed=len(shape) + shape[-1])
    want = _jax(JN.layer_norm, impl, x, g, b)
    got = _torch(ops.layer_norm, x, g, b)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("kind,shape", RMS_CASES)
def test_rms_norm_matches_jax_f32(kind, shape, impl):
    x, g, _ = _case(kind, shape, seed=shape[-1])
    want = _jax(JN.rms_norm, impl, x, g)
    got = _torch(ops.rms_norm, x, g)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


def _one_bf16_rounding(got, want):
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-5)


@pytest.mark.parametrize("impl", JAX_IMPLS)
def test_norms_match_jax_bf16(impl):
    x, g, b = _case("normal", (2, 77, 100), seed=3)
    _one_bf16_rounding(
        _torch(ops.layer_norm, x, g, b, dtype=torch.bfloat16),
        _jax(JN.layer_norm, impl, x, g, b, dtype=jnp.bfloat16),
    )
    _one_bf16_rounding(
        _torch(ops.rms_norm, x, g, dtype=torch.bfloat16),
        _jax(JN.rms_norm, impl, x, g, dtype=jnp.bfloat16),
    )


def test_offset_rows_need_the_two_pass_variance():
    """On the offset rows the one-pass E[x^2] - mean^2 in f32 misses the
    exact output by far more than the tolerance; the plain version does
    not."""
    x, g, b = _case("offset", (3, 128), seed=0)
    x64 = x.astype(np.float64)
    mean = x64.mean(-1, keepdims=True)
    exact = (x64 - mean) / np.sqrt(x64.var(-1, keepdims=True) + 1e-5) * g + b
    got = _torch(ops.layer_norm, x, g, b)
    np.testing.assert_allclose(got, exact, rtol=0, atol=F32_TOL)
    var1 = (x * x).mean(-1, keepdims=True) - x.mean(-1, keepdims=True) ** 2
    one_pass = (x64 - mean) / np.sqrt(np.abs(var1) + 1e-5) * g + b
    assert np.abs(one_pass - exact).max() > 100 * F32_TOL


def test_plain_path_is_the_reference_and_counts_no_launch():
    x, g, b = (torch.from_numpy(a) for a in _case("normal", (4, 16, 128), 1))
    before = dict(kernels.launches)
    assert torch.equal(ops.layer_norm(x, g, b), TN.reference_layer_norm(x, g, b))
    assert torch.equal(ops.rms_norm(x, g), TN.reference_rms_norm(x, g))
    assert kernels.launches == before
    assert {TN.LN_KERNEL, TN.RMS_KERNEL} <= set(kernels.launches)


def test_meta_and_empty_inputs():
    g = torch.ones(64)
    x = torch.empty((2, 9, 64), device="meta", dtype=torch.bfloat16)
    for out in (ops.layer_norm(x, g.to("meta"), g.to("meta")),
                ops.rms_norm(x, g.to("meta"))):
        assert out.device.type == "meta"
        assert out.shape == x.shape and out.dtype == torch.bfloat16
    empty = torch.empty((0, 3, 64))
    for out in (ops.layer_norm(empty, g, g), ops.rms_norm(empty, g)):
        assert out.shape == empty.shape and out.numel() == 0


def test_wrong_width_raises():
    x = torch.zeros((2, 64))
    with pytest.raises(ValueError, match="width"):
        ops.layer_norm(x, torch.ones(32), torch.zeros(32))
    with pytest.raises(ValueError, match="width"):
        ops.rms_norm(x, torch.ones(65))
    # checked before the empty shortcut too
    with pytest.raises(ValueError, match="width"):
        ops.rms_norm(torch.zeros((0, 64)), torch.ones(65))


def test_kernel_wrappers_refuse_cpu_tensors():
    x, g, b = (torch.from_numpy(a) for a in _case("normal", (2, 128), 2))
    with pytest.raises(ValueError, match="CUDA"):
        TN.layer_norm_kernel(x, g, b)
    with pytest.raises(ValueError, match="CUDA"):
        TN.rms_norm_kernel(x, g)
