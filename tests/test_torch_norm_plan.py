"""The norm kernels' variant choice and the register path's arithmetic, on
the CPU.

``ops.norms.norm_plan`` picks, per call and on the host, between the two
kernels of ``csrc/norms.cu``: the register path (each row read once into
registers, 16-byte vectors, g and b held) and the streaming path (any
alignment, any width).  The tests pin its choices: the main paths' shapes
take the register path; unaligned, mixed-alignment, non-vector and too
long rows stream.

``_emulate`` repeats the register kernel's steps in plain torch: the
plan's (threads per row, vectors per thread) partition, vector ``j * TPR +
lane`` in a thread's slot ``j``, slots past the row's end masked; each
thread's f32 partial sums over its held vectors, the warp's butterfly
shuffle sum, the warps' sums added in order; the mean and then the
centred squares from the held row (two passes over registers); the write,
rounded once to x's dtype.  It is held against the JAX package's
``layer_norm``/``rms_norm`` (``xla`` and the Pallas kernel in interpret
mode) at the tolerances of ``tests/test_torch_norms.py``: 1e-5 in f32, one
bf16 rounding (2^-7 |y| + 1e-5) for bf16 values.  Nothing on the port's
paths calls the emulation.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_scheduler_tpu.ops import norms as JN
from distributed_llm_scheduler_tpu_torch.ops import kernels
from distributed_llm_scheduler_tpu_torch.ops import norms as TN

BF16, F32 = torch.bfloat16, torch.float32
JAX_IMPLS = ("xla", "pallas_interpret")
F32_TOL = 1e-5  # tests/test_torch_norms.py
EPS = 1e-5


def _plan(rows, D, dtype, stride=None, x=0, out=0, w=(0, 0)):
    return TN.norm_plan(rows, D, D if stride is None else stride, dtype,
                        x, out, w)


# (rows, D, dtype) -> (threads per row, vectors per thread)
MAIN_SHAPES = [
    ((512, 768, BF16), (32, 4)),    # GPT-2 flagship task
    ((8, 768, BF16), (32, 4)),      # GPT-2 decode step
    ((512, 4096, BF16), (128, 4)),  # Llama-3 8B task
    ((512, 768, F32), (128, 2)),    # GPT-2 f32 leg
    ((256, 4096, F32), (128, 8)),   # Llama-3 8B f32 leg
]


@pytest.mark.parametrize("shape,instance", MAIN_SHAPES, ids=str)
def test_main_shapes_take_the_register_path(shape, instance):
    rows, D, dtype = shape
    plan = _plan(rows, D, dtype)
    assert plan.variant == TN.REGISTER
    assert (plan.threads_per_row, plan.vecs_per_thread) == instance
    assert plan.blocks == -(-rows // (TN.THREADS // instance[0]))


# bf16 widths at the instances' edges: (D, instance or None = streaming)
BF16_BOUNDARIES = [
    (8, (32, 1)), (256, (32, 1)), (264, (32, 2)), (512, (32, 2)),
    (520, (32, 4)), (1024, (32, 4)), (1032, (128, 2)), (2048, (128, 2)),
    (4096, (128, 4)), (8192, (128, 8)), (8200, None),
    (257, None), (1025, None), (100, None),  # not whole 16-byte vectors
]


@pytest.mark.parametrize("D,instance", BF16_BOUNDARIES)
def test_bf16_width_boundaries(D, instance):
    plan = _plan(16, D, BF16)
    if instance is None:
        assert plan.variant == TN.STREAMING and plan.vecs_per_thread == 0
    else:
        assert plan.variant == TN.REGISTER
        assert (plan.threads_per_row, plan.vecs_per_thread) == instance


@pytest.mark.parametrize("D,instance", [(4, (32, 1)), (512, (32, 4)),
                                        (516, (128, 2)), (4096, (128, 8)),
                                        (4100, None), (1500, (128, 4)),
                                        (6, None)])
def test_f32_width_boundaries(D, instance):
    plan = _plan(16, D, F32)
    got = (plan.threads_per_row, plan.vecs_per_thread)
    assert (plan.variant == TN.REGISTER and got == instance) or (
        instance is None and plan.variant == TN.STREAMING)


@pytest.mark.parametrize("what,kwargs", [
    ("unaligned x base", dict(x=2)),
    ("mixed alignment", dict(x=16, out=8)),
    ("unaligned output", dict(out=4)),
    ("unaligned g", dict(w=(2, 0))),
    ("unaligned b", dict(w=(0, 6))),
    ("rows 3 elements apart", dict(stride=771)),
])
def test_what_the_register_path_does_not_take_streams(what, kwargs):
    plan = _plan(512, 768, BF16, **kwargs)
    assert plan.variant == TN.STREAMING, what
    assert plan.threads_per_row == 32  # a warp per row of <= 1,024
    assert plan.blocks == 512 // 4


def test_a_single_row_ignores_its_stride():
    assert _plan(1, 768, BF16, stride=771).variant == TN.REGISTER
    assert _plan(2, 768, BF16, stride=776).variant == TN.REGISTER


def test_streaming_geometry_matches_the_kernel():
    """The streaming launch gives a row of up to 1,024 elements a warp (4
    rows a block) and a longer row the block."""
    short, long_ = _plan(10, 1000, BF16, x=2), _plan(10, 9000, BF16)
    assert (short.threads_per_row, short.blocks) == (32, 3)
    assert (long_.threads_per_row, long_.blocks) == (128, 10)


def test_register_shapes_match_the_compiled_instances():
    src = (Path(TN.__file__).resolve().parent.parent / "csrc" / "norms.cu")
    compiled = tuple(
        (int(a), int(b))
        for a, b in re.findall(r"^\s*DLS_NORM_REG\((\d+), (\d+)\);",
                               src.read_text(), re.M))
    assert compiled == TN.REGISTER_SHAPES
    widths = [t * v for t, v in TN.REGISTER_SHAPES]
    assert widths == sorted(widths)  # smallest holding instance first


def test_per_variant_counts_exist():
    for name in (TN.LN_KERNEL, TN.RMS_KERNEL):
        for variant in (TN.REGISTER, TN.STREAMING):
            assert f"{name}.{variant}" in kernels.launches


def test_kernel_wrappers_refuse_grad():
    """The kernel wrappers take no plain version for an input that needs a
    gradient: such a call goes through the differentiable Function, whose
    forward is the same device launch, so a CPU tensor is refused there
    as it is under ``no_grad``."""
    x = torch.zeros((2, 64), requires_grad=True)
    g, b = torch.ones(64), torch.zeros(64)
    with pytest.raises(ValueError, match="CUDA"):
        TN.layer_norm_kernel(x, g, b)
    with pytest.raises(ValueError, match="CUDA"):
        TN.rms_norm_kernel(x.detach(), g.requires_grad_())
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        TN.layer_norm_kernel(x, g, b)
    # the CPU entry takes the plain version, which is differentiable
    TN.layer_norm(x, g, b).sum().backward()
    assert x.grad is not None


# -- the register path, emulated ------------------------------------------------

def _butterfly(s):
    """A warp's ``__shfl_xor_sync`` sum over the last axis (32 lanes):
    every lane ends with the same total."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        s = s + s[..., lanes ^ o]
    return s[..., 0]


def _row_total(partial, tpr):
    """Sum of the per-thread partials (rows, tpr): each warp's butterfly,
    then the warps' sums added in warp order."""
    warps = _butterfly(partial.reshape(partial.shape[0], tpr // 32, 32))
    total = warps[:, 0]
    for w in range(1, tpr // 32):
        total = total + warps[:, w]
    return total


def _thread_sum(vals):
    """Each thread's f32 sum over its slots, slot by slot, element by
    element: vals (rows, tpr, vpt, n) -> (rows, tpr)."""
    s = torch.zeros(vals.shape[:2])
    for j in range(vals.shape[2]):
        for k in range(vals.shape[3]):
            s = s + vals[:, :, j, k]
    return s


def _partition(D, plan, n):
    """Columns (tpr, vpt, n) each thread's slots hold, and which slots are
    live (the rest are masked: not loaded, held as zeros)."""
    tpr, vpt = plan.threads_per_row, plan.vecs_per_thread
    vi = torch.arange(vpt)[None, :] * tpr + torch.arange(tpr)[:, None]
    live = vi < D // n
    cols = vi[..., None] * n + torch.arange(n)
    return cols, live


def _emulate(kind, x, g, b, dtype):
    """The register kernel on (rows, D) f32 values (bf16-valued for
    ``dtype`` bf16), output rounded to ``dtype``."""
    rows, D = x.shape
    n = 16 // dtype.itemsize
    plan = _plan(rows, D, dtype)
    assert plan.variant == TN.REGISTER
    cols, live = _partition(D, plan, n)
    safe = cols.clamp(max=D - 1)
    held = torch.where(live[..., None], x[:, safe], 0.0)  # the registers
    gh, bh = g[safe], b[safe]
    tpr = plan.threads_per_row
    if kind == "ln":
        mean = _row_total(_thread_sum(held), tpr) / D
        c = torch.where(live[..., None], held - mean[:, None, None, None], 0.0)
        var = _row_total(_thread_sum(c * c), tpr) / D
        rstd = torch.rsqrt(var + EPS)[:, None, None, None]
        y = (held - mean[:, None, None, None]) * rstd * gh + bh
    else:
        ms = _row_total(_thread_sum(held * held), tpr) / D
        y = held * torch.rsqrt(ms + EPS)[:, None, None, None] * gh
    out = torch.full((rows, D), float("nan"))
    out[:, cols[live]] = y[:, live]  # live slots write, masked ones do not
    return out.to(dtype).float()


def _inputs(shape, seed, offset=False):
    rng = np.random.default_rng(seed)
    D = shape[-1]
    if offset:  # 1e4 + k/8, each row's k summing to a multiple of D
        k = np.round(8.0 * rng.standard_normal(shape))
        for row in k:
            row[: int(row.sum()) % D] -= 1
        x = 1e4 + k / 8.0
    else:
        x = rng.standard_normal(shape)
    g, b = rng.standard_normal(D), rng.standard_normal(D)
    return tuple(a.astype(np.float32) for a in (x, g, b))


def _jax(kind, impl, x, g, b, jdtype=jnp.float32):
    args = (x, g, b) if kind == "ln" else (x, g)
    fn = JN.layer_norm if kind == "ln" else JN.rms_norm
    return np.asarray(fn(*(jnp.asarray(a, jdtype) for a in args), impl=impl),
                      np.float32)


@pytest.mark.parametrize("D", [8, 768, 1032, 4096])
def test_partition_holds_every_column_once(D):
    plan = _plan(4, D, BF16)
    cols, live = _partition(D, plan, 8)
    held = cols[live].flatten()
    assert torch.equal(held.sort().values, torch.arange(D))
    assert plan.vecs_per_thread <= 8 and live.sum() == D // 8
    # masked slots are a thread's last ones: past the row's end
    assert (cols[~live][..., 0] >= D).all()


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("kind", ["ln", "rms"])
@pytest.mark.parametrize("D", [768, 4096, 100, 1500])
def test_emulated_register_path_matches_jax_f32(D, kind, impl):
    x, g, b = _inputs((5, D), seed=D)
    got = _emulate(kind, *(torch.from_numpy(a) for a in (x, g, b)), F32)
    np.testing.assert_allclose(got.numpy(), _jax(kind, impl, x, g, b),
                               rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("kind", ["ln", "rms"])
@pytest.mark.parametrize("D", [768, 4096])
def test_emulated_register_path_matches_jax_bf16(D, kind, impl):
    x, g, b = (torch.from_numpy(a).to(BF16).float()
               for a in _inputs((5, D), seed=D + 1))
    got = _emulate(kind, x, g, b, BF16).numpy()
    want = _jax(kind, impl, *(t.numpy() for t in (x, g, b)),
                jdtype=jnp.bfloat16)
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-5)


@pytest.mark.parametrize("D", [100, 128, 192])
def test_emulated_two_pass_variance_on_offset_rows(D):
    """Rows at 1e4: the centred squares from the held registers give the
    exact statistics (a one-pass E[x^2] - mean^2 would not).  Every
    partial sum of these rows is exact in f32 while D * 1e4 * 8 < 2^24,
    so D stays under 209 (D = 100: a masked slot on 7 lanes of the one
    vector each; 192: a second slot masked on 16)."""
    x, g, b = _inputs((4, D), seed=7, offset=True)
    got = _emulate("ln", *(torch.from_numpy(a) for a in (x, g, b)), F32)
    for impl in JAX_IMPLS:
        np.testing.assert_allclose(got.numpy(), _jax("ln", impl, x, g, b),
                                   rtol=0, atol=F32_TOL)
    x64 = x.astype(np.float64)
    exact = ((x64 - x64.mean(-1, keepdims=True))
             / np.sqrt(x64.var(-1, keepdims=True) + EPS) * g + b)
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=F32_TOL)
