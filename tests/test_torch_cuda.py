"""The port's CUDA kernels against their plain versions, on a GPU.

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


def _bf16_close(got, q, k, v, causal):
    """The bf16 kernel's rule against the plain version, K/V repeated."""
    group = q.shape[1] // k.shape[1]
    kr, vr = (t.repeat_interleave(group, dim=1) for t in (k, v))
    want = A.reference_mha(q, kr, vr, causal=causal)
    want32 = A.reference_mha(q.float(), kr.float(), vr.float(), causal=causal)
    _kernel_close(got, want, want32, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("T", [1, 77, 300])
def test_bf16_kernel_head_dims_and_ragged_lengths(cuda, hd, T):
    """Every head dim the tensor-core kernel is built for, at lengths that
    end inside a tile, under the causal and the full mask."""
    q, k, v = _qkv((2, 3, T, hd), torch.bfloat16, cuda, seed=hd + T)
    for causal in (True, False):
        before = kernels.launches[A.KERNEL]
        got = A.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert kernels.launches[A.KERNEL] == before + 1
        _bf16_close(got, q, k, v, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_reads_fewer_kv_heads_in_place(cuda, dtype):
    """``flash_attention`` with 8 query heads on 2 KV heads: one launch,
    the same output as the kernel on K/V repeated across each group."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 8, 200, 128)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 200, 128)).astype(np.float32))
            for _ in range(2))
    q, k, v = (t.to(cuda, dtype) for t in (q, k, v))
    before = kernels.launches[A.KERNEL]
    got = A.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launches[A.KERNEL] == before + 1
    kr, vr = (t.repeat_interleave(4, dim=1) for t in (k, v))
    assert torch.equal(got, A.flash_attention(q, kr, vr))
    if dtype == torch.bfloat16:
        _bf16_close(got, q, k, v, True)
    else:
        assert (got - A.reference_mha(q, kr, vr)).abs().max().item() < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
def test_bf16_kernel_reads_strided_qkv_views(cuda, hd):
    """Heads of one fused (B, T, 3*H*hd) bf16 product, as GPT-2 hands them
    to the kernel: bit for bit the output of contiguous copies."""
    (x,) = _qkv((2, 300, 3 * 4 * hd), torch.bfloat16, cuda, seed=hd)[:1]
    q, k, v = (t.reshape(2, 300, 4, hd).transpose(1, 2)
               for t in x.split(4 * hd, -1))
    before = kernels.launches[A.KERNEL]
    got = A.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launches[A.KERNEL] == before + 1
    want = A.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    _bf16_close(got, q, k, v, True)


@pytest.mark.cuda
def test_bf16_kernel_refuses_unaligned_rows(cuda):
    wide = torch.zeros((1, 2, 64, 72), device=cuda, dtype=torch.bfloat16)
    q = torch.zeros((1, 2, 64, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        A.flash_attention(q, wide[..., 4:68], q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_head_dim_16_runs_the_kernel(cuda, dtype, kv_heads):
    """Head dim 16 (Mixtral tiny's): ``mha`` and ``gqa_mha`` launch the
    flash kernel, in f32 and bf16, plain and GQA, allclose to
    ``reference_mha`` at the kernel tolerances (f32 1e-4, bf16 5e-2)."""
    rng = np.random.default_rng(16 + kv_heads)
    shape, kv = (2, 4, 77, 16), (2, kv_heads, 77, 16)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda, dtype) for s in (shape, kv, kv))
    kernels.reset_launches()
    got = (A.mha(q, k, v) if kv_heads == 4 else A.gqa_mha(q, k, v))
    torch.cuda.synchronize()
    assert kernels.launches[A.KERNEL] == 1
    assert sum(kernels.routes.values()) == 0
    kr, vr = (t.repeat_interleave(4 // kv_heads, dim=1) for t in (k, v))
    want = A.reference_mha(q, kr, vr)
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    assert (got.float() - want.float()).abs().max().item() < tol
    if dtype == torch.bfloat16:
        _bf16_close(got, q, k, v, True)


@pytest.mark.cuda
def test_resolver_routes_on_the_card(cuda):
    """On a card every call launches the kernel: a head dim without an
    instance on copies padded to the next one (counted), float16 GQA as
    given, a misaligned bf16 view on contiguous copies (counted, equal to
    the kernel on copies made by hand)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 2, 40, 48)).astype(np.float32)).to(cuda)
    kernels.reset_launches()
    out = A.mha(x, x, x)
    torch.cuda.synchronize()
    assert kernels.launches[A.KERNEL] == 1
    assert kernels.routes[f"{A.KERNEL}.kernel:padded"] == 1
    assert torch.allclose(out, A.reference_mha(x, x, x), atol=1e-4)
    h = x[..., :32].half()
    A.gqa_mha(h, h[:, :1], h[:, :1])
    torch.cuda.synchronize()
    assert kernels.launches[A.KERNEL] == 2
    wide = torch.from_numpy(rng.standard_normal((1, 2, 40, 33)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    view = wide[..., 1:33]
    q = view.contiguous()
    got = A.mha(q, view, view)
    torch.cuda.synchronize()
    assert kernels.routes[f"{A.KERNEL}.kernel:contiguous"] == 1
    assert kernels.launches[A.KERNEL] == 3
    assert torch.equal(got, A.flash_attention(q, q, q))
    with pytest.raises(ValueError, match="head dims up to 128"):
        A.mha(*(torch.zeros(1, 2, 8, 192, device=cuda) for _ in range(3)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("hd,kv_heads", [(8, 4), (48, 2), (80, 4), (96, 1),
                                         (64, 4), (128, 2)])
def test_every_head_dim_and_type_runs_the_kernel(cuda, dtype, hd, kv_heads):
    """Head dims between the instances (padded) and float16 (its own
    tensor-core instance): ``mha``/``gqa_mha`` launch the flash kernel
    once, allclose to ``reference_mha`` by the kernel rule of the type."""
    rng = np.random.default_rng(hd + kv_heads)
    shape, kv = (2, 4, 77, hd), (2, kv_heads, 77, hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda, dtype) for s in (shape, kv, kv))
    kernels.reset_launches()
    got = A.mha(q, k, v) if kv_heads == 4 else A.gqa_mha(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launches[A.KERNEL] == 1
    assert got.shape == q.shape
    kr, vr = (t.repeat_interleave(4 // kv_heads, dim=1) for t in (k, v))
    want = A.reference_mha(q, kr, vr)
    want32 = A.reference_mha(q.float(), kr.float(), vr.float())
    _kernel_close(got, want, want32, dtype)


# -- paged attention ----------------------------------------------------------

from distributed_llm_scheduler_tpu_torch.eval import decode_bench as DB  # noqa: E402

_SINGLE = [f[0] for f in DB._paged_op_parity_fixtures()]
_RAGGED = [f[0] for f in DB._ragged_op_parity_fixtures()]


def _args(case):
    return {k: v for k, v in case.items() if k not in ("name", "real")}


@pytest.mark.cuda
@pytest.mark.parametrize("kind,name", [("single", n) for n in _SINGLE]
                         + [("ragged", n) for n in _RAGGED])
def test_paged_kernels_meet_bench_fixtures(cuda, kind, name):
    """The decode bench's op-parity fixtures (trash page poisoned with
    1e9), kernel vs plain version on the card at the bench's 1e-5."""
    build = DB.paged_parity_cases if kind == "single" else DB.ragged_parity_cases
    case = next(c for c in build(device=cuda) if c["name"] == name)
    kname = A.PAGED_KERNEL if kind == "single" else A.PAGED_RAGGED_KERNEL
    before = kernels.launches[kname]
    res = DB.op_parity([case])
    torch.cuda.synchronize()
    assert kernels.launches[kname] == before + 1
    assert res["allclose"], res


@pytest.mark.cuda
@pytest.mark.parametrize("q_tokens", [1, 32])
def test_paged_kernels_at_the_serving_shape_bf16(cuda, q_tokens):
    """GPT-2 small serving shape in bf16: within 5e-2 of the plain version
    and every element within bf16 rounding (2^-8 |x| + 1e-4) of the
    plain version computed in f32 (real rows only for the ragged case)."""
    case = DB.serving_case(torch.bfloat16, cuda, seed=1, q_tokens=q_tokens)
    args = _args(case)
    got = A.paged_decode_attention(**args, impl="kernel").float()
    want = A.paged_decode_attention(**args, impl="plain").float()
    args32 = {k: (v.float() if torch.is_tensor(v) and v.is_floating_point() else v)
              for k, v in args.items()}
    want32 = A.paged_decode_attention(**args32, impl="plain")
    m = case["real"].expand_as(got) if "real" in case else torch.ones_like(got)
    assert torch.isfinite(got).all()
    assert ((got - want).abs() * m).max().item() < 5e-2
    assert (((got - want32).abs() - (2.0 ** -8 * want32.abs() + 1e-4)) * m
            ).max().item() <= 0


@pytest.mark.cuda
def test_paged_kernel_reads_strided_qkv_views(cuda):
    """q, k_new and v_new as head views of one fused qkv product, the
    layout the paged decode DAG hands the kernel."""
    case = DB.serving_case(torch.float32, cuda, seed=2)
    S, H, _, hd = case["q"].shape
    qkv = torch.randn(S, 1, 3 * H * hd, device=cuda)
    q, k, v = (t.reshape(S, 1, H, hd).transpose(1, 2)
               for t in qkv.split(H * hd, -1))
    args = dict(_args(case), q=q, k_new=k, v_new=v)
    got = A.paged_attention(**args)
    want = A.paged_attention(**dict(args, q=q.contiguous(), k_new=k.contiguous(),
                                     v_new=v.contiguous()))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    ref = A.paged_decode_attention(**args, impl="plain")
    assert (got - ref).abs().max().item() < 1e-4


# the single-token kernel's split edges (tests/test_torch_paged_split.py
# holds the same cases' arithmetic to the JAX package on the CPU): (S, Hq,
# Hkv, hd, page_size, pages_per_seq, lengths, insert, NaN poison); with
# page 16 a split spans 64 positions
_SPLIT_CASES = {
    "len0_insert_only": (2, 2, 2, 8, 16, 16, [0, 0], True, False),
    "len0_no_insert": (2, 2, 2, 8, 16, 16, [0, 9], False, False),
    "past_capacity": (2, 4, 2, 16, 16, 16, [256 + 7, 255], True, False),
    "insert_on_split_boundary": (3, 4, 2, 32, 16, 16, [64, 128, 192], True, False),
    "ends_at_span_end": (3, 4, 2, 32, 16, 16, [63, 127, 191], True, False),
    "empty_trailing_splits": (2, 4, 2, 16, 16, 16, [3, 70], True, False),
    "nan_trash_and_masked_tail": (2, 4, 2, 16, 16, 16, [20, 100], True, True),
    "gqa_4to1": (2, 8, 2, 16, 16, 16, [33, 200], True, False),
    "gqa_2to1_hd64": (3, 4, 2, 64, 16, 16, [5, 130, 255], True, False),
    "hd128": (2, 2, 2, 128, 16, 16, [77, 250], True, False),
    "hd8_page5": (3, 4, 2, 8, 5, 40, [4, 64, 199], True, False),
    # S * Hkv >= 132: fewer, longer splits (6 of 96 positions)
    "slots16_heads12": (16, 12, 12, 64, 16, 32, None, True, False),
    # 1,056 blocks per split already: one split, no combine launch
    "one_split": (88, 12, 12, 64, 16, 8, None, True, False),
}


def _split_case(name, dtype, device, seed=11):
    """One case's tensors (pages in order, trash page 0 behind unused
    entries) and, when poisoned, the same call with the trash page and
    each slot's masked tail rows set to NaN."""
    S, Hq, Hkv, hd, ps, ppseq, lengths, insert, poison = _SPLIT_CASES[name]
    rng = np.random.default_rng(seed)
    cap = ps * ppseq
    if lengths is None:
        lengths = rng.integers(0, cap, size=S).tolist()

    def draw(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            device=device, dtype=dtype)

    pt = np.zeros((S, ppseq), np.int32)
    page = 1
    for s, L in enumerate(lengths):
        for j in range(-(-min(L + 1, cap) // ps)):
            pt[s, j] = page
            page += 1
    case = dict(q=draw((S, Hq, 1, hd)), k_pool=draw((S * ppseq + 1, ps, Hkv, hd)),
                v_pool=draw((S * ppseq + 1, ps, Hkv, hd)),
                page_table=torch.from_numpy(pt).to(device),
                lengths=torch.tensor(lengths, dtype=torch.int32, device=device),
                sm_scale=hd ** -0.5)
    if insert:
        case["k_new"], case["v_new"] = draw((S, Hkv, 1, hd)), draw((S, Hkv, 1, hd))
    poisoned = None
    if poison:
        poisoned = dict(case, k_pool=case["k_pool"].clone(),
                        v_pool=case["v_pool"].clone())
        for pool in (poisoned["k_pool"], poisoned["v_pool"]):
            pool[0] = float("nan")
            for s, L in enumerate(lengths):
                last = min(L, cap - 1)
                pool[int(pt[s, last // ps]), last % ps + 1:] = float("nan")
    return case, poisoned


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(_SPLIT_CASES))
def test_paged_kernel_split_edges(cuda, name, dtype):
    """The split kernel and its combine at each split edge, against the
    plain version (on the un-poisoned pools for the NaN case: the poison
    must change nothing): f32 within 1e-4; bf16 within 5e-2 of the plain
    version and every element within 2^-8 |x| + 1e-4 of it in f32."""
    case, poisoned = _split_case(name, dtype, cuda)
    before = kernels.launches[A.PAGED_KERNEL]
    got = A.paged_decode_attention(**(poisoned or case), impl="kernel").float()
    torch.cuda.synchronize()
    assert kernels.launches[A.PAGED_KERNEL] == before + 1
    assert torch.isfinite(got).all()
    want = A.paged_decode_attention(**case, impl="plain").float()
    if dtype == torch.float32:
        assert (got - want).abs().max().item() < 1e-4
        return
    want32 = A.paged_decode_attention(**{
        k: (v.float() if torch.is_tensor(v) and v.is_floating_point() else v)
        for k, v in case.items()}, impl="plain")
    assert (got - want).abs().max().item() < 5e-2
    assert ((got - want32).abs() > 2.0 ** -8 * want32.abs() + 1e-4).sum().item() == 0


@pytest.mark.cuda
def test_paged_kernel_refuses_unqualified_geometry(cuda):
    case = DB.serving_case(torch.float32, cuda, seed=3, head_dim=48)
    with pytest.raises(ValueError, match="head_dim 48"):
        A.paged_decode_attention(**_args(case))


# the ragged kernel's tensor-core variant (tests/test_torch_paged_ragged_split.py
# holds the same arithmetic to the JAX package on the CPU): (S, Hq, Hkv, hd,
# page_size, pages_per_seq, Tn, [(L, q_len), ...] or None for drawn spans)
_RAGGED_TC_CASES = {
    "llama_width_gqa": (8, 32, 8, 128, 16, 32, 16, None),
    "llama_width_128_rows": (8, 32, 8, 128, 16, 32, 32, None),
    "two_row_tiles": (2, 64, 8, 128, 16, 16, 32, None),
    "chunk_48": (8, 12, 12, 64, 16, 32, 48, None),
    "one_token_q_lens": (8, 12, 12, 64, 16, 32, 1, None),
    "gqa_rows_not_16": (2, 6, 2, 32, 16, 8, 7, [(40, 7), (3, 5)]),
    "lengths_at_capacity": (2, 4, 2, 16, 16, 4, 8, [(61, 8), (63, 1)]),
    "idle_and_short_slots": (3, 4, 4, 64, 16, 16, 8, [(16, 0), (3, 4), (240, 8)]),
    "hd8_page5": (3, 4, 2, 8, 5, 40, 8, [(4, 8), (64, 3), (190, 8)]),
    "page_size_1": (1, 2, 2, 64, 1, 600, 4, [(590, 4)]),
}


def _ragged_tc_case(name, device, seed=13):
    """One bf16 ragged call (pages in order, each slot's pages covering
    every position its rows see, the trash page 0 behind the rest) and
    the same call with the trash page and each slot's rows past its last
    visible position set to NaN, which must change nothing."""
    S, Hq, Hkv, hd, ps, ppseq, Tn, spans = _RAGGED_TC_CASES[name]
    rng = np.random.default_rng(seed)
    cap = ps * ppseq
    if spans is None:
        spans = list(zip(rng.integers(0, cap - Tn + 1, size=S).tolist(),
                         rng.integers(0, Tn + 1, size=S).tolist()))

    def draw(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)

    pt = np.zeros((S, ppseq), np.int32)
    page = 1
    tops = [min(L + max(QL, 1), cap) for L, QL in spans]
    for s, top in enumerate(tops):
        for j in range(-(-top // ps)):
            pt[s, j] = page
            page += 1
    case = dict(q=draw((S, Hq, Tn, hd)), k_pool=draw((S * ppseq + 1, ps, Hkv, hd)),
                v_pool=draw((S * ppseq + 1, ps, Hkv, hd)),
                page_table=torch.from_numpy(pt).to(device),
                lengths=torch.tensor([L for L, _ in spans], dtype=torch.int32,
                                     device=device),
                q_lens=torch.tensor([QL for _, QL in spans], dtype=torch.int32,
                                    device=device),
                sm_scale=hd ** -0.5)
    poisoned = dict(case, k_pool=case["k_pool"].clone(), v_pool=case["v_pool"].clone())
    for pool in (poisoned["k_pool"], poisoned["v_pool"]):
        pool[0] = float("nan")
        for s, top in enumerate(tops):
            pool[int(pt[s, (top - 1) // ps]), (top - 1) % ps + 1:] = float("nan")
    return case, poisoned


def _ragged_tc_close(got, case, real=None):
    """bf16 kernel output against the plain version on the card: within
    5e-2 of it in bf16 and every element (of ``real`` rows) within 2^-8 |x|
    + 1e-4 of it in f32."""
    want = A.reference_paged_attention_ragged(**case).float()
    want32 = A.reference_paged_attention_ragged(**{
        k: (v.float() if torch.is_tensor(v) and v.is_floating_point() else v)
        for k, v in case.items()})
    m = torch.ones_like(got) if real is None else real.expand_as(got).float()
    assert torch.isfinite(got).all()
    assert ((got - want).abs() * m).max().item() < 5e-2
    beyond = (got - want32).abs() > 2.0 ** -8 * want32.abs() + 1e-4
    assert (beyond & m.bool()).sum().item() == 0


def _tc_launches():
    return kernels.launches[f"{A.PAGED_RAGGED_KERNEL}.{A.RAGGED_TC}"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 6])
def test_ragged_tc_kernel_at_the_serving_chunk(cuda, seed):
    """The GPT-2 serving chunk (8, 12, 32, 64) bf16 runs on the
    tensor-core variant, within the bf16 rule of the f32 plain version on
    its real rows."""
    case = DB.serving_case(torch.bfloat16, cuda, seed=seed, q_tokens=32)
    before = _tc_launches()
    got = A.paged_decode_attention(**_args(case)).float()
    torch.cuda.synchronize()
    assert _tc_launches() == before + 1
    _ragged_tc_close(got, _args(case), case["real"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_RAGGED_TC_CASES))
def test_ragged_tc_kernel_edges(cuda, name):
    """Llama-width GQA chunks (one and two row tiles), the 48-token chunk,
    one token with q_lens, M-tiles straddling heads, lengths at the
    capacity, idle and short slots (splits past every visible position),
    hd 8 padded to 16, a page size of 1: every row (padding rows
    included) within the bf16 rule, the NaN poison changing nothing."""
    case, poisoned = _ragged_tc_case(name, cuda)
    before = _tc_launches()
    got = A.paged_attention_ragged(**poisoned).float()
    torch.cuda.synchronize()
    assert _tc_launches() == before + 1
    _ragged_tc_close(got, case)


@pytest.mark.cuda
def test_ragged_variant_counts(cuda):
    """Each launch counts under the kernel and under the variant its plan
    names: an f32 bench fixture on the walk kernel, a bf16 chunk on the
    tensor cores."""
    f32 = DB.ragged_parity_cases(device=cuda)[0]
    bf16 = DB.serving_case(torch.bfloat16, cuda, seed=4, q_tokens=32)
    kernels.reset_launches()
    A.paged_decode_attention(**_args(f32))
    A.paged_decode_attention(**_args(bf16))
    torch.cuda.synchronize()
    assert kernels.launches[A.PAGED_RAGGED_KERNEL] == 2
    assert kernels.launches[f"{A.PAGED_RAGGED_KERNEL}.{A.RAGGED_WALK}"] == 1
    assert kernels.launches[f"{A.PAGED_RAGGED_KERNEL}.{A.RAGGED_TC}"] == 1


@pytest.mark.cuda
def test_ragged_kernel_raises_on_a_geometry_no_variant_takes(cuda):
    """bf16 at a page size of 1 and 8,193 pages per slot: no split keeps
    within 1,024 page ids, so the call raises and launches nothing."""
    q = torch.zeros(1, 2, 4, 64, dtype=torch.bfloat16, device=cuda)
    pool = torch.zeros(2, 1, 2, 64, dtype=torch.bfloat16, device=cuda)
    pt = torch.zeros(1, 8193, dtype=torch.int32, device=cuda)
    n = torch.tensor([3], dtype=torch.int32, device=cuda)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="no split count"):
        A.paged_decode_attention(q, pool, pool, pt, n, q_lens=n)
    assert kernels.launches[A.PAGED_RAGGED_KERNEL] == 0


# -- LayerNorm / RMSNorm -------------------------------------------------------

from distributed_llm_scheduler_tpu_torch.ops import norms as N  # noqa: E402


def _norm_inputs(shape, dtype, device, seed, offset=False, pad=0, g_dtype=None):
    """x (a view into a wider, offset buffer when ``pad``), g and b from
    numpy ``seed``; ``offset`` rows sit at 1e4 + k/8 with each row's
    integer k summing to a multiple of D (exact f32 sums)."""
    rng = np.random.default_rng(seed)
    D = shape[-1]
    if offset:
        k = np.round(8.0 * rng.standard_normal(shape)).reshape(-1, D)
        for row in k:
            row[: int(row.sum()) % D] -= 1
        x = 1e4 + k.reshape(shape) / 8.0
    else:
        x = rng.standard_normal(shape)
    x = torch.from_numpy(x.astype(np.float32)).to(device=device, dtype=dtype)
    if pad:
        wide = torch.zeros(shape[:-1] + (D + 2 * pad,), dtype=dtype, device=device)
        wide[..., pad:pad + D] = x
        x = wide[..., pad:pad + D]  # strided rows, unaligned base
    g, b = (torch.from_numpy(rng.standard_normal(D).astype(np.float32))
            .to(device=device, dtype=g_dtype or dtype) for _ in range(2))
    return x, g, b


def _kernel_close(got, want, want32, dtype):
    """f32: within 1e-4 of the plain version (summation order).  bf16 and
    f16: within 5e-2 of the plain version and every element within the
    type's unit roundoff (2^-8 for bf16, 2^-11 for f16, times |y|, plus
    1e-4) of the plain version computed in f32."""
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        assert (got - want).abs().max().item() < 1e-4
        return
    roundoff = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -11
    assert (got.float() - want.float()).abs().max().item() < 5e-2
    assert ((got.float() - want32).abs() - (roundoff * want32.abs() + 1e-4)
            ).max().item() <= 0


NORM_CASES = [
    # (kernel, shape, dtype, offset, pad, g dtype): the main paths' shapes,
    # then f32, ragged widths over 77 rows, strided rows, the long-row
    # (block per row) path with a tail, offset rows, mixed weight dtype
    ("ln", (1, 512, 768), torch.bfloat16, False, 0, None),
    ("ln", (8, 1, 768), torch.bfloat16, False, 0, None),
    ("rms", (1, 512, 4096), torch.bfloat16, False, 0, None),
    ("ln", (1, 512, 768), torch.float32, False, 0, None),
    ("rms", (1, 512, 4096), torch.float32, False, 0, None),
    ("ln", (77, 100), torch.float32, False, 0, None),
    ("rms", (77, 100), torch.float32, False, 0, None),
    ("ln", (77, 128), torch.bfloat16, False, 0, None),
    ("rms", (77, 128), torch.bfloat16, False, 0, None),
    ("ln", (3, 40, 100), torch.bfloat16, False, 3, None),
    ("rms", (3, 40, 128), torch.float32, False, 1, None),
    ("ln", (5, 1500), torch.float32, False, 0, None),
    ("rms", (5, 1500), torch.bfloat16, False, 5, None),
    ("ln", (4, 128), torch.float32, True, 0, None),
    ("ln", (4, 100), torch.float32, True, 0, None),
    ("rms", (2, 64, 4096), torch.bfloat16, False, 0, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", NORM_CASES, ids=lambda c: "-".join(map(str, c)))
def test_norm_kernels_match_plain(cuda, case):
    kind, shape, dtype, offset, pad, g_dtype = case
    x, g, b = _norm_inputs(shape, dtype, cuda, seed=len(shape) * 1000 + shape[-1],
                           offset=offset, pad=pad, g_dtype=g_dtype)
    name = N.LN_KERNEL if kind == "ln" else N.RMS_KERNEL
    before = kernels.launches[name]
    # offset rows: the plain version on the card takes the mean as
    # sum * (1/D), one rounding off these rows' exact mean (an ulp of 1e4
    # is ~1e-3); on the CPU it divides, exactly, as the kernel does
    where = torch.device("cpu") if offset else cuda
    xw, gw, bw = (t.to(where) for t in (x, g, b))
    if kind == "ln":
        got = N.layer_norm(x, g, b)
        want = N.reference_layer_norm(xw, gw, bw)
        want32 = N.reference_layer_norm(xw.float(), gw.float(), bw.float())
    else:
        got = N.rms_norm(x, g)
        want = N.reference_rms_norm(xw, gw)
        want32 = N.reference_rms_norm(xw.float(), gw.float())
    want, want32 = want.to(cuda), want32.to(cuda)
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 1
    assert got.shape == x.shape and got.dtype == dtype
    _kernel_close(got, want, want32, dtype)


@pytest.mark.cuda
def test_norm_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros((4, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        N.rms_norm(x, torch.ones(64, device=cuda, dtype=torch.float16))
    y = torch.zeros((64, 4), device=cuda).t()
    with pytest.raises(ValueError, match="stride 1"):
        N.rms_norm(y, torch.ones(64, device=cuda))


@pytest.mark.cuda
def test_gqa_mha_at_the_llama_shape(cuda):
    """Llama-3 8B's attention per microbatch: q (1, 32, 512, 128) bf16 with
    8 KV heads, through the flash kernel (one launch on the un-repeated K
    and V), against the plain version."""
    from distributed_llm_scheduler_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.llama3_8b()
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((1, H, 512, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, Hkv, 512, hd)).astype(np.float32))
            for _ in range(2))
    q, k, v = (t.to(cuda, torch.bfloat16) for t in (q, k, v))
    before = kernels.launches[A.KERNEL]
    got = A.gqa_mha(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launches[A.KERNEL] == before + 1
    kr, vr = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
    want = A.reference_mha(q, kr, vr)
    want32 = A.reference_mha(q.float(), kr.float(), vr.float())
    _kernel_close(got, want, want32, torch.bfloat16)


# -- the register and streaming norm kernels --------------------------------------

NORM_VARIANT_CASES = [
    # (kernel, shape, dtype, offset, pad, g dtype, variant norm_plan picks):
    # bf16 widths at the register instances' edges (8 elements a vector; a
    # warp holds up to 1,024 a row, a 128-thread block up to 8,192), one
    # above the largest, and widths that are not whole vectors
    ("ln", (33, 8), torch.bfloat16, False, 0, None, "register"),
    ("rms", (33, 256), torch.bfloat16, False, 0, None, "register"),
    ("ln", (33, 257), torch.bfloat16, False, 0, None, "streaming"),
    ("ln", (33, 768), torch.bfloat16, False, 0, None, "register"),
    ("rms", (33, 1024), torch.bfloat16, False, 0, None, "register"),
    ("ln", (33, 1025), torch.bfloat16, False, 0, None, "streaming"),
    ("ln", (33, 1032), torch.bfloat16, False, 0, None, "register"),
    ("rms", (9, 4096), torch.bfloat16, False, 0, None, "register"),
    ("ln", (9, 8192), torch.bfloat16, False, 0, None, "register"),
    ("rms", (9, 8192), torch.bfloat16, False, 0, None, "register"),
    ("ln", (9, 8200), torch.bfloat16, False, 0, None, "streaming"),
    # f32 rows: 4 elements a vector, up to 4,096 a row
    ("ln", (9, 4096), torch.float32, False, 0, None, "register"),
    ("rms", (9, 4100), torch.float32, False, 0, None, "streaming"),
    ("ln", (33, 516), torch.float32, False, 0, None, "register"),
    # mixed weight dtypes, the largest instance's register load among them
    ("ln", (9, 8192), torch.bfloat16, False, 0, torch.float32, "register"),
    ("rms", (9, 8192), torch.bfloat16, False, 0, torch.float32, "register"),
    ("ln", (33, 768), torch.float32, False, 0, torch.bfloat16, "register"),
    ("rms", (9, 4096), torch.float32, False, 0, torch.bfloat16, "register"),
    # strided rows: 16 bytes in (aligned) and 8 bytes in (unaligned)
    ("ln", (3, 40, 768), torch.bfloat16, False, 8, None, "register"),
    ("rms", (3, 40, 768), torch.bfloat16, False, 4, None, "streaming"),
    ("ln", (3, 40, 4096), torch.float32, False, 4, None, "register"),
    # offset rows, held against the CPU: a masked slot on some lanes
    ("ln", (4, 192), torch.float32, True, 0, None, "register"),
    ("rms", (4, 192), torch.float32, True, 0, None, "register"),
    # more rows than the card holds blocks: the grid-stride loop, g and b
    # held across rows, the reduction buffers reused
    ("ln", (20000, 768), torch.bfloat16, False, 0, None, "register"),
    ("ln", (3000, 4096), torch.bfloat16, False, 0, None, "register"),
    ("rms", (3000, 4096), torch.bfloat16, False, 0, None, "register"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", NORM_VARIANT_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_norm_kernel_variants(cuda, case):
    kind, shape, dtype, offset, pad, g_dtype, variant = case
    x, g, b = _norm_inputs(shape, dtype, cuda, seed=len(shape) * 7000 + shape[-1],
                           offset=offset, pad=pad, g_dtype=g_dtype)
    name = N.LN_KERNEL if kind == "ln" else N.RMS_KERNEL
    before = {k: kernels.launches[k] for k in
              (name, f"{name}.{N.REGISTER}", f"{name}.{N.STREAMING}")}
    where = torch.device("cpu") if offset else cuda
    xw, gw, bw = (t.to(where) for t in (x, g, b))
    if kind == "ln":
        got = N.layer_norm(x, g, b)
        want = N.reference_layer_norm(xw, gw, bw)
        want32 = N.reference_layer_norm(xw.float(), gw.float(), bw.float())
    else:
        got = N.rms_norm(x, g)
        want = N.reference_rms_norm(xw, gw)
        want32 = N.reference_rms_norm(xw.float(), gw.float())
    want, want32 = want.to(cuda), want32.to(cuda)
    torch.cuda.synchronize()
    assert kernels.launches[name] == before[name] + 1
    assert kernels.launches[f"{name}.{variant}"] == before[f"{name}.{variant}"] + 1
    assert got.shape == x.shape and got.dtype == dtype
    _kernel_close(got, want, want32, dtype)


@pytest.mark.cuda
def test_norm_kernels_refuse_grad(cuda):
    """A norm call that needs a gradient launches the kernel for its
    forward (no plain forward on a card) and differentiates through the
    recompute: its grads equal autograd of the plain version; a call with
    no grad launches the same kernel and keeps no graph."""
    torch.manual_seed(0)
    x = torch.randn(4, 768, device=cuda, requires_grad=True)
    g = (1 + 0.1 * torch.randn(768, device=cuda)).requires_grad_()
    b = (0.1 * torch.randn(768, device=cuda)).requires_grad_()
    dy = torch.randn(4, 768, device=cuda)
    for name, fn, plain, ws in (
            (N.LN_KERNEL, N.layer_norm, N.reference_layer_norm, (g, b)),
            (N.RMS_KERNEL, N.rms_norm, N.reference_rms_norm, (g,))):
        before = kernels.launches[name]
        out = fn(x, *ws)
        assert kernels.launches[name] == before + 1 and out.grad_fn is not None
        got = torch.autograd.grad(out, (x, *ws), dy)
        want = torch.autograd.grad(plain(x, *ws), (x, *ws), dy)
        assert kernels.launches[name] == before + 1  # the backward recomputes
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4)
        with torch.no_grad():
            out = fn(x, *ws)
        assert out.grad_fn is None and kernels.launches[name] == before + 2


# -- the flash path's backward ----------------------------------------------------

FLASH_GRAD_CASES = [
    # (entry, q shape, KV heads, dtype, causal): GPT-2 tiny's attention in
    # f32, full attention, GQA 4:1 at a ragged T, and bf16 at the main
    # paths' head dims
    ("mha", (1, 4, 128, 32), 4, torch.float32, True),
    ("mha", (1, 4, 128, 32), 4, torch.float32, False),
    ("gqa_mha", (1, 8, 77, 64), 2, torch.float32, True),
    ("mha", (1, 4, 128, 64), 4, torch.bfloat16, True),
    ("gqa_mha", (1, 8, 128, 128), 2, torch.bfloat16, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_GRAD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_path_is_differentiable(cuda, case):
    """dq, dk and dv through the kernel path against autograd of the plain
    version: f32 at 2e-4 (the loss also feeds the output back, so the
    kernel's forward enters the cotangent); bf16 under the bf16 rule
    against the same plain autograd in bf16.  dk and dv keep the KV heads;
    the forward is one launch and the backward launches nothing."""
    entry, shape, kv_heads, dtype, causal = case
    B, H, T, hd = shape
    rng = np.random.default_rng(sum(shape) + kv_heads)
    q, cot = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
              .to(cuda, dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, kv_heads, T, hd))
                             .astype(np.float32)).to(cuda, dtype)
            for _ in range(2))

    def loss(out):
        if dtype == torch.float32:
            return (out * cot).sum() + 0.5 * (out * out).sum()
        return (out.float() * cot.float()).sum()

    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    before = kernels.launches[A.KERNEL]
    out = getattr(A, entry)(*ins, causal=causal)
    assert out.grad_fn is not None
    loss(out).backward()
    torch.cuda.synchronize()
    assert kernels.launches[A.KERNEL] == before + 1

    refs = [t.clone().requires_grad_() for t in (q, k, v)]
    group = H // kv_heads
    loss(A.reference_mha(refs[0], refs[1].repeat_interleave(group, 1),
                         refs[2].repeat_interleave(group, 1),
                         causal=causal)).backward()
    for name, t, r in zip("qkv", ins, refs):
        assert t.grad.shape == r.shape, name
        if dtype == torch.float32:
            assert (t.grad - r.grad).abs().max().item() < 2e-4, name
        else:
            want = r.grad.float()
            assert torch.isfinite(t.grad).all(), name
            assert ((t.grad.float() - want).abs()
                    - (2.0 ** -8 * want.abs() + 1e-4)).max().item() <= 0, name


@pytest.mark.cuda
def test_flash_grads_land_in_the_fused_qkv(cuda):
    """q, k and v as strided head views of one (B, T, 3*H*hd) product:
    the gradient lands in the parent, as autograd of the plain version
    puts it."""
    (x,) = _qkv((2, 64, 3 * 128), torch.float32, cuda)[:1]
    cot = torch.randn(2, 2, 64, 64, device=cuda)

    def grad_of(attend):
        xx = x.clone().requires_grad_()
        q, k, v = (t.reshape(2, 64, 2, 64).transpose(1, 2)
                   for t in xx.split(128, -1))
        (attend(q, k, v) * cot).sum().backward()
        return xx.grad

    got = grad_of(A.mha)
    want = grad_of(A.reference_mha)
    assert (got - want).abs().max().item() < 2e-4


@pytest.mark.cuda
def test_flash_under_no_grad_takes_the_launcher(cuda):
    q, k, v = (t.requires_grad_() for t in _qkv((1, 4, 128, 64), torch.bfloat16, cuda))
    before = kernels.launches[A.KERNEL]
    with torch.no_grad():
        out = A.mha(q, k, v)
    assert out.grad_fn is None
    assert kernels.launches[A.KERNEL] == before + 1


# -- the north-star bench's pieces on the card ---------------------------------

@pytest.mark.cuda
def test_calibrate_link_measures_the_host_link(cuda):
    from distributed_llm_scheduler_tpu_torch.utils.linkmodel import calibrate_link

    cal = calibrate_link([cuda], sizes=(1 << 10, 1 << 20, 1 << 24), repeats=3)
    assert cal.provenance["param_load"] == "measured"
    assert cal.param_load_gbps > 0 and cal.latency_s > 0
    assert cal.provenance["interconnect"].startswith("estimated(h100 ")
    assert len(cal.samples["param_load"]) == 3
    # the latency is the 1 KB copy's best time, not a clamped intercept
    assert cal.latency_s == cal.samples["param_load"][0][1] > 1e-6


@pytest.mark.cuda
def test_calibrate_link_measures_the_peer_link(cuda):
    """With two cards the interconnect leg is a measured peer copy."""
    from distributed_llm_scheduler_tpu_torch.utils.linkmodel import calibrate_link

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    cal = calibrate_link([torch.device("cuda", 0), torch.device("cuda", 1)],
                         sizes=(1 << 10, 1 << 20, 1 << 24, 1 << 26), repeats=3)
    assert cal.provenance == {"param_load": "measured",
                              "interconnect": "measured"}
    assert cal.interconnect_gbps > cal.param_load_gbps > 0
    assert 0 < cal.latency_s < 1e-3
    print(f"host {cal.param_load_gbps:.3f} GB/s, peer "
          f"{cal.interconnect_gbps:.3f} GB/s, latency {cal.latency_s * 1e6:.3f} us")


@pytest.mark.cuda
def test_preflight_footprints_cover_outputs_and_never_lower(cuda):
    import distributed_llm_scheduler_tpu_torch as P
    from distributed_llm_scheduler_tpu_torch.utils.hbm import preflight_task_memory

    dag = P.build_gpt2_dag(P.GPT2Config.tiny(dtype=torch.bfloat16), batch=4,
                           seq_len=32, microbatches=2, vocab_shards=4)
    graph = P.fuse_linear_chains(dag.graph)
    pinned = next(iter(graph))
    pinned.memory_required = 5.0
    before = {t.task_id: t.memory_required for t in graph}
    gb = preflight_task_memory(graph, dag.init_params(device=cuda),
                               dag.make_inputs(device=cuda))
    assert set(gb) == {t.task_id for t in graph}
    for t in graph:
        assert gb[t.task_id] * 1024**3 >= t.out_bytes > 0, t.task_id
        assert t.memory_required == max(before[t.task_id], gb[t.task_id])
    assert pinned.memory_required == 5.0


@pytest.mark.cuda
def test_bench_runs_the_tiny_bf16_config(cuda):
    from distributed_llm_scheduler_tpu_torch.eval import bench

    result = bench.run("tiny", cuda, reps=2)
    assert result.oracle_ok is True
    assert result.mfu_single_chip is not None and result.mfu_single_chip > 0
    assert result.link_provenance.startswith("cuda:measured,")
    assert not result.fallback and result.node_hbm_gb > 0
    assert result.preflight_max_gb > 0
    line = result.to_json()
    assert line["metric"].endswith("_policies_cuda")
    assert line["launches"]["per_task"][A.KERNEL] > 0


# -- the execution ladder: streams per node, captured segments, one graph ----

def _ladder_setup(cuda, policy, n):
    import distributed_llm_scheduler_tpu_torch as P

    dag = P.build_gpt2_dag(P.GPT2Config.tiny(dtype=torch.bfloat16), batch=4,
                           seq_len=32, microbatches=2, vocab_shards=4)
    graph = P.fuse_linear_chains(dag.graph)
    cluster = P.Cluster.from_torch_devices([cuda] * n)
    sched = P.get_scheduler(policy).schedule(graph, cluster)
    assert not sched.failed
    return (P.DeviceBackend(cluster), graph, sched,
            dag.init_params(device=cuda), dag.make_inputs(device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("policy,n", [("greedy", 1), ("heft", 4)])
def test_captured_rungs_equal_the_planned_path_over_replays(cuda, policy, n):
    """The captured segments (unbatched) and the one-graph program give the
    planned path's output bit for bit, run after run; the rebatched
    segments stay within the bf16 band of it."""
    backend, graph, sched, params, ids = _ladder_setup(cuda, policy, n)
    want = backend.execute(graph, sched, params, ids).output.clone()
    per_task = backend.execute(graph, sched, params, ids, planned=False)
    assert torch.equal(per_task.output, want)
    for kw in (dict(segments=True, rebatch=False), dict(compiled=True),
               dict(segments=True)):
        for i in range(3):
            rep = backend.execute(graph, sched, params, ids, reps=2,
                                  warmup=i == 0, **kw)
            torch.cuda.synchronize()
            if kw.get("rebatch", True) and kw.get("segments"):
                err = (rep.output.float() - want.float()).abs().max().item()
                assert err < 5e-2, (kw, i, err)
            else:
                assert torch.equal(rep.output, want), (kw, i)
            assert rep.captured_launches, kw
    assert rep.n_dispatches <= per_task.n_dispatches


@pytest.mark.cuda
@pytest.mark.parametrize("rung", ["per_task", "planned", "segments", "compiled"])
def test_a_cross_node_edge_waits_on_its_producer(cuda, rung):
    """Two nodes of one card run on two streams; the producer spins before
    it writes, so a consumer that did not wait on its event would read the
    zeros."""
    import distributed_llm_scheduler_tpu_torch as P

    def slow_ones(p, x):
        out = torch.zeros(1 << 20, device=x.device)
        torch.cuda._sleep(20_000_000)
        return out.fill_(1.0)

    graph = P.TaskGraph([
        P.Task("a", 0.1, 0.1, [], fn=slow_ones),
        P.Task("b", 0.1, 0.1, ["a"], fn=lambda p, x: x * 2.0),
    ], name="edge").freeze()
    cluster = P.Cluster([P.DeviceState(n, 1.0, torch_device=cuda)
                         for n in ("n0", "n1")])
    sched = P.Schedule(policy="hand", per_node={"n0": ["a"], "n1": ["b"]},
                       assignment_order=["a", "b"])
    backend = P.DeviceBackend(cluster)
    s0, s1 = backend.stream_of("n0"), backend.stream_of("n1")
    assert s0 is not None and s1 is not None and s0 != s1
    assert torch.cuda.current_stream(cuda) not in (s0, s1)
    kw = {"per_task": dict(planned=False), "planned": {},
          "segments": dict(segments=True), "compiled": dict(compiled=True)}[rung]
    rep = backend.execute(graph, sched, {}, torch.zeros(1, device=cuda),
                          reps=2, **kw)
    torch.cuda.synchronize()
    assert rep.transfer_edges == 1
    assert torch.equal(rep.output, torch.full((1 << 20,), 2.0, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(compiled=True), dict(segments=True)],
                         ids=["compiled", "segments"])
def test_a_task_that_reads_to_the_host_fails_the_capture(cuda, kw):
    import distributed_llm_scheduler_tpu_torch as P

    graph = P.TaskGraph([
        P.Task("a", 0.1, 0.1, [], fn=lambda p, x: x + 1.0),
        P.Task("b", 0.1, 0.1, ["a"],
               fn=lambda p, x: x * float(x.sum().item())),
    ], name="readback").freeze()
    cluster = P.Cluster.from_torch_devices([cuda])
    sched = P.get_scheduler("greedy").schedule(graph, cluster)
    with pytest.raises(RuntimeError):
        P.DeviceBackend(cluster).execute(
            graph, sched, {}, torch.ones(4, device=cuda), **kw)
    torch.cuda.synchronize()
    # eager rungs read to the host freely, and the card still works
    rep = P.DeviceBackend(cluster).execute(
        graph, sched, {}, torch.ones(4, device=cuda))
    assert rep.output.sum().item() == 4 * 2.0 * 8.0


@pytest.mark.cuda
def test_launch_counts_per_rung(cuda):
    """Eager rungs count each launch as it runs; a captured rung's wrappers
    count once in its warm-up and once in the capture, never at replay,
    the report carries the kernels in the graphs one run replays, and
    every replay adds those to ``kernels.replayed``."""
    from distributed_llm_scheduler_tpu_torch.ops import norms as N

    backend, graph, sched, params, ids = _ladder_setup(cuda, "greedy", 1)
    mb, layers = 2, 2
    per_forward = {A.KERNEL: mb * layers, N.LN_KERNEL: mb * (2 * layers + 1)}
    rebatched = {A.KERNEL: layers, N.LN_KERNEL: 2 * layers + 1}

    def counted(**kw):
        kernels.reset_launches()
        rep = backend.execute(graph, sched, params, ids, reps=3, **kw)
        torch.cuda.synchronize()
        return rep, ({k: kernels.launches[k] for k in per_forward},
                     {k: kernels.replayed.get(k, 0) for k in per_forward})

    for kw in (dict(planned=False), {}, dict(coalesce=True)):
        rep, (got, replayed) = counted(**kw)
        assert got == {k: v * 4 for k, v in per_forward.items()}, kw
        assert rep.captured_launches == {}
        assert replayed == {k: 0 for k in per_forward}, kw
    for kw, per_run in ((dict(segments=True), rebatched),
                        (dict(segments=True, rebatch=False), per_forward),
                        (dict(compiled=True), per_forward)):
        rep, (got, replayed) = counted(**kw)
        assert {k: rep.captured_launches[k] for k in per_run} == per_run, kw
        assert got == {k: 2 * v for k, v in per_run.items()}, kw
        assert replayed == {k: 4 * v for k, v in per_run.items()}, kw
        rep, (got, replayed) = counted(warmup=False, **kw)  # replays only
        assert got == {k: 0 for k in per_run}, kw
        assert replayed == {k: 3 * v for k, v in per_run.items()}, kw
    assert rep.n_dispatches == 2  # the input copy and the replay


@pytest.mark.cuda
def test_a_captured_program_reads_fixed_inputs_in_place(cuda):
    """An input named fixed is not copied: the graph reads the caller's
    tensor itself, sees its new contents at each replay, and refuses
    another tensor; other inputs are copied into static buffers."""
    from distributed_llm_scheduler_tpu_torch.backends.device import (
        CapturedProgram,
    )

    prog = CapturedProgram(lambda p, ext: ext["a"] * 2.0 + ext["b"],
                           torch.cuda.Stream(device=cuda))
    a, b = torch.ones(8, device=cuda), torch.zeros(8, device=cuda)
    out = prog({}, {"a": a, "b": b}, frozenset({"a"}))
    torch.cuda.synchronize()
    assert prog.static_in["a"] is a and prog.static_in["b"] is not b
    assert torch.equal(out, torch.full((8,), 2.0, device=cuda))
    a.fill_(3.0)
    out = prog({}, {"a": a, "b": torch.ones(8, device=cuda)}, frozenset({"a"}))
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full((8,), 7.0, device=cuda))
    with pytest.raises(RuntimeError, match="read in place"):
        prog({}, {"a": a.clone(), "b": b}, frozenset({"a"}))


@pytest.mark.cuda
def test_segments_of_a_node_share_one_memory_pool(cuda):
    """Under heft x4 each node's captured segments share one pool (they
    replay in capture order on its stream) and no two nodes share one
    (their segments run at once); the programs are cached as a whole."""
    from distributed_llm_scheduler_tpu_torch.backends.device import (
        CapturedProgram,
    )

    backend, graph, sched, params, ids = _ladder_setup(cuda, "heft", 4)
    placed, _ = backend.place_params(graph, sched, params)
    order = backend.dispatch_order(graph, sched)
    segs = backend.build_segments(graph, sched, order)
    fns = backend._segment_programs(graph, segs, True, placed)
    assert all(isinstance(f, CapturedProgram) for f in fns)
    pool_of = {}
    for (node, _t, _e), f in zip(segs, fns):
        assert pool_of.setdefault(node, f.pool) == f.pool
    assert len(set(pool_of.values())) == len(pool_of) > 1
    assert backend._segment_programs(graph, segs, True, placed) is fns


@pytest.mark.cuda
def test_node_streams_are_shared_across_backends(cuda):
    """The k-th node of a card runs on the card's k-th node stream in every
    backend, so a new backend adds no stream (and no cuBLAS workspace,
    which a stream keeps for the life of the process)."""
    import distributed_llm_scheduler_tpu_torch as P

    one = P.DeviceBackend(P.Cluster.from_torch_devices([cuda] * 4))
    two = P.DeviceBackend(P.Cluster.from_torch_devices([cuda] * 2))
    streams = [one.stream_of(f"core_{i}") for i in range(4)]
    assert len(set(streams)) == 4
    assert [two.stream_of(f"core_{i}") for i in range(2)] == streams[:2]


# -- parameter streaming: copy stream, events, deferred frees ----------------

def _stream_setup(cuda, n=1, policy="greedy"):
    """GPT-2 small widths at 2 layers (bf16), params on the host, pinned."""
    import distributed_llm_scheduler_tpu_torch as P
    from distributed_llm_scheduler_tpu_torch.backends.device import pin_params

    dag = P.build_gpt2_dag(P.GPT2Config.small(n_layer=2, dtype=torch.bfloat16),
                           batch=2, seq_len=64, microbatches=2)
    graph = dag.graph
    cluster = P.Cluster.from_torch_devices([cuda] * n)
    sched = P.get_scheduler(policy).schedule(graph, cluster)
    assert not sched.failed
    params = pin_params(dag.init_params(device="cpu"))
    return P.DeviceBackend(cluster), graph, sched, params, dag.make_inputs(
        device=cuda)


@pytest.mark.cuda
def test_streaming_under_heavy_block_reuse_is_bit_equal(cuda):
    """A budget that holds one task's params: every load evicts, and the
    allocator hands each freed block to the next load at once.  Over
    several runs each streamed output equals the unstreamed one bit for
    bit, per task and segmented (no re-batching)."""
    backend, graph, sched, params, ids = _stream_setup(cuda)
    biggest = max(sum(graph.param_size_gb(g) for g in t.params_needed)
                  for t in graph)
    for kw in (dict(planned=False), dict(segments=True, rebatch=False)):
        backend.cluster.devices[0].total_memory = 16.0
        want = backend.execute(graph, sched, params, ids, **kw).output.clone()
        backend.cluster.devices[0].total_memory = biggest
        for _ in range(3):
            rep = backend.execute(graph, sched, params, ids,
                                  stream_params=True, **kw)
            torch.cuda.synchronize()
            assert rep.param_evictions > 0 and rep.streamed
            assert torch.equal(rep.output, want), kw


@pytest.mark.cuda
def test_stream_params_refuses_params_on_the_card(cuda):
    backend, graph, sched, params, ids = _stream_setup(cuda)
    on_card = {k: v.to(cuda) for k, v in params.items()}
    with pytest.raises(ValueError, match="on a card"):
        backend.execute(graph, sched, on_card, ids, stream_params=True)


@pytest.mark.cuda
def test_stream_params_refuses_unpinned_host_params(cuda):
    """Pinning is the caller's, once: execute copies no params itself."""
    backend, graph, sched, params, ids = _stream_setup(cuda)
    pageable = {k: v.clone() for k, v in params.items()}
    backend.cluster.devices[0].total_memory = 0.4 * graph.total_param_gb()
    with pytest.raises(ValueError, match="not pinned"):
        backend.execute(graph, sched, pageable, ids, stream_params=True)


@pytest.mark.cuda
def test_calibrate_link_measures_the_sustained_leg(cuda):
    from distributed_llm_scheduler_tpu_torch.utils.linkmodel import calibrate_link

    cal = calibrate_link([cuda], sizes=(1 << 20, 1 << 24), repeats=3,
                         sustained=True)
    assert cal.sustained_gbps > 0
    assert cal.provenance["sustained"] == "measured"
    assert [b for b, _ in cal.samples["sustained"]] == [8 << 24, 8 << 24]
    # the burst leg stays as it was: pageable copies
    assert cal.param_load_gbps > 0
    assert calibrate_link([cuda], sizes=(1 << 20, 1 << 24),
                          repeats=1).sustained_gbps is None


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(), dict(segments=True, rebatch=False)],
                         ids=["per_task", "segments"])
def test_no_captured_rung_runs_under_stream_params(cuda, kw):
    """Streamed segments are eager programs: nothing is captured or
    replayed, and each forward (warm-up and timed run) launches every
    kernel of its tasks (segments not re-batched, so one per task)."""
    from distributed_llm_scheduler_tpu_torch.ops import norms as N

    backend, graph, sched, params, ids = _stream_setup(cuda)
    backend.cluster.devices[0].total_memory = 0.4 * graph.total_param_gb()
    kernels.reset_launches()
    rep = backend.execute(graph, sched, params, ids, stream_params=True, **kw)
    torch.cuda.synchronize()
    assert rep.captured_launches == {} and not rep.compiled
    assert not any(kernels.replayed.values())
    n_attn = sum(1 for t in graph if t.task_id.endswith("_attention"))
    n_ln = sum(1 for t in graph
               if t.task_id.endswith(("_ln1", "_ln2", "final_ln")))
    assert kernels.launches[A.KERNEL] == 2 * n_attn
    assert kernels.launches[N.LN_KERNEL] == 2 * n_ln


@pytest.mark.cuda
def test_multi_node_streamed_output_equals_unstreamed(cuda):
    """heft x4 on one card, each node capped at half its own union: each
    node streams on its own budget, loads go on the card's copy stream,
    and the output equals the unstreamed run's bit for bit."""
    backend, graph, sched, params, ids = _stream_setup(cuda, 4, "heft")
    want = backend.execute(graph, sched, params, ids,
                           planned=False).output.clone()
    capped = 0
    for d in backend.cluster:
        union = {g for t in sched.per_node.get(d.node_id, ())
                 for _, g in graph[t].param_items()}
        if union:
            d.total_memory = 0.5 * sum(graph.param_size_gb(g) for g in union)
            capped += 1
    assert capped > 1
    rep = backend.execute(graph, sched, params, ids, stream_params=True)
    torch.cuda.synchronize()
    assert rep.param_evictions > 0
    assert torch.equal(rep.output, want)


# -- the serving layer ---------------------------------------------------------

def _serve_reqs():
    """Seeded requests at the serve bench's geometry (capacity 32): 8- and
    24-token prompts (24 takes three 8-token chunks), one long generation
    in three."""
    rng = np.random.default_rng(31)
    reqs = []
    for i in range(8):
        plen = (8, 24)[i % 2]
        ids = rng.integers(0, 512, size=(1, plen), dtype=np.int32)
        ids[0, :8] = 7  # one shared first page
        reqs.append((f"c{i}", ids, 32 - plen if i % 3 == 0 else min(3 + i, 32 - plen)))
    return reqs


def _serve_run(device, sharing, chunk, preempt):
    """The serve bench's tiny f32 engine on ``device``: the requests in two
    waves, ``c0`` preempted after two segments and resumed from its
    prefix when ``preempt``.  Returns {rid: tokens}, passes stitched."""
    from distributed_llm_scheduler_tpu_torch.eval import serve_bench as SB
    from distributed_llm_scheduler_tpu_torch.serve import VirtualClock

    eng, _ = SB.build_serve_engine(sharing=sharing, chunk_tokens=chunk,
                                   clock=VirtualClock(), device=device)
    reqs = _serve_reqs()
    for rid, ids, gen in reqs[:4]:
        eng.submit(rid, ids, gen)
    eng.step_segment()
    eng.step_segment()
    res = None
    if preempt:
        res = eng.preempt("c0")
        eng.submit("c0#p1", np.concatenate([reqs[0][1], res["tokens"][None]], 1),
                   res["remaining"])
    for rid, ids, gen in reqs[4:]:
        eng.submit(rid, ids, gen)
    out = {k: np.asarray(v) for k, v in eng.run().items()}
    if res is not None:
        out["c0"] = np.concatenate([res["tokens"], out.pop("c0#p1")])
    assert eng.page_occupancy()["free_pages"] == eng.pool.n_pages - 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("sharing,chunk,preempt", [
    (False, None, False), (False, 8, False), (True, None, False),
    (False, None, True), (True, 8, True)])
def test_serve_engine_on_the_card_equals_the_cpu(cuda, sharing, chunk, preempt):
    """The serving engine in f32 on the card (the kernels) and on the CPU
    (the plain versions), from the same numpy weights, with chunked
    prefill, prefix sharing and a preempted request resumed: every
    request's tokens equal."""
    kernels.reset_launches()
    card = _serve_run(cuda, sharing, chunk, preempt)
    torch.cuda.synchronize()
    assert kernels.launches[A.PAGED_KERNEL] > 0
    host = _serve_run(torch.device("cpu"), sharing, chunk, preempt)
    assert sorted(card) == sorted(host)
    for rid in host:
        np.testing.assert_array_equal(card[rid], host[rid], err_msg=rid)


@pytest.mark.cuda
@pytest.mark.parametrize("admission", ["fifo", "slo"])
def test_frontend_virtual_clock_leg_on_the_card_equals_the_cpu(cuda, admission):
    """The serve bench's frontend leg on a virtual clock, on the card and
    on the CPU: equal digests (request rows and every token)."""
    from distributed_llm_scheduler_tpu_torch.eval import serve_bench as SB
    from distributed_llm_scheduler_tpu_torch.obs import SLOPolicy
    from distributed_llm_scheduler_tpu_torch.serve import (
        ServiceTimeModel, VirtualClock, poisson_arrivals)

    sc = SB.SCENARIO
    arrivals = poisson_arrivals(
        sc["rate_rps"], sc["n_requests"], 7, prompt_lens=sc["prompt_lens"],
        max_new_tokens=sc["max_new_tokens"], priorities=sc["priorities"],
        priority_weights=sc["priority_weights"])
    policy = SLOPolicy(ttft_s=sc["ttft_s"], window_s=sc["window_s"],
                       percentile=sc["percentile"])
    tm = ServiceTimeModel(wave_s=sc["wave_s"], segment_s=sc["segment_s"],
                          idle_s=sc["idle_s"])
    legs = {}
    for where in (cuda, torch.device("cpu")):
        eng, _ = SB.build_serve_engine(clock=VirtualClock(), device=where)
        legs[where.type] = SB.run_serving_leg(
            arrivals, policy, admission, admission == "slo", tm, engine=eng)
    assert legs["cuda"]["digest"] == legs["cpu"]["digest"]
    assert legs["cuda"]["pages_leaked"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(segments=True), dict(compiled=True)],
                         ids=["segments", "compiled"])
def test_traced_captured_rung_windows_come_from_cuda_events(cuda, kw):
    """On a captured rung each node's span is the replay's window on the
    card (CUDA events on the host clock): inside the ``execute`` span,
    starting after its host replay call began, one per segment (or one
    ``program`` span per node); the output is bit-equal to the untraced
    run and the attribution tiles its makespan."""
    from distributed_llm_scheduler_tpu_torch.obs import Tracer
    from distributed_llm_scheduler_tpu_torch.obs.export import (
        chrome_events, validate_trace)

    backend, graph, sched, params, ids = _ladder_setup(cuda, "heft", 4)
    off = backend.execute(graph, sched, params, ids, **kw).output.clone()
    tr = Tracer()
    rep = backend.execute(graph, sched, params, ids, trace=tr, reps=2, **kw)
    torch.cuda.synchronize()
    assert torch.equal(rep.output, off)
    ex = next(e for e in tr.events if e["name"] == "execute")
    replays = [e for e in tr.events if e["name"] == "replay"]
    nodes = set(sched.placement.values())
    dev = [e for e in tr.events if e["type"] == "span"
           and e["track"] in nodes]
    want = "program" if "compiled" in kw else "launch"
    assert dev and {e["cat"] for e in dev} == {want}
    first_replay = min(e["t0"] for e in replays)
    for e in dev:
        assert ex["t0"] <= e["t0"] <= e["t1"] <= ex["t1"]
        assert e["t0"] >= first_replay
    if "segments" in kw:
        assert len(dev) == len(replays) == 2 * rep.n_dispatches
    assert validate_trace({"traceEvents": chrome_events(tr)}) == []
    att = rep.attribution
    assert att is not None and att["critical_path"]
    assert abs(sum(att["breakdown_s"].values()) - att["makespan_s"]) < 1e-9


@pytest.mark.cuda
def test_memprof_reconciles_the_allocator_peak(cuda):
    """On a card the memory profile carries the allocator's peak
    (``allocated_bytes.all.peak``) as the platform source, beside the
    model-derived one, for every node of the card."""
    from distributed_llm_scheduler_tpu_torch.obs import MemoryProfiler

    backend, graph, sched, params, ids = _ladder_setup(cuda, "heft", 4)
    mem = MemoryProfiler()
    rep = backend.execute(graph, sched, params, ids, memprof=mem)
    peak = torch.cuda.memory_stats(cuda)["allocated_bytes.all.peak"]
    assert mem.verify() == []
    for node, entry in rep.memory["devices"].items():
        assert entry["source"] == "platform", node
        assert entry["platform_peak_bytes"] == peak
        assert entry["platform_peak_bytes"] >= entry["peak_bytes"] > 0


@pytest.mark.cuda
def test_fleet_restart_gives_back_pages_and_device_memory(cuda):
    """Three replicas of the serve engine share the card; a restart
    through ``rebind_obs`` returns the replica's pages and its device
    memory: ``memory_allocated`` comes back to its level before (taken
    once the engine has captured its segment graph, whose static buffers
    live as long as the engine)."""
    from distributed_llm_scheduler_tpu_torch.eval import serve_bench as SB
    from distributed_llm_scheduler_tpu_torch.serve import (
        EngineRegistry, VirtualClock, prompt_token_ids)

    engines = {rid: SB.build_serve_engine(clock=VirtualClock(), device=cuda)[0]
               for rid in ("n0", "n1", "n2")}

    def factory(rid, *, clock=None, metrics=None):
        engines[rid].rebind_obs(clock=clock, metrics=metrics)
        return engines[rid]

    reg = EngineRegistry(factory)
    for rid in engines:
        reg.add(rid)
    eng = reg.get("n1").engine
    vocab = int(eng.config.vocab_size)
    eng.submit("warm", prompt_token_ids("warm", 8, vocab, 0), 4)
    eng.run()
    eng.reset()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    for i in range(3):
        eng.submit(f"r{i}", prompt_token_ids(f"r{i}", 8, vocab, 0), 12)
    eng.step_segment()
    assert eng.pool.used_pages > 0
    eng.begin_drain()
    reg.restart("n1")
    torch.cuda.synchronize()
    assert eng.pool.used_pages == 0 and not eng.draining
    assert torch.cuda.memory_allocated(cuda) == before


def _cyclic(graph):
    """Copies of ``graph``'s tasks with its first task waiting on its last
    (left unfrozen: freezing it raises)."""
    import dataclasses

    import distributed_llm_scheduler_tpu_torch as P

    order = graph.topo_order
    tasks = [dataclasses.replace(t, dependencies=list(t.dependencies))
             for t in graph.tasks()]
    next(t for t in tasks if t.task_id == order[0]).dependencies.append(
        order[-1])
    return P.TaskGraph(tasks, name=graph.name)


def _with_lists(sched, **per_node):
    import distributed_llm_scheduler_tpu_torch as P

    lists = {n: list(ts) for n, ts in sched.per_node.items()}
    lists.update(per_node)
    return P.Schedule(policy="edited", per_node=lists,
                      assignment_order=list(sched.assignment_order),
                      completed=set(sched.completed))


@pytest.mark.cuda
@pytest.mark.parametrize("defect", ["task on two nodes", "cycle"])
def test_the_gate_refuses_on_the_card_before_any_launch(cuda, defect):
    """``execute`` (planned and compiled), ``CompiledSchedule.build`` and
    ``paged_decode_engine`` refuse a corrupt schedule or graph on the card
    with ``AnalysisError``, and no kernel launches."""
    import distributed_llm_scheduler_tpu_torch as P
    from distributed_llm_scheduler_tpu_torch.analysis import AnalysisError
    from distributed_llm_scheduler_tpu_torch.backends.compiled_schedule import (
        CompiledSchedule,
    )

    backend, graph, sched, params, ids = _ladder_setup(cuda, "heft", 4)
    cfg = P.GPT2Config.tiny(dtype=torch.bfloat16)
    paged = P.build_paged_decode_dag(cfg, slots=2, page_size=4, n_pages=16,
                                     pages_per_seq=4)
    two = P.Cluster.from_torch_devices([cuda] * 2)
    p_sched = P.get_scheduler("greedy").schedule(paged.graph, two)
    p_home = next(n for n, ts in p_sched.per_node.items() if ts)
    if defect == "cycle":
        graph, p_graph = _cyclic(graph), _cyclic(paged.graph)
    else:
        first = sched.assignment_order[0]
        other = next(n for n in sched.per_node if n != sched.placement[first])
        sched = _with_lists(sched, **{other: [first] + sched.per_node[other]})
        p_other = next(n for n in ("core_0", "core_1") if n != p_home)
        p_graph = paged.graph
        p_sched = _with_lists(
            p_sched, **{p_other: [p_sched.per_node[p_home][0]]})
    kernels.reset_launches()
    runs = (
        lambda: backend.execute(graph, sched, params, ids),
        lambda: backend.execute(graph, sched, params, ids, compiled=True),
        lambda: CompiledSchedule.build(backend, graph, sched, {}, ids),
        lambda: P.DeviceBackend(two).paged_decode_engine(
            p_graph, p_sched, cfg, {}, P.PagePool(16), slots=2,
            pages_per_seq=4),
    )
    want = "DAG001" if defect == "cycle" else "SCH003"
    for run in runs:
        with pytest.raises(AnalysisError) as e:
            run()
        assert e.value.report.has(want)
    torch.cuda.synchronize()
    assert not any(kernels.launches.values())
    assert not any(kernels.replayed.values())


@pytest.mark.cuda
def test_skip_analysis_turns_the_gate_off_on_the_card(cuda, monkeypatch):
    from distributed_llm_scheduler_tpu_torch.analysis import AnalysisError

    backend, graph, sched, params, ids = _ladder_setup(cuda, "heft", 4)
    clean = backend.execute(graph, sched, params, ids).output.clone()
    bogus = _with_lists(sched, bogus=[])
    with pytest.raises(AnalysisError):
        backend.execute(graph, bogus, params, ids)
    monkeypatch.setenv("DLS_SKIP_ANALYSIS", "1")
    assert torch.equal(backend.execute(graph, bogus, params, ids).output,
                       clean)


@pytest.mark.cuda
def test_analyze_on_the_card_equals_the_cpu(cuda):
    """``analyze()`` over a schedule on nodes of the card, bf16 params as
    meta tensors: equal, diagnostic for diagnostic, to the call on CPU
    nodes of the same budgets, and no kernel launches."""
    import distributed_llm_scheduler_tpu_torch as P
    from distributed_llm_scheduler_tpu_torch.analysis import analyze

    dag = P.build_gpt2_dag(P.GPT2Config.tiny(dtype=torch.bfloat16), batch=4,
                           seq_len=32, microbatches=2, vocab_shards=4)
    graph = P.fuse_linear_chains(dag.graph)
    card = P.Cluster.from_torch_devices([cuda] * 4)
    host = P.Cluster([P.DeviceState(d.node_id, d.total_memory,
                                    torch_device=torch.device("cpu"))
                      for d in card])
    sched = P.get_scheduler("heft").schedule(graph, card)
    kw = dict(params=dag.param_specs, graph_input=dag.input_spec)
    kernels.reset_launches()
    a, b = analyze(graph, card, sched, **kw), analyze(graph, host, sched, **kw)
    torch.cuda.synchronize()
    assert [(d.code, d.message) for d in a.diagnostics] == [
        (d.code, d.message) for d in b.diagnostics]
    assert a.ok and not any(kernels.launches.values())


@pytest.mark.cuda
@pytest.mark.parametrize("policy,kw", [("refine", dict(max_evals=60)),
                                       ("search", dict(budget=40))])
def test_searched_placements_run_on_the_card(cuda, policy, kw):
    """The searches' placements execute planned and compiled on 4 nodes of
    the card: compiled bit-equal to planned, within the bf16 band of the
    fused forward (the bench's ``oracle_close``)."""
    import distributed_llm_scheduler_tpu_torch as P

    dag = P.build_gpt2_dag(P.GPT2Config.tiny(dtype=torch.bfloat16), batch=4,
                           seq_len=32, microbatches=2, vocab_shards=4)
    graph = P.fuse_linear_chains(dag.graph)
    cluster = P.Cluster.from_torch_devices([cuda] * 4)
    sched = P.get_scheduler(policy, seed=0, **kw).schedule(graph, cluster)
    assert not sched.failed
    params, ids = dag.init_params(device=cuda), dag.make_inputs(device=cuda)
    backend = P.DeviceBackend(cluster)
    planned = backend.execute(graph, sched, params, ids).output.clone()
    compiled = backend.execute(graph, sched, params, ids, compiled=True)
    assert torch.equal(compiled.output, planned)
    from distributed_llm_scheduler_tpu_torch.eval.benchlib import oracle_close

    assert oracle_close(dag.reference_forward(params, ids), planned,
                        "bfloat16")


# -- the training step and the Mixtral DAG (BASELINE.json configs #5, #4) ----------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_backward_on_the_card_equals_autograd_of_the_plain_version(cuda, dtype):
    """Both norms at a training shape: the kernel's forward, the backward
    by recompute; gradients equal autograd of the plain version (the same
    recompute, so bit for bit in f32 and bf16)."""
    torch.manual_seed(1)
    x = torch.randn(2, 64, 768, device=cuda, dtype=dtype, requires_grad=True)
    g = (1 + 0.1 * torch.randn(768, device=cuda, dtype=dtype)).requires_grad_()
    b = (0.1 * torch.randn(768, device=cuda, dtype=dtype)).requires_grad_()
    dy = torch.randn_like(x)
    for name, fn, plain, ws in (
            (N.LN_KERNEL, N.layer_norm, N.reference_layer_norm, (g, b)),
            (N.RMS_KERNEL, N.rms_norm, N.reference_rms_norm, (g,))):
        before = kernels.launches[name]
        got = torch.autograd.grad(fn(x, *ws), (x, *ws), dy)
        want = torch.autograd.grad(plain(x, *ws), (x, *ws), dy)
        assert kernels.launches[name] == before + 1
        for a, w in zip(got, want):
            assert a.dtype == w.dtype and torch.equal(a, w)


def _train_step_pair(cuda):
    import distributed_llm_scheduler_tpu_torch as P

    dag = P.build_gpt2_train_dag(P.GPT2Config.tiny(), batch=2, seq_len=16, lr=1e-2)
    params = dag.init_params(seed=0, device=cuda)
    inputs = dag.make_inputs(device=cuda)
    return P, dag, params, inputs


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, dict(segments=True), dict(compiled=True)],
                         ids=["planned", "segments", "compiled"])
def test_train_dag_on_two_nodes_of_the_card(cuda, kw):
    """The tiny training step placed by mru on 2 nodes of the card, on the
    planned rung and the captured ones (autograd inside the captured
    tasks): within the JAX test's tolerances of the fused oracle step, 2
    flash and 4 LayerNorm launches per layer and 1 more per step (a
    captured rung: at its warm-up and capture, and its graphs' replays
    counted at each replay).  A segment of tasks that launch nothing
    (``batch``, ``step_out``) captures an empty graph."""
    P, dag, params, inputs = _train_step_pair(cuda)
    want = dag.reference_forward(params, inputs)
    # each node at 0.55x the step's footprint on one node (the train bench's
    # pressure), so the step must spread
    one = P.Cluster.from_torch_devices([cuda])
    s1 = P.get_scheduler("greedy").schedule(dag.graph, one)
    step = max(P.validate_schedule(dag.graph, one, s1).peak_no_evict_gb.values())
    cluster = P.Cluster.from_torch_devices([cuda] * 2, hbm_cap_gb=0.55 * step)
    s = P.get_scheduler("mru").schedule(dag.graph, cluster)
    assert not s.failed and len({n for n in s.placement.values()}) == 2
    L = dag.config.n_layer
    per_step = {A.KERNEL: 2 * L, N.LN_KERNEL: 4 * L + 1}
    kernels.reset_launches()
    rep = P.DeviceBackend(cluster).execute(dag.graph, s, params, inputs, **kw)
    torch.cuda.synchronize()
    assert rep.transfer_edges > 0
    got = {k: kernels.launches[k] for k in per_step}
    assert got == {k: 2 * n for k, n in per_step.items()}  # warm-up + run
    if kw:  # captured: the warm-up run and the run replay the graphs
        assert {k: kernels.replayed[k] for k in per_step} == {
            k: 2 * n for k, n in per_step.items()}
    torch.testing.assert_close(rep.output["loss"], want["loss"],
                               rtol=1e-5, atol=0)
    for k, w in want["params"].items():
        torch.testing.assert_close(rep.output["params"][k], w,
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
def test_routed_mixtral_dag_on_the_card(cuda):
    """The tiny routed Mixtral DAG (bf16, 2 microbatches, drops) placed by
    mru on 4 nodes of the card, planned and compiled: 1 flash and 2
    RMSNorm launches per layer and microbatch plus the final norms,
    outputs equal to the per-microbatch routed oracle under the bf16
    rule."""
    import distributed_llm_scheduler_tpu_torch as P

    cfg = P.MixtralConfig.tiny(dtype=torch.bfloat16)
    dag = P.build_moe_dag(cfg, batch=4, seq_len=16, microbatches=2, routed=True,
                          capacity_factor=0.75)
    params = dag.init_params(seed=0, device=cuda)
    ids = dag.make_inputs(seed=1, device=cuda)
    want = dag.reference_forward(params, ids).float()
    total = dag.graph.total_param_gb()
    cluster = P.Cluster.from_torch_devices([cuda] * 4, hbm_cap_gb=total * 0.45)
    s = P.get_scheduler("mru").schedule(dag.graph, cluster)
    assert not s.failed
    L, mb = cfg.n_layers, 2
    per_forward = {A.KERNEL: L * mb, N.RMS_KERNEL: (2 * L + 1) * mb}
    for kw in ({}, dict(compiled=True)):
        kernels.reset_launches()
        rep = P.DeviceBackend(cluster).execute(dag.graph, s, params, ids, **kw)
        torch.cuda.synchronize()
        assert {k: kernels.launches[k] for k in per_forward} == {
            k: 2 * n for k, n in per_forward.items()}, kw
        got = rep.output.float()
        assert torch.isfinite(got).all()
        diff = (got - want).abs()
        assert int((diff > 5e-2 + 5e-2 * want.abs()).sum()) <= 1, kw


def _tiny_llama(cuda):
    from distributed_llm_scheduler_tpu_torch import LlamaConfig, params_from_numpy
    from distributed_llm_scheduler_tpu_torch.models import llama

    cfg = LlamaConfig.tiny()
    params = params_from_numpy(llama.init_params_numpy(cfg, 0), cuda)
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8),
                                        dtype=np.int32)).to(cuda)
    return cfg, params, ids


@pytest.mark.cuda
def test_decode_dag_captured_rungs_read_slabs_updated_in_place(cuda):
    """A tiny Llama decode-step DAG: the segmented and compiled rungs,
    captured at the first step, replay two steps later (the cache slabs
    written in place by apply_cache_updates in between) with logits equal
    to the per-task step's, launching nothing eagerly and capturing no new
    program (new slab tensors would have made the backend capture anew)."""
    import distributed_llm_scheduler_tpu_torch as P
    from distributed_llm_scheduler_tpu_torch.ops import norms as N

    cfg, params, ids = _tiny_llama(cuda)
    M = 16
    cluster = P.Cluster.from_torch_devices([cuda])
    be = P.DeviceBackend(cluster)
    pdag = P.build_decode_dag_any(cfg, batch=2, step_len=8, max_len=M)
    ddag = P.build_decode_dag_any(cfg, batch=2, step_len=1, max_len=M)
    sched = P.get_scheduler("greedy").schedule(ddag.graph, cluster)
    pc = pdag.derive_params(params)
    rep = be.execute(pdag.graph, P.get_scheduler("greedy").schedule(
        pdag.graph, cluster), pc, P.decode_inputs(ids, 0), keep_outputs=True)
    P.apply_cache_updates(pc, rep.task_outputs, cfg, 0)
    tok = rep.output[:, -1].argmax(-1).to(torch.int32)[:, None]
    for step in range(1, 4):
        pos = 8 + step - 1
        inp = P.decode_inputs(tok, pos, max_len=M)
        pt = be.execute(ddag.graph, sched, pc, inp, keep_outputs=True,
                        planned=False)
        if step in (1, 3):
            for kw in (dict(segments=True, rebatch=False), dict(compiled=True)):
                kernels.reset_launches()
                # captured at step 1 (its warm-up), replayed once at step 3
                got = be.execute(ddag.graph, sched, pc, inp, warmup=step == 1,
                                 **kw).output.clone()
                assert torch.equal(got, pt.output), (step, kw)
                programs = (sum(map(len, be._seg_cache.values()))
                            + sum(map(len, be._prog_cache.values())))
                if step == 1:
                    captured = programs
                else:
                    assert kernels.launches.get(N.RMS_KERNEL, 0) == 0, kw
                    assert kernels.replayed.get(N.RMS_KERNEL, 0) == 2 * cfg.n_layers + 1
                    assert programs == captured, kw
        P.apply_cache_updates(pc, pt.task_outputs, cfg, pos)
        tok = pt.output[:, -1].argmax(-1).to(torch.int32)[:, None]


@pytest.mark.cuda
def test_int8_cache_generate_on_the_card_equals_the_plain_norms(cuda,
                                                                 monkeypatch):
    """generate with the int8 KV cache on the card: the RMSNorm kernel's
    greedy tokens equal those of the same run with the plain RMSNorm.  The
    5 decode steps run captured: the prefill, the first step (eager, then
    recorded into the graph) launch eagerly, the 4 later steps by
    replays."""
    from distributed_llm_scheduler_tpu_torch.models import decode, llama
    from distributed_llm_scheduler_tpu_torch.ops import norms as N

    cfg, params, ids = _tiny_llama(cuda)
    decode.clear_programs()
    kernels.reset_launches()
    got = llama.generate(params, ids, cfg, max_new_tokens=6, kv_int8=True)
    per = 2 * cfg.n_layers + 1
    assert kernels.launches[N.RMS_KERNEL] == 3 * per
    assert kernels.replayed[N.RMS_KERNEL] == 4 * per
    decode.clear_programs()  # a stored graph would replay the kernel
    monkeypatch.setattr(llama, "rms_norm", N.reference_rms_norm)
    want = llama.generate(params, ids, cfg, max_new_tokens=6, kv_int8=True)
    decode.clear_programs()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["llama", "mixtral"])
def test_rms_norm_launches_per_decode_step(cuda, family):
    """One cached decode step of a Llama-backbone model launches the
    RMSNorm kernel 2 * n_layers + 1 times, every one on the register
    variant, and reads nothing back to the host with a tensor position."""
    from distributed_llm_scheduler_tpu_torch import MixtralConfig, params_from_numpy
    from distributed_llm_scheduler_tpu_torch.models import llama, mixtral
    from distributed_llm_scheduler_tpu_torch.ops import norms as N

    mod = llama if family == "llama" else mixtral
    cfg = (llama.LlamaConfig.tiny() if family == "llama"
           else MixtralConfig.tiny())
    params = params_from_numpy(mod.init_params_numpy(cfg, 0), cuda)
    cache = mod.init_cache(cfg, 2, 16, device=cuda)
    ids = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    mod.forward_cached(params, ids, cache, 0, cfg)
    kernels.reset_launches()
    pos = torch.full((), 8, dtype=torch.int32, device=cuda)
    mod.forward_cached(params, ids[:, :1], cache, pos, cfg)
    torch.cuda.synchronize()
    n = 2 * cfg.n_layers + 1
    assert kernels.launches[N.RMS_KERNEL] == n
    assert kernels.launches[f"{N.RMS_KERNEL}.register"] == n


# -- the captured decode loops ------------------------------------------------

def _family_params(cuda, family, dtype=torch.float32):
    from distributed_llm_scheduler_tpu_torch import params_from_numpy
    from distributed_llm_scheduler_tpu_torch.models.family import module_for

    mod = module_for(family)
    cfg = {"gpt2": lambda: mod.GPT2Config.tiny(dtype=dtype),
           "llama": lambda: mod.LlamaConfig.tiny(dtype=dtype),
           "mixtral": lambda: mod.MixtralConfig.tiny(dtype=dtype)}[family]()
    params = params_from_numpy(mod.init_params_numpy(cfg, 0), cuda, dtype)
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8),
                                        dtype=np.int32)).to(cuda)
    return mod, cfg, params, ids


@pytest.mark.cuda
@pytest.mark.parametrize("kv_int8", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("family", ["gpt2", "llama", "mixtral"])
def test_captured_generate_equals_the_eager_path(cuda, family, kv_int8):
    """Greedy generate on the card replays one captured step graph; its
    tokens equal ``capture=False``'s bit for bit, on a fresh program and
    on the stored one with another prompt (its cache reset in place)."""
    from distributed_llm_scheduler_tpu_torch.models import decode

    mod, cfg, params, ids = _family_params(cuda, family)
    decode.clear_programs()
    for prompt in (ids, ids.flip(0)):
        kernels.reset_launches()
        got = mod.generate(params, prompt, cfg, max_new_tokens=8,
                           kv_int8=kv_int8)
        assert sum(kernels.replayed.values()) > 0
        want = mod.generate(params, prompt, cfg, max_new_tokens=8,
                            kv_int8=kv_int8, capture=False)
        assert torch.equal(got, want), family
    assert len(decode._programs) == 1
    decode.clear_programs()


@pytest.mark.cuda
def test_captured_dense_loop_equals_the_eager_loop(cuda):
    """The dense K-step loop captured per (batch, K) and slab set: equal
    tokens and slabs to the eager loop from the same state, windows
    chained on one set of slabs with no new capture."""
    import distributed_llm_scheduler_tpu_torch as P
    from distributed_llm_scheduler_tpu_torch.backends.decode_loop import (
        build_decode_loop, split_cache_params)

    cfg, params, ids = _tiny_llama(cuda)
    M = 24
    cluster = P.Cluster.from_torch_devices([cuda])
    be = P.DeviceBackend(cluster)
    pdag = P.build_decode_dag_any(cfg, batch=2, step_len=8, max_len=M)
    ddag = P.build_decode_dag_any(cfg, batch=2, step_len=1, max_len=M)
    sched = P.get_scheduler("greedy").schedule(ddag.graph, cluster)
    pc = pdag.derive_params(params)
    rep = be.execute(pdag.graph, P.get_scheduler("greedy").schedule(
        pdag.graph, cluster), pc, P.decode_inputs(ids, 0), keep_outputs=True)
    P.apply_cache_updates(pc, rep.task_outputs, cfg, 0)
    tok0 = rep.output[:, -1].argmax(-1).to(torch.int32)[:, None]
    weights, caches = split_cache_params(pc)
    start = {k: v.clone() for k, v in caches.items()}
    runs = []
    for capture in (True, False):
        for k, v in start.items():
            caches[k].copy_(v)
        loop = build_decode_loop(ddag.graph, sched, cfg, steps=4,
                                 capture=capture)
        toks, tok, pos = [], tok0, 8
        for _ in range(3):
            kernels.reset_launches()
            out, caches = loop(weights, caches, tok, pos)
            if capture and pos > 8:
                assert not kernels.launches.get("rms_norm", 0)
                assert kernels.replayed["rms_norm"] > 0
            toks.append(out)
            tok, pos = out[:, -1:], pos + 4
        runs.append((torch.cat(toks, 1), {k: v.clone()
                                          for k, v in caches.items()}))
    assert torch.equal(runs[0][0], runs[1][0])
    for k in start:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k


def _serve_engines(cuda):
    from distributed_llm_scheduler_tpu_torch.eval import serve_bench as SB

    return [SB.build_serve_engine(device=cuda)[0] for _ in range(2)]


def _capture_reqs(vocab, n=6):
    rng = np.random.default_rng(3)
    return [(f"q{i}", rng.integers(0, vocab, size=(1, 8 + 4 * (i % 3)),
                                   dtype=np.int32), 6 + i) for i in range(n)]


@pytest.mark.cuda
def test_captured_segment_equals_the_eager_engine(cuda):
    """The paged engine's segment replays one graph per engine; a second
    engine with ``capture=False`` gives the same tokens bit for bit, and
    the captured one launches the paged kernel only by replays once
    warm."""
    captured, eager = _serve_engines(cuda)
    eager.capture = False
    reqs = _capture_reqs(int(captured.config.vocab_size))
    out = []
    for eng in (captured, eager, captured):
        eng.reset()
        kernels.reset_launches()
        for rid, ids, n in reqs:
            eng.submit(rid, ids, n)
        out.append(eng.run())
    assert kernels.launches.get(A.PAGED_KERNEL, 0) == 0
    assert kernels.replayed[A.PAGED_KERNEL] > 0
    for rid, _, _ in reqs:
        assert np.array_equal(out[0][rid], out[1][rid]), rid
        assert np.array_equal(out[2][rid], out[1][rid]), rid


@pytest.mark.cuda
def test_reset_zeroes_the_pools_the_graph_reads(cuda):
    """After ``reset()`` the captured segment replays over the same pool
    tensors, zeroed in place (no new capture, the first run's tokens);
    pools replaced by other tensors are refused by the captured program."""
    eng = _serve_engines(cuda)[0]
    reqs = _capture_reqs(int(eng.config.vocab_size))
    runs, progs = [], []
    for _ in range(2):
        eng.reset()
        addr = {k: v.data_ptr() for k, v in eng.pools.items()}
        for rid, ids, n in reqs:
            eng.submit(rid, ids, n)
        runs.append(eng.run())
        progs.append(eng._captured_seg)
        assert {k: v.data_ptr() for k, v in eng.pools.items()} == addr
        assert all(int(v.abs().sum()) > 0 for v in eng.pools.values())
    assert progs[0] is progs[1] is not None
    for rid, _, _ in reqs:
        assert np.array_equal(runs[0][rid], runs[1][rid])
    eng.reset()
    eng.pools = {k: v.clone() for k, v in eng.pools.items()}
    eng.submit("x", reqs[0][1], 4)
    with pytest.raises(RuntimeError, match="another tensor"):
        eng.run()


@pytest.mark.cuda
def test_a_step_that_reads_to_the_host_fails_capture(cuda):
    """A body that syncs with the host cannot be captured: the capture
    raises, and nothing runs it eagerly instead."""
    from distributed_llm_scheduler_tpu_torch.backends.device import (
        CapturedProgram, CapturedStep, capture_stream)

    x = torch.ones((4,), device=cuda)
    calls = []

    def body():
        calls.append(1)
        x.add_(float(x.sum()))  # .item()-style read: a sync

    step = CapturedStep(body, cuda)
    with pytest.raises(RuntimeError):
        step()
    assert step.graph is None and len(calls) == 2  # the warm-up, the capture
    prog = CapturedProgram(lambda p, e: e["a"] * int(e["a"].sum()),
                           stream=capture_stream(cuda))
    with pytest.raises(RuntimeError):
        prog({}, {"a": x})
    assert prog.graph is None
    torch.cuda.synchronize()
