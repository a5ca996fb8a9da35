"""The port's paged attention against the JAX package's, on the CPU.

The 7 single-token and 5 ragged multi-token fixtures are the JAX decode
bench's own op-parity sweeps (``eval/decode_bench.py``
``_paged_op_parity_fixtures`` / ``_ragged_op_parity_fixtures``), with the
trash page poisoned to 1e9 so the comparison also proves the masking.
Inputs come from one numpy seed per fixture and go to both packages.
The port's plain versions are held to JAX ``impl="xla"`` at atol = rtol
= 1e-5, the bench's own tolerance (ragged: real rows only, rows past
``q_lens`` are padding), and two fixtures also to the Pallas kernel in
interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_scheduler_tpu.eval.decode_bench import (
    _paged_op_parity_fixtures,
    _ragged_op_parity_fixtures,
)
from distributed_llm_scheduler_tpu.ops.attention import (
    paged_decode_attention as jax_paged,
)
from distributed_llm_scheduler_tpu_torch.ops import attention as A
from distributed_llm_scheduler_tpu_torch.ops import kernels

PS = 16
TOL = 1e-5
SINGLE = _paged_op_parity_fixtures(PS)
RAGGED = _ragged_op_parity_fixtures(PS)


def single_case(fx, seed, dtype=np.float32):
    """Numpy inputs of one single-token fixture, built as the bench does."""
    name, S, Hq, Hkv, hd, ppseq, lengths, with_insert = fx
    rng = np.random.default_rng(seed)
    n_pages = S * ppseq + 1
    q = rng.standard_normal((S, Hq, 1, hd)).astype(dtype)
    k_pool = rng.standard_normal((n_pages, PS, Hkv, hd)).astype(dtype)
    v_pool = rng.standard_normal((n_pages, PS, Hkv, hd)).astype(dtype)
    k_pool[0] = 1e9  # poison the trash page
    v_pool[0] = 1e9
    pt = np.zeros((S, ppseq), np.int32)
    page = 1
    for s, L in enumerate(lengths):
        for j in range((min(L + 1, ppseq * PS) + PS - 1) // PS):
            pt[s, j] = page
            page += 1
    kn = vn = None
    if with_insert:
        kn = rng.standard_normal((S, Hkv, 1, hd)).astype(dtype)
        vn = rng.standard_normal((S, Hkv, 1, hd)).astype(dtype)
    return dict(q=q, k_pool=k_pool, v_pool=v_pool, page_table=pt,
                lengths=np.asarray(lengths, np.int32), k_new=kn, v_new=vn,
                sm_scale=1.0 / hd ** 0.5)


def ragged_case(fx, seed):
    name, S, Hq, Hkv, hd, ppseq, Tn, spans = fx
    rng = np.random.default_rng(seed)
    n_pages = S * ppseq + 1
    q = rng.standard_normal((S, Hq, Tn, hd)).astype(np.float32)
    k_pool = rng.standard_normal((n_pages, PS, Hkv, hd)).astype(np.float32)
    v_pool = rng.standard_normal((n_pages, PS, Hkv, hd)).astype(np.float32)
    k_pool[0] = 1e9
    v_pool[0] = 1e9
    pt = np.zeros((S, ppseq), np.int32)
    page = 1
    for s, (L, QL) in enumerate(spans):
        for j in range((max(L + QL, 1) + PS - 1) // PS):
            pt[s, j] = page
            page += 1
    return dict(q=q, k_pool=k_pool, v_pool=v_pool, page_table=pt,
                lengths=np.asarray([L for L, _ in spans], np.int32),
                q_lens=np.asarray([QL for _, QL in spans], np.int32),
                sm_scale=1.0 / hd ** 0.5)


def to_jax(case):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in case.items()}


def to_torch(case, dtype=None):
    out = {}
    for k, v in case.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.to(dtype) if dtype is not None and t.is_floating_point() else t
        else:
            out[k] = v
    return out


def real_rows(q_lens, Tn):
    return (np.arange(Tn)[None, :] < q_lens[:, None])[:, None, :, None]


@pytest.mark.parametrize("i", range(len(SINGLE)), ids=[f[0] for f in SINGLE])
def test_plain_paged_matches_jax_xla(i):
    case = single_case(SINGLE[i], seed=100 + i)
    want = np.asarray(jax_paged(**to_jax(case), impl="xla"))
    got = A.reference_paged_attention(**to_torch(case)).numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("i", range(len(RAGGED)), ids=[f[0] for f in RAGGED])
def test_plain_ragged_matches_jax_xla(i):
    fx = RAGGED[i]
    case = ragged_case(fx, seed=200 + i)
    want = np.asarray(jax_paged(**to_jax(case), impl="xla"))
    got = A.reference_paged_attention_ragged(**to_torch(case)).numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()  # padding rows too
    m = real_rows(case["q_lens"], fx[6])
    np.testing.assert_allclose(got * m, want * m, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind,i", [("single", 0), ("ragged", 2)])
def test_plain_paged_matches_jax_pallas_interpret(kind, i):
    if kind == "single":
        case = single_case(SINGLE[i], seed=100 + i)
        got = A.reference_paged_attention(**to_torch(case)).numpy()
        m = 1.0
    else:
        case = ragged_case(RAGGED[i], seed=200 + i)
        got = A.reference_paged_attention_ragged(**to_torch(case)).numpy()
        m = real_rows(case["q_lens"], RAGGED[i][6])
    want = np.asarray(jax_paged(**to_jax(case), impl="pallas_interpret"))
    np.testing.assert_allclose(got * m, want * m, atol=TOL, rtol=TOL)


def test_plain_paged_bf16_matches_jax_xla():
    """bf16 in both packages (GPT-2's head dim 64).  Both round q * scale
    and p to bf16 and accumulate in f32, so they differ by summation
    order and the final rounding: one bf16 ulp of outputs of magnitude
    <= ~2 is 2^-7, so 1e-2 absolute holds that and catches a wrong mask
    or insert, which moves outputs by O(1)."""
    fx = ("bf16_gpt2", 3, 12, 12, 64, 4, [0, 17, 63], True)
    case = single_case(fx, seed=7)
    case["k_pool"][0] = 0.0  # keep the trash page finite in bf16 products
    jcase = to_jax(case)
    for k in ("q", "k_pool", "v_pool", "k_new", "v_new"):
        jcase[k] = jcase[k].astype(jnp.bfloat16)
    want = np.asarray(jax_paged(**jcase, impl="xla").astype(jnp.float32))
    got = A.reference_paged_attention(**to_torch(case, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=0)


def test_dispatcher_runs_plain_on_cpu():
    case = to_torch(single_case(SINGLE[0], seed=100))
    before = dict(kernels.launches)
    got = A.paged_decode_attention(**case)
    assert torch.equal(got, A.reference_paged_attention(**case))
    assert A.paged_decode_attention(**case, impl="plain").equal(got)
    rcase = to_torch(ragged_case(RAGGED[0], seed=200))
    rgot = A.paged_decode_attention(**rcase)
    assert torch.equal(rgot, A.reference_paged_attention_ragged(**rcase))
    assert kernels.launches == before  # no kernel counted on the CPU


def test_dispatcher_infers_shapes_on_meta():
    case = to_torch(single_case(SINGLE[3], seed=103))
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
            for k, v in case.items()}
    out = A.paged_decode_attention(**meta)
    assert out.device.type == "meta"
    assert out.shape == case["q"].shape and out.dtype == case["q"].dtype
    rcase = to_torch(ragged_case(RAGGED[4], seed=204))
    rmeta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
             for k, v in rcase.items()}
    assert A.paged_decode_attention(**rmeta).shape == rcase["q"].shape


def test_dispatcher_refuses_what_it_cannot_run():
    case = to_torch(single_case(SINGLE[0], seed=100))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        A.paged_decode_attention(**case, impl="kernel")
    with pytest.raises(ValueError, match="unknown paged attention impl"):
        A.paged_decode_attention(**case, impl="xla")
    rcase = to_torch(ragged_case(RAGGED[0], seed=200))
    with pytest.raises(ValueError, match="requires per-slot q_lens"):
        A.paged_decode_attention(**{**rcase, "q_lens": None})
    with pytest.raises(ValueError, match="takes no k_new"):
        A.paged_decode_attention(**rcase, k_new=rcase["q"], v_new=rcase["q"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        A.paged_attention(**case)


def test_kernel_constraints_name_the_rule():
    assert A.paged_kernel_constraints(16, 64, 12, 12, torch.bfloat16) == []
    assert A.paged_kernel_constraints(1, 8, 2, 8, torch.float32, q_tokens=7) == []
    bad = A.paged_kernel_constraints(
        0, 24, 3, 4, torch.float16, q_tokens=0, contiguous=False)
    assert len(bad) == 6
    for word in ("head_dim 24", "page_size 0", "multiple of n_kv_heads",
                 "float16", "q_tokens 0", "contiguous"):
        assert any(word in b for b in bad), word


def test_port_sweeps_are_the_jax_bench_sweeps():
    """The port's copy of the bench fixtures (used by ``chip_smoke.py``
    and the ``cuda`` tests) equals the JAX bench's, and on its draws the
    plain versions meet JAX ``impl="xla"`` at the bench's tolerance."""
    from distributed_llm_scheduler_tpu_torch.eval import decode_bench as TB

    assert TB._paged_op_parity_fixtures(PS) == SINGLE
    assert TB._ragged_op_parity_fixtures(PS) == RAGGED
    cases = TB.paged_parity_cases(PS, "cpu") + TB.ragged_parity_cases(PS, "cpu")
    assert len(cases) == 12
    for c in cases:
        args = {k: v for k, v in c.items() if k not in ("name", "real")}
        got = A.paged_decode_attention(**args).numpy()
        want = np.asarray(jax_paged(**{
            k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
            for k, v in args.items()}, impl="xla"))
        m = c["real"].numpy() if "real" in c else 1.0
        np.testing.assert_allclose(got * m, want * m, atol=TB.PARITY_TOL,
                                   rtol=TB.PARITY_TOL, err_msg=c["name"])
    assert TB.op_parity(cases, kernel_impl="plain")["allclose"]
