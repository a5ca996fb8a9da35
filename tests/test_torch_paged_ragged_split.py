"""The bf16 ragged paged kernel's tiles, split and combine, emulated on the
CPU.

``csrc/paged_attention.cu``'s ``paged_ragged_tc_kernel`` computes a ragged
multi-token chunk on the tensor cores as a grid of (slot, KV head, split,
row tile) blocks.  A KV head's G * Tn query rows (row ``c = g * Tn + t``)
fall into row tiles of 16-row M-tiles; row ``c`` sees positions ``<= L +
min(c % Tn, max(q_lens[s] - 1, 0))``.
Split j spans ``pages_per_split`` whole pages from ``j * span``
(:func:`ragged_split` sizes it from the geometry); a split starting past
the tile's last visible position reads nothing; the others stage their
span's K/V rows in tiles of TK keys, every row past the tile's last
visible position zero-filled and masked.  The warps of an M-tile
(key groups) each take 32 keys of every tile and keep an online softmax
per row over them, on f32 scores of bf16 operands scaled by scale *
log2(e), in the exp2 domain; P enters P V as hi = bf16(P) and lo =
bf16(P - hi), the denominator sums the f32 P; the (split, key group)
partials merge in split order, then key-group order.  ``_emulate`` repeats those steps in plain torch (f32 products of
bf16 values are exact, as on the tensor cores), and the tests hold it to
the JAX package's gather path (``impl="xla"``) and its Pallas kernel in
interpret mode at the decode bench's 1e-5, on bf16-valued inputs, whose
output rounded to bf16 once must also lie within 2^-8 |x| + 1e-4 of the
f32 function.  P rounded to bf16 once instead breaks that rule (see
``test_unsplit_p_breaks_the_bf16_rule``), so the kernel splits it.
Nothing on the port's main path calls the emulation.
"""

import contextlib
import inspect
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_scheduler_tpu.ops.attention import (
    paged_decode_attention as jax_paged,
)
from distributed_llm_scheduler_tpu_torch.eval import decode_bench as DB
from distributed_llm_scheduler_tpu_torch.ops import attention as A
from distributed_llm_scheduler_tpu_torch.ops import kernels

LOG2E = 1.4426950408889634
TOL = 1e-5  # eval/decode_bench.py's op-parity tolerance
ROUNDOFF, SLACK = 2.0 ** -8, 1e-4  # chip_smoke's BF16_ROUNDOFF, F32_SLACK
SMS = 132  # an H100 SXM's SMs: the split the card would use


def _emulate(q, k_pool, v_pool, page_table, lengths, q_lens, sm_scale,
             split_p=True):
    """f32 (S, Hq, Tn, hd) before the output's rounding, from f32 tensors
    holding bf16 values, as the tensor-core kernel computes it."""
    S, Hq, Tn, hd = q.shape
    _, ps, Hkv, _ = k_pool.shape
    G, ppseq = Hq // Hkv, page_table.shape[1]
    cap, R = ppseq * ps, G * Tn
    plan = A.ragged_plan(torch.bfloat16, S, Hq, Hkv, Tn, hd, ps, ppseq, SMS)
    assert plan.variant == A.RAGGED_TC
    kg = A.ragged_key_groups(hd)
    rows, span = 16 * plan.warps // kg, plan.pages_per_split * ps
    tk = A.ragged_tile_keys(hd)
    kw = tk // kg  # keys of a tile for each warp of an M-tile
    scale_log2 = torch.tensor(sm_scale, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    qr = q.reshape(S, Hkv, R, hd)
    out = torch.empty(S, Hkv, R, hd)
    for s in range(S):
        L, tmax = int(lengths[s]), max(int(q_lens[s]) - 1, 0)
        for z in range(plan.row_tiles):
            c0 = z * rows
            nrows = min(rows, R - c0)
            lim = L + torch.clamp(torch.arange(c0, c0 + rows) % Tn, max=tmax)
            t0 = c0 % Tn
            tt = Tn - 1 if t0 + nrows - 1 >= Tn else t0 + nrows - 1
            last = min(L + min(tt, tmax), cap - 1)  # the tile's last position
            Q = torch.zeros(Hkv, rows, hd)  # M-tile rows past R are zeros
            Q[:, :nrows] = qr[s, :, c0:c0 + nrows]
            parts = []
            for j in range(plan.n_split):
                p0 = j * span
                if p0 > last:
                    continue  # reads nothing, pushes nothing
                p1 = min(p0 + span, last + 1)
                n_kv = -(-(p1 - p0) // tk) * tk
                K, V = torch.zeros(n_kv, Hkv, hd), torch.zeros(n_kv, Hkv, hd)
                for r in range(p1 - p0):  # rows past p1 stay zero-filled
                    pos = p0 + r
                    page = int(page_table[s, pos // ps])
                    K[r], V[r] = k_pool[page, pos % ps], v_pool[page, pos % ps]
                for g in range(kg):  # each key group's own partial
                    m = torch.full((Hkv, rows), -math.inf)
                    l, acc = torch.zeros(Hkv, rows), torch.zeros(Hkv, rows, hd)
                    for k0 in range(g * kw, n_kv, tk):
                        pos = p0 + k0 + torch.arange(kw)
                        sc = torch.einsum("hrd,nhd->hrn", Q, K[k0:k0 + kw]) * scale_log2
                        seen = (pos[None, :] < p1) & (pos[None, :] <= lim[:, None])
                        sc = sc.masked_fill(~seen[None], -math.inf)
                        m_new = torch.maximum(m, sc.amax(dim=-1))
                        base = torch.where(m_new == -math.inf, 0.0, m_new)
                        alpha = torch.exp2(m - base)
                        p = torch.exp2(sc - base[..., None])
                        l = l * alpha + p.sum(dim=-1)
                        Vt = V[k0:k0 + kw].transpose(0, 1)  # (Hkv, kw, hd)
                        hi = p.bfloat16().float()
                        pv = hi @ Vt
                        if split_p:
                            pv = pv + (p - hi).bfloat16().float() @ Vt
                        acc = acc * alpha[..., None] + pv
                        m = m_new
                    parts.append((m, l, acc))
            M = torch.stack([p[0] for p in parts]).amax(dim=0)
            c = [torch.exp2(p[0] - M) for p in parts]
            den = sum(ci * p[1] for ci, p in zip(c, parts))
            num = sum(ci[..., None] * p[2] for ci, p in zip(c, parts))
            out[s, :, c0:c0 + nrows] = (num / den[..., None])[:, :nrows]
    return out.reshape(S, Hq, Tn, hd)


def _bf16_values(case):
    """The case with every float tensor rounded to bf16 values, in f32."""
    return {k: (v.bfloat16().float() if torch.is_tensor(v) and v.is_floating_point()
                else v) for k, v in case.items()}


def _chunk(name, S, Hq, Hkv, hd, ps, ppseq, Tn, spans, seed):
    """A ragged call: (L, q_len) per slot, pages in order covering each
    slot's chunk rows (at least one page), the trash page 0 behind every
    unused entry."""
    rng = np.random.default_rng(seed)
    n_pages = S * ppseq + 1
    pt = np.zeros((S, ppseq), np.int32)
    page = 1
    for s, (L, QL) in enumerate(spans):
        for j in range(-(-min(max(L + QL, 1), ppseq * ps) // ps)):
            pt[s, j] = page
            page += 1
    return dict(
        name=name,
        q=torch.from_numpy(rng.standard_normal((S, Hq, Tn, hd)).astype(np.float32)),
        k_pool=torch.from_numpy(
            rng.standard_normal((n_pages, ps, Hkv, hd)).astype(np.float32)),
        v_pool=torch.from_numpy(
            rng.standard_normal((n_pages, ps, Hkv, hd)).astype(np.float32)),
        page_table=torch.from_numpy(pt),
        lengths=torch.tensor([L for L, _ in spans], dtype=torch.int32),
        q_lens=torch.tensor([QL for _, QL in spans], dtype=torch.int32),
        sm_scale=hd ** -0.5,
    )


def _cases():
    out = [c for c in DB.ragged_parity_cases(device="cpu")]
    out.append(DB.serving_case(torch.float32, "cpu", seed=0, q_tokens=32))
    out += [
        # GQA 3:1, 7 tokens: 21 rows, the first M-tile holds three heads
        _chunk("gqa_rows_not_16", 2, 6, 2, 32, 16, 8, 7, [(40, 7), (3, 5)], 1),
        # Llama-3 8B's heads: 32 query heads on 8 KV heads, hd 128, Tn 16
        _chunk("llama_width_gqa", 2, 32, 8, 128, 16, 16, 16,
               [(100, 16), (7, 11)], 2),
        # L + t at and past the capacity (64): clamped to the last page
        _chunk("lengths_at_capacity", 2, 4, 2, 16, 16, 4, 8,
               [(61, 8), (63, 1)], 3),
        # one slot sees only split 0's span, the other every split
        _chunk("splits_past_every_position", 2, 4, 4, 64, 16, 16, 8,
               [(3, 4), (240, 8)], 4),
        # one token per slot, with q_lens (R = G = 2)
        _chunk("one_token_q_lens", 3, 4, 2, 64, 16, 8, 1,
               [(0, 1), (70, 1), (127, 0)], 5),
        # the serving chunk of `lint --chunk-tokens 48`
        _chunk("chunk_48", 2, 4, 4, 64, 16, 8, 48, [(20, 48), (60, 30)], 6),
    ]
    return out


CASES = _cases()
IDS = [c["name"] for c in CASES]


def _args(case):
    return {k: case[k] for k in ("q", "k_pool", "v_pool", "page_table",
                                 "lengths", "q_lens", "sm_scale")}


def _jax(case, impl):
    args = {k: (jnp.asarray(v.numpy()) if torch.is_tensor(v) else v)
            for k, v in _args(case).items()}
    return np.asarray(jax_paged(**args, impl=impl))


_ORACLE = {}


def _oracle(i, impl):
    """The JAX function in f32 on case ``i``'s bf16 values (cached: the
    interpret-mode kernel is slow)."""
    if (i, impl) not in _ORACLE:
        _ORACLE[(i, impl)] = _jax(_bf16_values(CASES[i]), impl)
    return _ORACLE[(i, impl)]


def _beyond_bf16_rule(got, want):
    rounded = got.bfloat16().float().numpy()
    return int((np.abs(rounded - want) > ROUNDOFF * np.abs(want) + SLACK).sum())


@pytest.mark.parametrize("oracle", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_emulated_kernel_matches_jax(i, oracle):
    case = _bf16_values(CASES[i])
    want = _oracle(i, oracle)
    got = _emulate(**_args(case))
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    # the kernel rounds its f32 result to bf16 once
    assert _beyond_bf16_rule(got, want) == 0


def test_unsplit_p_breaks_the_bf16_rule():
    """P rounded to bf16 once, the usual FlashAttention-2 step, puts
    outputs beyond 2^-8 |x| + 1e-4 of the f32 function on every case
    above (~9% of the GPT-2 serving chunk's elements, ~13% of the
    Llama-width chunk's), as for the flash kernel
    (tests/test_torch_flash_numerics.py): that rounding alone would not
    do, so the kernel keeps P as hi + lo."""
    broken = {}
    for i, case in enumerate(CASES):
        got = _emulate(**_args(_bf16_values(case)), split_p=False)
        broken[case["name"]] = _beyond_bf16_rule(got, _oracle(i, "xla"))
    assert all(n > 0 for n in broken.values()), broken
    assert broken["serving_ragged"] > 0.05 * 8 * 12 * 32 * 64, broken


def test_cases_reach_the_paths_they_are_named_for():
    """Several splits per slot, a split past every visible position,
    two row tiles, a tile straddling heads, and the padded head dim."""
    plans = {c["name"]: A.ragged_plan(
        torch.bfloat16, *c["q"].shape[:2], c["k_pool"].shape[2],
        c["q"].shape[2], c["q"].shape[3], c["k_pool"].shape[1],
        c["page_table"].shape[1], SMS) for c in CASES}
    assert plans["serving_ragged"].n_split == 4
    assert plans["serving_ragged"].pages_per_split * 16 == 128
    p = plans["splits_past_every_position"]
    assert p.n_split == 4 and p.pages_per_split * 16 == 64  # slot 0: 3 + 3 < 64
    assert plans["llama_width_gqa"].n_split == 8  # 32-key tiles: 32-key spans
    # warps: M-tiles x key groups (2 at hd <= 64, 1 at hd 128)
    warps = {k: p.warps for k, p in plans.items()}
    assert warps["chunk_48"] == 6 and plans["chunk_48"].row_tiles == 1
    assert warps["serving_ragged"] == 4
    assert warps["llama_width_gqa"] == 4  # G * Tn = 64 rows, hd 128
    assert warps["gqa_rows_not_16"] == 4  # 21 rows: 2 M-tiles
    assert warps["one_token_q_lens"] == 2
    assert warps["chunk_straddles_page"] == 2  # G 2 x Tn 8; hd 8, padded


@pytest.mark.parametrize(
    "S,Hq,Hkv,Tn,hd,ps,ppseq,want",
    [(8, 12, 12, 32, 64, 16, 32, (1, 4, 8, 4)),   # the GPT-2 serving chunk
     (8, 32, 8, 16, 128, 16, 32, (1, 4, 6, 6)),   # Llama-width GQA chunk
     (8, 32, 8, 32, 128, 16, 32, (1, 8, 8, 4)),   # 128 rows a tile
     (8, 64, 8, 32, 128, 16, 32, (2, 8, 16, 2)),  # 256 rows: two tiles
     (2, 4, 2, 8, 8, 16, 3, (1, 2, 3, 1)),        # capacity under a tile
     (1, 2, 2, 4, 64, 1, 4096, (1, 2, 512, 8)),   # page size 1: 8 splits
     (8, 12, 12, 48, 64, 16, 32, (1, 6, 8, 4)),   # the 48-token lint chunk
     (2, 4, 2, 8, 64, 5, 40, (1, 2, 13, 4)),      # page size 5: 65 a span
     (8, 12, 12, 1, 64, 16, 32, (1, 2, 8, 4))],   # one token per slot
)
def test_ragged_plan_sizes(S, Hq, Hkv, Tn, hd, ps, ppseq, want):
    plan = A.ragged_plan(torch.bfloat16, S, Hq, Hkv, Tn, hd, ps, ppseq, SMS)
    assert plan.variant == A.RAGGED_TC
    assert (plan.row_tiles, plan.warps, plan.pages_per_split,
            plan.n_split) == want
    R = Hq // Hkv * Tn
    kg = A.ragged_key_groups(hd)
    assert plan.warps % kg == 0 and plan.warps <= 8
    rows = 16 * plan.warps // kg
    assert plan.row_tiles * rows >= R > (plan.row_tiles - 1) * rows
    assert 1 <= plan.n_split <= 8
    assert (plan.n_split - 1) * plan.pages_per_split < ppseq <= (
        plan.n_split * plan.pages_per_split)
    # the partials of every split land in split 0's shared memory
    smem = A.ragged_smem_bytes(rows, hd, plan.pages_per_split, plan.n_split)
    # every (split, key group) partial of the block's slice of rows
    slice_rows = -(-rows // plan.n_split)
    assert smem >= plan.n_split * kg * slice_rows * (hd + 2) * 4
    assert smem <= A.SMEM_BLOCK


@pytest.mark.parametrize("hd", A.PAGED_HEAD_DIMS)
@pytest.mark.parametrize("Tn", [1, 7, 16, 32, 48, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_ragged_split_fits_a_block(hd, Tn, G):
    """Over head dims, chunk lengths and GQA groups, at the serving
    geometry and a long one: at most 8 splits, a footprint the kernel can
    ask for, and one wave of the card whenever any split count gives one."""
    for S, Hkv, ps, ppseq in ((8, 8, 16, 32), (4, 2, 16, 512)):
        plan = A.ragged_plan(torch.bfloat16, S, G * Hkv, Hkv, Tn, hd, ps,
                             ppseq, SMS)
        assert 1 <= plan.n_split <= 8
        assert plan.pages_per_split <= A.MAX_SPAN_PAGES
        rows = 16 * plan.warps // A.ragged_key_groups(hd)
        assert A.ragged_smem_bytes(rows, hd, plan.pages_per_split,
                                   plan.n_split) <= A.SMEM_BLOCK
        assert plan.pages_per_split * ps >= min(A.ragged_tile_keys(hd), ppseq * ps)


def test_ragged_split_refuses_what_no_split_holds():
    # 1,024 pages a split at most, 8 splits: 8,193 pages cannot be held
    with pytest.raises(ValueError, match="no split count"):
        A.ragged_split(4, 32, 64, 1, 8193, SMS)


def test_ragged_plan_variants():
    """bf16 on the tensor cores at every head dim the kernels take, f32
    on the walk kernel; nothing else."""
    for hd in A.PAGED_HEAD_DIMS:
        assert A.ragged_plan(torch.bfloat16, 8, 12, 12, 32, hd, 16, 32,
                             SMS).variant == A.RAGGED_TC
        assert A.ragged_plan(torch.float32, 8, 12, 12, 32, hd, 16, 32,
                             SMS).variant == A.RAGGED_WALK
    with pytest.raises(ValueError, match="no variant"):
        A.ragged_plan(torch.float16, 8, 12, 12, 32, 64, 16, 32, SMS)
    with pytest.raises(ValueError, match="no split count"):
        A.ragged_plan(torch.bfloat16, 1, 2, 2, 4, 64, 1, 8193, SMS)


def _fake_card(monkeypatch):
    """Stand-ins for the card around the ragged wrapper: a 132-SM device,
    a stream, and a library whose entries record their arguments and
    return 0."""
    calls = []

    def entry(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn

    lib = types.SimpleNamespace(
        dls_paged_attention_ragged_tc_fwd=entry("tc"),
        dls_paged_attention_ragged_fwd=entry("walk"))
    monkeypatch.setattr(A, "_check_paged", lambda *a: None)
    monkeypatch.setattr(A, "_paged_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=SMS))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wrapper_reads_nothing_back_and_counts_its_variant(monkeypatch, dtype):
    """The ragged wrapper plans and launches from shapes alone: with every
    host read of a tensor's values raising, it passes the plan's numbers
    to its variant's entry and counts the launch under the kernel and the
    variant."""
    calls = _fake_card(monkeypatch)

    def readback(*a, **k):
        raise AssertionError("host read of a device tensor")

    for name in ("item", "tolist", "cpu", "numpy", "__int__", "__index__",
                 "__bool__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, readback)
    case = DB.serving_case(dtype, "cpu", seed=0, q_tokens=32)
    before = dict(kernels.launches)
    A.paged_attention_ragged(**_args(case))
    monkeypatch.undo()
    variant = A.RAGGED_TC if dtype == torch.bfloat16 else A.RAGGED_WALK
    assert [c[0] for c in calls] == [variant]
    args = calls[0][1]
    assert args[8:15] == (8, 12, 12, 32, 64, 16, 32)  # S, Hq, Hkv, Tn, hd, ps, ppseq
    if variant == A.RAGGED_TC:
        plan = A.ragged_plan(dtype, 8, 12, 12, 32, 64, 16, 32, SMS)
        assert args[15:18] == (plan.warps, plan.pages_per_split, plan.n_split)
    else:
        assert args[15] == 0  # the dtype code of float32
    assert kernels.launches[A.PAGED_RAGGED_KERNEL] == before[A.PAGED_RAGGED_KERNEL] + 1
    key = f"{A.PAGED_RAGGED_KERNEL}.{variant}"
    assert kernels.launches[key] == before[key] + 1


def test_sizing_reads_no_lengths():
    """Neither the plan nor the sizing takes a tensor, and their sources
    read nothing back."""
    for fn in (A.ragged_plan, A.ragged_split, A.ragged_smem_bytes,
               A.ragged_tile_keys, A.ragged_key_groups,
               A.paged_attention_ragged):
        src = inspect.getsource(fn)
        for call in (".item(", ".tolist(", ".cpu(", ".numpy(", "int(ln",
                     "int(ql", "int(pt"):
            assert call not in src, (fn.__name__, call)
    params = inspect.signature(A.ragged_plan).parameters
    assert "lengths" not in params and "q_lens" not in params
