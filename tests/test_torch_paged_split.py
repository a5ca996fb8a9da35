"""The single-token paged kernel's split, staging and combine, emulated on
the CPU.

``csrc/paged_attention.cu`` computes one decode token per slot as a grid
of (slot, KV head, split) blocks: split j spans ``pages_per_split`` whole
pages from position ``j * span`` (:func:`paged_split` sizes it from the
geometry); a split starting past the slot's last visible position
``min(L, cap - 1)`` writes nothing; the others stage their span's K/V
rows through shared memory in tiles of TK keys, zero-filling every row
past the split's last visible position (so a masked row, poisoned or
not, is never read) and copying this step's ``k_new``/``v_new`` in place
of the pool's row at ``min(L, cap - 1)``; each of the four warps keeps
its own online softmax over its quarter of each tile's keys, in f32 on
log2-scaled scores; the warps merge into the split's (m, l, acc), and a
slot's splits merge in split order.  ``_emulate`` repeats those steps in
plain torch, and the tests hold it to the JAX package's gather path
(``impl="xla"``) and its Pallas kernel in interpret mode at the decode
bench's tolerance (1e-5), on f32 inputs and on bf16-valued ones (whose
kernel output, rounded to bf16 once, must also stay within 2^-8 |x| +
1e-4 of the f32 function).  Nothing on the port's main path calls the
emulation.
"""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_scheduler_tpu.ops.attention import (
    paged_decode_attention as jax_paged,
)
from distributed_llm_scheduler_tpu_torch.ops import attention as A

LOG2E = 1.4426950408889634
TOL = 1e-5  # eval/decode_bench.py's op-parity tolerance
ROUNDOFF, SLACK = 2.0 ** -8, 1e-4  # chip_smoke's BF16_ROUNDOFF, F32_SLACK
SMS = 132  # an H100 SXM's SMs: the split size the card would use
NW = 4  # warps per block


def _tile_keys(hd: int, esize: int) -> int:
    """The kernel's TK (``Lanes<T, HD>``): ~4 KB of K per tile, at most
    64 keys, and at least one lane group's worth per warp."""
    epl = hd // 32 if hd >= 64 else 2
    groups = 32 // (hd // epl)
    return max(min(4096 // (hd * esize), 64), NW * groups)


def _emulate(q, k_pool, v_pool, page_table, lengths, sm_scale,
             k_new=None, v_new=None, esize=4):
    """f32 (S, Hq, 1, hd) before the output's rounding, from f32 tensors
    holding the kernel's input values (``esize``: their bytes on the
    card, which sets the tile)."""
    S, Hq, _, hd = q.shape
    _, ps, Hkv, _ = k_pool.shape
    G, ppseq = Hq // Hkv, page_table.shape[1]
    cap = ppseq * ps
    pps, n_split = A.paged_split(A._split_blocks(S, Hq, Hkv), ps, ppseq, SMS)
    span, tk = pps * ps, _tile_keys(hd, esize)
    scale_log2 = torch.tensor(sm_scale, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    qs = q[:, :, 0].reshape(S, Hkv, G, hd) * scale_log2
    out = torch.empty(S, Hkv, G, hd)
    for s in range(S):
        last = min(int(lengths[s]), cap - 1)
        ins = last if k_new is not None else -1
        parts = []
        for j in range(n_split):
            p0 = j * span
            if p0 > last:
                continue  # the split exits at once and writes nothing
            p1 = min(p0 + span, last + 1)
            n_rows = -(-(p1 - p0) // tk) * tk
            K, V = torch.zeros(n_rows, Hkv, hd), torch.zeros(n_rows, Hkv, hd)
            for row in range(p1 - p0):  # rows past p1 stay zero-filled
                pos = p0 + row
                if pos == ins:
                    K[row], V[row] = k_new[s, :, 0], v_new[s, :, 0]
                else:
                    page = int(page_table[s, pos // ps])
                    K[row], V[row] = k_pool[page, pos % ps], v_pool[page, pos % ps]
            warps = []
            for w in range(NW):
                m = torch.full((Hkv, G), -math.inf)
                l, acc = torch.zeros(Hkv, G), torch.zeros(Hkv, G, hd)
                for t0 in range(0, n_rows, tk):
                    rows = torch.arange(t0 + w * tk // NW, t0 + (w + 1) * tk // NW)
                    sc = torch.einsum("nhd,hgd->hgn", K[rows], qs[s])
                    sc = sc.masked_fill((p0 + rows >= p1)[None, None, :], -math.inf)
                    m_new = torch.maximum(m, sc.amax(dim=-1))
                    ms = torch.where(m_new == -math.inf, 0.0, m_new)
                    alpha = torch.exp2(m - ms)
                    p = torch.exp2(sc - ms[..., None])
                    l = l * alpha + p.sum(dim=-1)
                    acc = acc * alpha[..., None] + torch.einsum(
                        "hgn,nhd->hgd", p, V[rows])
                    m = m_new
                warps.append((m, l, acc))
            M = torch.stack([w[0] for w in warps]).amax(dim=0)
            c = [torch.exp2(w[0] - M) for w in warps]
            parts.append((M, sum(ci * w[1] for ci, w in zip(c, warps)),
                          sum(ci[..., None] * w[2] for ci, w in zip(c, warps))))
        M = torch.stack([p[0] for p in parts]).amax(dim=0)
        c = [torch.exp2(p[0] - M) for p in parts]
        den = sum(ci * p[1] for ci, p in zip(c, parts))
        num = sum(ci[..., None] * p[2] for ci, p in zip(c, parts))
        out[s] = num / den[..., None]
    return out.reshape(S, Hq, 1, hd)


# (name, S, Hq, Hkv, hd, page_size, pages_per_seq, lengths, insert, poison):
# with 64-position spans (page 16) a capacity of 256 holds 4 splits
CASES = [
    ("len0_insert_only", 2, 2, 2, 8, 16, 16, [0, 0], True, None),
    ("len0_no_insert", 2, 2, 2, 8, 16, 16, [0, 9], False, None),
    ("past_capacity", 2, 4, 2, 16, 16, 16, [256 + 7, 255], True, None),
    ("insert_on_split_boundary", 3, 4, 2, 32, 16, 16, [64, 128, 192], True, None),
    ("ends_at_span_end", 3, 4, 2, 32, 16, 16, [63, 127, 191], True, None),
    ("empty_trailing_splits", 2, 4, 2, 16, 16, 16, [3, 70], True, None),
    ("nan_trash_and_masked_tail", 2, 4, 2, 16, 16, 16, [20, 100], True, "nan"),
    ("gqa_4to1", 2, 8, 2, 16, 16, 16, [33, 200], True, None),
    ("hd128", 2, 2, 2, 128, 16, 16, [77, 250], True, None),
    ("hd8_page5", 3, 4, 2, 8, 5, 40, [4, 64, 199], True, None),
]


def _case(fx, seed, bf16_values):
    """Numpy inputs of one case (pages assigned in order, the trash page 0
    behind every unused entry) and, for ``poison == "nan"``, a copy whose
    trash page and masked tail rows of each slot's last visible page hold
    NaN."""
    name, S, Hq, Hkv, hd, ps, ppseq, lengths, insert, poison = fx
    rng = np.random.default_rng(seed)
    n_pages = S * ppseq + 1

    def draw(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        if bf16_values:
            x = torch.from_numpy(x).bfloat16().float().numpy()
        return x

    case = dict(q=draw((S, Hq, 1, hd)), k_pool=draw((n_pages, ps, Hkv, hd)),
                v_pool=draw((n_pages, ps, Hkv, hd)))
    pt = np.zeros((S, ppseq), np.int32)
    page = 1
    for s, L in enumerate(lengths):
        for j in range(-(-min(L + 1, ppseq * ps) // ps)):
            pt[s, j] = page
            page += 1
    case.update(page_table=pt, lengths=np.asarray(lengths, np.int32),
                sm_scale=1.0 / math.sqrt(hd), k_new=None, v_new=None)
    if insert:
        case["k_new"], case["v_new"] = draw((S, Hkv, 1, hd)), draw((S, Hkv, 1, hd))
    poisoned = None
    if poison == "nan":
        poisoned = {k: (v.copy() if isinstance(v, np.ndarray) else v)
                    for k, v in case.items()}
        for pool in (poisoned["k_pool"], poisoned["v_pool"]):
            pool[0] = np.nan
            for s, L in enumerate(lengths):
                last = min(L, ppseq * ps - 1)
                pool[pt[s, last // ps], last % ps + 1:] = np.nan
    return case, poisoned


def _jax(case, impl):
    args = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in case.items()}
    return np.asarray(jax_paged(**args, impl=impl))


def _torch(case):
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            for k, v in case.items()}


@pytest.mark.parametrize("oracle", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("values", ["f32", "bf16"])
@pytest.mark.parametrize("fx", CASES, ids=[c[0] for c in CASES])
def test_split_combine_matches_jax(fx, values, oracle):
    bf16 = values == "bf16"
    case, poisoned = _case(fx, seed=len(fx[0]), bf16_values=bf16)
    want = _jax(case, oracle)  # a finite pool: the poison must change nothing
    got = _emulate(**_torch(poisoned or case), esize=2 if bf16 else 4)
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    if bf16:  # the kernel rounds its f32 result to bf16 once
        rounded = got.bfloat16().float().numpy()
        assert (np.abs(rounded - want) > ROUNDOFF * np.abs(want) + SLACK).sum() == 0


def test_emulation_spans_several_splits():
    """The cases above reach the paths they are named for: more than one
    split per slot, empty trailing splits, an insert opening a split."""
    pps, n_split = A.paged_split(A._split_blocks(2, 4, 2), 16, 16, SMS)
    assert (pps * 16, n_split) == (64, 4)
    pps, n_split = A.paged_split(A._split_blocks(3, 4, 2), 5, 40, SMS)
    assert (pps * 5, n_split) == (65, 4)


@pytest.mark.parametrize(
    "S,Hq,Hkv,ps,ppseq,want",
    [(8, 12, 12, 16, 32, (4, 8)),      # GPT-2 small serving: 768 blocks
     (16, 12, 12, 16, 32, (6, 6)),     # S*Hkv >= 132: fewer, longer splits
     (88, 12, 12, 16, 32, (32, 1)),    # 1,056 blocks already: one split
     (2, 8, 2, 16, 1, (1, 1)),         # one page of capacity
     (8, 32, 8, 16, 32, (4, 8)),       # Llama-3 8B heads (G = 4)
     (4, 4, 4, 128, 8, (1, 8)),        # pages longer than 64 positions
     (2, 2, 2, 1, 4096, (512, 8))],    # at most 8 splits (one cluster)
)
def test_paged_split_sizes(S, Hq, Hkv, ps, ppseq, want):
    pps, n_split = A.paged_split(A._split_blocks(S, Hq, Hkv), ps, ppseq, SMS)
    assert (pps, n_split) == want
    assert pps * ps >= min(64, ppseq * ps) or pps == ppseq
    assert 1 <= n_split <= 8 and (n_split - 1) * pps < ppseq <= n_split * pps


def test_wrapper_reads_nothing_back():
    """The single-token wrapper sizes its launch from shapes alone: no
    host read of lengths or the page table (that would sync every layer
    of every step and block CUDA-graph capture)."""
    for fn in (A.paged_attention, A._check_paged, A.paged_split,
               A._split_blocks, A._int32, A._aligned_rows):
        src = inspect.getsource(fn)
        for call in (".item(", ".tolist(", ".cpu(", ".numpy(", "int(ln", "int(pt"):
            assert call not in src, (fn.__name__, call)
