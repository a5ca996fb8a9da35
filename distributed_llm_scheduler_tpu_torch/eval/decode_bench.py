"""Op-level parity sweeps of the paged-attention kernels.

PyTorch port of the kernel leg's op-parity part of
``distributed_llm_scheduler_tpu.eval.decode_bench``: the same ragged and
edge-case fixtures (copied at their shapes), the same numpy draws
(``RandomState(3)`` and ``(5)`` in fixture order), the trash page
poisoned with 1e9 so parity also proves the masking, and the bench's
tolerance, allclose at atol = rtol = 1e-5.  The kernel
(``impl="kernel"``, CUDA tensors) is held against the plain version
(``impl="plain"``) on the same device.  The rest of the JAX bench (the
dense-vs-paged and gather-vs-kernel engine legs) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

PARITY_TOL = 1e-5


def _paged_op_parity_fixtures(page_size: int = 16) -> list:
    """Single-token fixtures: (name, S, Hq, Hkv, hd, pages_per_seq,
    lengths, with_insert).  Ragged mixes, page-size edges (empty, 1-token
    tail, exactly-full page, single-page request), GQA ratios, and
    capacity-1 insert clamping."""
    ps = page_size
    return [
        ("ragged_mix", 3, 4, 2, 8, 4, [0, 5, 3 * ps + 1], True),
        ("no_insert", 3, 4, 2, 8, 4, [1, ps, 2 * ps - 1], False),
        ("mha_heads", 2, 2, 2, 8, 2, [ps - 1, ps + 3], True),
        ("gqa_4to1", 2, 8, 2, 16, 2, [3, 2 * ps - 2], True),
        ("single_page", 2, 4, 2, 8, 1, [1, ps - 1], True),
        ("page_boundary", 2, 4, 2, 8, 2, [ps, 2 * ps - 1], True),
        ("capacity_edge", 2, 4, 2, 8, 2, [2 * ps - 1, 2 * ps - 1], True),
    ]


def _ragged_op_parity_fixtures(page_size: int = 16) -> list:
    """Multi-token-q fixtures: (name, S, Hq, Hkv, hd, ppseq, Tn,
    [(base_len, q_len), ...]): a chunk straddling a page boundary, a
    chunk exactly one page long, a final partial chunk, an idle slot
    (q_len == 0), and GQA head grouping."""
    ps = page_size
    return [
        ("chunk_straddles_page", 2, 4, 2, 8, 3, 8,
         [(ps - 3, 8), (ps + 5, 8)]),
        ("chunk_eq_page", 2, 4, 2, 8, 3, ps, [(0, ps), (ps, ps)]),
        ("final_partial_chunk", 3, 4, 2, 8, 3, 8,
         [(2 * ps, 3), (5, 1), (0, 8)]),
        ("idle_slot", 2, 4, 2, 8, 2, 8, [(ps, 0), (3, 8)]),
        ("gqa_chunk", 2, 8, 2, 16, 2, 8, [(ps - 1, 8), (0, 5)]),
    ]


def paged_parity_cases(page_size: int = 16, device: Any = "cuda") -> List[Dict]:
    """The single-token fixtures as ``paged_decode_attention`` keyword
    arguments on ``device`` (float32), drawn as the JAX bench draws
    them."""
    rng = np.random.RandomState(3)
    ps = page_size
    out = []
    for name, S, Hq, Hkv, hd, ppseq, lengths, with_insert in \
            _paged_op_parity_fixtures(ps):
        n_pages = S * ppseq + 1
        q = rng.randn(S, Hq, 1, hd)
        k_pool = rng.randn(n_pages, ps, Hkv, hd)
        v_pool = rng.randn(n_pages, ps, Hkv, hd)
        k_pool[0] = 1e9  # poison the trash page
        v_pool[0] = 1e9
        pt = np.zeros((S, ppseq), np.int32)
        page = 1
        for s, L in enumerate(lengths):
            for j in range((min(L + 1, ppseq * ps) + ps - 1) // ps):
                pt[s, j] = page
                page += 1
        kn = vn = None
        if with_insert:
            kn = rng.randn(S, Hkv, 1, hd)
            vn = rng.randn(S, Hkv, 1, hd)
        out.append(dict(
            name=name, q=q, k_pool=k_pool, v_pool=v_pool, page_table=pt,
            lengths=np.asarray(lengths, np.int32), k_new=kn, v_new=vn,
            sm_scale=1.0 / hd ** 0.5,
        ))
    return [_on(c, device) for c in out]


def ragged_parity_cases(page_size: int = 16, device: Any = "cuda") -> List[Dict]:
    """The ragged fixtures as ``paged_decode_attention`` keyword arguments
    (with ``q_lens``) on ``device``, drawn as the JAX bench draws them;
    ``real`` masks the rows that are compared (``t < q_lens[s]``)."""
    rng = np.random.RandomState(5)
    ps = page_size
    out = []
    for name, S, Hq, Hkv, hd, ppseq, Tn, spans in \
            _ragged_op_parity_fixtures(ps):
        n_pages = S * ppseq + 1
        q = rng.randn(S, Hq, Tn, hd)
        k_pool = rng.randn(n_pages, ps, Hkv, hd)
        v_pool = rng.randn(n_pages, ps, Hkv, hd)
        k_pool[0] = 1e9
        v_pool[0] = 1e9
        pt = np.zeros((S, ppseq), np.int32)
        page = 1
        for s, (L, QL) in enumerate(spans):
            # pages cover the chunk's already-scattered K/V rows
            for j in range((max(L + QL, 1) + ps - 1) // ps):
                pt[s, j] = page
                page += 1
        ql = np.asarray([QL for _, QL in spans], np.int32)
        out.append(dict(
            name=name, q=q, k_pool=k_pool, v_pool=v_pool, page_table=pt,
            lengths=np.asarray([L for L, _ in spans], np.int32), q_lens=ql,
            sm_scale=1.0 / hd ** 0.5,
            real=(np.arange(Tn)[None, :] < ql[:, None])[:, None, :, None],
        ))
    return [_on(c, device) for c in out]


def serving_case(dtype: torch.dtype = torch.bfloat16, device: Any = "cuda",
                 seed: int = 0, q_tokens: int = 1, head_dim: int = 64) -> Dict:
    """One paged-attention call at the GPT-2 small serving shape: 8
    slots, 12 heads of 64, page size 16, 32 pages per slot (capacity
    512), 8 * 32 + 1 pages, slot lengths from a numpy seed, each slot's
    pages drawn in shuffled order.  ``q_tokens == 1`` adds this step's
    ``k_new``/``v_new`` rows; ``q_tokens > 1`` is a ragged chunk with
    ``q_lens`` in ``[0, q_tokens]`` whose rows fit the capacity.  The
    pools depend on the seed only, so both forms of one seed share them."""
    S, H, hd, ps, ppseq = 8, 12, head_dim, 16, 32
    cap = ps * ppseq
    n_pages = S * ppseq + 1
    pool_rng = np.random.default_rng(seed)
    k_pool = pool_rng.standard_normal((n_pages, ps, H, hd))
    v_pool = pool_rng.standard_normal((n_pages, ps, H, hd))
    rng = np.random.default_rng(seed + 1)
    if q_tokens == 1:
        lengths = rng.integers(0, cap, size=S)
        q_lens = None
    else:
        lengths = rng.integers(0, cap - q_tokens + 1, size=S)
        q_lens = rng.integers(0, q_tokens + 1, size=S)
    perm = rng.permutation(np.arange(1, n_pages))
    pt = np.zeros((S, ppseq), np.int32)
    nxt = 0
    for s in range(S):
        top = lengths[s] + (1 if q_lens is None else max(q_lens[s], 1))
        for j in range(-(-min(top, cap) // ps)):
            pt[s, j] = perm[nxt]
            nxt += 1
    case = dict(
        name=f"serving_{'single' if q_tokens == 1 else 'ragged'}",
        q=rng.standard_normal((S, H, q_tokens, hd)),
        k_pool=k_pool, v_pool=v_pool,
        page_table=pt, lengths=lengths.astype(np.int32),
        sm_scale=1.0 / hd ** 0.5,
    )
    if q_lens is None:
        case["k_new"] = rng.standard_normal((S, H, 1, hd))
        case["v_new"] = rng.standard_normal((S, H, 1, hd))
    else:
        case["q_lens"] = q_lens.astype(np.int32)
        case["real"] = (np.arange(q_tokens)[None, :] <
                        q_lens[:, None])[:, None, :, None]
    out = _on(case, device)
    for k in ("q", "k_pool", "v_pool", "k_new", "v_new"):
        if k in out:
            out[k] = out[k].to(dtype)
    return out


def _on(case: Dict, device: Any) -> Dict:
    """numpy arrays -> tensors on ``device`` (floats as float32)."""
    out = {}
    for k, v in case.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.float().to(device) if t.is_floating_point() or \
                v.dtype == bool else t.to(device)
        else:
            out[k] = v
    return out


def op_parity(cases: List[Dict], kernel_impl: str = "kernel") -> Dict[str, Any]:
    """``paged_decode_attention`` under ``kernel_impl`` against
    ``impl="plain"`` on each case's device: per-fixture max |err| (real
    rows only for ragged cases) and the aggregate allclose verdict at the
    bench's tolerance."""
    from ..ops.attention import paged_decode_attention

    out, ok = {}, True
    for c in cases:
        args = {k: v for k, v in c.items() if k not in ("name", "real")}
        ref = paged_decode_attention(**args, impl="plain")
        got = paged_decode_attention(**args, impl=kernel_impl)
        m = c.get("real")
        m = torch.ones_like(got) if m is None else m.to(got.dtype).expand_as(got)
        err = float(((got - ref) * m).abs().max())
        close = bool(torch.allclose(got * m, ref * m, atol=PARITY_TOL,
                                    rtol=PARITY_TOL))
        finite = bool(torch.isfinite(got).all())
        ok = ok and close and finite
        out[c["name"]] = {"max_abs_err": err, "allclose": close,
                          "finite": finite}
    return {"fixtures": out, "allclose": ok}


__all__ = [
    "PARITY_TOL",
    "op_parity",
    "paged_parity_cases",
    "ragged_parity_cases",
    "serving_case",
]
