"""Decode-throughput measurement of the KV-cache generation paths.

PyTorch port of ``distributed_llm_scheduler_tpu.eval.decode_bench``, the
inference-side probe beside the north-star bench.  Run on the card::

    python -m distributed_llm_scheduler_tpu_torch.eval.decode_bench [MODE]

with no MODE (``measure_decode``: GPT-2 small bf16 greedy generation),
``--attribute`` (``decode_attribution``), ``--dag``
(``measure_decode_dag``: decoding through the scheduler), ``--int8`` or
``--kv-int8`` (int8 weights and cache, or the cache alone), ``--paged``
(``measure_paged_decode``, gated), ``--kernel``
(``measure_paged_kernel``, gated) or ``--tp N``
(``measure_decode_sharded``: a world of N cards).  Each prints one JSON
line.

The measured paths run on the card the caller names and read the card's
clock only after ``torch.cuda.synchronize``; the CPU runs the same code
(tests use it) but its numbers are not device numbers, and the roofline
is None there.  Timings are fence-amortized: ``reps`` runs issued back to
back, one synchronize, the wall over ``reps``.

Also here: the op-level parity sweeps of the paged-attention kernels, on
the JAX bench's ragged and edge-case fixtures (copied at their shapes),
the same numpy draws (``RandomState(3)`` and ``(5)`` in fixture order),
the trash page poisoned with 1e9 so parity also proves the masking, and
the bench's tolerance, allclose at atol = rtol = 1e-5.  The kernel
(``impl="kernel"``, CUDA tensors) is held against the plain version
(``impl="plain"``) on the same device.
"""

from __future__ import annotations

# dls-lint: allow-file(DET001) benchmark harness: wall time IS the measured quantity

import json
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..models.family import init_params

PARITY_TOL = 1e-5

# Peak device-memory rate for the decode roofline, by the card's name as
# ``torch.cuda.get_device_name`` gives it: NVIDIA H100 SXM5 data sheet,
# 3.35 TB/s (the provenance class of ``benchlib.PEAK_FLOPS``).  Batch-small
# decode is bandwidth-bound: every step re-reads the weights and the KV
# cache, so bytes over this rate is the floor on a step.
PEAK_HBM_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}


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


# -- timing on the caller's device ---------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _amortized(fn: Callable[[], Any], reps: int, device: torch.device) -> float:
    """Seconds per call of ``fn`` issued ``reps`` times back to back with
    one synchronize at the end (the caller has warmed it up)."""
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return max((time.perf_counter() - t0) / reps, 1e-9)


def _fence_rtt(device: torch.device) -> float:
    """Median seconds of one synchronized 4-byte device-to-host read: the
    host's round trip to the card, paid per token by a host-driven loop."""
    x = torch.zeros((), dtype=torch.int32, device=device)
    samples = []
    for _ in range(5):
        _sync(device)
        t0 = time.perf_counter()
        int((x + 1).cpu())
        samples.append(time.perf_counter() - t0)
    return sorted(samples)[2]


def _device_kind(device: torch.device) -> str:
    from .benchlib import device_kind

    return device_kind(device)


def prompt_ids(config: Any, batch: int, prompt_len: int, device: torch.device):
    """(batch, prompt_len) int32 ids in ``[0, vocab)`` from numpy seed 1."""
    rng = np.random.default_rng(1)
    ids = rng.integers(0, config.vocab_size, size=(batch, prompt_len),
                       dtype=np.int32)
    return torch.from_numpy(ids).to(device)


def _param_bytes(params: Dict[str, Any]) -> int:
    from ..utils.quantize import QParam

    return int(sum(
        (v.q.nbytes + v.scale.nbytes) if isinstance(v, QParam) else v.nbytes
        for v in params.values()))


# -- the roofline ----------------------------------------------------------------

def decode_roofline(
    config: Any, batch: int, cache_len: int, device_kind: str
) -> Optional[Dict[str, float]]:
    """Memory-bandwidth bound for one decode step on the card named
    ``device_kind`` (``torch.cuda.get_device_name``).

    Bytes per step = all params (the weights are re-read every token) +
    the full KV cache buffer (the static-shape cached attention reads the
    whole allocated buffer each step, masked) + the cache write.  Returns
    None on the CPU and on a card :data:`PEAK_HBM_GBPS` does not name."""
    bw = PEAK_HBM_GBPS.get(device_kind)
    if bw is None:
        return None
    from ..frontend.decode_dag import cache_dims
    from ..models.family import family_of, module_for

    mod = module_for(family_of(config))
    param_bytes = sum(
        int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        for shape, dtype in mod.param_shapes(config).values())
    n_layer, n_kv, head_dim = cache_dims(config)
    itemsize = torch.empty((), dtype=config.dtype).element_size()
    kv_read = 2 * n_layer * batch * n_kv * cache_len * head_dim * itemsize
    kv_write = 2 * n_layer * batch * n_kv * head_dim * itemsize
    bytes_per_step = param_bytes + kv_read + kv_write
    step_bound_s = bytes_per_step / (bw * 1e9)
    return {
        "hbm_gbps_assumed": bw,
        "param_bytes": float(param_bytes),
        "kv_cache_bytes": float(kv_read),
        "bytes_per_step": float(bytes_per_step),
        "step_bound_ms": step_bound_s * 1e3,
        "bound_tok_s": batch / step_bound_s,
    }


def _dequant_forward(family: str, dtype: torch.dtype):
    """A ``forward_cached`` over int8 weights: every ``QParam`` is
    dequantized (``utils/quantize.dequantize``) to ``dtype`` inside the
    step, so the weights held on the card stay int8."""
    from ..models.family import module_for
    from ..utils.quantize import dequantize

    mod = module_for(family)

    def fwd_q(p, *args, **kw):
        dense = {k: dequantize(v, dtype) for k, v in p.items()}
        return mod.forward_cached(dense, *args, **kw)

    return fwd_q


# -- the whole-model generation ---------------------------------------------------

@torch.no_grad()
def measure_decode(
    config: Any = None,
    batch: int = 8,
    prompt_len: int = 512,
    new_tokens: int = 64,
    reps: int = 3,
    quantize: bool = False,
    kv_int8: bool = False,
    device: Any = "cuda",
    params: Optional[Dict[str, torch.Tensor]] = None,
    eager_leg: bool = False,
) -> Dict[str, Any]:
    """Greedy-generation throughput of ``models/decode.generate``.

    ``config`` may be any family's (GPT-2 small bf16 by default); the
    weights are ``params`` or drawn from seed 0 on ``device``.
    ``wall_s`` covers prefill + every decode step; the per-step cost is
    the DIFFERENCE of two generation lengths, ``(wall(N) - wall(1)) /
    (N - 1)``, so the prefill cannot inflate it; ``decode_tok_s`` derives
    from it.  ``quantize=True`` generates over int8 weights (grouped
    scales, row-wise embeddings), dequantized inside each step;
    ``kv_int8=True`` over the int8 cache.  A lossy leg reports its
    ``token_agreement`` and ``first_token_agreement`` with the
    unquantized generation, and a quantized one its ``argmax_flip_rate``
    and ``logit_rmse`` over one full-prompt forward; the roofline fields
    count the quantized bytes.  On a card the decode steps replay one
    captured CUDA graph; ``eager_leg=True`` also times ``generate(...,
    capture=False)`` the same way and reports it under ``eager`` (its step
    time, tok/s, bound utilization, and whether its tokens equal the
    captured path's).  Keys: the JAX bench's, plus ``device`` and
    ``eager``."""
    from ..models import decode as decode_mod
    from ..models.family import family_of, module_for

    if config is None:
        from ..models.gpt2 import GPT2Config

        config = GPT2Config.small(dtype=torch.bfloat16)
    if new_tokens < 2:
        raise ValueError("new_tokens must be >= 2 to difference out prefill")
    device = torch.device(device)
    family = family_of(config)
    mod = module_for(family)
    if params is None:
        params = init_params(mod, config, 0, device)
    ids = prompt_ids(config, batch, prompt_len, device)

    gen_params: Any = params
    q_param_bytes: Optional[int] = None
    lossy = quantize or kv_int8
    if quantize:
        from ..utils.quantize import ROWWISE_EMBED_KEYS, quantize_params

        gen_params = quantize_params(
            params, scheme="grouped",
            rowwise_keys=ROWWISE_EMBED_KEYS.get(family, ()))
        q_param_bytes = _param_bytes(gen_params)
        fwd_q = _dequant_forward(family, config.dtype)

        def generate(p, n, capture=True):
            return decode_mod.generate(fwd_q, mod.init_cache, p, ids, config,
                                       max_new_tokens=n, kv_int8=kv_int8,
                                       capture=capture)
    else:
        def generate(p, n, capture=True):
            return mod.generate(p, ids, config, max_new_tokens=n,
                                kv_int8=kv_int8, capture=capture)

    if lossy:
        # generated once up front: the lossy leg's warm-up and the tokens
        # its agreement reads
        got = generate(gen_params, new_tokens)
        ref = mod.generate(params, ids, config, max_new_tokens=new_tokens)

    def timed(n: int, capture: bool = True) -> float:
        generate(gen_params, n, capture)  # warm-up (and capture)
        return _amortized(lambda: generate(gen_params, n, capture), reps,
                          device)

    wall_1 = timed(1)  # prefill + one step
    wall_s = timed(new_tokens)
    step_s = max((wall_s - wall_1) / (new_tokens - 1), 1e-9)
    eager = None
    if eager_leg:
        e1, en = timed(1, False), timed(new_tokens, False)
        e_step = max((en - e1) / (new_tokens - 1), 1e-9)
        same = torch.equal(generate(gen_params, new_tokens),
                           generate(gen_params, new_tokens, False))
        eager = {"wall_s": en, "ms_per_token_step": e_step * 1e3,
                 "decode_tok_s": batch / e_step, "tokens_equal": bool(same)}
    out: Dict[str, Any] = {
        "batch": float(batch),
        "prompt_len": float(prompt_len),
        "new_tokens": float(new_tokens),
        "wall_s": wall_s,
        "prefill_plus_one_s": wall_1,
        "decode_tok_s": batch / step_s,
        "ms_per_token_step": step_s * 1e3,
        "device": _device_kind(device),
    }
    if eager is not None:
        out["eager"] = eager
    if lossy:
        g, r = got[:, prompt_len:], ref[:, prompt_len:]
        out["token_agreement"] = round(float((g == r).float().mean()), 4)
        # no compounding: how often the lossy path flips one greedy pick
        out["first_token_agreement"] = round(
            float((g[:, 0] == r[:, 0]).float().mean()), 4)
        dname = str(config.dtype).removeprefix("torch.")
        out["weights"] = "int8" if quantize else dname
        out["kv_cache"] = "int8" if kv_int8 else dname
        if quantize:
            from ..utils.quantize import dequantize

            out["quant_scheme"] = "grouped64+rowwise_embed"
            ref_l = mod.forward(params, ids, config)
            q_l = mod.forward({k: dequantize(v, config.dtype)
                               for k, v in gen_params.items()}, ids, config)
            flips = (q_l.argmax(-1) != ref_l.argmax(-1)).float().mean()
            d = q_l.float() - ref_l.float()
            out["argmax_flip_rate"] = round(float(flips), 4)
            out["logit_rmse"] = round(float(d.square().mean().sqrt()), 4)
            del ref_l, q_l, d
    roof = decode_roofline(config, batch, prompt_len + new_tokens,
                           _device_kind(device))
    if roof is not None:
        # the cache-write term survives the quantized rebuilds
        write_term = (roof["bytes_per_step"] - roof["param_bytes"]
                      - roof["kv_cache_bytes"])
        if q_param_bytes is not None:
            roof["param_bytes"] = float(q_param_bytes)
        if kv_int8:
            # int8 rows + one f32 scale per head_dim-sized row
            itemsize = torch.empty((), dtype=config.dtype).element_size()
            elems = roof["kv_cache_bytes"] / itemsize
            roof["kv_cache_bytes"] = float(elems + elems / config.head_dim * 4)
        if q_param_bytes is not None or kv_int8:
            roof["bytes_per_step"] = (roof["param_bytes"]
                                      + roof["kv_cache_bytes"] + write_term)
            step_bound_s = roof["bytes_per_step"] / (
                roof["hbm_gbps_assumed"] * 1e9)
            roof["step_bound_ms"] = round(step_bound_s * 1e3, 4)
            roof["bound_tok_s"] = round(batch / step_bound_s, 4)
        out.update(roof)
        out["bound_utilization"] = (batch / step_s) / roof["bound_tok_s"]
        if eager is not None:
            eager["bound_utilization"] = (
                eager["decode_tok_s"] / roof["bound_tok_s"])
    return out


def measure_decode_sharded(
    config: Any = None,
    tp: int = 2,
    batch: int = 8,
    prompt_len: int = 64,
    new_tokens: int = 16,
    reps: int = 3,
    mesh: Any = None,
) -> Dict[str, Any]:
    """Tensor-parallel decode throughput over a dp=1 x tp mesh
    (:func:`..parallel.decode.generate_sharded`), greedy.

    Without ``mesh`` it starts a world of ``tp`` ranks on the platform
    seam's platform (the cards unless ``DLS_PLATFORM=cpu``) and returns rank 0's
    numbers; inside a world, every rank of ``mesh`` calls it.  The
    weights are drawn from seed 0 on each rank's device and sharded once;
    the prompt is :func:`prompt_ids`'.  ``wall_s`` is one generation of
    ``new_tokens`` (fence-amortized over ``reps``); the per-step cost is
    the difference of two generation lengths, as :func:`measure_decode`'s.
    On the CPU the numbers are functional only (``functional_only``):
    every rank shares the host.  Keys: the JAX bench's, plus
    ``ms_per_token_step``, ``decode_tok_s`` and ``device``."""
    if mesh is None:
        from ..parallel.launch import spawn

        return spawn(_sharded_decode_rank, tp,
                     args=(config, tp, batch, prompt_len, new_tokens, reps))
    from ..models.family import family_of, module_for
    from ..parallel.decode import generate_on_shards, shard_decode_params
    from ..parallel.launch import device as rank_device

    if config is None:
        from ..models.gpt2 import GPT2Config

        config = GPT2Config.small(dtype=torch.bfloat16)
    if new_tokens < 2:
        raise ValueError("new_tokens must be >= 2 to difference out prefill")
    device = rank_device()
    mod = module_for(family_of(config))
    local = shard_decode_params(mesh, init_params(mod, config, 0, device), config)
    ids = prompt_ids(config, batch, prompt_len, device)

    def timed(n: int) -> float:
        generate_on_shards(local, ids, config, mesh, n)  # warm-up
        return _amortized(
            lambda: generate_on_shards(local, ids, config, mesh, n), reps,
            device)

    wall_1 = timed(1)
    wall = timed(new_tokens)
    step_s = max((wall - wall_1) / (new_tokens - 1), 1e-9)
    return {
        "tp": float(mesh.axis_size("tp")),
        "batch": float(batch),
        "prompt_len": float(prompt_len),
        "new_tokens": float(new_tokens),
        "wall_s": wall,
        "tok_s_end_to_end": batch * new_tokens / wall,
        "prefill_plus_one_s": wall_1,
        "ms_per_token_step": step_s * 1e3,
        "decode_tok_s": batch / step_s,
        "platform": device.type,
        "functional_only": device.type == "cpu",
        "device": _device_kind(device),
    }


def _sharded_decode_rank(config, tp, batch, prompt_len, new_tokens, reps):
    """One rank of :func:`measure_decode_sharded`'s world."""
    from ..parallel.mesh import make_mesh

    return measure_decode_sharded(config, tp, batch, prompt_len, new_tokens,
                                  reps, mesh=make_mesh(tp=tp))


@torch.no_grad()
def decode_attribution(
    config: Any = None,
    batch: int = 8,
    prompt_len: int = 512,
    new_tokens: int = 64,
    reps: int = 8,
    device: Any = "cuda",
    params: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, Any]:
    """Attribute the gap between measured decode tok/s and the bound.

    Each component is timed on its own, fence-amortized, at decode shapes
    (T = 1, full cache): ``step_ms`` (the real step inside generation,
    differenced as :func:`measure_decode` does); ``forward_donated_ms``,
    one ``forward_cached`` writing the cache in place (what the
    generation loop pays); ``forward_undonated_ms``, the same call on a
    clone of the cache (its difference, ``cache_copy_ms``, is what
    writing in place saves); ``head_ms`` (the LM head); ``attn_ms`` (all
    layers' ``cached_attention`` over full buffers); ``sample_ms``
    (greedy argmax); ``loop_overhead_ms`` = step - donated - sample.
    Component byte bounds localize the gap; they are None off the
    roofline's cards."""
    import math

    from ..frontend.decode_dag import cache_dims
    from ..models import decode as _decode
    from ..models.family import family_of, module_for

    if config is None:
        from ..models.gpt2 import GPT2Config

        config = GPT2Config.small(dtype=torch.bfloat16)
    device = torch.device(device)
    family = family_of(config)
    mod = module_for(family)
    kind = _device_kind(device)
    if params is None:
        params = init_params(mod, config, 0, device)
    cache_len = prompt_len + new_tokens
    n_layer, nkv, hd = cache_dims(config)
    cache = _decode.init_cache(n_layer, batch, nkv, cache_len, hd,
                               config.dtype, device)
    pos = torch.full((), prompt_len, dtype=torch.int32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    tok = torch.randint(0, config.vocab_size, (batch, 1), generator=gen,
                        device=device, dtype=torch.int32)

    def timeit(fn):
        fn()  # warm-up
        return _amortized(fn, reps, device)

    t_fwd_undonated = timeit(lambda: mod.forward_cached(
        params, tok, {k: v.clone() for k, v in cache.items()}, pos, config))
    # in place: the cache write is the same row every rep
    t_fwd_donated = timeit(
        lambda: mod.forward_cached(params, tok, cache, pos, config))

    D = getattr(config, "n_embd", None) or config.d_model
    x1 = torch.randn((batch, 1, D), generator=gen, device=device).to(config.dtype)
    if family == "gpt2":
        t_head = timeit(lambda: mod.output_projection(x1, params["wte"]))
    else:
        from ..models import llama as _llama

        t_head = timeit(lambda: _llama.lm_head(x1, params["lm_head"]))

    nh = getattr(config, "n_heads", None) or config.n_head
    scale = 1.0 / math.sqrt(hd)
    q1 = torch.randn((batch, nh, 1, hd), generator=gen,
                     device=device).to(config.dtype)

    def attn_all():
        acc = torch.zeros_like(q1)
        for i in range(n_layer):
            acc = acc + _decode.cached_attention(
                q1, cache["k"][i], cache["v"][i], pos, scale)
        return acc

    t_attn = timeit(attn_all)
    logits = torch.randn((batch, 1, config.vocab_size), generator=gen,
                         device=device)
    t_sample = timeit(lambda: torch.argmax(logits[:, -1, :], dim=-1))

    step = measure_decode(config, batch=batch, prompt_len=prompt_len,
                          new_tokens=new_tokens, reps=reps, device=device,
                          params=params)
    step_s = step["ms_per_token_step"] / 1e3

    roof = decode_roofline(config, batch, cache_len, kind)
    itemsize = torch.empty((), dtype=config.dtype).element_size()
    head_bytes = D * config.vocab_size * itemsize
    kv_bytes = roof["kv_cache_bytes"] if roof else None
    bw = PEAK_HBM_GBPS.get(kind)

    def bound_ms(nbytes):
        return nbytes / (bw * 1e9) * 1e3 if bw and nbytes else None

    out = {
        "platform": device.type,
        "device": kind,
        "family": family,
        "batch": batch,
        "cache_len": cache_len,
        "step_ms": round(step_s * 1e3, 4),
        "forward_donated_ms": round(t_fwd_donated * 1e3, 4),
        "forward_undonated_ms": round(t_fwd_undonated * 1e3, 4),
        "cache_copy_ms": round(
            max(t_fwd_undonated - t_fwd_donated, 0.0) * 1e3, 4),
        "head_ms": round(t_head * 1e3, 4),
        "attn_ms": round(t_attn * 1e3, 4),
        "sample_ms": round(t_sample * 1e3, 4),
        "loop_overhead_ms": round(
            max(step_s - t_fwd_donated - t_sample, 0.0) * 1e3, 4),
        "head_bytes": head_bytes,
        "head_bound_ms": bound_ms(head_bytes),
        "attn_bound_ms": bound_ms(kv_bytes),
        "decode_tok_s": step["decode_tok_s"],
    }
    if roof:
        out["step_bound_ms"] = roof["step_bound_ms"]
        out["bound_utilization"] = step["bound_utilization"]
        if out["head_bound_ms"]:
            out["head_bound_utilization"] = round(
                out["head_bound_ms"] / max(out["head_ms"], 1e-9), 4)
        if out["attn_bound_ms"]:
            out["attn_bound_utilization"] = round(
                out["attn_bound_ms"] / max(out["attn_ms"], 1e-9), 4)
    return out


# -- decoding through the scheduler ----------------------------------------------

def _cache_params(params: Dict[str, Any], config: Any, batch: int,
                  max_len: int, device: torch.device) -> Dict[str, Any]:
    """The model's params plus zeroed per-layer cache slabs."""
    from ..frontend.decode_dag import cache_dims

    n_layers, nkv, hd = cache_dims(config)
    out = dict(params)
    for i in range(n_layers):
        for kind in ("k", "v"):
            out[f"cache_{kind}_{i}"] = torch.zeros(
                (batch, nkv, max_len, hd), dtype=config.dtype, device=device)
    return out


@torch.no_grad()
def measure_decode_dag(
    config: Any = None,
    batch: int = 8,
    prompt_len: int = 512,
    new_tokens: int = 8,
    reps: int = 16,
    policy: str = "heft",
    device: Any = "cuda",
    params: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, Any]:
    """Decode THROUGH the scheduler (``frontend/decode_dag``) on one node of
    ``device``: the task-graph inference path's numbers.

    * ``step_ms_per_task``: one decode-step DAG under per-task dispatch,
      ``reps`` runs back to back (best of 2), comparable to
      :func:`measure_decode`'s ``ms_per_token_step``;
    * ``step_ms_segmented``: the same step as one captured segment;
    * ``tok_s_end_to_end``: a host-driven generation's wall tok/s: each
      step dispatches the DAG, reads the batch's argmax tokens back, folds
      the cache updates in place and builds the next inputs;
    * ``looped``: :func:`...backends.decode_loop.build_decode_loop`'s
      K-step windows (one token readback per K; on a card each window one
      replay of the captured loop, with the eager loop's window beside it
      under ``eager``), and the same window on int8 weights
      (``quantize_dag``, channel scales, cache slabs kept).

    Oracle: the host-driven generation is TEACHER-FORCED on the whole-
    model ``generate`` stream, and every step's logits must meet the
    family's ``forward_cached`` on the same cache state under
    ``benchlib.oracle_close`` (``oracle_ok``); ``token_agreement`` is the
    greedy match against that stream.  The position is runtime data, so
    the generation builds two graph classes (prefill + one-token step).
    A failing leg raises.  Keys: the JAX bench's, plus ``device``."""
    from .. import get_scheduler
    from ..backends.decode_loop import build_decode_loop, split_cache_params
    from ..backends.device import DeviceBackend
    from ..core.cluster import Cluster
    from ..frontend.decode_dag import (
        apply_cache_updates,
        build_decode_dag_any,
        decode_inputs,
    )
    from ..models.decode import _position_limit
    from ..models.family import family_of, module_for
    from ..utils.quantize import quantize_dag, quantize_like
    from .benchlib import best_of, oracle_close

    if config is None:
        from ..models.gpt2 import GPT2Config

        config = GPT2Config.small(dtype=torch.bfloat16)
    if new_tokens < 3:
        raise ValueError("new_tokens must be >= 3 (the first steps build "
                         "the graph classes and are not timed)")
    device = torch.device(device)
    mod = module_for(family_of(config))
    if params is None:
        params = init_params(mod, config, 0, device)
    ids = prompt_ids(config, batch, prompt_len, device)
    max_len = prompt_len + new_tokens
    dtype_name = str(config.dtype).removeprefix("torch.")

    cluster = Cluster.from_torch_devices([device])
    backend = DeviceBackend(cluster)
    params_c = _cache_params(params, config, batch, max_len, device)
    graphs: Dict[int, Any] = {}

    def schedule(dag):
        sched = get_scheduler(policy).schedule(dag.graph, cluster)
        if sched.failed:
            raise RuntimeError(f"{dag.graph.name}: one node must place "
                               f"every task, {len(sched.failed)} failed")
        return sched

    def step_exec(tok_ids, pos, cache_params):
        step_len = tok_ids.shape[1]
        first = step_len not in graphs
        if first:
            ddag = build_decode_dag_any(config, batch=batch,
                                        step_len=step_len, max_len=max_len)
            graphs[step_len] = (ddag, schedule(ddag))
        ddag, sched = graphs[step_len]
        return backend.execute(
            ddag.graph, sched, cache_params,
            decode_inputs(tok_ids, pos, max_len=max_len),
            keep_outputs=True, warmup=first)

    # the teacher stream: whole-model greedy generation
    full = mod.generate(params, ids, config, max_new_tokens=new_tokens,
                        max_len=max_len)[:, prompt_len:].cpu().numpy()

    oracle_ok, agree = True, 0
    rep = step_exec(ids, 0, params_c)
    ref = graphs[prompt_len][0].reference_forward(
        params_c, decode_inputs(ids, 0, max_len=max_len))
    oracle_ok &= oracle_close(ref, rep.output, dtype_name)
    agree += int((rep.output[:, -1, :].argmax(-1).cpu().numpy()
                  == full[:, 0]).sum())
    apply_cache_updates(params_c, rep.task_outputs, config, 0)
    pos = prompt_len
    tok_ids = torch.from_numpy(full[:, 0:1].astype(np.int32)).to(device)
    n_timed, t_loop = 0, 0.0
    for step in range(1, new_tokens):
        timed = 1 in graphs  # the step class is built: steady state
        # the timed window is what a host-driven loop does per token:
        # dispatch the step DAG, read the tokens back, fold the cache
        # updates, build the next inputs.  The oracle is not timed.
        _sync(device)
        t0 = time.perf_counter()
        rep = step_exec(tok_ids, pos, params_c)
        nxt = torch.argmax(rep.output[:, -1, :], dim=-1).cpu().numpy()
        # the oracle below runs on the cache with this step's rows already
        # written: its forward writes the same rows at pos and masks the
        # rest, so it sees the state the step saw
        apply_cache_updates(params_c, rep.task_outputs, config, pos)
        next_tok = torch.from_numpy(
            full[:, step:step + 1].astype(np.int32)).to(device)
        if timed:
            _sync(device)
            t_loop += time.perf_counter() - t0
            n_timed += 1
        ref = graphs[1][0].reference_forward(
            params_c, decode_inputs(tok_ids, pos, max_len=max_len))
        oracle_ok &= oracle_close(ref, rep.output, dtype_name)
        agree += int((nxt == full[:, step]).sum())
        pos += 1
        tok_ids = next_tok
    token_agreement = agree / float(batch * new_tokens)

    # the device-side step, fence-amortized: ONE steady-state step re-run
    # back to back (tasks do not write the slabs, so state stays valid)
    ddag, sched = graphs[1]
    step_in = decode_inputs(tok_ids, max_len - 1, max_len=max_len)
    step_pt = best_of(2, lambda: backend.execute(
        ddag.graph, sched, params_c, step_in, warmup=False, reps=reps
    ).makespan_s)
    backend.execute(ddag.graph, sched, params_c, step_in, segments=True)
    step_seg = best_of(2, lambda: backend.execute(
        ddag.graph, sched, params_c, step_in, segments=True, warmup=False,
        reps=reps).makespan_s)

    # the K-step loop, on fresh graphs at a longer horizon (the run above
    # consumed its cache)
    K = 64
    limit = _position_limit(config)
    if limit is not None:  # tiny configs: shrink with the horizon
        K = min(K, (limit - prompt_len - 1) // 2)
    if K < 2:
        raise ValueError(f"position horizon too short for a looped window "
                         f"(limit {limit}, prompt {prompt_len})")
    max_len2 = prompt_len + 1 + 2 * K
    pdag2 = build_decode_dag_any(config, batch=batch, step_len=prompt_len,
                                 max_len=max_len2)
    params2 = _cache_params(params, config, batch, max_len2, device)
    rep2 = backend.execute(pdag2.graph, schedule(pdag2), params2,
                           decode_inputs(ids, 0, max_len=max_len2),
                           keep_outputs=True)
    apply_cache_updates(params2, rep2.task_outputs, config, 0)
    tok0 = torch.argmax(rep2.output[:, -1, :], dim=-1).to(torch.int32)[:, None]
    del rep2
    ddag2 = build_decode_dag_any(config, batch=batch, step_len=1,
                                 max_len=max_len2)
    dsched2 = schedule(ddag2)
    weights2, caches2 = split_cache_params(params2)
    loop = build_decode_loop(ddag2.graph, dsched2, config, steps=K)
    # the first window advances to P + K; its end state is the mid-point
    # every timed window restarts from
    toks1, caches_mid = loop(weights2, caches2, tok0, prompt_len)
    toks1_np = toks1.cpu().numpy()
    mid = {k: v.clone() for k, v in caches_mid.items()}
    tok_mid = toks1[:, -1:]

    def timed_window(run_loop, w):
        # back to the mid-point in place (off the clock): a captured loop
        # reads the slabs where it was captured
        for k, v in mid.items():
            caches2[k].copy_(v)
        _sync(device)
        t0 = time.perf_counter()
        toks, _ = run_loop(w, caches2, tok_mid, prompt_len + K)
        toks_np = toks.cpu().numpy()  # the one readback
        return time.perf_counter() - t0, toks_np

    # on a card the first window captures the loop
    timed_window(loop, weights2)
    wall, toks2_np = min((timed_window(loop, weights2) for _ in range(3)),
                         key=lambda w: w[0])
    full2 = mod.generate(params, ids, config, max_new_tokens=2 * K + 1,
                         max_len=max_len2)[:, prompt_len:].cpu().numpy()
    ours = np.concatenate([tok0.cpu().numpy(), toks1_np, toks2_np], axis=1)
    looped: Dict[str, Any] = {
        "steps_per_dispatch": K,
        "tok_s": round(batch * K / wall, 2),
        "ms_per_token": round(wall * 1e3 / K, 4),
        "dispatch_plus_readback_ms": round(wall * 1e3, 2),
        "token_agreement_vs_whole_program": round(
            float((ours == full2).mean()), 4),
    }
    if device.type == "cuda":
        # the same window through the eager loop, beside the captured one
        eloop = build_decode_loop(ddag2.graph, dsched2, config, steps=K,
                                  capture=False)
        timed_window(eloop, weights2)  # warm-up
        ewall, etoks_np = min(
            (timed_window(eloop, weights2) for _ in range(3)),
            key=lambda w: w[0])
        looped["eager"] = {
            "tok_s": round(batch * K / ewall, 2),
            "ms_per_token": round(ewall * 1e3 / K, 4),
            "tokens_equal_captured": bool(np.array_equal(etoks_np, toks2_np)),
        }
    # int8 weights: the placed weight tasks quantized (channel scales, the
    # cache slabs kept), the window timed from the same mid-point
    qd = quantize_dag(ddag2, exclude_prefixes=("cache_",))
    qparams = quantize_like(qd, weights2)
    qloop = build_decode_loop(qd.graph, schedule(qd), config, steps=K)
    _, qtoks_np = timed_window(qloop, qparams)  # warm-up, agreement sample
    qwall = min(timed_window(qloop, qparams)[0] for _ in range(3))
    looped["int8_weights"] = {
        "tok_s": round(batch * K / qwall, 2),
        "ms_per_token": round(qwall * 1e3 / K, 4),
        "weight_bytes": _param_bytes(qparams),
        "token_agreement_vs_bf16_loop": round(
            float((qtoks_np == toks2_np).mean()), 4),
    }
    del qparams, mid, params2, caches2, caches_mid

    out: Dict[str, Any] = {
        "family": family_of(config),
        "platform": device.type,
        "device": _device_kind(device),
        "batch": batch,
        "prompt_len": prompt_len,
        "new_tokens": new_tokens,
        "policy": policy,
        "n_tasks_decode_step": len(ddag.graph),
        "graph_classes_compiled": len(graphs),
        "oracle_ok": bool(oracle_ok),
        "token_agreement": round(token_agreement, 4),
        "step_ms_per_task": round(step_pt * 1e3, 4),
        "tok_s_per_task": round(batch / max(step_pt, 1e-12), 2),
        "step_ms_segmented": round(step_seg * 1e3, 4),
        "tok_s_segmented": round(batch / max(step_seg, 1e-12), 2),
        "tok_s_end_to_end": (round(batch * n_timed / t_loop, 2)
                             if t_loop > 0 else None),
        "host_rtt_ms": round(_fence_rtt(device) * 1e3, 3),
        "n_timed_steps": n_timed,
        "looped": looped,
    }
    roof = decode_roofline(config, batch, max_len, _device_kind(device))
    if roof is not None:
        out["bound_tok_s"] = round(roof["bound_tok_s"], 2)
        out["segmented_bound_utilization"] = round(
            (batch / step_seg) / roof["bound_tok_s"], 4)
    return out


# -- paged serving against dense static batching --------------------------------

def _paged_workload(config: Any, n_requests: int, capacity: int) -> list:
    """The JAX bench's serving workload: prompts of 16 (first half) and 24
    tokens, generation lengths ``[capacity - 24, 8, 8, 8]`` in turn, ids
    from ``RandomState(7)`` in request order."""
    rng = np.random.RandomState(7)
    reqs = []
    for i in range(n_requests):
        P = 16 if i < n_requests // 2 else 24
        gen = min([capacity - 24, 8, 8, 8][i % 4], capacity - P)
        ids = rng.randint(0, config.vocab_size, (1, P)).astype(np.int32)
        reqs.append((f"r{i}", ids, gen))
    return reqs


def _paged_engine(backend: Any, cluster: Any, config: Any, weights: Dict,
                  slots: int, page_size: int, pages_per_seq: int,
                  n_pages: int, seg_steps: int, impl: Optional[str] = None):
    """A paged decode engine over the paged decode DAG placed by
    ``greedy`` on one node; returns ``(engine, pool)``."""
    from ..frontend.decode_dag import build_paged_decode_dag
    from ..models.kv_pages import PagePool
    from ..sched.policies import get_scheduler

    dag = build_paged_decode_dag(config, slots=slots, page_size=page_size,
                                 n_pages=n_pages, pages_per_seq=pages_per_seq,
                                 attention_impl=impl)
    sched = get_scheduler("greedy").schedule(dag.graph, cluster)
    pool = PagePool(n_pages=n_pages, page_size=page_size)
    eng = backend.paged_decode_engine(
        dag.graph, sched, config, weights, pool, slots=slots,
        pages_per_seq=pages_per_seq, seg_steps=seg_steps,
        attention_impl=impl)
    return eng, pool


def _serve(eng: Any, reqs: list) -> Dict[str, Any]:
    for rid, ids, gen in reqs:
        eng.submit(rid, ids, gen)
    return dict(eng.run())


def _evaluate_bench_slo(reqlog) -> Dict[str, Any]:
    from ..obs.slo import SLOPolicy, evaluate_slo

    policy = SLOPolicy(ttft_s=10.0, tpot_s=1.0, e2e_s=60.0, window_s=1.0)
    return evaluate_slo(reqlog, policy).summary()


@torch.no_grad()
def measure_paged_decode(
    config: Any = None,
    slots: int = 4,
    page_size: int = 16,
    pages_per_seq: int = 8,
    n_pages: int = 64,
    seg_steps: int = 8,
    n_requests: int = 12,
    reps: int = 5,
    device: Any = "cuda",
) -> Dict[str, Any]:
    """Mixed-length multi-request serving: paged continuous batching
    against dense static batching at equal token budgets.

    The workload: ``n_requests`` requests of two prompt lengths with one
    long generation per three short.  The DENSE baseline groups by prompt
    length into batches of up to ``slots`` and runs ``generate`` per batch
    (every row pays the batch's longest generation); the PAGED engine
    retires each request the step it finishes and admits the next.  Both
    attend over the same capacity (``pages_per_seq * page_size``), in the
    model's f32 default, so each request's greedy tokens must be equal
    (``tokens_exact``).  tok/s counts useful tokens over the end-to-end
    wall (median of ``reps`` interleaved runs).  Keys: the JAX bench's,
    plus ``device``."""
    from ..backends.device import DeviceBackend
    from ..core.cluster import Cluster
    from ..models.family import family_of, module_for
    from ..models.kv_pages import pages_needed

    if config is None:
        from ..models.gpt2 import GPT2Config

        config = GPT2Config.tiny()  # f32: batch-size-invariant numerics
    device = torch.device(device)
    mod = module_for(family_of(config))
    capacity = pages_per_seq * page_size
    params = init_params(mod, config, 0, device)
    reqs = _paged_workload(config, n_requests, capacity)
    useful_tokens = sum(g for _, _, g in reqs)

    batches = []
    for P in sorted({ids.shape[1] for _, ids, _ in reqs}):
        group = [r for r in reqs if r[1].shape[1] == P]
        for j in range(0, len(group), slots):
            chunk = group[j:j + slots]
            batches.append((
                torch.from_numpy(np.concatenate([r[1] for r in chunk])).to(device),
                [r[2] for r in chunk], [r[0] for r in chunk]))

    def run_dense():
        out = {}
        for ids_b, gens, rids in batches:
            toks = mod.generate(params, ids_b, config,
                                max_new_tokens=max(gens),
                                max_len=capacity).cpu().numpy()
            P = ids_b.shape[1]
            for row, (rid, gen) in enumerate(zip(rids, gens)):
                out[rid] = toks[row, P:P + gen]  # padding rows truncated
        return out

    dense_tokens = run_dense()  # warm-up pass
    cluster = Cluster.from_torch_devices([device])
    eng, pool = _paged_engine(DeviceBackend(cluster), cluster, config, params,
                              slots, page_size, pages_per_seq, n_pages,
                              seg_steps)
    paged_tokens = _serve(eng, reqs)  # warm-up pass
    segments = eng.segments_run
    # interleaved reps, median walls: host drift hits both paths alike
    walls_d, walls_p = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        run_dense()
        walls_d.append(time.perf_counter() - t0)
        eng.reset()
        t0 = time.perf_counter()
        _serve(eng, reqs)
        walls_p.append(time.perf_counter() - t0)
    dense_wall = sorted(walls_d)[len(walls_d) // 2]
    paged_wall = sorted(walls_p)[len(walls_p) // 2]

    exact = all(np.array_equal(dense_tokens[rid], np.asarray(paged_tokens[rid]))
                for rid, _, _ in reqs)
    dense_tok_s = useful_tokens / max(dense_wall, 1e-9)
    paged_tok_s = useful_tokens / max(paged_wall, 1e-9)
    dense_slot_steps = sum(ids_b.shape[0] * max(gens)
                           for ids_b, gens, _ in batches)
    total_pages = sum(pages_needed(ids.shape[1] + gen, page_size)
                      for _, ids, gen in reqs)
    return {
        "n_requests": n_requests,
        "slots": slots,
        "page_size": page_size,
        "pages_per_seq": pages_per_seq,
        "n_pages": n_pages,
        "seg_steps": seg_steps,
        "capacity": capacity,
        "useful_tokens": useful_tokens,
        "dense_slot_steps": dense_slot_steps,
        "paged_slot_steps": segments * seg_steps * slots,
        "segments": segments,
        "pages_allocated_total": total_pages,
        "pages_leaked": (pool.n_pages - 1) - pool.free_pages,
        "dense_tok_s": round(dense_tok_s, 4),
        "paged_tok_s": round(paged_tok_s, 4),
        "speedup": round(paged_tok_s / max(dense_tok_s, 1e-9), 4),
        "tokens_exact": bool(exact),
        "metrics": eng.metrics.snapshot(),
        "requests": eng.reqlog.snapshot(),
        "slo": _evaluate_bench_slo(eng.reqlog),
        "device": _device_kind(device),
    }


@torch.no_grad()
def measure_paged_kernel(
    config: Any = None,
    slots: int = 4,
    page_size: int = 16,
    pages_per_seq: int = 8,
    n_pages: int = 64,
    seg_steps: int = 8,
    n_requests: int = 12,
    reps: int = 5,
    device: Any = "cuda",
) -> Dict[str, Any]:
    """The kernel leg: :func:`measure_paged_decode`'s workload through two
    paged engines that differ only in attention impl: the plain gather
    version (``attention_impl="plain"``, named by ``gather_impl``) and the
    CUDA kernels (``"kernel"``).

    Reported: each engine's useful tok/s, per-request tokens equal
    between them (``tokens_exact``), leaked pages per engine, and the
    op-level parity sweeps (:func:`op_parity` over the 7 single-token and
    5 ragged fixtures, ``parity_ok``/``ragged_parity_ok``).  On the card
    ``kernel_vs_gather_speedup`` too.  On the CPU both engines run the
    plain version (the kernels need the card): parity only, disclosed by
    ``cpu_parity_only``.  Keys: the JAX bench's, with ``gather_impl`` and
    ``device`` added and ``cpu_interpret_parity_only`` (JAX runs Pallas
    in interpret mode off the TPU) named ``cpu_parity_only``."""
    from ..backends.device import DeviceBackend
    from ..core.cluster import Cluster
    from ..frontend.decode_dag import cache_dims
    from ..models.family import family_of, module_for
    from ..ops.attention import paged_kernel_constraints

    if config is None:
        from ..models.gpt2 import GPT2Config

        config = GPT2Config.tiny()
    device = torch.device(device)
    on_card = device.type == "cuda"
    # the kernel engine's tasks are built "auto": the kernel for CUDA
    # tensors (it raises, never falls back, on a call it does not take),
    # the plain version for the meta tensors of the build and on the CPU
    kernel_impl = "kernel" if on_card else "auto"
    mod = module_for(family_of(config))
    capacity = pages_per_seq * page_size
    params = init_params(mod, config, 0, device)
    _n_layers, n_kv_heads, head_dim = cache_dims(config)
    reqs = _paged_workload(config, n_requests, capacity)
    useful_tokens = sum(g for _, _, g in reqs)

    cluster = Cluster.from_torch_devices([device])
    backend = DeviceBackend(cluster)
    geom = (slots, page_size, pages_per_seq, n_pages, seg_steps)
    eng_x, pool_x = _paged_engine(backend, cluster, config, params, *geom,
                                  impl="plain")
    eng_k, pool_k = _paged_engine(backend, cluster, config, params, *geom,
                                  impl="auto")
    toks_x = _serve(eng_x, reqs)  # warm-up passes
    toks_k = _serve(eng_k, reqs)
    tokens_exact = all(
        np.array_equal(np.asarray(toks_x[rid]), np.asarray(toks_k[rid]))
        for rid, _, _ in reqs)
    leaked_x = (pool_x.n_pages - 1) - pool_x.free_pages
    leaked_k = (pool_k.n_pages - 1) - pool_k.free_pages

    walls_x, walls_k = [], []
    for _ in range(reps):
        for eng, walls in ((eng_x, walls_x), (eng_k, walls_k)):
            eng.reset()
            t0 = time.perf_counter()
            _serve(eng, reqs)
            walls.append(time.perf_counter() - t0)
    wall_x = sorted(walls_x)[len(walls_x) // 2]
    wall_k = sorted(walls_k)[len(walls_k) // 2]

    parity = op_parity(paged_parity_cases(page_size, device), kernel_impl)
    ragged = op_parity(ragged_parity_cases(page_size, device), kernel_impl)
    res: Dict[str, Any] = {
        "platform": device.type,
        "device": _device_kind(device),
        "kernel_impl": kernel_impl,
        "gather_impl": "plain",
        "kernel_geometry_eligible": not paged_kernel_constraints(
            page_size, head_dim, n_kv_heads, dtype=config.dtype),
        "n_requests": n_requests,
        "useful_tokens": useful_tokens,
        "page_size": page_size,
        "pages_per_seq": pages_per_seq,
        "gather_tok_s": round(useful_tokens / max(wall_x, 1e-9), 4),
        "kernel_tok_s": round(useful_tokens / max(wall_k, 1e-9), 4),
        "tokens_exact": bool(tokens_exact),
        "pages_leaked_gather": int(leaked_x),
        "pages_leaked_kernel": int(leaked_k),
        "parity": parity,
        "parity_ok": bool(parity["allclose"]),
        "ragged_parity": ragged,
        "ragged_parity_ok": bool(ragged["allclose"]),
    }
    if on_card:
        res["kernel_vs_gather_speedup"] = round(wall_x / max(wall_k, 1e-9), 4)
    else:
        res["cpu_parity_only"] = True
        res["disclosure"] = (
            "CPU run: both engines take the plain paged attention (the "
            "kernels need the card), so wall-clock compares nothing; "
            "parity and leak gates only")
    return res


def _round4(d: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in d.items()}


def _out_path(argv: List[str]) -> Optional[str]:
    return argv[argv.index("--out") + 1] if "--out" in argv else None


def paged_gate_failures(res: Dict[str, Any]) -> List[str]:
    failures = []
    if not res["tokens_exact"]:
        failures.append("paged tokens diverge from dense argmax")
    if res["speedup"] < 1.0:
        failures.append(
            f"paged {res['paged_tok_s']} tok/s < dense {res['dense_tok_s']} "
            f"tok/s (speedup {res['speedup']})")
    if res["pages_leaked"]:
        failures.append(f"{res['pages_leaked']} pages leaked")
    return failures


def kernel_gate_failures(res: Dict[str, Any]) -> List[str]:
    failures = []
    if not res["tokens_exact"]:
        failures.append("kernel engine tokens diverge from the gather engine")
    for key, label in (("parity", "op-level"), ("ragged_parity", "ragged")):
        if not res[key + "_ok"]:
            bad = [n for n, r in res[key]["fixtures"].items()
                   if not (r["allclose"] and r["finite"])]
            failures.append(f"{label} parity failed on {bad}")
    if res["pages_leaked_gather"] or res["pages_leaked_kernel"]:
        failures.append(f"pages leaked (gather {res['pages_leaked_gather']}, "
                        f"kernel {res['pages_leaked_kernel']})")
    if res.get("kernel_vs_gather_speedup", 1.1) < 1.1:
        failures.append(
            f"kernel {res['kernel_tok_s']} tok/s vs gather "
            f"{res['gather_tok_s']} tok/s: speedup "
            f"{res['kernel_vs_gather_speedup']} < 1.1x")
    return failures


def main(argv: Optional[List[str]] = None) -> int:
    """The bench's command line (see the module docstring); runs on the
    card and exits 2 without one."""
    argv = sys.argv[1:] if argv is None else argv
    mode = argv[0] if argv else ""
    if not torch.cuda.is_available():
        print("decode_bench: no CUDA device", file=sys.stderr)
        return 2
    if mode == "--tp" or mode.startswith("--tp="):
        try:
            tp = int(mode.split("=", 1)[1] if "=" in mode else argv[1])
        except (IndexError, ValueError):
            print("usage: decode_bench [--tp N]", file=sys.stderr)
            return 2
        print(json.dumps(_round4(measure_decode_sharded(tp=tp))))
        return 0
    if mode == "--attribute":
        print(json.dumps(decode_attribution()))
        return 0
    if mode == "--dag":
        print(json.dumps(measure_decode_dag()))
        return 0
    if mode in ("--int8", "--kv-int8"):
        # --int8: weights and KV cache quantized; --kv-int8: the cache only
        res = measure_decode(quantize=mode == "--int8", kv_int8=True)
        print(json.dumps(_round4(res)))
        return 0
    if mode in ("--paged", "--kernel"):
        paged = mode == "--paged"
        res = measure_paged_decode() if paged else measure_paged_kernel()
        res = _round4(res) if paged else res
        print(json.dumps(res))
        out = _out_path(argv)
        if out:
            with open(out, "w") as f:
                json.dump(res, f, indent=1)
        failures = (paged_gate_failures(res) if paged
                    else kernel_gate_failures(res))
        tag = "PAGED" if paged else "KERNEL"
        for f_ in failures:
            print(f"{tag} GATE FAIL: {f_}", file=sys.stderr)
        if failures:
            return 1
        print(f"{tag} GATES PASS", file=sys.stderr)
        return 0
    if mode:
        print(f"decode_bench: unknown mode {mode!r}", file=sys.stderr)
        return 2
    print(json.dumps(_round4(measure_decode())))
    return 0


__all__ = [
    "PARITY_TOL",
    "PEAK_HBM_GBPS",
    "decode_attribution",
    "decode_roofline",
    "kernel_gate_failures",
    "measure_decode",
    "measure_decode_dag",
    "measure_decode_sharded",
    "measure_paged_decode",
    "measure_paged_kernel",
    "op_parity",
    "paged_gate_failures",
    "paged_parity_cases",
    "prompt_ids",
    "ragged_parity_cases",
    "serving_case",
]


if __name__ == "__main__":
    sys.exit(main())
