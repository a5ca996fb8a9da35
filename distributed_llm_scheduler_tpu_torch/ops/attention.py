"""Attention: hand-written CUDA kernels beside their plain versions.

PyTorch port of ``distributed_llm_scheduler_tpu.ops.attention``.

Dense half: the Pallas TPU kernel ``_flash_kernel`` becomes
``csrc/flash_attention.cu``, CUDA kernels for Hopper that keep the (T, T)
score matrix out of device memory with the same online softmax: bf16 on
the tensor cores (``mma.sync``, P split into two bf16 terms so the output
stays within one bf16 rounding of the f32 function), f32 on the CUDA
cores.  K and V may carry fewer heads than q (grouped-query attention);
the kernels read each KV head in place for its group of query heads.
``mha`` and ``gqa_mha`` are the public entries, with the JAX package's
signatures and (B, H, T, hd) layout.  The flash path is differentiable
as the JAX package's ``_flash_with_vjp`` is: the kernel runs the forward,
and the backward (:func:`flash_attention_backward`) recomputes attention
through the plain version under autograd from q, k and v alone.

Paged half: ``_paged_kernel`` (single-token decode with the in-kernel
insert of this step's K/V row) and ``_paged_ragged_kernel`` (multi-token
q with per-slot ``q_lens``) become the two entry points of
``csrc/paged_attention.cu``.  The single-token one splits each slot's
positions across blocks (:func:`paged_split` sizes the split from the
geometry, never from the lengths on the device) and merges the splits'
partials in the same launch, through distributed shared memory.  The
ragged one has two variants, picked on the host by :func:`ragged_plan`:
bf16 runs the same split with the chunk's query rows on the tensor
cores (:func:`ragged_split` sizes it, capped by the partials' shared
memory); f32 walks the positions on the CUDA cores.
``paged_decode_attention`` is the public entry, with the JAX package's
signature.

Dispatch is by device: a CUDA tensor goes to a kernel, which either
launches or raises; a CPU or meta tensor goes to the plain version
(:func:`reference_mha`, :func:`reference_paged_attention`,
:func:`reference_paged_attention_ragged`), which is how the CPU tests and
shape inference (``device="meta"`` in the DAG builders) run.  No other
device is accepted.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import List, Optional

import torch

from . import kernels

KERNEL = "flash_attention"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
kernels.launches.setdefault(KERNEL, 0)


def reference_mha(q, k, v, causal: bool = True, sm_scale: Optional[float] = None):
    """Plain PyTorch oracle with the JAX package's ``reference_mha``
    arithmetic: scores in the input dtype, softmax in f32, probabilities
    cast to ``v.dtype`` before P@V.  O(T^2) memory."""
    hd = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        T = q.shape[-2]
        i = torch.arange(T, device=q.device)
        scores = torch.where(
            i[None, :] <= i[:, None], scores, torch.finfo(scores.dtype).min
        )
    probs = torch.softmax(scores.float(), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def _library() -> ctypes.CDLL:
    lib = kernels.load(KERNEL)
    fn = lib.dls_flash_attention_fwd
    if fn.argtypes is None:  # first load: declare the C signature
        vp, i = ctypes.c_void_p, ctypes.c_int
        # q, k, v, o, B, H, Hkv, T, hd, strides, dtype, causal, scale, stream
        fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp, i, i,
                       ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v) -> None:
    """Raise unless the kernel takes (q, k, v): q (B, Hq, T, hd), k and v
    (B, Hkv, T, hd) with Hq a multiple of Hkv, one dtype, one CUDA device,
    a unit head-dim stride, and for bf16 a 16-byte aligned base and (b, h,
    t) strides (the tensor-core kernel copies 16-byte chunks)."""
    if q.dim() != 4:
        raise ValueError(f"expected (B, H, T, hd) tensors, got {tuple(q.shape)}")
    B, H, T, hd = q.shape
    if k.dim() != 4 or (k.shape[0], k.shape[2], k.shape[3]) != (B, T, hd):
        raise ValueError(
            f"k shape {tuple(k.shape)} is not (B, Hkv, T, hd) for q shape "
            f"{tuple(q.shape)}"
        )
    if v.shape != k.shape:
        raise ValueError(f"v shape {tuple(v.shape)} != k shape {tuple(k.shape)}")
    Hkv = k.shape[1]
    if Hkv < 1 or H % Hkv:
        raise ValueError(
            f"{H} query heads are not a multiple of {Hkv} KV heads")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {_HEAD_DIMS}")
    if T < 1:
        raise ValueError("sequence length must be >= 1")
    bf16 = q.dtype == torch.bfloat16
    for name, t in (("q", q), ("k", k), ("v", v)):
        sb, sh, st, sd = t.stride()
        if sd != 1:
            raise ValueError(f"{name} head dim must be contiguous (stride 1)")
        # 16 bytes = 8 bf16 elements: every stride a multiple of 8
        if bf16 and (t.data_ptr() % 16 or (sb | sh | st) % 8):
            raise ValueError(
                f"{name}: base and (b, h, t) strides must be 16-byte aligned "
                f"for the bf16 kernel, got strides {t.stride()}")
    if q.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {q.device}")


def flash_attention(q, k, v, causal: bool = True, sm_scale: Optional[float] = None):
    """Launch the CUDA flash kernel on (B, H, T, hd) CUDA tensors.

    k and v may have fewer heads than q (H a multiple of Hkv): query head
    h reads KV head h // (H // Hkv) in place.  q, k and v may be strided
    views (e.g. heads split out of a fused qkv projection) as long as the
    head dim is contiguous.  The output is allocated as (B, T, H, hd) and
    returned as its (B, H, T, hd) view, so the caller's merge of heads back
    to (B, T, H*hd) needs no copy.  Raises when the inputs do not qualify
    or the launch fails.

    With grad enabled and q, k or v requiring grad, the call goes through
    :class:`_FlashAttention`, whose backward is
    :func:`flash_attention_backward`; otherwise (every executed path runs
    under ``torch.no_grad()``) the kernel is launched directly.  Either
    way the forward is one launch."""
    if torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, sm_scale)
    return _flash_forward(q, k, v, causal, sm_scale)


def _flash_forward(q, k, v, causal, sm_scale):
    """The kernel launch behind :func:`flash_attention`."""
    _check(q, k, v)
    B, H, T, hd = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    out = out.transpose(1, 2)
    strides = (ctypes.c_int64 * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3])
    )
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dls_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, k.shape[1], T, hd, ctypes.addressof(strides),
            _DTYPE_CODE[q.dtype], int(bool(causal)), float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash attention launch failed: cudaError {err}")
    kernels.launches[KERNEL] += 1
    return out


def flash_attention_backward(q, k, v, grad_out, causal: bool = True,
                             sm_scale: Optional[float] = None):
    """(dq, dk, dv) of attention at (q, k, v) for the cotangent
    ``grad_out``: the JAX package's ``_flash_with_vjp`` backward, which
    recomputes attention through the plain version and differentiates
    that (no O(T^2) tensor is kept between forward and backward; the
    recompute builds one).  k and v may carry fewer heads than q: they
    are repeated across each query group inside the differentiated graph,
    so dk and dv come back at their own head count, summed over the
    group."""
    group = q.shape[1] // k.shape[1]
    with torch.enable_grad():
        q_, k_, v_ = (t.detach().requires_grad_() for t in (q, k, v))
        kr, vr = ((k_, v_) if group == 1 else
                  (k_.repeat_interleave(group, dim=1),
                   v_.repeat_interleave(group, dim=1)))
        out = reference_mha(q_, kr, vr, causal=causal, sm_scale=sm_scale)
        return torch.autograd.grad(out, (q_, k_, v_), grad_out)


class _FlashAttention(torch.autograd.Function):
    """The flash kernel's forward with :func:`flash_attention_backward` as
    its backward; saves q, k and v only."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return _flash_forward(q, k, v, causal, sm_scale)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, grad_out, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def mha(q, k, v, causal: bool = True, sm_scale: Optional[float] = None):
    """Multi-head attention on (B, H, T, hd) tensors: the CUDA kernel for
    CUDA tensors, the plain version for CPU and meta tensors."""
    kind = q.device.type
    if kind == "cuda":
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    if kind in ("cpu", "meta"):
        return reference_mha(q, k, v, causal=causal, sm_scale=sm_scale)
    raise ValueError(f"mha: unsupported device {q.device}")


def gqa_mha(q, k, v, causal: bool = True, sm_scale: Optional[float] = None):
    """Grouped-query attention: q (B, Hq, T, hd), k/v (B, Hkv, T, hd) with
    Hq a multiple of Hkv.  CUDA tensors go to the flash kernel, which reads
    each KV head in place for its query group (one launch, no copy); CPU
    and meta tensors repeat each KV head across its group, as the JAX
    package does, and take the plain version."""
    Hq, Hkv = q.shape[1], k.shape[1]
    if Hq != Hkv and q.device.type != "cuda":
        if Hkv < 1 or Hq % Hkv:
            raise ValueError(f"{Hq} query heads are not a multiple of {Hkv} KV heads")
        k = k.repeat_interleave(Hq // Hkv, dim=1)
        v = v.repeat_interleave(Hq // Hkv, dim=1)
    return mha(q, k, v, causal=causal, sm_scale=sm_scale)


# -- paged attention ------------------------------------------------------------

PAGED_KERNEL = "paged_attention"
PAGED_RAGGED_KERNEL = "paged_attention_ragged"
PAGED_SOURCE = "paged_attention"  # csrc/paged_attention.cu holds both
PAGED_HEAD_DIMS = (8, 16, 32, 64, 128)
PAGED_IMPLS = (None, "auto", "kernel", "plain")
# the ragged kernel's variants: bf16 on the tensor cores, f32 walking the
# positions on the CUDA cores (:func:`ragged_plan` picks one per call)
RAGGED_TC, RAGGED_WALK = "tc", "walk"
kernels.launches.setdefault(PAGED_KERNEL, 0)
kernels.launches.setdefault(PAGED_RAGGED_KERNEL, 0)
for _variant in (RAGGED_TC, RAGGED_WALK):
    kernels.launches.setdefault(f"{PAGED_RAGGED_KERNEL}.{_variant}", 0)

# Hopper's shared memory (sm_90): a block may ask for up to SMEM_BLOCK
# bytes of dynamic shared memory; an SM holds SMEM_SM, less SMEM_RESERVED
# for each resident block, and at most 2,048 threads and 32 blocks.
SMEM_BLOCK, SMEM_SM, SMEM_RESERVED = 232448, 233472, 1024
SM_THREADS, SM_BLOCKS = 2048, 32
# the split kernels keep at most this many page ids per split, and the
# splits of one (slot, KV head) form a cluster of at most 8 (portable)
MAX_SPAN_PAGES, MAX_SPLITS = 1024, 8
RAGGED_MAX_WARPS = 8  # warps per block of the tensor-core kernel


def reference_paged_attention(
    q, k_pool, v_pool, page_table, lengths, sm_scale: float,
    k_new=None, v_new=None,
):
    """Plain single-token paged attention: the JAX package's gather path.

    ``q`` (S, Hq, 1, hd); pools (P, ps, Hkv, hd); ``page_table`` (S,
    ppseq) int; ``lengths`` (S,) int.  Each slot's pages are gathered into
    a (S, M, Hkv, hd) view, M = ppseq * ps; ``k_new``/``v_new`` (S, Hkv,
    1, hd), when given, are written into that view at ``min(lengths[s],
    M - 1)`` before the scores (write-then-attend); slot ``s`` attends
    positions ``<= lengths[s]``.  Scores (S, Hkv, M, G) accumulate in f32
    from operands in q's dtype; masks use ``finfo.min``; p is cast to the
    output dtype before P·V, which accumulates in f32."""
    from ..models.kv_pages import gather_kv_flat  # lazy: models imports ops

    S, Hq, _, hd = q.shape
    k_view = gather_kv_flat(k_pool, page_table)  # (S, M, Hkv, hd)
    v_view = gather_kv_flat(v_pool, page_table)
    M, Hkv = k_view.shape[1], k_view.shape[2]
    G = Hq // Hkv
    lengths = lengths.long()
    if k_new is not None:
        s_idx = torch.arange(S, device=q.device)
        at = lengths.clamp(max=M - 1)
        k_view[s_idx, at] = k_new[:, :, 0, :].to(k_view.dtype)
        v_view[s_idx, at] = v_new[:, :, 0, :].to(v_view.dtype)
    qg = (q * sm_scale).reshape(S, Hkv, G, hd)
    s = torch.einsum("smhd,shgd->shmg", k_view.to(qg.dtype).float(), qg.float())
    rows = torch.arange(M, device=q.device)[None, None, :, None]
    s = torch.where(rows <= lengths.reshape(S, 1, 1, 1), s,
                    torch.finfo(s.dtype).min)
    m = s.amax(dim=2, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=2, keepdim=True)
    out_dtype = q.dtype
    o = torch.einsum(
        "shmg,smhd->shgd", p.to(out_dtype).float(), v_view.to(out_dtype).float()
    )
    return (o / l.reshape(S, Hkv, G, 1)).to(out_dtype).reshape(S, Hq, 1, hd)


def reference_paged_attention_ragged(
    q, k_pool, v_pool, page_table, lengths, q_lens, sm_scale: float,
):
    """Plain multi-token-q paged attention: the JAX package's
    ``_gather_chunk_attention``.

    ``q`` (S, Hq, Tn, hd); row ``t`` of slot ``s`` attends positions
    ``<= lengths[s] + clip(t, 0, max(q_lens[s] - 1, 0))``; rows at or past
    ``q_lens[s]`` are padding (finite, never meaningful).  The chunk's own
    K/V rows must already be in the pools.  Same arithmetic as
    :func:`reference_paged_attention`, with the query group axis widened
    from G to G * Tn (column ``c = g * Tn + t``)."""
    from ..models.kv_pages import gather_kv_flat  # lazy: models imports ops

    S, Hq, Tn, hd = q.shape
    k_view = gather_kv_flat(k_pool, page_table)  # (S, M, Hkv, hd)
    v_view = gather_kv_flat(v_pool, page_table)
    M, Hkv = k_view.shape[1], k_view.shape[2]
    G = Hq // Hkv
    qg = (q * sm_scale).reshape(S, Hkv, G * Tn, hd)
    s = torch.einsum("smhd,shcd->shmc", k_view.to(qg.dtype).float(), qg.float())
    rows = torch.arange(M, device=q.device)[None, None, :, None]
    t = (torch.arange(G * Tn, device=q.device) % Tn)[None, None, None, :]
    ql = q_lens.long().reshape(S, 1, 1, 1)
    t_eff = torch.minimum(t, (ql - 1).clamp(min=0))
    valid = rows <= lengths.long().reshape(S, 1, 1, 1) + t_eff
    s = torch.where(valid, s, torch.finfo(s.dtype).min)
    m = s.amax(dim=2, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=2, keepdim=True)
    out_dtype = q.dtype
    o = torch.einsum(
        "shmc,smhd->shcd", p.to(out_dtype).float(), v_view.to(out_dtype).float()
    )
    return (o / l.reshape(S, Hkv, G * Tn, 1)).to(out_dtype).reshape(S, Hq, Tn, hd)


def paged_kernel_constraints(
    page_size: int,
    head_dim: int,
    n_kv_heads: int,
    n_q_heads: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    q_tokens: Optional[int] = None,
    contiguous: bool = True,
) -> List[str]:
    """Violated rules of the Hopper paged kernels; an empty list means the
    geometry qualifies.  Each string names the rule it breaks.

    The kernels read one K/V row of ``head_dim`` elements per key in
    16-byte pieces (so the head dim is a multiple of 8, and their register
    tiles are compiled for a fixed set of widths), find each position's
    row through the page table (any page size), fold
    ``n_q_heads // n_kv_heads`` query heads onto each KV head, and address
    the pools as contiguous (P, ps, Hkv, hd) arrays."""
    out = []
    if head_dim not in PAGED_HEAD_DIMS:
        out.append(f"head_dim {head_dim} is not one of {PAGED_HEAD_DIMS}")
    if page_size < 1:
        out.append(f"page_size {page_size} must be >= 1")
    if n_kv_heads < 1:
        out.append(f"n_kv_heads {n_kv_heads} must be >= 1")
    elif n_q_heads is not None and n_q_heads % n_kv_heads:
        out.append(
            f"n_q_heads {n_q_heads} is not a multiple of n_kv_heads "
            f"{n_kv_heads} (GQA group mapping)"
        )
    if dtype not in _DTYPE_CODE:
        out.append(f"dtype {dtype} is not float32 or bfloat16")
    if q_tokens is not None and q_tokens < 1:
        out.append(f"q_tokens {q_tokens} must be >= 1")
    if not contiguous:
        out.append("K/V pools must be contiguous (P, ps, Hkv, hd) arrays")
    return out


def paged_split(
    blocks_per_split: int, page_size: int, pages_per_seq: int, sm_count: int,
):
    """(pages per split, number of splits) for the single-token kernel.

    Each split spans whole pages, at least 64 positions (a page, when
    pages are longer).  The splits of a (slot, KV head) form one
    thread-block cluster, so there are at most 8 (the portable cluster
    size).  Splits are added until the grid holds 8 blocks per SM (about
    half of them over live positions when lengths spread over the
    capacity), never more than the capacity fills, never fewer than one.
    Sized from the geometry alone: the lengths live on the device and
    are never read here."""
    min_pages = -(-64 // page_size)
    most = min(8, -(-pages_per_seq // min_pages))
    want = -(-8 * sm_count // blocks_per_split)
    n = max(1, min(want, most))
    pps = min(max(min_pages, -(-pages_per_seq // n)), pages_per_seq)
    return pps, -(-pages_per_seq // pps)


def _split_blocks(S: int, Hq: int, Hkv: int) -> int:
    """Blocks of one split of the single-token kernel: one per (slot, KV
    head, tile of the group's query heads), a tile being one head without
    GQA and up to four with it (as ``csrc/paged_attention.cu`` tiles)."""
    G = Hq // Hkv
    return S * Hkv * (1 if G == 1 else -(-G // 4))


def ragged_tile_keys(head_dim: int) -> int:
    """Keys per K/V tile of the tensor-core ragged kernel (``Tc<HD>::TK``
    in ``csrc/paged_attention.cu``): 64, or 32 at head dims above 64, so
    a tile's bf16 K and V rows take at most 16 KB a stage."""
    return 32 if head_dim > 64 else 64


def ragged_key_groups(head_dim: int) -> int:
    """Warps that share an M-tile of the tensor-core ragged kernel, each
    taking 32 of a tile's keys (``Tc<HD>::KG``): 2, or 1 at head dims
    above 64."""
    return ragged_tile_keys(head_dim) // 32


def ragged_smem_bytes(rows: int, head_dim: int, pages_per_split: int,
                      n_split: int) -> int:
    """Dynamic shared memory of one block of ``rows`` query rows of the
    tensor-core ragged kernel (``ragged_tc_smem`` in
    ``csrc/paged_attention.cu``): K and V tiles in two stages at the head
    dim padded to 16 (bf16); the landing place of the f32 partials (acc,
    m and l) of the block's slice of ceil(rows / n_split) rows, one from
    each key group of each split; the split's page ids."""
    hdp = max(head_dim, 16)
    staging = 2 * 2 * ragged_tile_keys(head_dim) * hdp * 2
    slice_rows = -(-rows // n_split)
    partials = n_split * ragged_key_groups(head_dim) * slice_rows
    return staging + partials * (head_dim + 2) * 4 + 4 * pages_per_split


def ragged_split(blocks_per_split: int, rows: int, head_dim: int,
                 page_size: int, pages_per_seq: int, sm_count: int):
    """(pages per split, number of splits) for the tensor-core ragged
    kernel, whose blocks of ``rows`` query rows (``rows * 2`` threads per
    key group) number ``blocks_per_split`` in each split.

    Each split spans whole pages, a multiple of the fewest that hold one
    K/V tile of positions (:func:`ragged_tile_keys`), so at page sizes
    that divide the tile a span is whole tiles.  At most 8 splits (one
    cluster).  The most splits are taken whose footprint
    (:func:`ragged_smem_bytes`) fits a block and whose grid fits the card
    in one wave at the blocks per SM that footprint allows; when no count
    fills only one wave, the fewest that fit a block.  Sized from the
    geometry alone: the lengths live on the device and are never read
    here.  Raises ValueError when no split count fits."""
    min_pages = -(-ragged_tile_keys(head_dim) // page_size)
    most = min(MAX_SPLITS, -(-pages_per_seq // min_pages))
    fits = None
    for n in range(most, 0, -1):
        pps = min(-(-pages_per_seq // (n * min_pages)) * min_pages, pages_per_seq)
        n_eff = -(-pages_per_seq // pps)
        smem = ragged_smem_bytes(rows, head_dim, pps, n_eff)
        if pps > MAX_SPAN_PAGES or smem > SMEM_BLOCK:
            continue
        threads = 2 * rows * ragged_key_groups(head_dim)
        per_sm = min(SMEM_SM // (smem + SMEM_RESERVED),
                     SM_THREADS // threads, SM_BLOCKS)
        if blocks_per_split * n_eff <= per_sm * sm_count:
            return pps, n_eff
        fits = (pps, n_eff)  # the smallest count that fits, so far
    if fits is None:
        raise ValueError(
            f"{pages_per_seq} pages of {page_size} per slot at head dim "
            f"{head_dim}: no split count of at most {MAX_SPLITS} keeps a "
            f"split within {MAX_SPAN_PAGES} pages and {SMEM_BLOCK} bytes of "
            f"shared memory")
    return fits


@dataclass(frozen=True)
class RaggedPlan:
    """How one ragged call runs: ``variant`` (RAGGED_TC or RAGGED_WALK)
    and, for the tensor-core kernel, the warps of a block (its 16-row
    M-tiles times the key groups), the row tiles that cover a KV head's
    query rows, the pages of each split and the splits (one cluster)."""

    variant: str
    warps: int = 0
    row_tiles: int = 0
    pages_per_split: int = 0
    n_split: int = 0


def ragged_plan(dtype, S: int, Hq: int, Hkv: int, Tn: int, head_dim: int,
                page_size: int, pages_per_seq: int, sm_count: int) -> RaggedPlan:
    """The ragged kernel variant for a call, from dtype, head dim and
    geometry alone (never from the lengths on the device).

    bfloat16 runs on the tensor cores (RAGGED_TC): the KV head's G * Tn
    query rows in tiles of M-tiles of 16, each M-tile taken by
    :func:`ragged_key_groups` warps (at most 8 warps a block), the
    positions split across a cluster by :func:`ragged_split`.  float32
    walks the positions on the CUDA cores (RAGGED_WALK): TF32 tensor
    cores would not meet the f32 legs' 1e-5.  Raises ValueError on a call
    that no variant takes."""
    if dtype == torch.float32:
        return RaggedPlan(RAGGED_WALK)
    if dtype != torch.bfloat16:
        raise ValueError(f"ragged paged attention: no variant takes {dtype}")
    R = (Hq // Hkv) * Tn
    kg = ragged_key_groups(head_dim)
    m_tiles = min(RAGGED_MAX_WARPS // kg, -(-R // 16))
    rows = 16 * m_tiles
    row_tiles = -(-R // rows)
    pps, n_split = ragged_split(S * Hkv * row_tiles, rows, head_dim,
                                page_size, pages_per_seq, sm_count)
    return RaggedPlan(RAGGED_TC, m_tiles * kg, row_tiles, pps, n_split)


def _paged_library():
    lib = kernels.load(PAGED_SOURCE)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.dls_paged_attention_fwd
    if fn.argtypes is None:  # first load: declare the C signatures
        # q, k_pool, v_pool, page_table, lengths, k_new, v_new, out,
        # q strides, new strides, S, Hq, Hkv, hd, page_size, ppseq,
        # pages_per_split, has_new, dtype, sm_scale, stream
        fn.argtypes = [vp] * 10 + [i] * 9 + [f, vp]
        fn.restype = ctypes.c_int
        rg = lib.dls_paged_attention_ragged_fwd
        # q, k_pool, v_pool, page_table, lengths, q_lens, out, q strides,
        # S, Hq, Hkv, Tn, hd, page_size, ppseq, dtype, sm_scale, stream
        rg.argtypes = [vp] * 8 + [i] * 8 + [f, vp]
        rg.restype = ctypes.c_int
        tc = lib.dls_paged_attention_ragged_tc_fwd
        # the same, with warps, pages_per_split and n_split for dtype
        tc.argtypes = [vp] * 8 + [i] * 10 + [f, vp]
        tc.restype = ctypes.c_int
    return lib


def _aligned_rows(t):
    """``t`` with unit head-dim stride and 16-byte aligned rows (the
    kernels load K/V rows as 16-byte vectors): as given, or a copy."""
    esz = t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all((st * esz) % 16 == 0 for st in t.stride()[:-1])):
        return t
    return t.contiguous()


def _check_paged(q, k_pool, v_pool, page_table, lengths, q_tokens):
    if q.device.type != "cuda":
        raise ValueError(f"the paged kernels take CUDA tensors, got {q.device}")
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError(
            f"expected q (S, Hq, Tn, hd) and pools (P, ps, Hkv, hd), got "
            f"{tuple(q.shape)} and {tuple(k_pool.shape)}"
        )
    S, Hq, Tn, hd = q.shape
    P, ps, Hkv, pool_hd = k_pool.shape
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"v_pool {tuple(v_pool.shape)} != k_pool {tuple(k_pool.shape)}")
    if pool_hd != hd:
        raise ValueError(f"pool head dim {pool_hd} != q head dim {hd}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if page_table.dim() != 2 or page_table.shape[0] != S:
        raise ValueError(f"page_table {tuple(page_table.shape)} is not ({S}, ppseq)")
    if tuple(lengths.shape) != (S,):
        raise ValueError(f"lengths {tuple(lengths.shape)} is not ({S},)")
    bad = paged_kernel_constraints(
        ps, hd, Hkv, n_q_heads=Hq, dtype=q.dtype, q_tokens=q_tokens,
        contiguous=k_pool.is_contiguous() and v_pool.is_contiguous(),
    )
    if bad:
        raise ValueError("paged kernel does not take this call: " + "; ".join(bad))
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernels copy 16-byte chunks of its "
                             f"rows, so its base must be 16-byte aligned")


def _int32(t):
    return t.to(torch.int32).contiguous()


def paged_attention(
    q, k_pool, v_pool, page_table, lengths, sm_scale: Optional[float] = None,
    k_new=None, v_new=None,
):
    """Launch the CUDA single-token paged kernel (the port of
    ``_paged_kernel``) on CUDA tensors; see
    :func:`reference_paged_attention` for the function it computes.
    One call is one launch and one count in ``kernels.launches``: the
    splits of a slot merge inside it, through their thread-block
    cluster's shared memory.  Nothing is read back to the host.  Raises
    when the call does not qualify or the launch fails."""
    _check_paged(q, k_pool, v_pool, page_table, lengths, None)
    S, Hq, Tn, hd = q.shape
    if Tn != 1:
        raise ValueError(f"single-token kernel takes Tn == 1, got {Tn}")
    _, ps, Hkv, _ = k_pool.shape
    has_new = k_new is not None
    if has_new:
        for name, t in (("k_new", k_new), ("v_new", v_new)):
            if t is None or tuple(t.shape) != (S, Hkv, 1, hd):
                raise ValueError(f"{name} must be ({S}, {Hkv}, 1, {hd})")
            if t.dtype != q.dtype or t.device != q.device:
                raise ValueError(f"{name} must match q's dtype and device")
        kn, vn = _aligned_rows(k_new), _aligned_rows(v_new)
        if kn.stride()[:2] != vn.stride()[:2]:
            kn, vn = kn.contiguous(), vn.contiguous()
        new_strides = (kn.stride(0), kn.stride(1))
    else:
        kn = vn = k_pool  # never read
        new_strides = (0, 0)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    pt, ln = _int32(page_table), _int32(lengths)
    if q.stride(-1) != 1:
        q = q.contiguous()
    out = torch.empty((S, Hq, 1, hd), dtype=q.dtype, device=q.device)
    ppseq = pt.shape[1]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    pps, _ = paged_split(_split_blocks(S, Hq, Hkv), ps, ppseq, sms)
    if pps > MAX_SPAN_PAGES:
        raise ValueError(
            f"{ppseq} pages per slot need splits of {pps} pages; the kernel "
            f"keeps at most {MAX_SPAN_PAGES} page ids per split (8 splits)")
    q_strides = (ctypes.c_int64 * 3)(*q.stride()[:3])
    n_strides = (ctypes.c_int64 * 2)(*new_strides)
    lib = _paged_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dls_paged_attention_fwd(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), pt.data_ptr(),
            ln.data_ptr(), kn.data_ptr(), vn.data_ptr(), out.data_ptr(),
            ctypes.addressof(q_strides), ctypes.addressof(n_strides),
            S, Hq, Hkv, hd, ps, ppseq, pps, int(has_new),
            _DTYPE_CODE[q.dtype], float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"paged attention launch failed: cudaError {err}")
    kernels.launches[PAGED_KERNEL] += 1
    return out


def paged_attention_ragged(
    q, k_pool, v_pool, page_table, lengths, q_lens,
    sm_scale: Optional[float] = None,
):
    """Launch the CUDA multi-token-q paged kernel (the port of
    ``_paged_ragged_kernel``) on CUDA tensors; see
    :func:`reference_paged_attention_ragged` for the function it
    computes.  :func:`ragged_plan` picks the variant on the host; one
    call is one launch, counted under ``paged_attention_ragged`` and
    ``paged_attention_ragged.<variant>``.  Nothing is read back to the
    host.  Raises when no variant takes the call or the launch fails."""
    S, Hq, Tn, hd = q.shape
    _check_paged(q, k_pool, v_pool, page_table, lengths, Tn)
    if tuple(q_lens.shape) != (S,) or q_lens.device != q.device:
        raise ValueError(f"q_lens must be ({S},) on {q.device}")
    _, ps, Hkv, _ = k_pool.shape
    ppseq = page_table.shape[1]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = ragged_plan(q.dtype, S, Hq, Hkv, Tn, hd, ps, ppseq, sms)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    pt, ln, ql = _int32(page_table), _int32(lengths), _int32(q_lens)
    # the tensor-core kernel reads q as bf16 pairs: 4-byte aligned rows
    if q.stride(-1) != 1 or (plan.variant == RAGGED_TC and (
            q.data_ptr() % 4 or any(st % 2 for st in q.stride()[:3]))):
        q = q.contiguous()
    out = torch.empty((S, Hq, Tn, hd), dtype=q.dtype, device=q.device)
    q_strides = (ctypes.c_int64 * 3)(*q.stride()[:3])
    lib = _paged_library()
    args = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), pt.data_ptr(),
            ln.data_ptr(), ql.data_ptr(), out.data_ptr(),
            ctypes.addressof(q_strides), S, Hq, Hkv, Tn, hd, ps, ppseq)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if plan.variant == RAGGED_TC:
            err = lib.dls_paged_attention_ragged_tc_fwd(
                *args, plan.warps, plan.pages_per_split, plan.n_split,
                float(scale), stream)
        else:
            err = lib.dls_paged_attention_ragged_fwd(
                *args, _DTYPE_CODE[q.dtype], float(scale), stream)
    if err != 0:
        raise RuntimeError(
            f"ragged paged attention ({plan.variant}) launch failed: "
            f"cudaError {err}")
    kernels.launches[PAGED_RAGGED_KERNEL] += 1
    kernels.launches[f"{PAGED_RAGGED_KERNEL}.{plan.variant}"] += 1
    return out


def check_paged_impl(impl: Optional[str]) -> None:
    """Raise on a paged-attention impl name the port does not know."""
    if impl not in PAGED_IMPLS:
        raise ValueError(
            f"unknown paged attention impl {impl!r}; expected one of "
            f"{PAGED_IMPLS}"
        )


def paged_decode_attention(
    q,
    k_pool,
    v_pool,
    page_table,
    lengths,
    sm_scale: Optional[float] = None,
    k_new=None,
    v_new=None,
    impl: Optional[str] = None,
    q_lens=None,
):
    """Ragged paged attention with the JAX package's signature.

    ``q`` (S, Hq, 1, hd) — one new token per slot, attending positions
    ``<= lengths[s]`` of its pages, with ``k_new``/``v_new`` (S, Hkv, 1,
    hd) inserted at ``lengths[s]`` first; or ``q`` (S, Hq, Tn, hd) with
    per-slot ``q_lens`` — a ragged multi-token chunk whose K/V rows are
    already in the pools (``k_new`` is not accepted then).

    ``impl``: ``None``/``"auto"`` runs the CUDA kernel for CUDA tensors
    and the plain version for CPU and meta tensors; ``"kernel"`` demands
    the kernel (raises off the card); ``"plain"`` runs the plain version
    on any device.  A CUDA call whose geometry the kernel does not take
    raises (:func:`paged_kernel_constraints`); it never drops to the
    plain version."""
    check_paged_impl(impl)
    S, Hq, Tn, hd = q.shape
    if Tn != 1:
        if q_lens is None:
            raise ValueError(f"multi-token q (Tn={Tn}) requires per-slot q_lens")
        if k_new is not None:
            raise ValueError(
                "multi-token q takes no k_new/v_new: scatter the chunk "
                "into the pools first (write-then-attend at chunk "
                "granularity)"
            )
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    kind = q.device.type
    if impl in (None, "auto"):
        if kind not in ("cuda", "cpu", "meta"):
            raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
        impl = "kernel" if kind == "cuda" else "plain"
    if impl == "kernel":
        if kind != "cuda":
            raise ValueError(
                f"impl='kernel' needs CUDA tensors, got {q.device}")
        if Tn != 1:
            return paged_attention_ragged(
                q, k_pool, v_pool, page_table, lengths, q_lens, scale)
        return paged_attention(
            q, k_pool, v_pool, page_table, lengths, scale, k_new, v_new)
    if Tn != 1:
        return reference_paged_attention_ragged(
            q, k_pool, v_pool, page_table, lengths, q_lens, scale)
    return reference_paged_attention(
        q, k_pool, v_pool, page_table, lengths, scale, k_new, v_new)
