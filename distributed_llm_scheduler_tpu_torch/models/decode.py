"""Autoregressive KV-cache decoding: the dense cache and its attention.

PyTorch port of ``distributed_llm_scheduler_tpu.models.decode``: a
static-shape KV cache allocated at ``max_len`` up front, masked cached
attention, the int8 cache with per-row scales, greedy / temperature
sampling, and :func:`generate`.  JAX runs the generation as one jitted
``lax.scan`` per static configuration, the cache donated; here greedy
generation runs its decode steps over a :class:`DecodeProgram` that owns
the cache, as the donated buffers are owned by the jitted program: on a
card the step is one CUDA graph captured at the first step and replayed
(``backends.device.CapturedStep``), off the card the same body runs
eagerly.  The cache is written IN PLACE (JAX returns updated arrays);
every function still returns the cache so call sites read alike.

The step position ``pos_start`` is a Python int or a 0-d integer tensor on
the cache's device.  With a tensor, the cache writes are ``index_copy_``
at ``pos + arange(T)`` and the masks compare against it on the device, so
a step reads nothing back to the host (a decode DAG's task carries the
position as a tensor, and a captured step may not sync); with an int the
writes are slices.  Both give the same numbers.

The plain attention keeps the reference's arithmetic: scores of the
single-token path accumulate in f32 from operands in the query's dtype,
the prefill's scores are in the query's dtype, masks use ``finfo.min``,
probabilities are cast to the output dtype before P·V, which accumulates
in f32, and the single-token path divides by the softmax denominator
last.  An int8 cache's per-row scales fold into the score columns and
the probabilities after the contractions, as the reference's docstring
says (exact: a scale is constant along head_dim).

Each family module provides ``init_cache(config, batch, max_len, device)``
and ``forward_cached(params, ids, cache, pos_start, config)``;
:func:`generate` drives any of them.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

KVCache = Dict[str, torch.Tensor]  # {"k": (L, B, Hkv, M, hd), "v": same}
Pos = Union[int, torch.Tensor]


def init_cache(
    n_layers: int,
    batch: int,
    n_kv_heads: int,
    max_len: int,
    head_dim: int,
    dtype: torch.dtype,
    device: Any = "cuda",
) -> KVCache:
    """Zeroed stacked-layer cache; positions >= the write cursor are masked
    out by :func:`cached_attention`, so zeros never leak into outputs."""
    shape = (n_layers, batch, n_kv_heads, max_len, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def quantize_cache(cache: KVCache) -> KVCache:
    """An int8 container with the same (L, B, Hkv, M, hd) geometry: values
    as int8 plus one float32 absmax scale per cached row (L, B, Hkv, M, 1),
    on the cache's device.  Init scales are 1.0 but never read: every row
    is either written (getting a real scale) or masked out."""
    L, B, H, M, _ = cache["k"].shape
    dev = cache["k"].device
    return {
        "k": torch.zeros(cache["k"].shape, dtype=torch.int8, device=dev),
        "k_scale": torch.ones((L, B, H, M, 1), dtype=torch.float32, device=dev),
        "v": torch.zeros(cache["v"].shape, dtype=torch.int8, device=dev),
        "v_scale": torch.ones((L, B, H, M, 1), dtype=torch.float32, device=dev),
    }


def layer_view(cache: KVCache, layer: int):
    """(k, v, k_scale, v_scale) of one layer; the scales are None for a
    dense cache, so family attention code handles both layouts."""
    ks, vs = cache.get("k_scale"), cache.get("v_scale")
    return (
        cache["k"][layer],
        cache["v"][layer],
        None if ks is None else ks[layer],
        None if vs is None else vs[layer],
    )


def _quantize_rows(new: torch.Tensor):
    """(B, Hkv, T, hd) -> int8 values + per-row float32 absmax scales
    (B, Hkv, T, 1); round half to even, as ``jnp.round``."""
    xf = new.float()
    s = xf.abs().amax(dim=-1, keepdim=True)
    s = torch.where(s == 0, torch.ones_like(s), s / 127.0)
    return torch.round(xf / s).to(torch.int8), s


def positions(pos_start: Pos, T: int, device: Any) -> torch.Tensor:
    """(T,) int64 absolute positions ``[pos_start, pos_start + T)`` on
    ``device``, computed there when ``pos_start`` is a tensor."""
    ar = torch.arange(T, device=device)
    if isinstance(pos_start, torch.Tensor):
        return pos_start.to(device=device, dtype=torch.int64) + ar
    return ar + int(pos_start)


def write_rows(buf: torch.Tensor, new: torch.Tensor, pos_start: Pos) -> None:
    """Write ``new`` (..., T, d) into ``buf`` (..., M, d) at rows
    ``[pos_start, pos_start + T)`` in place.  An int start past the end
    raises (JAX's ``dynamic_update_slice`` would clamp); a tensor start is
    not read back, so its bounds are the caller's to check."""
    T = new.shape[-2]
    new = new.to(buf.dtype)
    if isinstance(pos_start, torch.Tensor):
        buf.index_copy_(buf.ndim - 2, positions(pos_start, T, buf.device), new)
        return
    pos = int(pos_start)
    if pos < 0 or pos + T > buf.shape[-2]:
        raise ValueError(f"rows [{pos}, {pos + T}) outside the cache's "
                         f"{buf.shape[-2]}")
    buf[..., pos:pos + T, :] = new


def update_layer_cache(
    cache: KVCache, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
    pos_start: Pos,
) -> KVCache:
    """Write (B, Hkv, T_new, hd) keys/values at [pos_start, pos_start+T_new)
    of layer ``layer``, in place.  An int8 cache (:func:`quantize_cache`
    layout) quantizes the incoming rows on write."""
    if "k_scale" in cache:
        kq, ks = _quantize_rows(k_new)
        vq, vs = _quantize_rows(v_new)
        write_rows(cache["k"][layer], kq, pos_start)
        write_rows(cache["k_scale"][layer], ks, pos_start)
        write_rows(cache["v"][layer], vq, pos_start)
        write_rows(cache["v_scale"][layer], vs, pos_start)
        return cache
    write_rows(cache["k"][layer], k_new, pos_start)
    write_rows(cache["v"][layer], v_new, pos_start)
    return cache


def cached_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos_start: Pos,
    sm_scale: float,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Causal attention of ``q`` (B, Hq, T_new, hd) over a full-length cache
    (B, Hkv, M, hd) whose rows beyond ``pos_start + T_new`` are invalid.

    Query row ``r`` (absolute position ``pos_start + r``) may attend cache
    columns ``c <= pos_start + r``; one mask covers the stale tail and
    causality among the new tokens, so one path serves prefill and decode.
    KV heads broadcast across their query group (GQA): prefill repeats
    them, the single-token path puts the group on its own axis.

    ``k_scale``/``v_scale`` (B, Hkv, M, 1) mark an int8 cache: its values
    enter the products as they are and the scales multiply the score
    columns / the probabilities after them."""
    B, Hq, Tn, hd = q.shape
    Hkv, M = k_cache.shape[1], k_cache.shape[2]
    if Tn == 1:
        return _decode_attention_natural(
            q, k_cache, v_cache, pos_start, sm_scale, k_scale, v_scale)
    if Hq != Hkv:
        group = Hq // Hkv
        k_cache = k_cache.repeat_interleave(group, dim=1)
        v_cache = v_cache.repeat_interleave(group, dim=1)
        if k_scale is not None:
            k_scale = k_scale.repeat_interleave(group, dim=1)
        if v_scale is not None:
            v_scale = v_scale.repeat_interleave(group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k_cache.to(q.dtype)) * sm_scale
    if k_scale is not None:
        # (B, H, M, 1) -> one multiplier per score column
        scores = scores * k_scale[..., 0][:, :, None, :].to(scores.dtype)
    rows = positions(pos_start, Tn, q.device)[:, None]
    cols = torch.arange(M, device=q.device)[None, :]
    scores = torch.where(cols <= rows, scores, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1)
    if v_scale is not None:
        probs = probs * v_scale[..., 0][:, :, None, :]
    out_dtype = q.dtype
    return torch.einsum(
        "bhqk,bhkd->bhqd", probs.to(out_dtype), v_cache.to(out_dtype))


def _decode_attention_natural(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: Pos,
    sm_scale: float,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token cached attention with the reference's K @ q
    orientation: scores (B, Hkv, M, G), softmax over M, the query group on
    the G axis so K/V are read once per KV head; int8 scales fold along
    the same axes."""
    B, Hq, _, hd = q.shape
    Hkv, M = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qg = (q * sm_scale).reshape(B, Hkv, G, hd)
    s = torch.einsum(
        "bhmd,bhgd->bhmg", k_cache.to(qg.dtype).float(), qg.float()
    )
    if k_scale is not None:
        s = s * k_scale.float()  # (B, Hkv, M, 1) broadcasts over G
    rows = torch.arange(M, device=q.device)[None, None, :, None]
    if isinstance(pos, torch.Tensor):
        pos = pos.to(q.device)
    s = torch.where(rows <= pos, s, torch.finfo(s.dtype).min)
    m = s.amax(dim=2, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=2, keepdim=True)
    if v_scale is not None:
        p = p * v_scale.float()
    out_dtype = q.dtype
    o = torch.einsum(
        "bhmg,bhmd->bhgd", p.to(out_dtype).float(), v_cache.to(out_dtype).float()
    )
    return (o / l.reshape(B, Hkv, G, 1)).to(out_dtype).reshape(B, Hq, 1, hd)


def sample_token(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    temperature: float,
    top_k: int = 0,
) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 token ids.

    ``temperature == 0`` is greedy argmax on the logits' own dtype (the
    first maximal index, as ``jnp.argmax``; no generator needed).
    Otherwise tokens are drawn from ``softmax(logits / temperature)``
    with the explicit ``generator``; ``top_k > 0`` restricts the draw to
    the k most likely tokens.  A torch generator does not reproduce
    ``jax.random``'s bits: compare distributions, not draws."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.finfo(torch.float32).min, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def _position_limit(config: Any) -> Optional[int]:
    """The family's maximum absolute position: GPT-2's learned table length
    or the Llama backbone's trained RoPE horizon."""
    return getattr(config, "n_positions", None) or getattr(
        config, "max_seq_len", None
    )


# The decode programs of :func:`generate` by static key, least recently used
# first.  The JAX package keeps 64 compiled programs (``lru_cache``); a
# program here owns its cache, so the store is bounded by the bytes its
# programs own instead (one Llama-3 8B bf16 cache at batch 8, 576 rows is
# ~0.6 GB): past ``PROGRAM_BYTES`` the least recently used programs are
# dropped, the one in use never.
PROGRAM_BYTES = 4 << 30
_programs: "OrderedDict[tuple, DecodeProgram]" = OrderedDict()


class DecodeProgram:
    """The greedy decode state of one static configuration and the step
    that advances it, the counterpart of the body of the JAX package's
    ``lax.scan``.

    The state lives at fixed addresses: the cache (``init_cache_fn``'s,
    int8 with ``kv_int8``), the current token ``tok`` (B,), its position
    ``pos`` (a 0-d int32 tensor on the device, advanced by the step, so no
    step reads anything back) and ``out`` (B, M) int32, whose column
    ``pos + 1`` each step writes.  :meth:`start` re-initialises the cache in
    place (zeros, unit int8 scales) and prefills the prompt into it
    eagerly, since the prefill's shape follows the prompt.  :meth:`step`
    runs one decode step: on a card through a
    :class:`...backends.device.CapturedStep` (one CUDA graph of ONE step,
    captured at the first step and replayed once per token: it is reused
    for any number of new tokens at this cache length, and a step is
    milliseconds of device work against microseconds to launch a graph),
    on the CPU or meta tensors as the same body run eagerly.  The graph
    reads ``params`` at the addresses it was captured with, which is why
    their addresses are part of the program's key."""

    def __init__(self, forward_cached, init_cache_fn, config, B: int, M: int,
                 kv_int8: bool, device: torch.device):
        cache = init_cache_fn(config, B, M, device=device)
        self.cache = quantize_cache(cache) if kv_int8 else cache
        self.forward_cached = forward_cached
        self.config = config
        self.tok = torch.zeros((B,), dtype=torch.int32, device=device)
        self.pos = torch.zeros((), dtype=torch.int32, device=device)
        self.out = torch.zeros((B, M), dtype=torch.int32, device=device)
        self.params: Optional[Dict[str, Any]] = None
        self.nbytes = sum(t.nbytes for t in (*self.cache.values(), self.tok,
                                             self.pos, self.out))
        if device.type == "cuda":
            from ..backends.device import CapturedStep

            self.step = CapturedStep(self._body, device)
        else:
            self.step = self._body

    def _body(self) -> None:
        logits, _ = self.forward_cached(
            self.params, self.tok[:, None], self.cache, self.pos, self.config)
        nxt = sample_token(logits[:, -1, :], None, 0.0)
        self.out.index_copy_(
            1, (self.pos + 1).to(torch.int64).view(1), nxt[:, None])
        self.tok.copy_(nxt)
        self.pos.add_(1)

    def start(self, params: Dict[str, Any], prompt_ids: torch.Tensor) -> None:
        """Bind ``params``, reset the cache in place, prefill the prompt
        and write its greedy token at column T of ``out``."""
        for name, t in self.cache.items():
            t.fill_(1 if name.endswith("_scale") else 0)
        self.params = params
        T = prompt_ids.shape[1]
        logits, _ = self.forward_cached(
            params, prompt_ids, self.cache, 0, self.config)
        first = sample_token(logits[:, -1, :], None, 0.0)
        self.out[:, T] = first
        self.tok.copy_(first)
        self.pos.fill_(T)


def _program(forward_cached, init_cache_fn, params, config, B, M,
             temperature, top_k, kv_int8, device) -> DecodeProgram:
    """The store's program for this static configuration (made on a miss),
    moved to the most recent end; older ones dropped past
    ``PROGRAM_BYTES``.  Keyed as the JAX package keys ``_compiled_run``
    (model, config, batch, cache length, temperature, top-k, int8 cache)
    plus the device and the params' addresses."""
    from ..backends.device import address_key

    key = (forward_cached, init_cache_fn, config, B, M, temperature, top_k,
           kv_int8, device, address_key(params))
    prog = _programs.pop(key, None)
    if prog is None:
        prog = DecodeProgram(forward_cached, init_cache_fn, config, B, M,
                             kv_int8, device)
    _programs[key] = prog
    total = sum(p.nbytes for p in _programs.values())
    while total > PROGRAM_BYTES and len(_programs) > 1:
        total -= _programs.popitem(last=False)[1].nbytes
    return prog


def clear_programs() -> None:
    """Drop every stored decode program, with its cache and graph."""
    _programs.clear()


@torch.no_grad()
def generate(
    forward_cached: Callable[..., Tuple[torch.Tensor, KVCache]],
    init_cache_fn: Callable[..., KVCache],
    params: Dict[str, torch.Tensor],
    prompt_ids: torch.Tensor,
    config: Any,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: int = 0,
    generator: Optional[torch.Generator] = None,
    max_len: Optional[int] = None,
    kv_int8: bool = False,
    capture: bool = True,
) -> torch.Tensor:
    """Prefill the prompt, then decode ``max_new_tokens`` steps one by
    one.  ``kv_int8=True`` stores the KV cache as int8 with per-row scales
    (:func:`quantize_cache`; lossy, so opt-in).  Returns (B, prompt_len +
    max_new_tokens) int32: prompt + generated, on the prompt's device.
    No step reads anything back to the host: tokens stay on the device.

    Greedy decoding (``temperature == 0``) runs over the stored
    :class:`DecodeProgram` of its static configuration: on a card its
    steps replay one captured CUDA graph, and a capture or replay error
    raises.  Two rules keep a generation eager, on a fresh cache with
    int positions: ``temperature > 0`` (the draws take an explicit
    ``torch.Generator`` whose state a graph would have to own; the JAX
    package draws with a key it splits inside the scan), and
    ``capture=False`` (the decode bench's eager leg).  Both give the
    captured path's greedy tokens."""
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
    if max_new_tokens == 0:
        return prompt_ids
    B, T = prompt_ids.shape
    M = max_len if max_len is not None else T + max_new_tokens
    if M < T + max_new_tokens:
        raise ValueError(f"max_len {M} < prompt {T} + new {max_new_tokens}")
    limit = _position_limit(config)
    if limit is not None and T + max_new_tokens > limit:
        raise ValueError(
            f"prompt ({T}) + max_new_tokens ({max_new_tokens}) exceeds the "
            f"model's position limit {limit}"
        )
    if temperature == 0.0 and capture:
        prog = _program(forward_cached, init_cache_fn, params, config, B, M,
                        temperature, top_k, kv_int8, prompt_ids.device)
        prog.start(params, prompt_ids)
        try:
            for _ in range(max_new_tokens - 1):
                prog.step()
        finally:
            prog.params = None
        return torch.cat([prompt_ids.to(torch.int32),
                          prog.out[:, T:T + max_new_tokens]], dim=1)
    cache = init_cache_fn(config, B, M, device=prompt_ids.device)
    if kv_int8:
        cache = quantize_cache(cache)
    logits, cache = forward_cached(params, prompt_ids, cache, 0, config)
    tok = sample_token(logits[:, -1, :], generator, temperature, top_k)
    new = [tok]
    for pos in range(T, T + max_new_tokens - 1):
        logits, cache = forward_cached(params, tok[:, None], cache, pos, config)
        tok = sample_token(logits[:, -1, :], generator, temperature, top_k)
        new.append(tok)
    return torch.cat([prompt_ids.to(torch.int32), torch.stack(new, dim=1)], dim=1)
