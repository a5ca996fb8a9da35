"""Llama-3 in plain PyTorch: the second model family.

PyTorch port of ``distributed_llm_scheduler_tpu.models.llama``
(the training loss excepted).  Same design as :mod:`.gpt2`: a flat ``Dict[str, Tensor]``
of params whose names are the DAG frontend's ``params_needed`` vocabulary
(``tok_emb, l{i}_attn_norm_g, l{i}_wq/wk/wv/wo, l{i}_ffn_norm_g,
l{i}_w_gate/w_up/w_down, final_norm_g, lm_head``), so the JAX package's
weights bridge over name for name (:func:`.gpt2.params_from_numpy`).  The
architecture: RMSNorm (no biases), rotary position embeddings with
interleaved pairs, grouped-query attention (``n_kv_heads < n_heads``),
SwiGLU FFN, untied LM head.

Every per-op function is a plain tensor function the DAG frontend
(``frontend/llama_dag.py``) wraps as a task fn, and :func:`forward`
composes them: the fused baseline and the oracle for placed execution.
The decode half: the stacked-layer layout (:func:`stack_layers`,
:func:`forward_scan`) and KV-cache decoding (:func:`init_cache`,
:func:`attention_cached`, :func:`forward_cached`, :func:`generate`, driven
by :mod:`.decode`).
RMSNorm goes through :func:`..ops.norms.rms_norm` and attention through
:func:`..ops.attention.gqa_mha`: the CUDA kernels on a GPU, the plain
versions on the CPU and on meta.  The other products stay
``torch.matmul``.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import gqa_mha as _fused_gqa
# RMSNorm in f32, output in x's dtype: the CUDA kernel on a GPU, the plain
# version on the CPU and on meta
from ..ops.norms import rms_norm
from .gpt2 import params_from_numpy  # noqa: F401  (the bridge is name-agnostic)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    max_seq_len: int = 8192
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_hidden: int = 14_336
    rope_theta: float = 500_000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        """Llama-3 8B (8.03B params)."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """Test-sized: 2 layers, 128 wide, GQA 4:2 — CPU-fast, same topology."""
        kw.setdefault("vocab_size", 512)
        kw.setdefault("max_seq_len", 128)
        kw.setdefault("d_model", 128)
        kw.setdefault("n_layers", 2)
        kw.setdefault("n_heads", 4)
        kw.setdefault("n_kv_heads", 2)
        kw.setdefault("ffn_hidden", 256)
        kw.setdefault("rope_theta", 10_000.0)
        return cls(**kw)


# -- parameters ---------------------------------------------------------------

_BLOCK_KEYS = (
    "attn_norm_g", "wq", "wk", "wv", "wo", "ffn_norm_g",
    "w_gate", "w_up", "w_down",
)


def param_shapes(config: LlamaConfig) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) per param, in the JAX initializer's insertion order."""
    d, dt = config.d_model, config.dtype
    hd, nh, nkv, f = (config.head_dim, config.n_heads, config.n_kv_heads,
                      config.ffn_hidden)
    out: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {
        "tok_emb": ((config.vocab_size, d), dt),
    }
    for i in range(config.n_layers):
        p = f"l{i}_"
        out[p + "attn_norm_g"] = ((d,), dt)
        out[p + "wq"] = ((d, nh * hd), dt)
        out[p + "wk"] = ((d, nkv * hd), dt)
        out[p + "wv"] = ((d, nkv * hd), dt)
        out[p + "wo"] = ((nh * hd, d), dt)
        out[p + "ffn_norm_g"] = ((d,), dt)
        out[p + "w_gate"] = ((d, f), dt)
        out[p + "w_up"] = ((d, f), dt)
        out[p + "w_down"] = ((f, d), dt)
    out["final_norm_g"] = ((d,), dt)
    out["lm_head"] = ((d, config.vocab_size), dt)
    return out


def num_params(config: LlamaConfig) -> int:
    return sum(math.prod(shape) for shape, _ in param_shapes(config).values())


def _init_scale(config: LlamaConfig, name: str) -> float:
    """The JAX initializer's scales: N(0, 0.02), the residual-branch
    outputs (``wo``, ``w_down``) at 0.02 / sqrt(2 * n_layers); 0 marks a
    norm gain (ones)."""
    if name.endswith("_norm_g"):
        return 0.0
    std = 0.02
    if name.endswith(("_wo", "_w_down")):
        return std / math.sqrt(2 * config.n_layers)
    return std


def init_params_numpy(config: LlamaConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """Llama initialization as float32 numpy arrays from one numpy seed, at
    the JAX initializer's scales (unit norm gains).  The same seed gives
    the same weights to both packages and to every device."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for name, (shape, _dt) in param_shapes(config).items():
        scale = _init_scale(config, name)
        if scale == 0.0:
            out[name] = np.ones(shape, np.float32)
        else:
            out[name] = rng.standard_normal(shape, np.float32) * np.float32(scale)
    return out


def seeded_params(shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
                  scale_of: Callable[[str], float], seed: int, device: Any
                  ) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(name, tensor)`` drawn on ``device`` one at a time, in ``shapes``'
    order, from one seeded ``torch.Generator``: N(0, 1) times
    ``scale_of(name)``, ones where it is 0 (a norm gain)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for name, (shape, dtype) in shapes.items():
        scale = scale_of(name)
        if scale == 0.0:
            yield name, torch.ones(shape, dtype=dtype, device=device)
            continue
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        yield name, w.mul_(scale).to(dtype)


def iter_params_torch(config: LlamaConfig, seed: int = 0, device: Any = "cuda"
                      ) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(name, tensor)`` of :func:`init_params_torch`, one at a time, so
    a caller that keeps only some (a pipeline stage's) never holds the
    whole model."""
    return seeded_params(param_shapes(config),
                         lambda name: _init_scale(config, name), seed, device)


def init_params_torch(
    config: LlamaConfig, seed: int = 0, device: Any = "cuda"
) -> Dict[str, torch.Tensor]:
    """The same initializer drawn on ``device`` itself, tensor by tensor,
    from one seeded ``torch.Generator``: for full-size weights, whose numpy
    draw costs minutes of host time.  Other numbers than
    :func:`init_params_numpy`'s, at the same scales."""
    return dict(iter_params_torch(config, seed, device))


# -- per-op functions (DAG task granularity) ------------------------------------

def embedding(input_ids, tok_emb):
    return tok_emb[input_ids]


def rope_tables(T: int, head_dim: int, theta: float, device: Any):
    """(cos, sin) of shape (T, head_dim // 2), float32, on ``device``."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponents)
    ang = (torch.arange(T, dtype=torch.float32, device=device)[:, None]
           * inv_freq[None, :])
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, H, T, hd) with interleaved (even, odd) rotation pairs, the
    rotation in f32, output in ``x``'s dtype."""
    xf1, xf2 = x[..., 0::2].float(), x[..., 1::2].float()
    r1 = xf1 * cos - xf2 * sin
    r2 = xf1 * sin + xf2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def gqa_attention(x, wq, wk, wv, wo, n_heads: int, n_kv_heads: int,
                  rope_theta: float):
    """Causal grouped-query attention with RoPE, incl. output projection —
    one task, the per-layer "attention" granularity of the GPT-2 DAG."""
    B, T, D = x.shape
    hd = wq.shape[-1] // n_heads

    q = (x @ wq).reshape(B, T, n_heads, hd).transpose(1, 2)
    k = (x @ wk).reshape(B, T, n_kv_heads, hd).transpose(1, 2)
    v = (x @ wv).reshape(B, T, n_kv_heads, hd).transpose(1, 2)

    cos, sin = rope_tables(T, hd, rope_theta, x.device)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    out = _fused_gqa(q, k, v, causal=True)
    out = out.transpose(1, 2).reshape(B, T, n_heads * hd)
    return out @ wo


def ffn_gate(x, w_gate):
    return x @ w_gate


def ffn_up(x, w_up):
    return x @ w_up


def ffn_glu(gate, up):
    return F.silu(gate) * up


def ffn_down(x, w_down):
    return x @ w_down


def residual_add(a, b):
    return a + b


def lm_head(x, w):
    return x @ w


# -- whole-model forward (fused baseline + correctness oracle) ------------------

def transformer_block(block_params: Dict[str, Any], x, config: LlamaConfig):
    """One layer (RMSNorm + GQA + SwiGLU with residuals), params keyed by
    the unprefixed ``_BLOCK_KEYS`` names."""
    h = rms_norm(x, block_params["attn_norm_g"], config.rms_eps)
    h = gqa_attention(
        h, block_params["wq"], block_params["wk"], block_params["wv"],
        block_params["wo"], config.n_heads, config.n_kv_heads,
        config.rope_theta,
    )
    x = residual_add(x, h)
    h = rms_norm(x, block_params["ffn_norm_g"], config.rms_eps)
    g = ffn_gate(h, block_params["w_gate"])
    u = ffn_up(h, block_params["w_up"])
    h = ffn_down(ffn_glu(g, u), block_params["w_down"])
    return residual_add(x, h)


def backbone(params: Dict[str, Any], input_ids, config: Any,
             block_fn: Callable[..., Any], layer_keys: Tuple[str, ...],
             remat: bool = False, scan: bool = False):
    """The Llama-backbone forward skeleton: embed -> n_layers x block ->
    final RMSNorm -> LM head, parameterized by the layer block, with
    gradients flowing.  ``scan=True`` expects stacked ``layers_*`` params
    (:func:`stack_layers`) and applies the block along their leading axis
    (the JAX package's ``lax.scan``), with the same block math and order;
    ``remat=True`` checkpoints the block either way (``jax.checkpoint``'s
    trade, :func:`.gpt2._select_block`)."""
    from .gpt2 import _select_block

    block_fn = _select_block(remat, block_fn)
    x = embedding(input_ids, params["tok_emb"])
    if scan:
        stacked = {k: params["layers_" + k] for k in layer_keys}
        layers = [{k: v[i] for k, v in stacked.items()}
                  for i in range(stacked[layer_keys[0]].shape[0])]
    else:
        layers = [{k: params[f"l{i}_{k}"] for k in layer_keys}
                  for i in range(config.n_layers)]
    for bp in layers:
        x = block_fn(bp, x, config)
    x = rms_norm(x, params["final_norm_g"], config.rms_eps)
    return lm_head(x, params["lm_head"])


@torch.no_grad()
def backbone_forward(params: Dict[str, Any], input_ids, config: Any,
                     block_fn: Callable[..., Any], layer_keys: Tuple[str, ...],
                     scan: bool = False):
    """:func:`backbone` without gradients: the fused baseline and oracle."""
    return backbone(params, input_ids, config, block_fn, layer_keys, scan=scan)


def forward(params: Dict[str, Any], input_ids, config: LlamaConfig):
    """Full forward pass composing exactly the per-op functions above."""
    return backbone_forward(params, input_ids, config, transformer_block,
                            _BLOCK_KEYS)


_LAYER_PREFIX_RE = re.compile(r"^l\d+_")


def stack_layers(params: Dict[str, Any], n_layers: int,
                 keys: Tuple[str, ...]) -> Dict[str, Any]:
    """Per-layer ``l{i}_*`` tensors -> stacked ``layers_*`` with a leading
    layer dim (non-layer params unchanged): the scanned-forward layout,
    shared by the Llama-backbone families (Mixtral reuses it)."""
    out = {k: v for k, v in params.items() if not _LAYER_PREFIX_RE.match(k)}
    for key in keys:
        out["layers_" + key] = torch.stack(
            [params[f"l{i}_{key}"] for i in range(n_layers)])
    return out


def stack_layer_params(params: Dict[str, Any], config: LlamaConfig
                       ) -> Dict[str, Any]:
    return stack_layers(params, config.n_layers, _BLOCK_KEYS)


def forward_scan(params: Dict[str, Any], input_ids, config: LlamaConfig):
    """Forward over stacked layer params (:func:`stack_layer_params`);
    equal to :func:`forward`'s numbers."""
    return backbone_forward(params, input_ids, config, transformer_block,
                            _BLOCK_KEYS, scan=True)


# -- KV-cache decoding (models/decode.py drives this) ---------------------------

def init_cache(config: LlamaConfig, batch: int, max_len: int,
               device: Any = "cuda"):
    from . import decode

    return decode.init_cache(
        config.n_layers, batch, config.n_kv_heads, max_len,
        config.head_dim, config.dtype, device,
    )


def rope_rows(pos_start, T: int, head_dim: int, theta: float, device: Any):
    """(cos, sin) of shape (T, head_dim // 2) at the absolute positions
    ``[pos_start, pos_start + T)``: the rows of :func:`rope_tables` at
    those positions, computed for them alone.  ``pos_start`` is an int or
    a 0-d tensor (then nothing is read back to the host)."""
    from . import decode

    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponents)
    ang = (decode.positions(pos_start, T, device).to(torch.float32)[:, None]
           * inv_freq[None, :])
    return torch.cos(ang), torch.sin(ang)


def attention_cached(x, block_params: Dict[str, Any], cache, layer: int,
                     pos_start, config: Any):
    """GQA with RoPE at absolute positions [pos_start, pos_start+T), reading
    and writing the stacked-layer KV cache in place.  Shared with Mixtral
    (the same Llama-backbone attention)."""
    from . import decode

    B, T, D = x.shape
    nh, nkv, hd = config.n_heads, config.n_kv_heads, config.head_dim

    q = (x @ block_params["wq"]).reshape(B, T, nh, hd).transpose(1, 2)
    k = (x @ block_params["wk"]).reshape(B, T, nkv, hd).transpose(1, 2)
    v = (x @ block_params["wv"]).reshape(B, T, nkv, hd).transpose(1, 2)

    cos, sin = rope_rows(pos_start, T, hd, config.rope_theta, x.device)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    cache = decode.update_layer_cache(cache, layer, k, v, pos_start)
    kc, vc, ks, vs = decode.layer_view(cache, layer)
    out = decode.cached_attention(
        q, kc, vc, pos_start, 1.0 / math.sqrt(hd), k_scale=ks, v_scale=vs,
    )
    out = out.transpose(1, 2).reshape(B, T, D)
    return out @ block_params["wo"], cache


@torch.no_grad()
def forward_cached(params: Dict[str, Any], input_ids, cache, pos_start,
                   config: LlamaConfig):
    """Cached forward over positions [pos_start, pos_start + T); one code
    path for prefill and decode (cf. :func:`.gpt2.forward_cached`).
    Returns ``(logits, cache)``."""
    x = embedding(input_ids, params["tok_emb"])
    for i in range(config.n_layers):
        p = f"l{i}_"
        bp = {k: params[p + k] for k in _BLOCK_KEYS}
        h = rms_norm(x, bp["attn_norm_g"], config.rms_eps)
        h, cache = attention_cached(h, bp, cache, i, pos_start, config)
        x = residual_add(x, h)
        h = rms_norm(x, bp["ffn_norm_g"], config.rms_eps)
        g = ffn_gate(h, bp["w_gate"])
        u = ffn_up(h, bp["w_up"])
        h = ffn_down(ffn_glu(g, u), bp["w_down"])
        x = residual_add(x, h)
    x = rms_norm(x, params["final_norm_g"], config.rms_eps)
    return lm_head(x, params["lm_head"]), cache


def generate(params: Dict[str, Any], prompt_ids, config: LlamaConfig,
             max_new_tokens: int, **kw):
    """Autoregressive generation (greedy by default; see
    :func:`.decode.generate` for temperature, top-k and ``kv_int8``)."""
    from . import decode

    return decode.generate(
        forward_cached, init_cache, params, prompt_ids, config,
        max_new_tokens, **kw,
    )
