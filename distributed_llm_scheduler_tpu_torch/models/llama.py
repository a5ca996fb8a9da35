"""Llama-3 in plain PyTorch: the second model family.

PyTorch port of the forward half of ``distributed_llm_scheduler_tpu.
models.llama``.  Same design as :mod:`.gpt2`: a flat ``Dict[str, Tensor]``
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
RMSNorm goes through :func:`..ops.norms.rms_norm` and attention through
:func:`..ops.attention.gqa_mha`: the CUDA kernels on a GPU, the plain
versions on the CPU and on meta.  The other products stay
``torch.matmul``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

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


@torch.no_grad()
def init_params_torch(
    config: LlamaConfig, seed: int = 0, device: Any = "cuda"
) -> Dict[str, torch.Tensor]:
    """The same initializer drawn on ``device`` itself, tensor by tensor,
    from one seeded ``torch.Generator``: for full-size weights, whose numpy
    draw costs minutes of host time.  Other numbers than
    :func:`init_params_numpy`'s, at the same scales."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for name, (shape, dtype) in param_shapes(config).items():
        scale = _init_scale(config, name)
        if scale == 0.0:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
            continue
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        out[name] = w.mul_(scale).to(dtype)
    return out


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


@torch.no_grad()
def backbone_forward(params: Dict[str, Any], input_ids, config: Any,
                     block_fn: Callable[..., Any], layer_keys: Tuple[str, ...]):
    """The Llama-backbone forward skeleton: embed -> n_layers x block ->
    final RMSNorm -> LM head, parameterized by the layer block."""
    x = embedding(input_ids, params["tok_emb"])
    for i in range(config.n_layers):
        p = f"l{i}_"
        x = block_fn({k: params[p + k] for k in layer_keys}, x, config)
    x = rms_norm(x, params["final_norm_g"], config.rms_eps)
    return lm_head(x, params["lm_head"])


def forward(params: Dict[str, Any], input_ids, config: LlamaConfig):
    """Full forward pass composing exactly the per-op functions above."""
    return backbone_forward(params, input_ids, config, transformer_block,
                            _BLOCK_KEYS)
