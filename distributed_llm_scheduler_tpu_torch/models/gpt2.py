"""GPT-2 in plain PyTorch: the flagship model family.

PyTorch port of ``distributed_llm_scheduler_tpu.models.gpt2``.  Params are
a flat ``Dict[str, torch.Tensor]`` keyed by the same names the DAG
frontend uses for its tasks' ``params_needed`` sets (``wte, wpe, ln_f_g,
ln_f_b, h{i}_ln1_g, h{i}_attn_qkv_w, ...``), so the JAX package's weights
bridge over name for name (:func:`params_from_numpy`).

Every per-op function (``layer_norm``, ``causal_attention``, ``ffn_*``, ...)
is a plain tensor function the DAG frontend wraps as a task fn, and
:func:`forward` composes them into the whole-model forward: the fused
baseline and the correctness oracle for placed DAG execution.  Attention
goes through :func:`..ops.attention.mha` (the CUDA flash kernel on a GPU)
and LayerNorm through :func:`..ops.norms.layer_norm` (the CUDA LayerNorm
kernel on a GPU); the other products stay ``torch.matmul``.
:func:`forward_cached` runs the same layers over a dense KV cache
(:mod:`.decode`), the prefill of the paged decode engine and its per-slot
oracle.  :func:`loss_fn` is the training half: the same layers with
gradients flowing, optionally rematerialized per block or scanned over
stacked layer params.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops.attention import mha as _fused_mha
# LayerNorm with f32 statistics, output in x's dtype: the CUDA kernel on a
# GPU, the plain version on the CPU and on meta
from ..ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dtype: torch.dtype = torch.float32
    ln_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @classmethod
    def small(cls, **kw) -> "GPT2Config":
        """124M — the reference's extraction target (test_gpt2.py:47)."""
        return cls(**kw)

    @classmethod
    def medium(cls, **kw) -> "GPT2Config":
        """355M (BASELINE.json config #2)."""
        return cls(n_embd=1024, n_layer=24, n_head=16, **kw)

    @classmethod
    def tiny(cls, **kw) -> "GPT2Config":
        """Test-sized: 2 layers, 128 wide — CPU-fast, same topology."""
        return cls(
            vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=4, **kw
        )


# -- parameters ---------------------------------------------------------------

def param_shapes(config: GPT2Config) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) per param, in the JAX package's insertion order."""
    d, dt = config.n_embd, config.dtype
    out: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {
        "wte": ((config.vocab_size, d), dt),
        "wpe": ((config.n_positions, d), dt),
    }
    for i in range(config.n_layer):
        p = f"h{i}_"
        out[p + "ln1_g"] = ((d,), dt)
        out[p + "ln1_b"] = ((d,), dt)
        out[p + "attn_qkv_w"] = ((d, 3 * d), dt)
        out[p + "attn_qkv_b"] = ((3 * d,), dt)
        out[p + "attn_proj_w"] = ((d, d), dt)
        out[p + "attn_proj_b"] = ((d,), dt)
        out[p + "ln2_g"] = ((d,), dt)
        out[p + "ln2_b"] = ((d,), dt)
        out[p + "mlp_fc_w"] = ((d, 4 * d), dt)
        out[p + "mlp_fc_b"] = ((4 * d,), dt)
        out[p + "mlp_proj_w"] = ((4 * d, d), dt)
        out[p + "mlp_proj_b"] = ((d,), dt)
    out["ln_f_g"] = ((d,), dt)
    out["ln_f_b"] = ((d,), dt)
    return out


def init_params_numpy(config: GPT2Config, seed: int = 0) -> Dict[str, np.ndarray]:
    """GPT-2 initialization as float32 numpy arrays from one numpy seed:
    N(0, 0.02) weights, residual-branch projections scaled by
    1/sqrt(2 * n_layer), zero biases, unit LN gains.  The same seed gives
    the same weights to both packages."""
    rng = np.random.default_rng(seed)
    std = 0.02
    resid_std = std / math.sqrt(2 * config.n_layer)
    out: Dict[str, np.ndarray] = {}
    for name, (shape, _dt) in param_shapes(config).items():
        if name.endswith("_g"):
            out[name] = np.ones(shape, np.float32)
        elif name.endswith("_b"):
            out[name] = np.zeros(shape, np.float32)
        else:
            scale = resid_std if name.endswith(("attn_proj_w", "mlp_proj_w")) else std
            out[name] = (rng.standard_normal(shape, np.float32) * scale).astype(
                np.float32
            )
    return out


def params_from_numpy(
    np_params: Mapping[str, Any],
    device: Any = "cuda",
    dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """The weight bridge: flat numpy params (e.g. ``np.asarray`` of the JAX
    package's params) -> torch tensors on ``device``, name for name.
    Float arrays (weights and the decode DAG's ``cache_k_{i}`` /
    ``cache_v_{i}`` page pools) land in ``dtype``, going through float32
    because ``torch.from_numpy`` rejects the ``ml_dtypes`` bfloat16 arrays
    JAX hands out (bf16 -> f32 -> bf16 is exact); integer arrays (the
    paged DAG's ``page_table``) stay int32."""
    out: Dict[str, torch.Tensor] = {}
    for name, arr in np_params.items():
        arr = np.asarray(arr)
        if arr.dtype.kind in "iu":
            out[name] = torch.from_numpy(arr.astype(np.int32)).to(device)
            continue
        host = torch.from_numpy(np.array(arr, dtype=np.float32))  # a writable copy
        out[name] = host.to(device=device, dtype=dtype)
    return out


# -- per-op functions (task granularity of the reference DAG) -----------------

def embedding(input_ids, wte, wpe):
    T = input_ids.shape[-1]
    return wte[input_ids] + wpe[:T]


def causal_attention(x, qkv_w, qkv_b, proj_w, proj_b, n_head: int):
    """Multi-head causal self-attention incl. output projection — one task,
    matching the reference's per-layer "attention" granularity
    (reference test_gpt2.py:75-90: qkv + proj params on a single task).
    The per-head q, k and v are strided views of the qkv product; the
    kernel reads them in place."""
    B, T, D = x.shape
    hd = D // n_head
    qkv = x @ qkv_w + qkv_b
    q, k, v = qkv.split(D, dim=-1)

    def heads(t):  # (B, T, D) -> (B, n_head, T, hd)
        return t.reshape(B, T, n_head, hd).transpose(1, 2)

    out = _fused_mha(heads(q), heads(k), heads(v), causal=True)
    out = out.transpose(1, 2).reshape(B, T, D)
    return out @ proj_w + proj_b


def ffn_expand(x, fc_w, fc_b):
    return x @ fc_w + fc_b


def ffn_activation(x):
    return F.gelu(x, approximate="tanh")


def ffn_contract(x, proj_w, proj_b):
    return x @ proj_w + proj_b


def residual_add(a, b):
    return a + b


def output_projection(x, wte):
    """Logits via weight tying with the embedding table
    (reference test_gpt2.py:160-166)."""
    return x @ wte.T


# -- whole-model forward (fused baseline + correctness oracle) ----------------

_BLOCK_KEYS = (
    "ln1_g", "ln1_b", "attn_qkv_w", "attn_qkv_b", "attn_proj_w",
    "attn_proj_b", "ln2_g", "ln2_b", "mlp_fc_w", "mlp_fc_b",
    "mlp_proj_w", "mlp_proj_b",
)


def transformer_block(block_params: Dict[str, Any], x, config: GPT2Config):
    """One layer (pre-LN attention + MLP with residuals), params keyed by
    the unprefixed ``_BLOCK_KEYS`` names."""
    ln1 = layer_norm(x, block_params["ln1_g"], block_params["ln1_b"], config.ln_eps)
    attn = causal_attention(
        ln1,
        block_params["attn_qkv_w"],
        block_params["attn_qkv_b"],
        block_params["attn_proj_w"],
        block_params["attn_proj_b"],
        config.n_head,
    )
    x = residual_add(x, attn)
    ln2 = layer_norm(x, block_params["ln2_g"], block_params["ln2_b"], config.ln_eps)
    h = ffn_expand(ln2, block_params["mlp_fc_w"], block_params["mlp_fc_b"])
    h = ffn_activation(h)
    h = ffn_contract(h, block_params["mlp_proj_w"], block_params["mlp_proj_b"])
    return residual_add(x, h)


def _select_block(remat: bool, block=transformer_block):
    """The layer function both forwards iterate (``block``, by default
    :func:`transformer_block`; the tensor-parallel forward passes its
    own): checkpointed (its activations recomputed in the backward,
    ``jax.checkpoint``'s trade) or plain."""
    if not remat:
        return block

    def checkpointed(block_params, x, config):
        return torch.utils.checkpoint.checkpoint(
            block, block_params, x, config, use_reentrant=False)

    return checkpointed


def _head(x, params: Dict[str, Any], config: GPT2Config):
    """Shared epilogue: final LN + weight-tied output projection."""
    x = layer_norm(x, params["ln_f_g"], params["ln_f_b"], config.ln_eps)
    return output_projection(x, params["wte"])


def _forward(params: Dict[str, Any], input_ids, config: GPT2Config,
             remat: bool = False):
    """The forward with gradients flowing (the body of :func:`forward`)."""
    block = _select_block(remat)
    x = embedding(input_ids, params["wte"], params["wpe"])
    for i in range(config.n_layer):
        p = f"h{i}_"
        x = block({k: params[p + k] for k in _BLOCK_KEYS}, x, config)
    return _head(x, params, config)


@torch.no_grad()
def forward(params: Dict[str, Any], input_ids, config: GPT2Config):
    """Full forward pass composing exactly the per-op functions above."""
    return _forward(params, input_ids, config)


# -- scanned forward (stacked layers) and the loss -----------------------------

def stack_layer_params(params: Dict[str, Any], config: GPT2Config
                       ) -> Dict[str, Any]:
    """Per-layer ``h{i}_*`` tensors -> stacked ``layers_*`` with a leading
    layer dim (plus the non-layer params unchanged): the scanned-forward
    layout, numbers identical to the flat layout."""
    out = {k: v for k, v in params.items() if not k.startswith("h")}
    for key in _BLOCK_KEYS:
        out["layers_" + key] = torch.stack(
            [params[f"h{i}_{key}"] for i in range(config.n_layer)])
    return out


def forward_scan(params: Dict[str, Any], input_ids, config: GPT2Config,
                 remat: bool = False):
    """Forward over stacked layer params (:func:`stack_layer_params`): one
    block applied along the stacked leading axis, the JAX package's
    ``lax.scan``.  Gradients flow; same block math and order as
    :func:`forward`."""
    block = _select_block(remat)
    stacked = {k: params["layers_" + k] for k in _BLOCK_KEYS}
    x = embedding(input_ids, params["wte"], params["wpe"])
    for i in range(stacked[_BLOCK_KEYS[0]].shape[0]):
        x = block({k: v[i] for k, v in stacked.items()}, x, config)
    return _head(x, params, config)


def nll_loss(logits, targets):
    """Mean next-token cross-entropy in float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0].mean()


def loss_fn(params: Dict[str, Any], input_ids, targets, config: GPT2Config,
            remat: bool = False, scan: bool = False):
    """Next-token cross-entropy (the training-step DAG's oracle).  Not
    under ``no_grad``: gradients flow to every param that requires them.
    ``scan=True`` expects stacked-layer params (:func:`stack_layer_params`)
    and runs the scanned forward."""
    fwd = forward_scan if scan else _forward
    return nll_loss(fwd(params, input_ids, config, remat=remat), targets)


# -- KV-cache decoding (models/decode.py drives this) --------------------------

def init_cache(config: GPT2Config, batch: int, max_len: int, device: Any = "cuda"):
    from . import decode

    return decode.init_cache(
        config.n_layer, batch, config.n_head, max_len,
        config.head_dim, config.dtype, device,
    )


@torch.no_grad()
def forward_cached(params: Dict[str, Any], input_ids, cache, pos_start,
                   config: GPT2Config):
    """Forward over ``input_ids`` occupying absolute positions
    [pos_start, pos_start + T), reading and writing the KV cache in place.

    One code path serves prefill (T = prompt length, pos_start = 0) and
    decode (T = 1).  ``pos_start`` is an int or a 0-d tensor
    (:mod:`.decode`).  Matches :func:`forward` when the cache holds the
    full history.  Returns ``(logits, cache)``."""
    from . import decode

    B, T = input_ids.shape
    pos = pos_start
    nh, hd = config.n_head, config.head_dim
    scale = 1.0 / math.sqrt(hd)

    rows = decode.positions(pos, T, params["wpe"].device)
    x = params["wte"][input_ids] + params["wpe"].index_select(0, rows)
    for i in range(config.n_layer):
        p = f"h{i}_"
        ln1 = layer_norm(x, params[p + "ln1_g"], params[p + "ln1_b"], config.ln_eps)
        qkv = ln1 @ params[p + "attn_qkv_w"] + params[p + "attn_qkv_b"]
        q, k, v = qkv.split(config.n_embd, dim=-1)

        def heads(t):
            return t.reshape(B, T, nh, hd).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        cache = decode.update_layer_cache(cache, i, k, v, pos)
        kc, vc, ks, vs = decode.layer_view(cache, i)
        att = decode.cached_attention(q, kc, vc, pos, scale, k_scale=ks, v_scale=vs)
        att = att.transpose(1, 2).reshape(B, T, config.n_embd)
        x = x + (att @ params[p + "attn_proj_w"] + params[p + "attn_proj_b"])
        ln2 = layer_norm(x, params[p + "ln2_g"], params[p + "ln2_b"], config.ln_eps)
        h = ffn_contract(
            ffn_activation(
                ffn_expand(ln2, params[p + "mlp_fc_w"], params[p + "mlp_fc_b"])
            ),
            params[p + "mlp_proj_w"],
            params[p + "mlp_proj_b"],
        )
        x = x + h
    x = layer_norm(x, params["ln_f_g"], params["ln_f_b"], config.ln_eps)
    return output_projection(x, params["wte"]), cache


def generate(params: Dict[str, Any], prompt_ids, config: GPT2Config,
             max_new_tokens: int, **kw):
    """Autoregressive generation (greedy by default; see
    :func:`.decode.generate` for temperature/top-k)."""
    from . import decode

    return decode.generate(
        forward_cached, init_cache, params, prompt_ids, config,
        max_new_tokens, **kw,
    )
