"""Mixtral-style sparse MoE in plain PyTorch: the third model family
(BASELINE.json config #4: "Mixtral-8x7B MoE DAG, expert nodes as tasks").

PyTorch port of ``distributed_llm_scheduler_tpu.models.mixtral``.  The architecture is the Llama backbone (RMSNorm, RoPE,
GQA, reused from :mod:`.llama`) with the SwiGLU FFN replaced by a router
and ``n_experts`` experts under top-k gating.  Params are a flat
``Dict[str, Tensor]`` with the Llama names plus ``l{i}_router`` and
per-expert ``l{i}_e{e}_w_gate/w_up/w_down``, so the JAX package's weights
bridge over name for name (:func:`params_from_numpy`).

Two dispatch formulations, as in the JAX package:

* **Dense** (the DAG's default, the fused oracle): every expert runs on
  every token; its output is scaled by the (possibly zero) top-k gate
  weight.
* **Routed** (:func:`moe_routed`, ``forward(..., routed=True)``): each
  expert computes only its top-k-assigned tokens, up to the static
  capacity ``C = ceil(top_k * tokens / n_experts * capacity_factor)``;
  assignments beyond an expert's capacity are dropped (contribute zero).
  At ``capacity_factor = n_experts / top_k`` nothing can drop and routed
  equals dense.

The routing is equal to the JAX routing, not just close.  Top-k is a
stable descending sort of the f32 router logits, so among equal logits
the lower expert index comes first (``jax.lax.top_k``'s rule; ``torch.
topk`` states no tie order).  An assignment's position in its expert's
arrival order is a cumulative sum over the flattened ``(token, slot)``
order, as the reference takes it.  The reference's ``.at[...].add``
scatters are ``index_put_(..., accumulate=True)`` and ``index_add_``.

The decode half (the stacked-layer scan, ``init_cache``,
``forward_cached`` with the dense MoE, ``generate``) reuses the Llama
backbone's.  :func:`loss_fn` is the training forward, the Llama backbone
(:func:`..llama.backbone`, with remat) over Mixtral's blocks; the
expert-parallel path (``parallel/expert.py``) runs the same backbone
over its stacked-expert block.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import llama as _llama
from .gpt2 import params_from_numpy  # noqa: F401  (the bridge is name-agnostic)

# the Llama backbone ops are the same module-level functions
rms_norm = _llama.rms_norm
embedding = _llama.embedding
gqa_attention = _llama.gqa_attention
residual_add = _llama.residual_add
lm_head = _llama.lm_head


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32_000
    max_seq_len: int = 8192
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_hidden: int = 14_336
    n_experts: int = 8
    top_k: int = 2
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def mixtral_8x7b(cls, **kw) -> "MixtralConfig":
        """Mixtral-8x7B (46.7B total / ~12.9B active params)."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "MixtralConfig":
        """Test-sized: 2 layers, 4 experts, top-2 — CPU-fast, same topology."""
        kw.setdefault("vocab_size", 512)
        kw.setdefault("max_seq_len", 128)
        kw.setdefault("d_model", 64)
        kw.setdefault("n_layers", 2)
        kw.setdefault("n_heads", 4)
        kw.setdefault("n_kv_heads", 2)
        kw.setdefault("ffn_hidden", 128)
        kw.setdefault("n_experts", 4)
        kw.setdefault("top_k", 2)
        kw.setdefault("rope_theta", 10_000.0)
        return cls(**kw)


# -- parameters ---------------------------------------------------------------

def param_shapes(config: MixtralConfig
                 ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) per param, in the JAX initializer's insertion order."""
    d, dt = config.d_model, config.dtype
    hd, nh, nkv = config.head_dim, config.n_heads, config.n_kv_heads
    f, E = config.ffn_hidden, config.n_experts
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
        out[p + "router"] = ((d, E), dt)
        for e in range(E):
            q = f"{p}e{e}_"
            out[q + "w_gate"] = ((d, f), dt)
            out[q + "w_up"] = ((d, f), dt)
            out[q + "w_down"] = ((f, d), dt)
    out["final_norm_g"] = ((d,), dt)
    out["lm_head"] = ((d, config.vocab_size), dt)
    return out


def num_params(config: MixtralConfig) -> int:
    return sum(math.prod(shape) for shape, _ in param_shapes(config).values())


def num_active_params(config: MixtralConfig) -> int:
    """Params touched per token: everything except the (E - top_k)
    non-selected experts per layer."""
    per_expert = 3 * config.d_model * config.ffn_hidden
    inactive = (config.n_experts - config.top_k) * per_expert * config.n_layers
    return num_params(config) - inactive


def _init_scale(config: MixtralConfig, name: str) -> float:
    """The JAX initializer's scales: N(0, 0.02), the residual-branch
    outputs (``wo``, each expert's ``w_down``) at 0.02 / sqrt(2 *
    n_layers); 0 marks a norm gain (ones)."""
    if name.endswith("_norm_g"):
        return 0.0
    std = 0.02
    if name.endswith(("_wo", "_w_down")):
        return std / math.sqrt(2 * config.n_layers)
    return std


def init_params_numpy(config: MixtralConfig, seed: int = 0
                      ) -> Dict[str, np.ndarray]:
    """Mixtral initialization as float32 numpy arrays from one numpy seed,
    at the JAX initializer's scales (unit norm gains)."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for name, (shape, _dt) in param_shapes(config).items():
        scale = _init_scale(config, name)
        if scale == 0.0:
            out[name] = np.ones(shape, np.float32)
        else:
            out[name] = rng.standard_normal(shape, np.float32) * np.float32(scale)
    return out


def iter_params_torch(config: MixtralConfig, seed: int = 0,
                      device: Any = "cuda") -> Iterator[Tuple[str, torch.Tensor]]:
    """``(name, tensor)`` of :func:`init_params_torch`, one at a time, so
    a caller that keeps only some (a rank's experts) never holds the
    whole model."""
    return _llama.seeded_params(param_shapes(config),
                                lambda name: _init_scale(config, name),
                                seed, device)


def init_params_torch(config: MixtralConfig, seed: int = 0,
                      device: Any = "cuda") -> Dict[str, torch.Tensor]:
    """The same initializer drawn on ``device`` itself, tensor by tensor,
    from one seeded ``torch.Generator``: for full-width weights, whose
    numpy draw costs minutes of host time.  Other numbers than
    :func:`init_params_numpy`'s, at the same scales."""
    return dict(iter_params_torch(config, seed, device))


# -- MoE ops (DAG task granularity) --------------------------------------------

def topk_stable(logits, k: int):
    """``(values, indices)`` of the ``k`` largest entries of the last axis,
    largest first, equal values in ascending index order
    (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_weights(x, w_router, top_k: int):
    """Top-k gate weights, dense layout: (B, T, E) with zeros off the
    top-k.  Softmax over the selected f32 logits only (Mixtral's
    renormalized top-k)."""
    logits = (x @ w_router).float()  # (B, T, E)
    top_vals, top_idx = topk_stable(logits, top_k)
    top_w = torch.softmax(top_vals, dim=-1)
    dense = torch.zeros_like(logits).scatter(-1, top_idx, top_w)
    return dense.to(x.dtype)


def expert_ffn(x, w_gate, w_up, w_down):
    """One expert's SwiGLU over ALL tokens (dense static-shape MoE)."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def moe_combine(weights, *expert_outs):
    """Sum of expert outputs scaled by their dense gate column."""
    out = torch.zeros_like(expert_outs[0])
    for e, eo in enumerate(expert_outs):
        out = out + weights[..., e:e + 1] * eo
    return out


def _moe(block_params: Dict[str, Any], x, config: MixtralConfig):
    """Router + dense experts + combine over UNPREFIXED param names: the
    one implementation of the dense MoE layer."""
    w = router_weights(x, block_params["router"], config.top_k)
    outs = [
        expert_ffn(x, block_params[f"e{e}_w_gate"], block_params[f"e{e}_w_up"],
                   block_params[f"e{e}_w_down"])
        for e in range(config.n_experts)
    ]
    return moe_combine(w, *outs)


# -- routed dispatch primitives --------------------------------------------------
# The one implementation of the capacity-buffer routing, shared by the
# whole-program path (moe_routed) and the task-graph frontend
# (frontend/moe_dag routed tasks).

def moe_capacity(N: int, E: int, k: int, capacity_factor: float) -> int:
    """Static per-expert capacity: ``ceil(k*N/E * cf)`` clamped to [1, N]."""
    return min(N, max(1, math.ceil(k * N / E * capacity_factor)))


def route_topk(xf, w_router, k: int, C: int, out_dtype) -> Dict[str, Any]:
    """Static-shape top-k routing metadata over flat tokens ``xf (N, D)``.

    Returns ``{top_w (N, k), flat_e (N*k,), pos (N*k,), keep (N*k,)}``:
    renormalized gate weights, expert id per (token, slot) assignment
    (int32),
    position within the expert's arrival order (int32, clamped to C-1
    when dropped), and the under-capacity mask.
    """
    E = w_router.shape[-1]
    logits = (xf @ w_router).float()  # (N, E)
    top_vals, top_idx = topk_stable(logits, k)  # (N, k)
    top_w = torch.softmax(top_vals, dim=-1).to(out_dtype)
    flat_e = top_idx.reshape(-1)  # (N*k,) expert per assignment
    # position of each assignment within its expert's arrival order
    onehot = F.one_hot(flat_e, E)  # (N*k, E)
    pos_all = torch.cumsum(onehot, dim=0) - 1
    mypos = pos_all.gather(1, flat_e[:, None])[:, 0]
    keep = mypos < C
    # int32 indices, as the reference's: the metadata's bytes are what a
    # placement charges for moving it
    return {
        "top_w": top_w,
        "flat_e": flat_e.int(),
        "pos": torch.where(keep, mypos, C - 1).int(),
        "keep": keep,
    }


def _token_index(N: int, k: int, device):
    """The token of each flattened (token, slot) assignment."""
    return torch.arange(N, device=device).repeat_interleave(k)


def routed_dispatch(xf, route: Dict[str, Any], E: int, C: int):
    """Scatter kept assignments into the global ``(E, C, D)`` buffer."""
    N, D = xf.shape
    k = route["top_w"].shape[-1]
    contrib = torch.where(route["keep"][:, None],
                          xf[_token_index(N, k, xf.device)], 0)
    return xf.new_zeros((E, C, D)).index_put_(
        (route["flat_e"], route["pos"]), contrib, accumulate=True)


def routed_expert_buffer(xf, route: Dict[str, Any], expert: int, C: int):
    """ONE expert's ``(C, D)`` capacity buffer: the task-graph form, where
    each expert task dispatches only its own tokens."""
    N, D = xf.shape
    k = route["top_w"].shape[-1]
    mine = route["keep"] & (route["flat_e"] == expert)
    contrib = torch.where(mine[:, None], xf[_token_index(N, k, xf.device)], 0)
    return xf.new_zeros((C, D)).index_put_(
        (route["pos"],), contrib, accumulate=True)


def routed_collect(out_buf, route: Dict[str, Any], N: int):
    """Gather expert outputs ``(E, C, D)`` back to tokens ``(N, D)``,
    weighted by the renormalized gates; dropped assignments contribute 0."""
    D = out_buf.shape[-1]
    k = route["top_w"].shape[-1]
    gathered = torch.where(route["keep"][:, None],
                           out_buf[route["flat_e"], route["pos"]], 0)
    w_flat = route["top_w"].reshape(-1, 1)
    return out_buf.new_zeros((N, D)).index_add_(
        0, _token_index(N, k, out_buf.device), gathered * w_flat)


def route_stats(route: Dict[str, Any], C: int) -> Dict[str, Any]:
    return {
        "capacity": C,
        "dropped_slots": (~route["keep"]).sum(),
        "total_slots": route["flat_e"].shape[0],
    }


def moe_routed(block_params: Dict[str, Any], x, config: MixtralConfig,
               capacity_factor: float = 2.0, with_stats: bool = False):
    """Sparse top-k dispatch with static-shape capacity buffers: tokens
    land in an ``(E, C, D)`` buffer (each kept assignment owns a unique
    (expert, position) cell), the experts run as one batched product over
    stacked weights, and outputs gather back weighted by the renormalized
    gates.  Returns ``out`` or ``(out, stats)`` when ``with_stats``."""
    B, T, D = x.shape
    E, k = config.n_experts, config.top_k
    N = B * T
    C = moe_capacity(N, E, k, capacity_factor)
    xf = x.reshape(N, D)
    route = route_topk(xf, block_params["router"], k, C, x.dtype)
    buf = routed_dispatch(xf, route, E, C)
    wg = torch.stack([block_params[f"e{e}_w_gate"] for e in range(E)])
    wu = torch.stack([block_params[f"e{e}_w_up"] for e in range(E)])
    wd = torch.stack([block_params[f"e{e}_w_down"] for e in range(E)])
    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    out_buf = torch.bmm(h, wd)  # (E, C, D)
    out = routed_collect(out_buf, route, N).reshape(B, T, D)
    if with_stats:
        return out, route_stats(route, C)
    return out


# -- blocks and the whole-model forward (fused baseline + oracle) ----------------

def _layer_keys(config: MixtralConfig) -> Tuple[str, ...]:
    """Unprefixed per-layer param names."""
    keys = ["attn_norm_g", "wq", "wk", "wv", "wo", "ffn_norm_g", "router"]
    for e in range(config.n_experts):
        keys += [f"e{e}_w_gate", f"e{e}_w_up", f"e{e}_w_down"]
    return tuple(keys)


def _block_with_moe(block_params: Dict[str, Any], x, config: MixtralConfig,
                    moe_fn):
    """The one attention+residual block body, parameterized by the MoE
    dispatch (dense :func:`_moe` or :func:`moe_routed`)."""
    h = rms_norm(x, block_params["attn_norm_g"], config.rms_eps)
    h = gqa_attention(
        h, block_params["wq"], block_params["wk"], block_params["wv"],
        block_params["wo"], config.n_heads, config.n_kv_heads,
        config.rope_theta,
    )
    x = residual_add(x, h)
    h = rms_norm(x, block_params["ffn_norm_g"], config.rms_eps)
    return residual_add(x, moe_fn(block_params, h))


def transformer_block(block_params: Dict[str, Any], x, config: MixtralConfig):
    """One layer (RMSNorm + GQA + router/experts/combine with residuals),
    params keyed unprefixed."""
    return _block_with_moe(block_params, x, config,
                           lambda bp, h: _moe(bp, h, config))


def routed_transformer_block(block_params: Dict[str, Any], x,
                             config: MixtralConfig,
                             capacity_factor: float = 2.0):
    """:func:`transformer_block` with the routed MoE in place of dense
    dispatch: the same attention path, the same param layout."""
    return _block_with_moe(
        block_params, x, config,
        lambda bp, h: moe_routed(bp, h, config, capacity_factor))


def nll_loss(logits, targets):
    """Next-token cross-entropy in float32 (shared by both MoE paths and
    the pipeline)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0].mean()


def _block_for(routed: bool, capacity_factor: float):
    if not routed:
        return transformer_block

    def block(bp, x, cfg):
        return routed_transformer_block(bp, x, cfg, capacity_factor)

    return block


def forward(params: Dict[str, Any], input_ids, config: MixtralConfig,
            routed: bool = False, capacity_factor: float = 2.0):
    """The Llama backbone (:func:`..llama.backbone_forward`) over Mixtral's
    blocks.  ``routed=True`` switches every layer's MoE to the capacity-
    buffer dispatch (:func:`moe_routed`)."""
    return _llama.backbone_forward(params, input_ids, config,
                                   _block_for(routed, capacity_factor),
                                   _layer_keys(config))


def loss_fn(params: Dict[str, Any], input_ids, targets, config: MixtralConfig,
            remat: bool = False, scan: bool = False, routed: bool = False,
            capacity_factor: float = 2.0):
    """Next-token cross-entropy of the per-expert forward, gradients
    flowing (``scan=True``: stacked-layer params, dense dispatch only)."""
    if routed and scan:
        raise ValueError(
            "routed MoE is per-layer (stacked-expert einsums inside "
            "the block); use scan=False"
        )
    logits = _llama.backbone(params, input_ids, config,
                             _block_for(routed, capacity_factor),
                             _layer_keys(config), remat=remat, scan=scan)
    return nll_loss(logits, targets)


def stack_layer_params(params: Dict[str, Any], config: MixtralConfig
                       ) -> Dict[str, Any]:
    """The scanned-forward layout via :func:`..llama.stack_layers`;
    per-expert tensors stack to (n_layers, d, f) per expert key."""
    return _llama.stack_layers(params, config.n_layers, _layer_keys(config))


def forward_scan(params: Dict[str, Any], input_ids, config: MixtralConfig):
    """Forward over stacked layer params; equal to :func:`forward`'s
    numbers (dense dispatch)."""
    return _llama.backbone_forward(params, input_ids, config,
                                   transformer_block, _layer_keys(config),
                                   scan=True)


# -- KV-cache decoding (models/decode.py drives this) ---------------------------

def init_cache(config: MixtralConfig, batch: int, max_len: int,
               device: Any = "cuda"):
    from . import decode

    return decode.init_cache(
        config.n_layers, batch, config.n_kv_heads, max_len,
        config.head_dim, config.dtype, device,
    )


@torch.no_grad()
def forward_cached(params: Dict[str, Any], input_ids, cache, pos_start,
                   config: MixtralConfig):
    """Cached forward over positions [pos_start, pos_start + T): the Llama
    backbone's cached attention and the dense router/experts/combine of
    :func:`transformer_block`; routing is per token, so a decode step
    routes each new token as the fused forward would."""
    keys = _layer_keys(config)
    x = embedding(input_ids, params["tok_emb"])
    for i in range(config.n_layers):
        p = f"l{i}_"
        bp = {k: params[p + k] for k in keys}
        h = rms_norm(x, bp["attn_norm_g"], config.rms_eps)
        h, cache = _llama.attention_cached(h, bp, cache, i, pos_start, config)
        x = residual_add(x, h)
        h = rms_norm(x, bp["ffn_norm_g"], config.rms_eps)
        x = residual_add(x, _moe(bp, h, config))
    x = rms_norm(x, params["final_norm_g"], config.rms_eps)
    return lm_head(x, params["lm_head"]), cache


def generate(params: Dict[str, Any], prompt_ids, config: MixtralConfig,
             max_new_tokens: int, **kw):
    """Autoregressive generation (see :func:`.decode.generate`)."""
    from . import decode

    return decode.generate(
        forward_cached, init_cache, params, prompt_ids, config,
        max_new_tokens, **kw,
    )
