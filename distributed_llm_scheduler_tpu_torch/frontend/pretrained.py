"""Pretrained-weight ingestion: external checkpoints -> flat params.

The PyTorch port of ``distributed_llm_scheduler_tpu.frontend.pretrained``.
A HF/torch GPT-2, Llama or Mixtral state dict is name-mapped into the flat
param dict shared by :mod:`..models`, the DAG frontends and the backends,
as torch tensors on the CPU in the port's parameter layout (the caller
moves them, or the backend places them), so "schedule a real LLM" means
scheduling the *actual weights*.  The names, layouts, checks and error
messages are the JAX package's.

Layout note: HF GPT-2 uses ``Conv1D`` modules whose weights are stored
``(in_features, out_features)`` — the same orientation as our matmuls — so
the mapping is transpose-free; only names change.  Attention causal-mask
buffers (``attn.bias``/``attn.masked_bias``) and the tied ``lm_head.weight``
are dropped (we tie the head to ``wte`` the same way GPT-2 does).  Loading
a checkpoint from the HF hub is not ported: there is no network, and
:func:`torch.load` of a saved state dict is the way in.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models.gpt2 import GPT2Config, param_shapes

# HF name (layer-index formatted in) -> our flat name.  Complete for
# GPT2Model; GPT2LMHeadModel adds a "transformer." prefix (stripped) and
# "lm_head.weight" (tied; dropped).
_TOP_LEVEL = {
    "wte.weight": "wte",
    "wpe.weight": "wpe",
    "ln_f.weight": "ln_f_g",
    "ln_f.bias": "ln_f_b",
}
_PER_LAYER = {
    "ln_1.weight": "ln1_g",
    "ln_1.bias": "ln1_b",
    "attn.c_attn.weight": "attn_qkv_w",
    "attn.c_attn.bias": "attn_qkv_b",
    "attn.c_proj.weight": "attn_proj_w",
    "attn.c_proj.bias": "attn_proj_b",
    "ln_2.weight": "ln2_g",
    "ln_2.bias": "ln2_b",
    "mlp.c_fc.weight": "mlp_fc_w",
    "mlp.c_fc.bias": "mlp_fc_b",
    "mlp.c_proj.weight": "mlp_proj_w",
    "mlp.c_proj.bias": "mlp_proj_b",
}
# non-parameter buffers present in HF state dicts
_SKIP_SUFFIXES = (".attn.bias", ".attn.masked_bias")


def _to_tensor(v: Any) -> torch.Tensor:
    """Torch tensor / numpy array -> a CPU tensor (bf16 stays bf16)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.from_numpy(np.array(v))


def gpt2_params_from_state_dict(
    state_dict: Mapping[str, Any],
    config: GPT2Config,
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, torch.Tensor]:
    """Name-map a HF GPT-2 state dict into our flat param dict.

    Accepts ``GPT2Model`` or ``GPT2LMHeadModel`` state dicts (torch tensors
    or numpy arrays).  Every mapped tensor is shape-checked against
    :func:`..models.gpt2.param_shapes` for ``config``; missing or unknown
    parameter entries raise ``ValueError`` — silent partial loads are how
    wrong-model bugs hide.
    """
    dtype = dtype if dtype is not None else config.dtype
    expected = {k: shape for k, (shape, _) in param_shapes(config).items()}

    out: Dict[str, torch.Tensor] = {}
    unknown = []
    for name, value in state_dict.items():
        if name.startswith("transformer."):
            name = name[len("transformer."):]
        if name == "lm_head.weight" or name.endswith(_SKIP_SUFFIXES):
            continue
        ours = _TOP_LEVEL.get(name)
        if ours is None and name.startswith("h."):
            _, idx, rest = name.split(".", 2)
            per = _PER_LAYER.get(rest)
            if per is not None and idx.isdigit():
                ours = f"h{idx}_{per}"
        if ours is None:
            unknown.append(name)
            continue
        arr = _to_tensor(value)
        want = expected.get(ours)
        if want is None:
            raise ValueError(
                f"{name!r} maps to {ours!r} which is not a parameter of "
                f"this config (n_layer={config.n_layer}?)"
            )
        if tuple(arr.shape) != tuple(want):
            raise ValueError(
                f"shape mismatch for {name!r} -> {ours!r}: "
                f"checkpoint {tuple(arr.shape)} vs config {tuple(want)}"
            )
        out[ours] = arr.to(dtype).contiguous()

    if unknown:
        raise ValueError(f"unrecognized state-dict entries: {sorted(unknown)}")
    missing = sorted(set(expected) - set(out))
    if missing:
        raise ValueError(f"state dict is missing parameters: {missing}")
    return out


def config_from_hf(hf_config: Any, dtype: torch.dtype = torch.float32
                   ) -> GPT2Config:
    """Our config from a ``transformers.GPT2Config`` (structure fields only)."""
    return GPT2Config(
        vocab_size=hf_config.vocab_size,
        n_positions=hf_config.n_positions,
        n_embd=hf_config.n_embd,
        n_layer=hf_config.n_layer,
        n_head=hf_config.n_head,
        dtype=dtype,
        ln_eps=getattr(hf_config, "layer_norm_epsilon", 1e-5),
    )


# -- Llama family ------------------------------------------------------------

# HF stores torch.nn.Linear weights (out_features, in_features); our matmuls
# are x @ w with w (in, out), so every projection transposes on ingestion.
_LLAMA_TOP = {
    "embed_tokens.weight": ("tok_emb", False),
    "norm.weight": ("final_norm_g", False),
}
_LLAMA_PER_LAYER = {
    "input_layernorm.weight": ("attn_norm_g", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "post_attention_layernorm.weight": ("ffn_norm_g", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
}


def _interleave_rope_columns(w: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Permute q/k projection output columns from HF's rotate-half RoPE
    layout to our interleaved-pair layout.

    HF rotates pairs ``(j, j + hd/2)`` within each head; our
    :func:`..models.llama.apply_rope` rotates pairs ``(2j, 2j+1)`` with the
    SAME per-pair frequencies.  Mapping new column ``2j -> old j`` and
    ``2j+1 -> old j + hd/2`` per head makes our rope reproduce HF's math
    exactly; attention is invariant to the (shared) q/k permutation.  The
    same permutation llama.cpp's checkpoint converter applies.
    """
    d_in, out = w.shape
    hd = out // n_heads
    w = w.reshape(d_in, n_heads, 2, hd // 2)
    w = w.permute(0, 1, 3, 2)
    return w.reshape(d_in, out)


def _llama_backbone_params(
    state_dict: Mapping[str, Any],
    config: Any,
    expected: Dict[str, Tuple[int, ...]],
    per_layer: Mapping[str, Tuple[str, bool]],
    dtype: torch.dtype,
) -> Dict[str, torch.Tensor]:
    """The shared ingestion loop for Llama-backbone families: strip the
    ``model.`` prefix, rename/transpose per the maps, apply the RoPE
    column permutation to q/k, shape-check everything, fall back to tied
    embeddings for a missing ``lm_head.weight``."""
    hd = config.head_dim
    out: Dict[str, torch.Tensor] = {}
    unknown = []
    for name, value in state_dict.items():
        if name.startswith("model."):
            name = name[len("model."):]
        if name.endswith("rotary_emb.inv_freq"):
            continue  # derived buffer, not a parameter
        transpose = False
        ours = None
        if name == "lm_head.weight":
            ours, transpose = "lm_head", True
        elif name in _LLAMA_TOP:
            ours, transpose = _LLAMA_TOP[name]
        elif name.startswith("layers."):
            _, idx, rest = name.split(".", 2)
            per = per_layer.get(rest)
            if per is not None and idx.isdigit():
                ours, transpose = f"l{idx}_{per[0]}", per[1]
        if ours is None:
            unknown.append(name)
            continue
        arr = _to_tensor(value)
        if transpose:
            arr = arr.T
        if ours.endswith("_wq") or ours.endswith("_wk"):
            heads = arr.shape[1] // hd
            arr = _interleave_rope_columns(arr, heads)
        want = expected.get(ours)
        if want is None:
            raise ValueError(
                f"{name!r} maps to {ours!r} which is not a parameter of "
                f"this config (n_layers={config.n_layers}?)"
            )
        if tuple(arr.shape) != tuple(want):
            raise ValueError(
                f"shape mismatch for {name!r} -> {ours!r}: "
                f"checkpoint {tuple(arr.shape)} vs config {tuple(want)}"
            )
        out[ours] = arr.to(dtype).contiguous()

    if unknown:
        raise ValueError(f"unrecognized state-dict entries: {sorted(unknown)}")
    if "lm_head" not in out and "tok_emb" in out:
        out["lm_head"] = out["tok_emb"].T.contiguous()  # tied embeddings
    missing = sorted(set(expected) - set(out))
    if missing:
        raise ValueError(f"state dict is missing parameters: {missing}")
    return out


def llama_params_from_state_dict(
    state_dict: Mapping[str, Any],
    config: Any,
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, torch.Tensor]:
    """Name-map a HF Llama state dict into our flat param dict.

    Accepts ``LlamaModel`` or ``LlamaForCausalLM`` state dicts.  Beyond
    renaming: Linear weights transpose to (in, out), and q/k projections
    additionally permute per head for the RoPE-convention difference
    (:func:`_interleave_rope_columns`).  A missing ``lm_head.weight``
    (tied embeddings) falls back to ``tok_emb.T``.
    """
    from ..models.llama import param_shapes as llama_param_shapes

    dtype = dtype if dtype is not None else config.dtype
    expected = {k: shape for k, (shape, _) in llama_param_shapes(config).items()}
    return _llama_backbone_params(
        state_dict, config, expected, _LLAMA_PER_LAYER, dtype
    )


def mixtral_params_from_state_dict(
    state_dict: Mapping[str, Any],
    config: Any,
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, torch.Tensor]:
    """Name-map a HF Mixtral state dict into our flat param dict.

    The attention block is the Llama backbone's (same transposes, same
    RoPE permutation); the MoE block maps ``block_sparse_moe.gate`` to the
    router and each expert's ``w1/w3/w2`` to our ``w_gate/w_up/w_down``.
    HF's routing (softmax over all experts, top-k, renormalize) equals our
    renormalized-top-k softmax.
    """
    from ..models.mixtral import param_shapes as mixtral_param_shapes

    dtype = dtype if dtype is not None else config.dtype
    expected = {
        k: shape for k, (shape, _) in mixtral_param_shapes(config).items()
    }
    per_layer = {
        k: v for k, v in _LLAMA_PER_LAYER.items()
        if not k.startswith("mlp.")
    }
    per_layer["block_sparse_moe.gate.weight"] = ("router", True)
    for e in range(config.n_experts):
        pre = f"block_sparse_moe.experts.{e}."
        per_layer[pre + "w1.weight"] = (f"e{e}_w_gate", True)
        per_layer[pre + "w2.weight"] = (f"e{e}_w_down", True)
        per_layer[pre + "w3.weight"] = (f"e{e}_w_up", True)
    return _llama_backbone_params(
        state_dict, config, expected, per_layer, dtype
    )


def mixtral_config_from_hf(hf_config: Any, dtype: torch.dtype = torch.float32):
    """Our MixtralConfig from a ``transformers.MixtralConfig``."""
    from ..models.mixtral import MixtralConfig

    return MixtralConfig(
        vocab_size=hf_config.vocab_size,
        max_seq_len=hf_config.max_position_embeddings,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=hf_config.num_key_value_heads,
        ffn_hidden=hf_config.intermediate_size,
        n_experts=hf_config.num_local_experts,
        top_k=hf_config.num_experts_per_tok,
        rope_theta=float(hf_config.rope_theta),
        rms_eps=float(hf_config.rms_norm_eps),
        dtype=dtype,
    )


def llama_config_from_hf(hf_config: Any, dtype: torch.dtype = torch.float32):
    """Our LlamaConfig from a ``transformers.LlamaConfig`` (structure only)."""
    from ..models.llama import LlamaConfig

    return LlamaConfig(
        vocab_size=hf_config.vocab_size,
        max_seq_len=hf_config.max_position_embeddings,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=hf_config.num_key_value_heads,
        ffn_hidden=hf_config.intermediate_size,
        rope_theta=float(hf_config.rope_theta),
        rms_eps=float(hf_config.rms_norm_eps),
        dtype=dtype,
    )


def fit_params_to_dag(
    dag: Any, params: Dict[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """Derive any DAG-build-specific params missing from a base checkpoint.

    Vocab-sharded builds (``build_gpt2_dag(vocab_shards=S)``) consume
    ``wte_shard_k`` row slices of the tied table; checkpoints carry only
    ``wte``.  Returns a new dict with every spec key the DAG's tasks
    reference present.
    """
    from .vocab_sharding import shard_bounds

    out = dict(params)
    # GPT-2 family: row slices of the tied wte table.  Keys constructed
    # from the index — lexicographic sorting would misorder shard_10
    # before shard_2 at 10+ shards
    n_wte = sum(
        1 for k in dag.param_specs if k.startswith("wte_shard_")
    )
    if n_wte:
        lo = shard_bounds(dag.config.vocab_size, n_wte)
        for k in range(n_wte):
            out.setdefault(f"wte_shard_{k}", out["wte"][lo[k]:lo[k + 1]])
    # Llama backbone: tok_emb row slices + lm_head column slices (index
    # keys, like above — never iterate shard names lexicographically)
    n_emb = sum(
        1 for k in dag.param_specs if k.startswith("tok_emb_shard_")
    )
    if n_emb:
        lo = shard_bounds(dag.config.vocab_size, n_emb)
        for k in range(n_emb):
            out.setdefault(
                f"tok_emb_shard_{k}", out["tok_emb"][lo[k]:lo[k + 1]]
            )
            # a column slice is a strided view: copy it once, here
            out.setdefault(
                f"lm_head_shard_{k}",
                out["lm_head"][:, lo[k]:lo[k + 1]].contiguous(),
            )
    missing = sorted(set(dag.param_specs) - set(out))
    if missing:
        raise ValueError(f"params missing for DAG {dag.graph.name}: {missing}")
    return out
