"""Tensor-parallel blocks of the three model families.

The JAX package runs the unchanged global program of each family under
sharding annotations, and XLA inserts the Megatron collectives
(``distributed_llm_scheduler_tpu/parallel/sharding.py:3-6``,
``decode.py:13-19``).  Here each rank runs its own block of the model on
its blocks of the params (:func:`.sharding.shard_params`), built from the
per-op functions of ``models/*.py``, with the two collectives written in:

* column-parallel products (qkv / wq, wk, wv; the FFN's fc / gate, up)
  give this rank's heads and FFN columns; their replicated input goes
  through :func:`.collectives.copy_to_group` in the training forward;
* row-parallel products (attention's proj / wo; the FFN's proj / down)
  give partial sums, and :func:`.collectives.reduce_from_group` sums them
  over ``tp`` before anything else reads them;
* the row-parallel biases (``attn_proj_b``, ``mlp_proj_b``, replicated)
  are added once, after the sum;
* Llama's ``lm_head`` is column-sharded over the vocab: the logits are
  gathered over ``tp`` before anyone reads them (argmax, sampling);
  GPT-2's tied ``wte`` is replicated;
* Mixtral's router is replicated and its experts shard like the dense
  FFN; the combine is linear, so one sum after ``moe_combine`` covers
  every expert.

With a ``tp`` of 1 every collective is the identity and each function
runs the same operations, in the same order, as the family's own.
Attention is the port's :func:`..ops.attention.mha` / ``gqa_mha`` (the
flash kernel on a card), or ring attention over ``sp`` in the
sequence-parallel training forward; norms are ``ops/norms.py``'s (the
LayerNorm and RMSNorm kernels on a card).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict

import torch

from ..models import decode, gpt2, llama, mixtral
from ..ops.attention import mha
from ..ops.norms import layer_norm, rms_norm
from .collectives import all_gather_dim, copy_to_group, reduce_from_group
from .ring_attention import ring_attention


def _tp(mesh):
    return mesh.group("tp"), mesh.axis_size("tp")


# -- GPT-2: the training and evaluation forward ---------------------------------

def gpt2_block(block_params: Dict[str, Any], x, config, *, mesh,
               seq_parallel: bool = False):
    """One GPT-2 layer on this rank's heads and FFN columns, params keyed
    by ``gpt2._BLOCK_KEYS``.  ``seq_parallel``: x is this rank's sequence
    chunk and attention runs as ring attention over ``sp``."""
    group, ntp = _tp(mesh)
    B, T, _ = x.shape
    nh, hd = config.n_head // ntp, config.head_dim
    Dl = nh * hd
    h = layer_norm(x, block_params["ln1_g"], block_params["ln1_b"], config.ln_eps)
    h = copy_to_group(h, group)
    qkv = h @ block_params["attn_qkv_w"] + block_params["attn_qkv_b"]
    q, k, v = (t.reshape(B, T, nh, hd).transpose(1, 2)
               for t in qkv.split(Dl, dim=-1))
    if seq_parallel:
        att = ring_attention(q, k, v, mesh)
    else:
        att = mha(q, k, v, causal=True)
    att = att.transpose(1, 2).reshape(B, T, Dl)
    x = x + (reduce_from_group(att @ block_params["attn_proj_w"], group)
             + block_params["attn_proj_b"])
    h = layer_norm(x, block_params["ln2_g"], block_params["ln2_b"], config.ln_eps)
    h = copy_to_group(h, group)
    h = gpt2.ffn_activation(gpt2.ffn_expand(h, block_params["mlp_fc_w"],
                                            block_params["mlp_fc_b"]))
    return x + (reduce_from_group(h @ block_params["mlp_proj_w"], group)
                + block_params["mlp_proj_b"])


def gpt2_forward(params: Dict[str, Any], input_ids, config, mesh,
                 remat: bool = False, scan: bool = False,
                 seq_parallel: bool = False):
    """GPT-2's forward on this rank's param blocks and token block, with
    gradients flowing: logits (B_local, T_local, vocab).  ``scan``
    expects stacked ``layers_*`` params (``gpt2.stack_layer_params``);
    ``remat`` checkpoints each block (``gpt2._select_block``);
    ``seq_parallel`` offsets the position rows by this rank's chunk."""
    block = gpt2._select_block(remat, functools.partial(
        gpt2_block, mesh=mesh, seq_parallel=seq_parallel))
    T = input_ids.shape[-1]
    off = mesh.coords["sp"] * T if seq_parallel else 0
    x = params["wte"][input_ids] + params["wpe"][off:off + T]
    if scan:
        stacked = {k: params["layers_" + k] for k in gpt2._BLOCK_KEYS}
        layers = [{k: v[i] for k, v in stacked.items()}
                  for i in range(stacked[gpt2._BLOCK_KEYS[0]].shape[0])]
    else:
        layers = [{k: params[f"h{i}_{k}"] for k in gpt2._BLOCK_KEYS}
                  for i in range(config.n_layer)]
    for bp in layers:
        x = block(bp, x, config)
    return gpt2._head(x, params, config)


# -- KV-cache decoding: the families' forward_cached on param blocks ------------

def kv_heads(config) -> int:
    """The family's KV head count (GPT-2: its heads)."""
    return getattr(config, "n_kv_heads", None) or config.n_head


def init_cache(config, batch: int, max_len: int, device: Any = "cuda", *,
               mesh):
    """The dense cache of this rank's KV heads."""
    ntp = mesh.axis_size("tp")
    n_layers = getattr(config, "n_layers", None) or config.n_layer
    return decode.init_cache(n_layers, batch, kv_heads(config) // ntp,
                             max_len, config.head_dim, config.dtype, device)


@torch.no_grad()
def gpt2_forward_cached(params, input_ids, cache, pos_start, config, *, mesh):
    """``gpt2.forward_cached`` on this rank's heads and FFN columns."""
    group, ntp = _tp(mesh)
    B, T = input_ids.shape
    nh, hd = config.n_head // ntp, config.head_dim
    Dl = nh * hd
    rows = decode.positions(pos_start, T, params["wpe"].device)
    x = params["wte"][input_ids] + params["wpe"].index_select(0, rows)
    for i in range(config.n_layer):
        p = f"h{i}_"
        ln1 = layer_norm(x, params[p + "ln1_g"], params[p + "ln1_b"], config.ln_eps)
        qkv = ln1 @ params[p + "attn_qkv_w"] + params[p + "attn_qkv_b"]
        q, k, v = (t.reshape(B, T, nh, hd).transpose(1, 2)
                   for t in qkv.split(Dl, dim=-1))
        cache = decode.update_layer_cache(cache, i, k, v, pos_start)
        kc, vc, ks, vs = decode.layer_view(cache, i)
        att = decode.cached_attention(q, kc, vc, pos_start, 1.0 / math.sqrt(hd),
                                      k_scale=ks, v_scale=vs)
        att = att.transpose(1, 2).reshape(B, T, Dl)
        x = x + (reduce_from_group(att @ params[p + "attn_proj_w"], group)
                 + params[p + "attn_proj_b"])
        ln2 = layer_norm(x, params[p + "ln2_g"], params[p + "ln2_b"], config.ln_eps)
        h = gpt2.ffn_activation(gpt2.ffn_expand(ln2, params[p + "mlp_fc_w"],
                                                params[p + "mlp_fc_b"]))
        x = x + (reduce_from_group(h @ params[p + "mlp_proj_w"], group)
                 + params[p + "mlp_proj_b"])
    x = layer_norm(x, params["ln_f_g"], params["ln_f_b"], config.ln_eps)
    return gpt2.output_projection(x, params["wte"]), cache


def _attention_cached(x, bp, cache, layer: int, pos_start, config, mesh):
    """``llama.attention_cached`` on this rank's query and KV heads (the
    GQA grouping holds: both split contiguously over tp)."""
    group, ntp = _tp(mesh)
    B, T, _ = x.shape
    nh, nkv, hd = config.n_heads // ntp, config.n_kv_heads // ntp, config.head_dim
    q = (x @ bp["wq"]).reshape(B, T, nh, hd).transpose(1, 2)
    k = (x @ bp["wk"]).reshape(B, T, nkv, hd).transpose(1, 2)
    v = (x @ bp["wv"]).reshape(B, T, nkv, hd).transpose(1, 2)
    cos, sin = llama.rope_rows(pos_start, T, hd, config.rope_theta, x.device)
    q = llama.apply_rope(q, cos, sin)
    k = llama.apply_rope(k, cos, sin)
    cache = decode.update_layer_cache(cache, layer, k, v, pos_start)
    kc, vc, ks, vs = decode.layer_view(cache, layer)
    out = decode.cached_attention(q, kc, vc, pos_start, 1.0 / math.sqrt(hd),
                                  k_scale=ks, v_scale=vs)
    out = out.transpose(1, 2).reshape(B, T, nh * hd)
    return reduce_from_group(out @ bp["wo"], group), cache


def _backbone_cached(params, input_ids, cache, pos_start, config, mesh,
                     keys, ffn):
    """The Llama backbone's cached forward over param blocks, the FFN
    (``ffn(block_params, h)``, a partial sum) summed over tp."""
    group, _ = _tp(mesh)
    x = llama.embedding(input_ids, params["tok_emb"])
    for i in range(config.n_layers):
        bp = {k: params[f"l{i}_{k}"] for k in keys}
        h = rms_norm(x, bp["attn_norm_g"], config.rms_eps)
        h, cache = _attention_cached(h, bp, cache, i, pos_start, config, mesh)
        x = llama.residual_add(x, h)
        h = rms_norm(x, bp["ffn_norm_g"], config.rms_eps)
        x = llama.residual_add(x, reduce_from_group(ffn(bp, h), group))
    x = rms_norm(x, params["final_norm_g"], config.rms_eps)
    logits = llama.lm_head(x, params["lm_head"])  # this rank's vocab columns
    return all_gather_dim(logits, group, -1), cache


def _swiglu(bp, h):
    return llama.ffn_down(llama.ffn_glu(llama.ffn_gate(h, bp["w_gate"]),
                                        llama.ffn_up(h, bp["w_up"])),
                          bp["w_down"])


@torch.no_grad()
def llama_forward_cached(params, input_ids, cache, pos_start, config, *, mesh):
    """``llama.forward_cached`` on this rank's heads, FFN columns and
    vocab columns; the logits gathered whole."""
    return _backbone_cached(params, input_ids, cache, pos_start, config, mesh,
                            llama._BLOCK_KEYS, _swiglu)


@torch.no_grad()
def mixtral_forward_cached(params, input_ids, cache, pos_start, config, *,
                           mesh):
    """``mixtral.forward_cached`` on this rank's heads, expert FFN columns
    and vocab columns: the replicated router routes every token, each
    expert gives a partial sum, and one sum after the combine covers them
    all."""
    def moe(bp, h):
        w = mixtral.router_weights(h, bp["router"], config.top_k)
        outs = [mixtral.expert_ffn(h, bp[f"e{e}_w_gate"], bp[f"e{e}_w_up"],
                                   bp[f"e{e}_w_down"])
                for e in range(config.n_experts)]
        return mixtral.moe_combine(w, *outs)

    return _backbone_cached(params, input_ids, cache, pos_start, config, mesh,
                            mixtral._layer_keys(config), moe)


FORWARD_CACHED = {
    "gpt2": gpt2_forward_cached,
    "llama": llama_forward_cached,
    "mixtral": mixtral_forward_cached,
}


__all__ = [
    "FORWARD_CACHED", "gpt2_block", "gpt2_forward", "gpt2_forward_cached",
    "init_cache", "kv_heads", "llama_forward_cached", "mixtral_forward_cached",
]
