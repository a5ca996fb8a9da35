"""The paged KV-cache decode step as a task DAG: inference through the
scheduler.

PyTorch port of the paged half of ``distributed_llm_scheduler_tpu.
frontend.decode_dag`` (GPT-2 family).  One decode step for ``slots``
batch lanes becomes a per-layer task DAG whose KV cache is placeable:
every layer task needs its layer's shared page pools ``cache_k_{i}`` /
``cache_v_{i}`` ``(n_pages, page_size, H, hd)`` and the ``page_table``
``(slots, pages_per_seq) int32``, so placement sees the paged cache's real
residency.  Positions are runtime data (``{"ids", "lengths"}``), so one
graph serves every step.  Each layer task outputs ``{"x", "k_new",
"v_new", "lengths"}``: the step's own K/V rows, which its attention
already inserted (write-then-attend) and which the loop composer
(``backends/decode_loop.py``) writes into the pools after the step.

Task ids, dependencies, parameter sets and byte sizes, activation bytes
(inferred by running each task fn on ``device="meta"`` tensors), FLOP
counts, groups and the graph name equal the JAX builder's.  The dense
``build_decode_dag`` and the Llama/Mixtral builders are not ported yet.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.graph import Task, TaskGraph
from ..models import gpt2
from ..models.gpt2 import GPT2Config
from .gpt2_dag import DEFAULT_EFFECTIVE_FLOPS, ModelDAG, _dtype_name, make_task_adder


def cache_dims(config: Any) -> tuple:
    """``(n_layers, n_kv_heads, head_dim)`` of a config; GPT-2 is the one
    family the port has so far."""
    if not isinstance(config, GPT2Config):
        raise NotImplementedError(
            f"{type(config).__name__}: only the GPT-2 family is ported"
        )
    return config.n_layer, config.n_head, config.head_dim


class PagedDecodeDAG(ModelDAG):
    """ModelDAG for the paged decode step: inputs are ``{"ids": (S, 1)
    int32, "lengths": (S,) int32}`` and the KV cache params are shared
    page pools plus the ``page_table`` param."""

    slots: int = 1
    page_size: int = 0
    pages_per_seq: int = 0
    #: attention impl baked into the layer tasks (None = by device)
    attention_impl: Optional[str] = None

    def make_inputs(self, seed: int = 1, device: Any = "cuda",
                    lengths: Optional[Any] = None) -> Dict[str, torch.Tensor]:
        """Token ids in ``[0, vocab)`` from a numpy seed, and ``lengths``
        (zeros by default), both int32 on ``device``."""
        S = self.input_spec["ids"].shape[0]
        rng = np.random.default_rng(seed)
        ids = rng.integers(0, self.config.vocab_size, size=(S, 1), dtype=np.int32)
        ln = np.zeros((S,), np.int32) if lengths is None else np.asarray(
            lengths, np.int32)
        return {
            "ids": torch.from_numpy(ids).to(device),
            "lengths": torch.from_numpy(ln).to(device),
        }


def build_paged_decode_dag(
    config: Optional[GPT2Config] = None,
    slots: int = 4,
    page_size: int = 16,
    n_pages: int = 64,
    pages_per_seq: int = 8,
    effective_flops: float = DEFAULT_EFFECTIVE_FLOPS,
    attention_impl: Optional[str] = None,
) -> PagedDecodeDAG:
    """Paged single-token decode step as a task DAG (GPT-2 family).

    Attention is the ragged paged op
    (:func:`...ops.attention.paged_decode_attention`), with this step's
    K/V rows inserted at each slot's ``lengths[s]``.  ``attention_impl``
    is baked into every layer task: ``None``/``"auto"`` dispatch by
    device (the CUDA kernel on the card, the plain version on the CPU),
    ``"kernel"`` or ``"plain"`` force one; the graph name carries it."""
    from ..models.kv_pages import TRASH_PAGE, init_paged_kv
    from ..ops.attention import check_paged_impl, paged_decode_attention

    check_paged_impl(attention_impl)  # fail at build time on a typo
    config = config or GPT2Config.tiny()
    if n_pages < 2:
        raise ValueError(f"n_pages must be >= 2 (page 0 is reserved), "
                         f"got {n_pages}")
    S, D, H = slots, config.n_embd, config.n_head
    hd, ps = config.head_dim, page_size
    M = pages_per_seq * page_size  # per-slot gathered capacity
    eps = config.ln_eps
    scale = 1.0 / math.sqrt(hd)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    specs = {
        name: meta(shape, dtype)
        for name, (shape, dtype) in gpt2.param_shapes(config).items()
    }
    for i in range(config.n_layer):
        for kind in ("k", "v"):
            specs[f"cache_{kind}_{i}"] = meta((n_pages, ps, H, hd), config.dtype)
    specs["page_table"] = meta((S, pages_per_seq), torch.int32)
    input_spec = {
        "ids": meta((S, 1), torch.int32),
        "lengths": meta((S,), torch.int32),
    }

    tasks: List[Task] = []
    out_specs: Dict[str, Any] = {}
    add = make_task_adder(tasks, out_specs, specs, input_spec, effective_flops)

    def f_embed(p, inputs):
        # per-slot position rows: slot s sits at its own lengths[s]
        lengths = inputs["lengths"]
        wpe_rows = p["wpe"].index_select(0, lengths)[:, None, :]
        return {"x": p["wte"][inputs["ids"]] + wpe_rows, "lengths": lengths}

    def f_layer(p, prev):
        """One paged cached layer: ragged paged attention over the shared
        pools (this step's k/v inserted at each slot's length — the pool
        write itself is the loop composer's), then the MLP."""
        x, lengths = prev["x"], prev["lengths"]
        ln1 = gpt2.layer_norm(x, p["ln1_g"], p["ln1_b"], eps)
        qkv = ln1 @ p["qkv_w"] + p["qkv_b"]
        q, k, v = qkv.split(D, dim=-1)

        def heads(t):
            return t.reshape(S, 1, H, hd).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        att = paged_decode_attention(
            q, p["cache_k"], p["cache_v"], p["page_table"], lengths,
            scale, k_new=k, v_new=v, impl=attention_impl,
        )
        att = att.transpose(1, 2).reshape(S, 1, D)
        x = x + (att @ p["attn_proj_w"] + p["attn_proj_b"])
        ln2 = gpt2.layer_norm(x, p["ln2_g"], p["ln2_b"], eps)
        h = gpt2.ffn_contract(
            gpt2.ffn_activation(gpt2.ffn_expand(ln2, p["fc_w"], p["fc_b"])),
            p["mlp_proj_w"], p["mlp_proj_b"],
        )
        return {"x": x + h, "k_new": k, "v_new": v, "lengths": lengths}

    def f_head(p, prev):
        x = gpt2.layer_norm(prev["x"], p["ln_f_g"], p["ln_f_b"], eps)
        return gpt2.output_projection(x, p["wte"])

    add("embed", f_embed, [], {"wte": "wte", "wpe": "wpe"},
        2.0 * S * D, "embed")
    prev = "embed"
    for i in range(config.n_layer):
        pre = f"h{i}_"
        alias = {
            "ln1_g": pre + "ln1_g", "ln1_b": pre + "ln1_b",
            "qkv_w": pre + "attn_qkv_w", "qkv_b": pre + "attn_qkv_b",
            "attn_proj_w": pre + "attn_proj_w",
            "attn_proj_b": pre + "attn_proj_b",
            "ln2_g": pre + "ln2_g", "ln2_b": pre + "ln2_b",
            "fc_w": pre + "mlp_fc_w", "fc_b": pre + "mlp_fc_b",
            "mlp_proj_w": pre + "mlp_proj_w",
            "mlp_proj_b": pre + "mlp_proj_b",
            "cache_k": f"cache_k_{i}", "cache_v": f"cache_v_{i}",
            "page_table": "page_table",
        }
        # attention over the slot's full paged capacity, as the JAX
        # builder counts it
        flops = (
            2.0 * S * D * 3 * D
            + 2.0 * 2.0 * S * H * M * hd
            + 2.0 * S * D * D
            + 2.0 * S * D * 4 * D * 2
        )
        tid = f"layer_{i}"
        add(tid, f_layer, [prev], alias, flops, f"layer_{i}")
        prev = tid
    add("logits", f_head, [prev], {
        "ln_f_g": "ln_f_g", "ln_f_b": "ln_f_b", "wte": "wte",
    }, 2.0 * S * D * config.vocab_size, "head")

    name = (
        f"gpt2paged_{config.n_layer}l_d{D}_s{S}_ps{ps}_p{n_pages}"
        + ("" if config.dtype == torch.float32
           else f"_{_dtype_name(config.dtype)}")
        + ("" if attention_impl is None else f"_att{attention_impl}")
    )

    def derive_params(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The model's params plus empty page pools and a page table of
        trash pages, on the params' device."""
        device = params["wte"].device
        params = dict(params)
        params.update(init_paged_kv(
            config.n_layer, n_pages, ps, H, hd, config.dtype, device
        ))
        params["page_table"] = torch.full(
            (S, pages_per_seq), TRASH_PAGE, dtype=torch.int32, device=device
        )
        return params

    def reference_forward(params, inputs):
        """Independent oracle: per-slot DENSE cached forward — gather each
        slot's pages into a dense (1, H, M, hd) cache and run
        ``forward_cached`` at that slot's position.  Slow (a loop over
        slots) but shares no code with the paged op."""
        from ..models.kv_pages import gather_kv

        model_params = {
            k: v for k, v in params.items()
            if not k.startswith("cache_") and k != "page_table"
        }
        pt = params["page_table"]
        outs = []
        for s in range(S):
            cache = {
                kind: torch.stack([
                    gather_kv(params[f"cache_{kind}_{i}"], pt[s:s + 1])
                    for i in range(config.n_layer)
                ])
                for kind in ("k", "v")
            }
            logits, _ = gpt2.forward_cached(
                model_params, inputs["ids"][s:s + 1], cache,
                int(inputs["lengths"][s]), config,
            )
            outs.append(logits)
        return torch.cat(outs, dim=0)

    graph = TaskGraph(tasks, name=name).freeze()
    # stamped on the graph too: the engine receives the bare TaskGraph
    graph.attention_impl = attention_impl
    dag = PagedDecodeDAG(
        graph=graph,
        config=config,
        input_spec=input_spec,
        param_specs=specs,
        reference_forward=reference_forward,
        model=gpt2,
        derive_params=derive_params,
    )
    dag.slots = S
    dag.page_size = ps
    dag.pages_per_seq = pages_per_seq
    dag.attention_impl = attention_impl
    return dag


__all__ = ["PagedDecodeDAG", "build_paged_decode_dag", "cache_dims"]
