"""The KV-cache decode step as a task DAG: inference through the scheduler.

PyTorch port of ``distributed_llm_scheduler_tpu.frontend.decode_dag``.
One cached forward step becomes a per-layer task DAG whose KV cache is
placeable: every layer task needs its layer's cache params, so placement
sees the cache's real residency.

* Dense (all three families): :func:`build_decode_dag` (GPT-2),
  :func:`build_backbone_decode_dag` (Llama / Mixtral: GQA cache layout,
  RoPE at the runtime position, MoE routing per step) and the dispatching
  :func:`build_decode_dag_any`.  The cache params are per-layer slabs
  ``cache_k_{i}`` / ``cache_v_{i}`` ``(B, Hkv, max_len, hd)``; the graph
  input is ``{"ids", "pos"}`` with ``pos`` a 0-d int32 tensor, threaded
  through each task's output, so one graph serves every position of its
  ``(step_len, max_len)`` class and no task reads the position back to
  the host (its wpe or RoPE rows, cache rows and masks are tensor ops on
  it).  Each layer task outputs ``{"x", "k_new", "v_new", "pos"}``;
  :func:`apply_cache_updates` writes the new rows into the slabs in place.
* Paged (GPT-2): :func:`build_paged_decode_dag`, one decode step for
  ``slots`` batch lanes over shared page pools ``cache_k_{i}`` /
  ``cache_v_{i}`` ``(n_pages, page_size, H, hd)`` and the ``page_table``;
  positions are ``{"ids", "lengths"}``.  Each layer task outputs ``{"x",
  "k_new", "v_new", "lengths"}``: the step's own K/V rows, which its
  attention already inserted (write-then-attend) and which the loop
  composer (``backends/decode_loop.py``) writes into the pools.

Task ids, dependencies, parameter sets and byte sizes, activation bytes
(inferred by running each task fn on ``device="meta"`` tensors), FLOP
counts, groups and the graph name equal the JAX builders'.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.graph import Task, TaskGraph
from ..models import decode as _decode
from ..models import gpt2
from ..models.family import family_of
from ..models.gpt2 import GPT2Config
from .gpt2_dag import DEFAULT_EFFECTIVE_FLOPS, ModelDAG, _dtype_name, make_task_adder


def cache_dims(config: Any) -> tuple:
    """``(n_layers, n_kv_heads, head_dim)`` for any family's config: GPT-2
    spells these ``n_layer``/``n_head``, the Llama backbone
    ``n_layers``/``n_kv_heads``.  Callers allocating cache slabs use this
    rather than re-derive the attributes."""
    if family_of(config) == "gpt2":
        return config.n_layer, config.n_head, config.head_dim
    return config.n_layers, config.n_kv_heads, config.head_dim


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


class DecodeDAG(ModelDAG):
    """ModelDAG whose graph input is ``{"ids": (B, T) int32, "pos": ()
    int32}``: the position is runtime data, so one graph serves every step
    of its ``(step_len, max_len)`` class.  ``default_pos`` seeds
    :meth:`make_inputs` (callers stepping a generation pass their own)."""

    default_pos: int = 0

    def make_inputs(self, seed: int = 1, device: Any = "cuda",
                    pos: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Token ids in ``[0, vocab)`` from a numpy seed, and the position,
        both int32 on ``device``."""
        rng = np.random.default_rng(seed)
        ids = rng.integers(0, self.config.vocab_size,
                           size=tuple(self.input_spec["ids"].shape),
                           dtype=np.int32)
        return decode_inputs(torch.from_numpy(ids).to(device),
                             self.default_pos if pos is None else pos)


def decode_inputs(ids: Any, pos: Any, max_len: Optional[int] = None
                  ) -> Dict[str, torch.Tensor]:
    """The decode graphs' input dict for a concrete step: ``ids`` as int32
    and ``pos`` as a 0-d int32 tensor on the ids' device (made there by a
    fill, not copied from the host).

    Pass ``max_len`` for the bounds check the build-time guard cannot
    give (the position is runtime data): an out-of-range position would
    write past the cache.  A position given as a tensor on a card is not
    read back to check it."""
    ids = torch.as_tensor(ids).to(torch.int32)
    T = ids.shape[-1]
    if isinstance(pos, torch.Tensor):
        if max_len is not None and pos.device.type == "cpu" and \
                int(pos) + T > max_len:
            raise ValueError(f"pos {int(pos)} + step_len {T} exceeds "
                             f"max_len {max_len}")
        return {"ids": ids, "pos": pos.to(device=ids.device, dtype=torch.int32)}
    if max_len is not None and int(pos) + T > max_len:
        raise ValueError(f"pos {int(pos)} + step_len {T} exceeds "
                         f"max_len {max_len}")
    return {"ids": ids, "pos": torch.full((), int(pos), dtype=torch.int32,
                                          device=ids.device)}


def _with_step_rows(cache: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """A copy of the cache slab (B, H, M, hd) with this step's rows written
    at ``pos``: the reference's functional ``dynamic_update_slice``.  The
    placed slab itself is not written; :func:`apply_cache_updates` folds
    the step's rows into it after the run."""
    idx = _decode.positions(pos, new.shape[2], cache.device)
    return cache.index_copy(2, idx, new.to(cache.dtype))


def _stacked_cache(params: Dict[str, torch.Tensor], n_layers: int
                   ) -> Dict[str, torch.Tensor]:
    """The stacked-layer cache assembled (copied) from the per-layer slabs,
    so the oracle's in-place writes leave the slabs alone."""
    return {kind: torch.stack([params[f"cache_{kind}_{i}"]
                               for i in range(n_layers)])
            for kind in ("k", "v")}


def _cache_slab_params(n_layers: int, shape: tuple, dtype: torch.dtype):
    """``derive_params`` of a dense decode DAG: the model's params plus
    zeroed ``cache_k_{i}``/``cache_v_{i}`` slabs on their device."""

    def derive(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        device = next(iter(params.values())).device
        params = dict(params)
        for i in range(n_layers):
            for kind in ("k", "v"):
                params[f"cache_{kind}_{i}"] = torch.zeros(
                    shape, dtype=dtype, device=device)
        return params

    return derive


def _dense_name(prefix: str, config: Any, n_layers: int, D: int, B: int,
                T: int, M: int) -> str:
    return (f"{prefix}dec_{n_layers}l_d{D}_b{B}_t{T}_m{M}"
            + ("" if config.dtype == torch.float32
               else f"_{_dtype_name(config.dtype)}"))


def build_decode_dag(
    config: Optional[GPT2Config] = None,
    batch: int = 1,
    step_len: int = 1,
    pos: int = 0,
    max_len: int = 128,
    effective_flops: float = DEFAULT_EFFECTIVE_FLOPS,
) -> DecodeDAG:
    """Task DAG for one cached GPT-2 forward step; the position is a
    runtime input.

    ``step_len > 1`` is the prefill class, ``step_len = 1`` the decode
    class: one graph per class covers every position (``pos`` here only
    seeds ``make_inputs``' default and is checked against ``max_len``).
    Params are the model weights plus per-layer ``cache_k_{i}`` /
    ``cache_v_{i}`` slabs (zeros from ``init_params``).  Each layer task
    attends over a copy of its slab with this step's rows written at
    ``pos`` and outputs ``{"x", "k_new", "v_new", "pos"}``; the sink is
    the logits task.  Fold the step into the slabs with
    :func:`apply_cache_updates` from ``execute(keep_outputs=True)``'s
    ``task_outputs``."""
    config = config or GPT2Config.tiny()
    if pos + step_len > max_len:
        raise ValueError(
            f"pos {pos} + step_len {step_len} exceeds max_len {max_len}")
    B, T, D, H = batch, step_len, config.n_embd, config.n_head
    hd, M = config.head_dim, max_len
    eps = config.ln_eps
    scale = 1.0 / math.sqrt(hd)

    specs = {name: _meta(shape, dtype)
             for name, (shape, dtype) in gpt2.param_shapes(config).items()}
    for i in range(config.n_layer):
        specs[f"cache_k_{i}"] = _meta((B, H, M, hd), config.dtype)
        specs[f"cache_v_{i}"] = _meta((B, H, M, hd), config.dtype)
    input_spec = {"ids": _meta((B, T), torch.int32),
                  "pos": _meta((), torch.int32)}

    tasks: List[Task] = []
    out_specs: Dict[str, Any] = {}
    add = make_task_adder(tasks, out_specs, specs, input_spec, effective_flops)

    def f_embed(p, inputs):
        # token embedding + position rows [pos, pos + T), pos on the device
        pos_t = inputs["pos"]
        rows = _decode.positions(pos_t, T, p["wpe"].device)
        return {"x": p["wte"][inputs["ids"]] + p["wpe"].index_select(0, rows),
                "pos": pos_t}

    def f_layer(p, prev):
        """One cached transformer layer: attention over [0, pos + T) of the
        cache (this step's keys/values included), then the MLP."""
        x, pos_t = prev["x"], prev["pos"]
        ln1 = gpt2.layer_norm(x, p["ln1_g"], p["ln1_b"], eps)
        qkv = ln1 @ p["qkv_w"] + p["qkv_b"]
        q, k, v = qkv.split(D, dim=-1)

        def heads(t):
            return t.reshape(B, T, H, hd).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        att = _decode.cached_attention(
            q, _with_step_rows(p["cache_k"], k, pos_t),
            _with_step_rows(p["cache_v"], v, pos_t), pos_t, scale)
        att = att.transpose(1, 2).reshape(B, T, D)
        x = x + (att @ p["attn_proj_w"] + p["attn_proj_b"])
        ln2 = gpt2.layer_norm(x, p["ln2_g"], p["ln2_b"], eps)
        h = gpt2.ffn_contract(
            gpt2.ffn_activation(gpt2.ffn_expand(ln2, p["fc_w"], p["fc_b"])),
            p["mlp_proj_w"], p["mlp_proj_b"],
        )
        return {"x": x + h, "k_new": k, "v_new": v, "pos": pos_t}

    def f_head(p, prev):
        x = gpt2.layer_norm(prev["x"], p["ln_f_g"], p["ln_f_b"], eps)
        return gpt2.output_projection(x, p["wte"])

    add("embed", f_embed, [], {"wte": "wte", "wpe": "wpe"},
        2.0 * B * T * D, "embed")
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
        }
        # projections on T tokens + attention over the FULL masked cache
        # (compute is O(M) at any position: static shapes)
        flops = (
            2.0 * B * T * D * 3 * D
            + 2.0 * 2.0 * B * H * T * M * hd
            + 2.0 * B * T * D * D
            + 2.0 * B * T * D * 4 * D * 2
        )
        tid = f"layer_{i}"
        add(tid, f_layer, [prev], alias, flops, f"layer_{i}")
        prev = tid
    add("logits", f_head, [prev], {
        "ln_f_g": "ln_f_g", "ln_f_b": "ln_f_b", "wte": "wte",
    }, 2.0 * B * T * D * config.vocab_size, "head")

    def reference_forward(params, inputs):
        """Whole-program oracle over the same cache params: the stacked
        cache assembled from the per-layer slabs, ``forward_cached``."""
        model_params = {k: v for k, v in params.items()
                        if not k.startswith("cache_")}
        logits, _ = gpt2.forward_cached(
            model_params, inputs["ids"], _stacked_cache(params, config.n_layer),
            inputs["pos"], config)
        return logits

    graph = TaskGraph(
        tasks, name=_dense_name("gpt2", config, config.n_layer, D, B, T, M)
    ).freeze()
    dag = DecodeDAG(
        graph=graph, config=config, input_spec=input_spec, param_specs=specs,
        reference_forward=reference_forward, model=gpt2,
        derive_params=_cache_slab_params(config.n_layer, (B, H, M, hd),
                                         config.dtype),
    )
    dag.default_pos = pos
    return dag


def build_backbone_decode_dag(
    config: Any,
    batch: int = 1,
    step_len: int = 1,
    pos: int = 0,
    max_len: int = 128,
    effective_flops: float = DEFAULT_EFFECTIVE_FLOPS,
) -> DecodeDAG:
    """Llama-backbone decode-step DAG (Llama and Mixtral configs).

    The contract of :func:`build_decode_dag`: per-layer tasks own
    ``cache_k_{i}`` / ``cache_v_{i}`` slabs in the GQA layout
    ``(B, n_kv_heads, max_len, hd)``, RoPE rows are computed at the
    runtime step position, and Mixtral layers run their router and dense
    experts per step (routing is per token, as the fused cached forward
    does).  Oracle: the family's ``forward_cached`` over the stacked
    cache."""
    from ..models import llama as _llama
    from ..models import mixtral as _mixtral

    family = family_of(config)
    if family not in ("llama", "mixtral"):
        raise ValueError(f"backbone decode DAG needs llama/mixtral, got {family}")
    mod = _llama if family == "llama" else _mixtral
    is_moe = family == "mixtral"
    if pos + step_len > max_len:
        raise ValueError(
            f"pos {pos} + step_len {step_len} exceeds max_len {max_len}")
    B, T, D = batch, step_len, config.d_model
    nh, nkv, hd = config.n_heads, config.n_kv_heads, config.head_dim
    M, eps = max_len, config.rms_eps
    n_layers = config.n_layers
    scale = 1.0 / math.sqrt(hd)

    specs = {name: _meta(shape, dtype)
             for name, (shape, dtype) in mod.param_shapes(config).items()}
    for i in range(n_layers):
        for kind in ("k", "v"):
            specs[f"cache_{kind}_{i}"] = _meta((B, nkv, M, hd), config.dtype)
    input_spec = {"ids": _meta((B, T), torch.int32),
                  "pos": _meta((), torch.int32)}

    tasks: List[Task] = []
    out_specs: Dict[str, Any] = {}
    add = make_task_adder(tasks, out_specs, specs, input_spec, effective_flops)

    def f_embed(p, inputs):
        return {"x": _llama.embedding(inputs["ids"], p["tok_emb"]),
                "pos": inputs["pos"]}

    def f_layer(p, prev):
        x, pos_t = prev["x"], prev["pos"]
        h = _llama.rms_norm(x, p["attn_norm_g"], eps)
        q = (h @ p["wq"]).reshape(B, T, nh, hd).transpose(1, 2)
        k = (h @ p["wk"]).reshape(B, T, nkv, hd).transpose(1, 2)
        v = (h @ p["wv"]).reshape(B, T, nkv, hd).transpose(1, 2)
        cos, sin = _llama.rope_rows(pos_t, T, hd, config.rope_theta, x.device)
        q, k = _llama.apply_rope(q, cos, sin), _llama.apply_rope(k, cos, sin)
        att = _decode.cached_attention(
            q, _with_step_rows(p["cache_k"], k, pos_t),
            _with_step_rows(p["cache_v"], v, pos_t), pos_t, scale)
        att = att.transpose(1, 2).reshape(B, T, nh * hd)
        x = x + att @ p["wo"]
        h2 = _llama.rms_norm(x, p["ffn_norm_g"], eps)
        if is_moe:
            ffn = _mixtral._moe(p, h2, config)
        else:
            ffn = _llama.ffn_down(
                _llama.ffn_glu(_llama.ffn_gate(h2, p["w_gate"]),
                               _llama.ffn_up(h2, p["w_up"])),
                p["w_down"],
            )
        return {"x": x + ffn, "k_new": k, "v_new": v, "pos": pos_t}

    def f_head(p, prev):
        x = _llama.rms_norm(prev["x"], p["final_norm_g"], eps)
        return _llama.lm_head(x, p["lm_head"])

    add("embed", f_embed, [], {"tok_emb": "tok_emb"}, 2.0 * B * T * D, "embed")
    prev = "embed"
    for i in range(n_layers):
        pre = f"l{i}_"
        alias = {
            "attn_norm_g": pre + "attn_norm_g",
            "wq": pre + "wq", "wk": pre + "wk", "wv": pre + "wv",
            "wo": pre + "wo",
            "ffn_norm_g": pre + "ffn_norm_g",
            "cache_k": f"cache_k_{i}", "cache_v": f"cache_v_{i}",
        }
        if is_moe:
            alias["router"] = pre + "router"
            for e in range(config.n_experts):
                for s in ("w_gate", "w_up", "w_down"):
                    alias[f"e{e}_{s}"] = f"{pre}e{e}_{s}"
        else:
            for s in ("w_gate", "w_up", "w_down"):
                alias[s] = pre + s
        F = config.ffn_hidden
        if is_moe:
            # router + DENSE per-step expert sweep (every expert runs
            # every token: the disclosed dense-dispatch cost)
            ffn_flops = (
                2.0 * B * T * D * config.n_experts
                + config.n_experts * 3 * 2.0 * B * T * D * F
            )
        else:
            ffn_flops = 3 * 2.0 * B * T * D * F  # gate, up, down matmuls
        flops = (
            2.0 * B * T * D * (nh + 2 * nkv) * hd
            + 2.0 * 2.0 * B * nh * T * M * hd  # full masked cache, O(M)
            + 2.0 * B * T * nh * hd * D
            + ffn_flops
        )
        tid = f"layer_{i}"
        add(tid, f_layer, [prev], alias, flops, f"layer_{i}")
        prev = tid
    add("logits", f_head, [prev], {
        "final_norm_g": "final_norm_g", "lm_head": "lm_head",
    }, 2.0 * B * T * D * config.vocab_size, "head")

    def reference_forward(params, inputs):
        model_params = {k: v for k, v in params.items()
                        if not k.startswith("cache_")}
        logits, _ = mod.forward_cached(
            model_params, inputs["ids"], _stacked_cache(params, n_layers),
            inputs["pos"], config)
        return logits

    graph = TaskGraph(
        tasks, name=_dense_name(family, config, n_layers, D, B, T, M)
    ).freeze()
    dag = DecodeDAG(
        graph=graph, config=config, input_spec=input_spec, param_specs=specs,
        reference_forward=reference_forward, model=mod,
        derive_params=_cache_slab_params(n_layers, (B, nkv, M, hd),
                                         config.dtype),
    )
    dag.default_pos = pos
    return dag


def build_decode_dag_any(config: Any, **kw) -> DecodeDAG:
    """Family-dispatching decode-step DAG builder: GPT-2 configs go to
    :func:`build_decode_dag`, Llama/Mixtral to
    :func:`build_backbone_decode_dag`."""
    if family_of(config) == "gpt2":
        return build_decode_dag(config, **kw)
    return build_backbone_decode_dag(config, **kw)


def apply_cache_updates(
    params: Dict[str, Any],
    task_outputs: Dict[str, Any],
    config: Any,
    pos: Any,
) -> Dict[str, Any]:
    """Fold a run's per-layer ``k_new``/``v_new`` outputs into the cache
    slabs, IN PLACE, at ``pos`` (an int or a 0-d tensor): the step advance
    for the next step's graph.

    The slabs stay the same tensors, at the same addresses, so a captured
    segment or compiled run that reads them where they were placed sees
    the new rows (returning new tensors would leave it reading the old
    ones).  The rows are copied out of ``task_outputs`` now, on the
    current stream, before the next run can overwrite a graph-owned
    output.  ``task_outputs``: ``DeviceReport.task_outputs`` from
    ``execute(keep_outputs=True)``.  Works for every family
    (:func:`cache_dims`); returns ``params``."""
    n_layers, _, _ = cache_dims(config)
    for i in range(n_layers):
        o = task_outputs.get(f"layer_{i}")
        if o is None:
            raise KeyError(f"layer_{i} output missing from task_outputs")
        for kind in ("k", "v"):
            _decode.write_rows(params[f"cache_{kind}_{i}"], o[f"{kind}_new"],
                               pos)
    return params


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


__all__ = [
    "DecodeDAG",
    "PagedDecodeDAG",
    "apply_cache_updates",
    "build_backbone_decode_dag",
    "build_decode_dag",
    "build_decode_dag_any",
    "build_paged_decode_dag",
    "cache_dims",
    "decode_inputs",
]
