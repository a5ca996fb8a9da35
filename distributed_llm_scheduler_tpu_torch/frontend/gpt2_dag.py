"""GPT-2 forward-pass DAG builder.

PyTorch port of ``distributed_llm_scheduler_tpu.frontend.gpt2_dag``: the
same 8-tasks-per-layer structure (ln1, attention, attn_residual, ln2,
ffn_expand, ffn_activation, ffn_contract, layer_output) plus embedding,
final_ln and a weight-tied output_projection, with the same task ids,
dependencies, parameter sets and byte sizes, FLOP counts, groups and graph
name.  Every task carries

* a tensor fn ``fn(params: Dict[str, Tensor], *dep_outputs)`` the device
  backend dispatches;
* real param byte sizes from the model's shapes;
* real activation byte sizes for its output, inferred by running the fn
  on ``device="meta"`` tensors (shapes and dtypes only, no data);
* an analytic FLOP count, turned into a seed ``compute_time`` estimate
  that the measured cost model (``utils/costmodel``) later replaces.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.graph import (
    Task,
    TaskGraph,
    mark_batch0,
    mark_concat0,
    mark_rootslice,
)
from ..models import gpt2
from ..models.gpt2 import GPT2Config
from .vocab_sharding import logit_concat_fn, make_embed_partial_fn, shard_bounds

# Seed estimate for compute_time: effective sustained FLOP/s of one device
# on these op sizes.  Deliberately rough (and equal to the JAX package's,
# so seed schedules agree) — the calibrated cost model overwrites it.
DEFAULT_EFFECTIVE_FLOPS = 2.0e12


@dataclasses.dataclass
class ModelDAG:
    """A task graph plus everything needed to actually run it."""

    graph: TaskGraph
    config: Any
    # meta tensor(s) with the graph input's shape and dtype
    input_spec: Any
    # param name -> meta tensor; materialize with init_params()
    param_specs: Dict[str, torch.Tensor]
    # the fused single-program oracle: forward(params, input_ids)
    reference_forward: Callable[..., Any]
    # the model family's module (init_params_numpy, params_from_numpy)
    model: Any
    # the model's params -> the same plus the params the graph derives
    # from them (vocab shards) or holds beside them (KV pools), on the
    # model params' device
    derive_params: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]

    def init_params(
        self, seed: int = 0, device: Any = "cuda"
    ) -> Dict[str, torch.Tensor]:
        """Weights from a numpy seed (the same seed gives the same numbers
        on every device), in the config's dtype, with the graph's derived
        params."""
        np_params = self.model.init_params_numpy(self.config, seed)
        return self.derive_params(
            self.model.params_from_numpy(np_params, device, self.config.dtype)
        )

    def make_inputs(self, seed: int = 1, device: Any = "cuda") -> torch.Tensor:
        """Token ids in ``[0, vocab)`` from a numpy seed, as int32."""
        rng = np.random.default_rng(seed)
        ids = rng.integers(
            0, self.config.vocab_size, size=tuple(self.input_spec.shape),
            dtype=np.int32,
        )
        return torch.from_numpy(ids).to(device)


def _bytes_of(t: Any) -> int:
    """Total bytes of a tensor or of any dict/list/tuple nest of them."""
    if isinstance(t, dict):
        return sum(_bytes_of(v) for v in t.values())
    if isinstance(t, (list, tuple)):
        return sum(_bytes_of(v) for v in t)
    return t.numel() * t.element_size()


_GB = 1024**3


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def graph_name_tags(microbatches: int, vocab_shards: int, dtype: torch.dtype) -> str:
    """Cache-key-critical name suffix, identical to the JAX package's
    (the 'a' marks lane-aligned vocab shard boundaries)."""
    return (
        (f"_mb{microbatches}" if microbatches > 1 else "")
        + (f"_vs{vocab_shards}a" if vocab_shards > 1 else "")
        + ("" if dtype == torch.float32 else f"_{_dtype_name(dtype)}")
    )


def make_task_adder(
    tasks: List[Task],
    out_specs: Dict[str, torch.Tensor],
    specs: Dict[str, torch.Tensor],
    input_spec: torch.Tensor,
    effective_flops: float,
) -> Callable[..., None]:
    """The task-construction closure: ``add(tid, fn, deps, alias, flops,
    group)`` runs ``fn`` on meta tensors chained through ``out_specs`` to
    infer its output, computes real activation/param byte sizes, and
    appends a fully-wired :class:`Task`.  ``alias`` maps fn-local param
    names -> global param names; structurally identical tasks share ONE fn
    object."""

    def add(
        tid: str,
        fn: Callable[..., Any],
        deps: List[str],
        alias: Dict[str, str],
        flops: float,
        group: str,
    ) -> None:
        dep_specs = [out_specs[d] for d in deps] if deps else [input_spec]
        pspec = {loc: specs[glob] for loc, glob in alias.items()}
        with torch.no_grad():
            out = fn(pspec, *dep_specs)
        out_specs[tid] = out
        globals_ = list(alias.values())
        tasks.append(
            Task(
                tid,
                memory_required=_bytes_of(out) / _GB,
                compute_time=max(flops / effective_flops, 1e-7),
                dependencies=list(deps),
                params_needed=set(globals_),
                param_bytes={g: _bytes_of(specs[g]) for g in globals_},
                fn=fn,
                arg_tasks=list(deps),
                param_alias=dict(alias),
                out_shape=out,
                flops=flops,
                group=group,
            )
        )

    return add


def build_gpt2_dag(
    config: Optional[GPT2Config] = None,
    batch: int = 1,
    seq_len: int = 512,
    microbatches: int = 1,
    vocab_shards: int = 1,
    effective_flops: float = DEFAULT_EFFECTIVE_FLOPS,
) -> ModelDAG:
    """Build the per-op forward DAG for a GPT-2 config.

    ``microbatches > 1`` splits the batch into independent per-microbatch
    task chains sharing the layer weights, joined by a final concat — the
    DAG shape of pipeline parallelism.  ``vocab_shards > 1`` splits the
    tied table into vocab-range row shards (``wte_shard_k``) and shards
    both of its uses: per-shard embedding partials summed by a combine
    task, and per-shard logit slices concatenated along the vocab axis.
    """
    config = config or GPT2Config.small()
    if seq_len > config.n_positions:
        raise ValueError(
            f"seq_len {seq_len} exceeds n_positions {config.n_positions}"
        )
    if batch % microbatches != 0:
        raise ValueError(f"batch {batch} not divisible by microbatches {microbatches}")
    B, T, D, H, V = batch, seq_len, config.n_embd, config.n_head, config.vocab_size
    Bm = B // microbatches
    S = vocab_shards
    eps = config.ln_eps

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    specs = {
        name: meta(shape, dtype)
        for name, (shape, dtype) in gpt2.param_shapes(config).items()
    }
    shard_lo = shard_bounds(V, S)
    if S > 1:
        for k in range(S):
            specs[f"wte_shard_{k}"] = meta(
                (shard_lo[k + 1] - shard_lo[k], D), specs["wte"].dtype
            )
    input_spec = meta((B, T), torch.int32)

    tasks: List[Task] = []
    # running map of task_id -> output spec, for shape chaining
    out_specs: Dict[str, torch.Tensor] = {}
    add = make_task_adder(tasks, out_specs, specs, input_spec, effective_flops)

    # ---- task fns: fn(params_dict, *dep_outputs), local param names ------
    def make_f_embedding(lo, hi):
        def f_embedding(p, input_ids):
            return gpt2.embedding(input_ids[lo:hi], p["wte"], p["wpe"])

        return mark_rootslice(
            f_embedding, "gpt2_embedding", lo, hi, make_f_embedding
        )

    @mark_batch0
    def f_embed_combine(p, *partials):
        T_ = partials[0].shape[-2]
        out = partials[0]
        for part in partials[1:]:
            out = out + part
        return out + p["wpe"][:T_]

    @mark_concat0
    def f_concat(p, *chunks):
        return torch.cat(chunks, dim=0)

    @mark_batch0
    def f_ln(p, x):
        return gpt2.layer_norm(x, p["g"], p["b"], eps)

    @mark_batch0
    def f_attn(p, x):
        return gpt2.causal_attention(
            x, p["qkv_w"], p["qkv_b"], p["proj_w"], p["proj_b"], config.n_head
        )

    @mark_batch0
    def f_residual(p, a, b):
        return gpt2.residual_add(a, b)

    @mark_batch0
    def f_ffn_expand(p, x):
        return gpt2.ffn_expand(x, p["fc_w"], p["fc_b"])

    @mark_batch0
    def f_ffn_act(p, x):
        return gpt2.ffn_activation(x)

    @mark_batch0
    def f_ffn_contract(p, x):
        return gpt2.ffn_contract(x, p["proj_w"], p["proj_b"])

    @mark_batch0
    def f_output_projection(p, x):
        return gpt2.output_projection(x, p["wte"])

    @mark_batch0
    def f_logit_shard(p, x):
        """Logit slice via the tied table's row shard: x @ shard.T — runs
        wherever the embedding parked that shard, so the tied table is
        never loaded twice (nor anywhere in full)."""
        return x @ p["shard"].T

    # ---- graph assembly (8 tasks/layer + 3 per microbatch chain,
    # reference test_gpt2.py:54-166; mb prefix only when pipelining) -------
    hd = D // H
    mb_outputs: List[str] = []
    for m in range(microbatches):
        mb = f"mb{m}_" if microbatches > 1 else ""
        emb = f"{mb}embedding"
        if S > 1:
            part_ids = []
            for k in range(S):
                rows = specs[f"wte_shard_{k}"].shape[0]
                pid = f"{mb}embedding_shard_{k}"
                add(pid,
                    make_embed_partial_fn(m * Bm, (m + 1) * Bm, shard_lo[k], rows),
                    [], {"shard": f"wte_shard_{k}"},
                    3.0 * Bm * T * D, f"vocab_shard_{k}")
                part_ids.append(pid)
            add(emb, f_embed_combine, part_ids, {"wpe": "wpe"},
                (S + 1.0) * Bm * T * D, "embed")
        else:
            add(emb, make_f_embedding(m * Bm, (m + 1) * Bm), [],
                {"wte": "wte", "wpe": "wpe"}, 2.0 * Bm * T * D, "embed")

        prev = emb  # residual-stream carrier entering each layer
        for i in range(config.n_layer):
            pre, grp = f"h{i}_", f"layer_{i}"
            ln1 = f"{mb}layer_{i}_ln1"
            add(ln1, f_ln, [prev],
                {"g": pre + "ln1_g", "b": pre + "ln1_b"}, 5.0 * Bm * T * D, grp)

            attn = f"{mb}layer_{i}_attention"
            attn_flops = (
                2.0 * Bm * T * D * 3 * D          # qkv projection
                + 2.0 * 2.0 * Bm * H * T * T * hd  # scores + probs@v
                + 2.0 * Bm * T * D * D             # output projection
            )
            add(attn, f_attn, [ln1],
                {"qkv_w": pre + "attn_qkv_w", "qkv_b": pre + "attn_qkv_b",
                 "proj_w": pre + "attn_proj_w", "proj_b": pre + "attn_proj_b"},
                attn_flops, grp)

            attn_res = f"{mb}layer_{i}_attn_residual"
            add(attn_res, f_residual, [prev, attn], {}, 1.0 * Bm * T * D, grp)

            ln2 = f"{mb}layer_{i}_ln2"
            add(ln2, f_ln, [attn_res],
                {"g": pre + "ln2_g", "b": pre + "ln2_b"}, 5.0 * Bm * T * D, grp)

            expand = f"{mb}layer_{i}_ffn_expand"
            add(expand, f_ffn_expand, [ln2],
                {"fc_w": pre + "mlp_fc_w", "fc_b": pre + "mlp_fc_b"},
                2.0 * Bm * T * D * 4 * D, grp)

            act = f"{mb}layer_{i}_ffn_activation"
            add(act, f_ffn_act, [expand], {}, 8.0 * Bm * T * 4 * D, grp)

            contract = f"{mb}layer_{i}_ffn_contract"
            add(contract, f_ffn_contract, [act],
                {"proj_w": pre + "mlp_proj_w", "proj_b": pre + "mlp_proj_b"},
                2.0 * Bm * T * 4 * D * D, grp)

            layer_out = f"{mb}layer_{i}_output"
            add(layer_out, f_residual, [attn_res, contract], {},
                1.0 * Bm * T * D, grp)
            prev = layer_out

        fln = f"{mb}final_ln"
        add(fln, f_ln, [prev], {"g": "ln_f_g", "b": "ln_f_b"},
            5.0 * Bm * T * D, "head")
        # weight tying: reuses the embedding table (test_gpt2.py:160-166);
        # sharded builds tie per-shard, so the full table exists nowhere
        proj = f"{mb}output_projection"
        if S > 1:
            slice_ids = []
            for k in range(S):
                rows = specs[f"wte_shard_{k}"].shape[0]
                sid = f"{mb}output_projection_shard_{k}"
                add(sid, f_logit_shard, [fln], {"shard": f"wte_shard_{k}"},
                    2.0 * Bm * T * D * rows, f"vocab_shard_{k}")
                slice_ids.append(sid)
            add(proj, logit_concat_fn, slice_ids, {}, 1.0 * Bm * T * V, "head")
        else:
            add(proj, f_output_projection, [fln], {"wte": "wte"},
                2.0 * Bm * T * D * V, "head")
        mb_outputs.append(proj)

    if microbatches > 1:
        add("output_concat", f_concat, mb_outputs, {}, 1.0 * B * T * V, "head")

    name = f"gpt2_{config.n_layer}l_d{D}_b{B}_t{T}" + graph_name_tags(
        microbatches, S, config.dtype
    )

    def derive_params(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = dict(params)
        for k in range(S if S > 1 else 0):
            out[f"wte_shard_{k}"] = params["wte"][shard_lo[k]:shard_lo[k + 1]]
        return out

    graph = TaskGraph(tasks, name=name).freeze()
    graph.recipe = (f"{__name__}:build_gpt2_dag", (), dict(
        config=config, batch=batch, seq_len=seq_len, microbatches=microbatches,
        vocab_shards=vocab_shards, effective_flops=effective_flops))
    return ModelDAG(
        graph=graph,
        config=config,
        input_spec=input_spec,
        param_specs=specs,
        reference_forward=partial(gpt2.forward, config=config),
        model=gpt2,
        derive_params=derive_params,
    )


def execute_dag_locally(dag: ModelDAG, params: Dict[str, Any], graph_input: Any
                        ) -> Any:
    """Run the DAG task by task in topological order on the tensors' own
    device, under ``torch.no_grad()`` as the backends run it (a training
    task enables grad inside itself).

    The single-device correctness oracle: must match
    ``dag.reference_forward`` up to float reassociation.  Backends replace
    this with placed, timed execution."""
    outputs: Dict[str, Any] = {}
    with torch.no_grad():
        for tid in dag.graph.topo_order:
            task = dag.graph[tid]
            pd = {loc: params[glob] for loc, glob in task.param_items()}
            args = (
                [outputs[d] for d in (task.arg_tasks or task.dependencies)]
                if task.dependencies
                else [graph_input]
            )
            outputs[tid] = task.fn(pd, *args)
    return outputs[dag.graph.topo_order[-1]]
