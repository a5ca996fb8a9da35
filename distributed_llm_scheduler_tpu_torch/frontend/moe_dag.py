"""Mixtral MoE forward DAG builder: expert nodes as tasks
(BASELINE.json config #4).

PyTorch port of ``distributed_llm_scheduler_tpu.frontend.moe_dag``.  Per
layer the tasks are {attn_norm, attention, attn_residual, ffn_norm,
router, expert_0..E-1, moe_combine, layer_output} — ``7 + E`` per layer —
plus embedding, final_norm and lm_head: ``(7 + n_experts) * n_layers + 3``
(483 for Mixtral-8x7B), with the JAX builder's ids, dependencies, params,
byte sizes, FLOPs, groups and graph name.  Each expert task owns that
expert's three FFN matrices, so placing experts under per-node memory
limits is the param-cache-locality problem the MRU policy targets.  The
backbone assembly lives in :mod:`.backbone`; only the router/experts/
combine section is defined here.

Two dispatch modes:

* ``routed=False`` (default): experts compute densely; expert-task FLOPs
  record the useful top_k/E fraction.
* ``routed=True``: the router task emits the routing metadata
  (:func:`..models.mixtral.route_topk`), each expert task selects its own
  ``(C, D)`` capacity buffer and runs SwiGLU on that, and the combine
  gathers outputs back.  Routed task fns are not batch-axis-0 polymorphic
  (capacity positions are global per microbatch), so they are never
  re-batched across microbatch siblings; the oracle is the routed
  whole-program forward applied per microbatch.

One fn object per expert index is shared across layers and microbatches
(``param_alias`` feeds each task its own expert's weights).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from ..core.graph import mark_batch0
from ..models import mixtral
from ..models.mixtral import MixtralConfig
from .backbone import build_decoder_dag
from .gpt2_dag import DEFAULT_EFFECTIVE_FLOPS, ModelDAG, graph_name_tags


def build_moe_dag(
    config: Optional[MixtralConfig] = None,
    batch: int = 1,
    seq_len: int = 512,
    microbatches: int = 1,
    vocab_shards: int = 1,
    effective_flops: float = DEFAULT_EFFECTIVE_FLOPS,
    routed: bool = False,
    capacity_factor: float = 2.0,
) -> ModelDAG:
    """Build the per-op forward DAG for a Mixtral config, one task per
    expert."""
    config = config or MixtralConfig.mixtral_8x7b()
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    D, F = config.d_model, config.ffn_hidden
    E, K = config.n_experts, config.top_k
    Bm = batch // microbatches
    T = seq_len

    @mark_batch0
    def f_router(p, x):
        return mixtral.router_weights(x, p["w"], config.top_k)

    @mark_batch0
    def f_expert(p, x):
        return mixtral.expert_ffn(x, p["w_gate"], p["w_up"], p["w_down"])

    @mark_batch0
    def f_combine(p, weights, *outs):
        return mixtral.moe_combine(weights, *outs)

    # routed mode: static capacity per microbatch, all dispatch math from
    # models.mixtral's shared primitives
    N = Bm * T
    C = mixtral.moe_capacity(N, E, K, capacity_factor)

    def f_router_routed(p, x):
        """Top-k routing metadata with static shapes."""
        return mixtral.route_topk(x.reshape(N, D), p["w"], K, C, x.dtype)

    def f_expert_routed(p, x, route, *, expert):
        """Select THIS expert's capacity buffer, then SwiGLU on (C, D)."""
        buf = mixtral.routed_expert_buffer(x.reshape(N, D), route, expert, C)
        return mixtral.expert_ffn(buf, p["w_gate"], p["w_up"], p["w_down"])

    def f_combine_routed(p, route, *bufs):
        out = mixtral.routed_collect(torch.stack(bufs), route, N)
        return out.reshape(Bm, T, D)

    routed_expert_fns = [partial(f_expert_routed, expert=e) for e in range(E)]

    def ffn_section(add, mb, i, fnorm, grp):
        """Router + E expert tasks fanning out from the FFN norm, joined
        by the gate-weighted combine."""
        pre = f"l{i}_"
        router = f"{mb}layer_{i}_router"
        add(router, f_router_routed if routed else f_router,
            [fnorm], {"w": pre + "router"}, 2.0 * Bm * T * D * E, grp)

        expert_ids = []
        # useful-work fraction: each token activates top_k of E experts
        expert_flops = (
            (6.0 * C * D * F) + N * K * D  # FFN on the buffer + dispatch
            if routed
            else (6.0 * Bm * T * D * F) * (K / E)
        )
        for e in range(E):
            ex = f"{mb}layer_{i}_expert_{e}"
            add(ex, routed_expert_fns[e] if routed else f_expert,
                [fnorm, router] if routed else [fnorm],
                {"w_gate": f"{pre}e{e}_w_gate", "w_up": f"{pre}e{e}_w_up",
                 "w_down": f"{pre}e{e}_w_down"},
                expert_flops, grp)
            expert_ids.append(ex)

        comb = f"{mb}layer_{i}_moe_combine"
        add(comb, f_combine_routed if routed else f_combine,
            [router] + expert_ids, {}, 2.0 * Bm * T * D * E, grp)
        return comb

    name = (
        f"mixtral_{config.n_layers}l_d{D}_e{E}_b{batch}_t{T}"
        + ("_routed" if routed else "")
        + graph_name_tags(microbatches, vocab_shards, config.dtype)
    )
    dag = build_decoder_dag(
        config, mixtral,
        batch=batch, seq_len=seq_len, microbatches=microbatches,
        effective_flops=effective_flops, ffn_section=ffn_section, name=name,
        vocab_shards=vocab_shards,
    )
    if routed:
        # the DAG routes each microbatch on its own (its own capacity and
        # arrival order), so the oracle applies the routed forward per
        # microbatch
        def routed_reference(p, ids):
            outs = [
                mixtral.forward(p, ids[m * Bm:(m + 1) * Bm], config,
                                routed=True, capacity_factor=capacity_factor)
                for m in range(microbatches)
            ]
            return outs[0] if len(outs) == 1 else torch.cat(outs, 0)

        dag.reference_forward = routed_reference
    return dag
