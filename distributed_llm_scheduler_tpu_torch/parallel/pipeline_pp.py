"""Pipeline parallelism: GPipe over a ``pp`` mesh axis, one stage a rank.

PyTorch port of ``distributed_llm_scheduler_tpu.parallel.pipeline_pp``.
The JAX package runs the whole pipeline as one ``lax.scan`` of ``M + S -
1`` steps inside ``shard_map``: at step ``t`` stage ``s`` runs microbatch
``t - s``, every device ppermutes its previous output to its successor,
stage 0 selects the next embedded microbatch, and the fill and drain
steps compute on zeros (``pipeline_pp.py:12-19`` there).  Here each rank
of a ``(pp,)`` :class:`.mesh.Mesh` holds its stage's ``L / S`` layers
(and the embedding and head params) and runs the same ``M + S - 1``
steps:

* every step but the first, every rank calls
  :func:`.collectives.successor_hop` on its previous output, so every
  rank issues the same hops in the same order, forward and (by autograd,
  in reverse) backward;
* a step whose microbatch index is live runs the stage's layers (stage
  0 on the next embedded microbatch, the others on what they received);
  a fill or drain step runs nothing and passes on what it received, so
  each stage runs its layers ``M`` times per forward, not ``M + S - 1``;
* stage 0 takes its input through ``torch.where`` beside the (zero)
  received tensor, and every rank's outputs of the last ``M`` steps go
  into :func:`.collectives.share_from_last`: every rank's autograd graph
  then holds every hop, so no rank skips a backward hop its neighbour
  waits on;
* the head runs on the last stage's ``(M, mb, T, D)`` activations, shared
  over ``pp`` (never the logits), on every rank; on the other ranks it
  reads the shared params detached, so the head's gradient is counted
  once (the last stage's) and the embedding's once (stage 0's) when the
  training step sums the shared params' gradients over ``pp``.

``remat`` checkpoints each layer block, never a hop.  Params stay in the
families' flat per-layer layout, so checkpoints do too.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..models import gpt2, llama, mixtral
from ..models.family import family_of, module_for
from .collectives import share_from_last, successor_hop


def _family_bits(config: Any):
    """(module, n_layers, d_model, shared_keys, embed_fn, head_fn) per
    family: the only family-specific pieces."""
    family = family_of(config)  # raises ValueError for unknown configs
    if family == "gpt2":
        return (
            gpt2, config.n_layer, config.n_embd,
            ("wte", "wpe", "ln_f_g", "ln_f_b"),
            lambda sp, ids: gpt2.embedding(ids, sp["wte"], sp["wpe"]),
            lambda p, x: gpt2._head(x, p, config),
        )
    return (
        module_for(family), config.n_layers, config.d_model,
        ("tok_emb", "final_norm_g", "lm_head"),
        lambda sp, ids: llama.embedding(ids, sp["tok_emb"]),
        lambda p, x: llama.lm_head(
            llama.rms_norm(x, p["final_norm_g"], config.rms_eps), p["lm_head"]),
    )


def _layer_names(config: Any) -> Tuple[str, Tuple[str, ...]]:
    """(layer prefix, unprefixed per-layer keys) of the family."""
    family = family_of(config)
    if family == "gpt2":
        return "h", gpt2._BLOCK_KEYS
    if family == "llama":
        return "l", llama._BLOCK_KEYS
    return "l", mixtral._layer_keys(config)


def stage_layers(config: Any, n_stages: int, stage: int) -> range:
    """The layers stage ``stage`` of ``n_stages`` runs."""
    _, L, *_ = _family_bits(config)
    per = L // n_stages
    return range(stage * per, (stage + 1) * per)


def stage_param_names(config: Any, n_stages: int, stage: int) -> List[str]:
    """The flat param names a stage rank holds: its layers' and the
    embedding and head params, in the family's order."""
    _, _, _, shared_keys, *_ = _family_bits(config)
    prefix, keys = _layer_names(config)
    mine = {f"{prefix}{i}_{k}" for i in stage_layers(config, n_stages, stage)
            for k in keys} | set(shared_keys)
    return [k for k in module_for(family_of(config)).param_shapes(config)
            if k in mine]


def _stack_stage_params(mod: Any, params: Dict[str, torch.Tensor], config: Any,
                        n_stages: int, n_layers: int) -> Dict[str, torch.Tensor]:
    """Per-layer tensors -> ``(S, L/S, ...)`` stage stacks: the family's
    scanned layout (``stack_layer_params``) with its layer axis folded
    into (stage, layer-in-stage); block ``s`` is stage ``s``'s layers."""
    stacked = mod.stack_layer_params(params, config)
    per = n_layers // n_stages
    return {
        k[len("layers_"):]: v.reshape(n_stages, per, *v.shape[1:])
        for k, v in stacked.items()
        if k.startswith("layers_")
    }


def _check(config: Any, mesh, batch: int, microbatches: int):
    _, L, *_ = _family_bits(config)
    S = mesh.axis_size("pp")
    if L % S != 0:
        raise ValueError(f"n_layers {L} not divisible by pp={S}")
    if batch % microbatches != 0:
        raise ValueError(f"batch {batch} not divisible by microbatches {microbatches}")


def pipeline_forward(params: Dict[str, torch.Tensor], input_ids, config: Any,
                     mesh, microbatches: int, remat: bool = False):
    """Any family's forward as a pp-sharded pipeline; (B, T) -> (B, T, V)
    on every rank, gradients flowing.  ``params`` holds at least this
    rank's stage layers and the shared params (the whole params do);
    ``input_ids`` is the whole batch on every rank.  Requires ``n_layers %
    pp == 0`` and ``B % microbatches == 0``; equal to the family's plain
    forward (the same block math in the same order per microbatch).
    ``remat=True`` checkpoints each layer block."""
    mod, L, D, shared_keys, embed_fn, head_fn = _family_bits(config)
    S, s = mesh.axis_size("pp"), mesh.axis_index("pp")
    B, T = input_ids.shape
    M = microbatches
    _check(config, mesh, B, M)
    mb = B // M
    prefix, keys = _layer_names(config)
    layers = [{k: params[f"{prefix}{i}_{k}"] for k in keys}
              for i in stage_layers(config, S, s)]
    block = gpt2._select_block(remat, mod.transformer_block)
    shared = {k: params[k] for k in shared_keys}
    ids_mb = input_ids.reshape(M, mb, T)
    group = mesh.group("pp")
    first = torch.tensor(s == 0, device=input_ids.device)
    anchor = shared[shared_keys[0]]  # held by every stage

    y: Optional[torch.Tensor] = None
    outs = []
    for t in range(M + S - 1):
        recv = successor_hop(y, group, anchor) if t > 0 and S > 1 else None
        if 0 <= t - s < M:  # a live step: this stage's microbatch t - s
            if s == 0:
                x = embed_fn(shared, ids_mb[t])
                x = x if recv is None else torch.where(first, x, recv)
            else:
                x = recv
            for bp in layers:
                x = block(bp, x, config)
            y = x
        else:  # fill or drain: nothing to run, what came in goes on
            y = recv if recv is not None else torch.zeros(
                (mb, T, D), dtype=config.dtype, device=input_ids.device)
        if t >= S - 1:
            outs.append(y)
    acts = share_from_last(torch.stack(outs), group)  # (M, mb, T, D)
    head = shared if s == S - 1 else {k: v.detach() for k, v in shared.items()}
    return head_fn(head, acts.reshape(B, T, D))


def pp_loss_fn(params: Dict[str, torch.Tensor], input_ids, targets,
               config: Any, mesh, microbatches: int, remat: bool = False):
    """Next-token cross-entropy through :func:`pipeline_forward` (the
    shared ``models.mixtral.nll_loss``): its gradient is pipeline-parallel
    backprop, every stage's layers' own, the shared params' parts summed
    over ``pp`` by :func:`make_pp_train_step`."""
    logits = pipeline_forward(params, input_ids, config, mesh, microbatches,
                              remat=remat)
    return mixtral.nll_loss(logits, targets)


def make_pp_train_step(config: Any, mesh, microbatches: int,
                       optimizer: Any = None, remat: bool = False):
    """``(train_step, init_state)`` for pipeline-parallel training, the
    contract of :func:`.train.make_train_step`: the global batch (replicated
    on every stage) in, the state updated in place; ``init_state(seed=0,
    params=None)`` keeps this stage's layers and the shared params of the
    whole params (by default the family's ``init_params_numpy(config,
    seed)``).  The shared params' gradients are summed over ``pp``; params
    stay flat, so checkpoints are in the shared flat layout."""
    from .launch import device
    from .sharding import FlatLayout, Sharding
    from .train import make_step_from_loss

    mod, _, _, shared_keys, *_ = _family_bits(config)
    S, s = mesh.axis_size("pp"), mesh.axis_index("pp")
    mine = stage_param_names(config, S, s)
    dev = device()

    def loss(params, input_ids, targets):
        return pp_loss_fn(params, input_ids, targets, config, mesh,
                          microbatches, remat=remat)

    def init_params(seed: int, params):
        whole = params if params is not None else mod.init_params_numpy(config, seed)
        return gpt2.params_from_numpy(
            {k: whole[k].detach().cpu().float().numpy() if torch.is_tensor(whole[k])
             else whole[k] for k in mine}, dev, config.dtype)

    shapes = {k: s_ for k, (s_, _) in mod.param_shapes(config).items()}
    return make_step_from_loss(
        loss, init_params, optimizer,
        sum_group=mesh.group("pp"), sum_params=shared_keys,
        layout=FlatLayout(shapes, {k: Sharding(mesh, ()) for k in mine},
                          group=mesh.group("pp"), staged=True),
    )


def collective_probe(devices=None):
    """``(fn, args)`` for the collective sweep (``analysis.parallel_sweep``,
    ``lint --parallel``): the GPipe forward of tiny GPT-2 (weights from
    numpy seed 0) over ``S`` = 2 stages from two devices (1 on one), 2
    microbatches of the (4, 8) batch; ``fn(*args)`` runs on every rank of
    a world of ``len(devices)`` ranks (None beyond the mesh). The
    successor hops (``i -> i + 1`` for ``i < S - 1``) and the last stage's
    broadcast are its collectives."""
    import numpy as np

    from .launch import device, world_devices
    from .mesh import make_axes_mesh

    n = len(devices if devices is not None else world_devices())
    S = 2 if n >= 2 else 1
    config = gpt2.GPT2Config.tiny()
    ids = np.random.default_rng(0).integers(0, config.vocab_size, size=(4, 8),
                                            dtype=np.int32)

    def fn(ids):
        mesh = make_axes_mesh(pp=S)
        if not mesh.contains:
            return None
        params = gpt2.params_from_numpy(gpt2.init_params_numpy(config, 0),
                                        device(), config.dtype)
        return pipeline_forward(params, torch.from_numpy(ids).to(device()),
                                config, mesh, microbatches=2)

    return fn, (ids,)


__all__ = ["collective_probe", "make_pp_train_step", "pipeline_forward", "pp_loss_fn",
           "stage_layers", "stage_param_names"]
