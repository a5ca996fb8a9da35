"""Tensor-parallel autoregressive decoding over a device mesh.

PyTorch port of ``distributed_llm_scheduler_tpu.parallel.decode``.  A
model whose weights exceed one device's memory must be sharded to run at
all.  The JAX package jits the unchanged family ``generate`` against
sharded params and lets GSPMD partition every matmul and insert the
per-layer all-reduces, the KV cache inheriting the head sharding through
propagation (``decode.py:13-19``).  Here every rank of the ``tp`` axis
holds its blocks of the params (:func:`shard_decode_params`, the family's
Megatron rules) and runs the family's unchanged generation loop
(``models.decode.generate``: the prefill, the cache, the int8 cache,
greedy and temperature sampling) over the tensor-parallel
``forward_cached`` of :mod:`.blocks`, whose two sums per layer and
gathered logits are the collectives GSPMD would insert.  The cache holds
this rank's KV heads only.  The batch is split over ``dp`` when it
divides evenly (replicated otherwise), and the tokens are gathered back.

With ``tp`` of 1 the family's own ``generate`` runs on the whole params
(on a card its decode step is one captured CUDA graph).  With ``tp`` > 1
the steps run eagerly: a step's all-reduces are NCCL calls, which are not
captured into the step's graph yet (ROADMAP.md A.11).
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import torch

from ..models.family import family_of, module_for
from .blocks import FORWARD_CACHED, init_cache, kv_heads
from .collectives import all_gather_dim
from .sharding import shard_params


def shard_decode_params(mesh, params: Dict[str, Any], config: Any
                        ) -> Dict[str, torch.Tensor]:
    """This rank's blocks of a family's params under its Megatron rules.

    Validates the head-divisibility precondition up front, with the JAX
    package's messages."""
    family = family_of(config)
    tp = mesh.axis_size("tp")
    if tp > 1:
        if family != "gpt2" and config.vocab_size % tp != 0:
            raise ValueError(
                f"tp={tp} must divide vocab_size={config.vocab_size} "
                "for the column split of lm_head (pick a smaller tp)"
            )
        if kv_heads(config) % tp != 0:
            raise ValueError(
                f"tp={tp} must divide the (kv-)head count {kv_heads(config)} "
                "for the attention column split (pick a smaller tp)"
            )
    return shard_params(mesh, params, family)


def generate_sharded(
    params: Dict[str, Any],
    prompt_ids: torch.Tensor,
    config: Any,
    mesh,
    max_new_tokens: int,
    **kw,
) -> torch.Tensor:
    """Mesh-parallel generation from the whole ``params`` (the same on
    every rank): shard them, split the prompt batch over ``dp`` when it
    divides evenly, generate, and gather the tokens over ``dp``.  Returns
    (B, T + max_new_tokens) int32 on every rank of the mesh.  ``kw`` goes
    to the family's ``generate`` (``kv_int8``, ``temperature``, ...).  A
    collective: every rank of the mesh calls it."""
    return generate_on_shards(shard_decode_params(mesh, params, config),
                              prompt_ids, config, mesh, max_new_tokens, **kw)


def generate_on_shards(
    local: Dict[str, torch.Tensor],
    prompt_ids: torch.Tensor,
    config: Any,
    mesh,
    max_new_tokens: int,
    **kw,
) -> torch.Tensor:
    """:func:`generate_sharded` from this rank's blocks ``local``
    (:func:`shard_decode_params`'s), sharded once for many generations."""
    family = family_of(config)
    dp = mesh.axis_size("dp")
    B = prompt_ids.shape[0]
    split = dp > 1 and B % dp == 0
    ids = prompt_ids.chunk(dp, 0)[mesh.coords["dp"]] if split else prompt_ids
    if mesh.axis_size("tp") == 1:
        out = module_for(family).generate(local, ids, config, max_new_tokens,
                                          **kw)
    else:
        from ..models import decode

        kw.setdefault("capture", False)
        out = decode.generate(
            functools.partial(FORWARD_CACHED[family], mesh=mesh),
            functools.partial(init_cache, mesh=mesh),
            local, ids, config, max_new_tokens, **kw)
    return all_gather_dim(out, mesh.group("dp"), 0) if split else out


__all__ = ["generate_on_shards", "generate_sharded", "shard_decode_params"]
