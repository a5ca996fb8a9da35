"""Ulysses-style sequence parallelism: all-to-all head redistribution.

PyTorch port of ``distributed_llm_scheduler_tpu.parallel.ulysses``, the
second of the two long-context strategies (ring attention,
:mod:`.ring_attention`, is the other).  Where ring attention keeps
queries home and rotates K/V around the ring in ``sp`` steps, Ulysses
redistributes once:

1. inputs arrive sequence-sharded: each of the ``sp`` ranks holds
   (B, H, T/sp, hd) for all heads;
2. an ``all_to_all_single`` over ``sp`` re-shards from sequence to heads
   (:func:`.collectives.seq_to_heads`): each rank now holds (B, H/sp, T,
   hd), its head group over the full sequence, so plain attention runs
   locally with exact causality: the port's :func:`..ops.attention.mha`,
   the CUDA flash kernel on a card;
3. a second all-to-all restores sequence sharding.

The head count must be divisible by ``sp``; ring attention has no such
constraint.
"""

from __future__ import annotations

from ..ops.attention import mha as _fused_mha
from .collectives import all_gather_dim, group_size, heads_to_seq, seq_to_heads
from .ring_attention import shard_sequence


def ulysses_attention(q, k, v, mesh, axis_name: str = "sp",
                      causal: bool = True):
    """Attention under Ulysses sequence parallelism over the
    ``axis_name`` axis of ``mesh``: q/k/v this rank's sequence chunk
    (B, H, T_local, hd), H divisible by the axis size.  Returns the local
    chunk (B, H, T_local, hd).  A collective over the axis."""
    group = mesh.group(axis_name)
    sp = group_size(group)
    H = q.shape[1]
    if H % sp != 0:
        raise ValueError(
            f"ulysses needs heads ({H}) divisible by the {axis_name!r} "
            f"axis size ({sp}); use ring attention otherwise"
        )
    q, k, v = (seq_to_heads(t, group) for t in (q, k, v))
    # full sequence, local head group: exact attention, no online softmax
    out = _fused_mha(q, k, v, causal=causal)
    return heads_to_seq(out, group)


def ulysses_attention_sharded(q, k, v, mesh, axis_name: str = "sp",
                              causal: bool = True):
    """Convenience wrapper: global (B, H, T, hd) tensors (the same on
    every rank of the axis) sharded on their sequence dim, Ulysses
    attention, and the global output gathered back on every rank."""
    out = ulysses_attention(
        *(shard_sequence(t, mesh, axis_name) for t in (q, k, v)), mesh,
        axis_name, causal)
    return all_gather_dim(out, mesh.group(axis_name), 2)


__all__ = ["ulysses_attention", "ulysses_attention_sharded"]
