"""Vocab-sharding pieces for the GPT-2 DAG builder.

PyTorch port of ``distributed_llm_scheduler_tpu.frontend.vocab_sharding``.
Task-graph tensor parallelism for the tied vocab table: balanced row
shards, partial-lookup tasks whose sum equals the full lookup exactly, and
logit-slice concatenation.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from ..core.graph import mark_batch0, mark_rootslice


def shard_bounds(vocab_size: int, shards: int, align: int = 128) -> List[int]:
    """Near-balanced split boundaries: ``shards + 1`` cumulative offsets,
    every shard non-empty for any ``1 <= shards <= vocab_size``.

    Interior boundaries snap to multiples of ``align`` when the vocab is
    large enough, so every logit-shard product but the last starts on an
    aligned column; the same boundaries as the JAX package, so task shapes
    and byte sizes agree.  Any split is semantically exact (each id hits
    exactly one shard); tiny vocabs where alignment would empty a shard
    fall back to the balanced split."""
    if not 1 <= shards <= vocab_size:
        raise ValueError(
            f"vocab_shards {shards} out of range [1, {vocab_size}]"
        )
    base, extra = divmod(vocab_size, shards)
    lo = [0]
    for k in range(shards):
        lo.append(lo[-1] + base + (1 if k < extra else 0))
    if align > 1 and vocab_size >= shards * align:
        aligned = [0]
        for k in range(1, shards):
            b = round(lo[k] / align) * align
            # monotone and room for the remaining shards
            b = max(b, aligned[-1] + align)
            b = min(b, vocab_size - (shards - k) * align)
            aligned.append(b)
        aligned.append(vocab_size)
        lo = aligned
    return lo


def make_embed_partial_fn(
    lo_b: int, hi_b: int, lo_v: int, rows: int
) -> Callable:
    """Partial lookup over one row shard (``p["shard"]``): token ids outside
    ``[lo_v, lo_v + rows)`` contribute 0, so the shard-sum equals the full
    lookup exactly (each id hits exactly one shard).  ``[lo_b, hi_b)`` slices
    the microbatch from the full input batch."""

    def f_embed_partial(p, input_ids):
        local = input_ids[lo_b:hi_b] - lo_v
        mask = (local >= 0) & (local < rows)
        emb = p["shard"][torch.clamp(local, 0, rows - 1)]
        return emb * mask.unsqueeze(-1).to(emb.dtype)

    return mark_rootslice(
        f_embed_partial, ("embed_partial", lo_v, rows), lo_b, hi_b,
        lambda a, b: make_embed_partial_fn(a, b, lo_v, rows),
    )


@mark_batch0  # last-axis concat: batch-axis-0 polymorphic
def logit_concat_fn(p, *slices):
    """Concatenate per-shard logit slices along the vocab axis."""
    return torch.cat(slices, dim=-1)
