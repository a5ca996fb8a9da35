"""Ring attention: causal attention over sequence chunks on a mesh axis.

PyTorch port of ``distributed_llm_scheduler_tpu.parallel.ring_attention``.
The sequence dimension is sharded over the ``sp`` axis of a
:class:`.mesh.Mesh`; each rank holds one Q/K/V chunk.  K/V chunks travel
around the ring (:func:`.collectives.ring_hop`, the JAX package's
``ppermute`` with ``i -> i + 1``) while each rank accumulates its
queries' attention over every K/V block with a numerically stable online
softmax (running max and denominator in float32).  Causality is
blockwise: a Q chunk attends to a K/V chunk fully when the source block
index is lower, with a triangular mask when equal, not at all when
higher.

The JAX block body is plain XLA (online softmax, no Pallas), so this one
is plain torch: no kernel of the repository replaces it.  Gradients flow:
the hop's backward is the reverse hop, so the sequence-parallel training
step (:mod:`.train`) differentiates through the ring.
"""

from __future__ import annotations

import math

import torch

from .collectives import all_gather_dim, group_size, ring_hop


def _block_scores(q, k, q_blk: int, kv_blk: int, blk_len: int):
    """Masked scores of one Q chunk against one K/V chunk, in q's dtype:
    causal through global positions, the masked ones at the dtype's
    minimum."""
    hd = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
    Tq, Tk = scores.shape[-2:]
    qpos = q_blk * blk_len + torch.arange(Tq, device=q.device)[:, None]
    kpos = kv_blk * blk_len + torch.arange(Tk, device=q.device)[None, :]
    return torch.where(kpos <= qpos, scores,
                       torch.finfo(scores.dtype).min)


def ring_attention(q, k, v, mesh, axis_name: str = "sp"):
    """Causal ring attention over the ``axis_name`` axis of ``mesh``.

    q, k, v: this rank's sequence chunk, (B, H, T_local, hd).  Returns
    the local output chunk (B, H, T_local, hd) in q's dtype.  A
    collective over the axis: every rank of it calls it."""
    group = mesh.group(axis_name)
    n_blocks = group_size(group)
    my_blk = mesh.coords[axis_name]
    B, H, T, hd = q.shape
    f32 = torch.float32

    def attend(k_cur, v_cur, kv_blk, numer, denom, m):
        scores = _block_scores(q, k_cur, my_blk, kv_blk, T).to(f32)
        m_new = torch.maximum(m, scores.amax(-1))
        # guard fully masked rows: the max stays at -inf, exp gives 0
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        scale = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                      torch.full_like(m, -math.inf)))
        p = torch.exp(scores - m_safe[..., None])
        numer = numer * scale[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(v.dtype), v_cur).to(f32)
        denom = denom * scale + p.sum(-1)
        return numer, denom, m_new

    numer = torch.zeros((B, H, T, hd), dtype=f32, device=q.device)
    denom = torch.zeros((B, H, T), dtype=f32, device=q.device)
    m = torch.full((B, H, T), -math.inf, dtype=f32, device=q.device)
    numer, denom, m = attend(k, v, my_blk, numer, denom, m)  # own block
    k_cur, v_cur = k, v
    for step in range(1, n_blocks):
        # rotate first (K/V blocks travel around the ring), so the last
        # step pays no hop whose result would be dropped
        k_cur = ring_hop(k_cur, group)
        v_cur = ring_hop(v_cur, group)
        numer, denom, m = attend(k_cur, v_cur, (my_blk - step) % n_blocks,
                                 numer, denom, m)
    out = numer / denom.clamp_min(torch.finfo(f32).tiny)[..., None]
    return out.to(q.dtype)


def shard_sequence(t, mesh, axis_name: str = "sp"):
    """This rank's chunk of a global (B, H, T, hd) tensor along T."""
    n = mesh.axis_size(axis_name)
    if t.shape[2] % n:
        raise ValueError(f"sequence length {t.shape[2]} does not split "
                         f"evenly over {axis_name}={n}")
    return t.chunk(n, dim=2)[mesh.coords[axis_name]].contiguous()


def ring_attention_sharded(q, k, v, mesh, axis_name: str = "sp"):
    """Convenience wrapper: global (B, H, T, hd) tensors (the same on
    every rank of the axis) sharded on their sequence dim, ring attention,
    and the global output gathered back on every rank."""
    out = ring_attention(*(shard_sequence(t, mesh, axis_name) for t in (q, k, v)),
                         mesh, axis_name)
    return all_gather_dim(out, mesh.group(axis_name), 2)


def reference_causal_attention(q, k, v):
    """Unsharded oracle for tests: plain causal attention on (B,H,T,hd)."""
    hd = q.shape[-1]
    T = q.shape[-2]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
    i = torch.arange(T, device=q.device)[:, None]
    j = torch.arange(T, device=q.device)[None, :]
    scores = torch.where(j <= i, scores, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.to(torch.float32), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


__all__ = ["reference_causal_attention", "ring_attention",
           "ring_attention_sharded", "shard_sequence"]
