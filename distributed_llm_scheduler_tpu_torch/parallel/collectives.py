"""The collectives of the parallel layer, written out by hand.

The JAX package writes its tensor-parallel model as one global program
and lets GSPMD insert every collective from the sharding annotations
(``distributed_llm_scheduler_tpu/parallel/sharding.py:3-6``); its ring
and Ulysses attention call ``ppermute`` and ``all_to_all`` inside
``shard_map``.  Here each collective is explicit, and each is a
``torch.autograd.Function`` whose backward is the collective that makes
gradients right:

* :func:`copy_to_group` — Megatron's *f*: identity forward, all-reduce
  backward.  Put before a column-parallel product: the replicated input
  feeds a different slice of columns on every rank, so its gradient is
  the sum of the ranks' partial gradients.
* :func:`reduce_from_group` — Megatron's *g*: all-reduce forward,
  identity backward.  Put after a row-parallel product, whose outputs
  are partial sums.  The math after it is the same on every rank, so
  each rank's gradient is already the whole one; an all-reduce in the
  backward (``torch.distributed.nn.functional.all_reduce``'s) would
  multiply it by the group size.
* :func:`ring_hop` — send to the next rank of the group and receive from
  the previous one (``batch_isend_irecv``; ``ppermute`` with
  ``i -> i + 1``); backward: the reverse hop.
* :func:`seq_to_heads` / :func:`heads_to_seq` — Ulysses' two
  ``all_to_all_single`` redistributions of (B, H, T, hd) between sequence
  and head sharding; each is the other's backward.
* :func:`successor_hop` — the pipeline's hop: send to the next rank of
  the group, receive from the previous one; the first receives zeros and
  the last sends nothing (``ppermute`` with ``i -> i + 1`` for
  ``i < n - 1``); backward: the gradient back to the predecessor.
* :func:`share_from_last` — the last rank's tensor on every rank (the
  pipeline's final sum over ``pp``, where only the last stage adds
  anything); backward: the last rank keeps its gradient, the others pass
  back zeros, so the stages see the gradient of the one loss once.
* :func:`all_gather_dim` — concatenate the group's tensors along a dim
  (no gradient: logits and outputs gathered for reading);
  :func:`gather_objects` the same for picklable objects.

Every function takes ``group=None`` for a group of one rank and is then
the identity, so the single-device path runs the same code.

The collectives of this module, the groups of ``mesh._build`` and the
world queries of ``launch.device`` and ``train.run_train_loop`` go
through :data:`dist`: ``torch.distributed`` itself, or, on a thread that
runs a rank of a simulated world (:func:`rank_of`, :mod:`.simworld`),
that world, which records each collective for the collective sweep.
``launch``'s process-group set-up and the chip benches of ``runs``
(their barriers, object broadcasts and counted hops) act on a real world
only and call ``torch.distributed`` itself; no probe reaches them.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed


class _Seam:
    """``torch.distributed``, or the simulated rank this thread runs
    (attributes are looked up at each call, so a patched
    ``torch.distributed`` function is the one called)."""

    __slots__ = ()

    def __getattr__(self, name):
        return getattr(getattr(_THREAD, "rank", None) or torch.distributed, name)


_THREAD = threading.local()
#: the ``torch.distributed`` of this thread (module doc)
dist = _Seam()


@contextlib.contextmanager
def rank_of(rank):
    """In this thread, :data:`dist` answers as ``rank`` (a
    :class:`.simworld.SimRank`) until the block ends."""
    _THREAD.rank = rank
    try:
        yield rank
    finally:
        _THREAD.rank = None


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce of the gradient over ``group``."""
    if group is None:
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) over ``group`` forward, identity backward."""
    if group is None:
        return x
    return _ReduceFromGroup.apply(x, group)


def _hop(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send ``x`` to group rank ``me + shift``, receive from ``me - shift``."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    send = x.contiguous()
    recv = torch.empty_like(send)
    to = dist.get_global_rank(group, (me + shift) % n)
    frm = dist.get_global_rank(group, (me - shift) % n)
    ops = [dist.P2POp(dist.isend, send, to, group),
           dist.P2POp(dist.irecv, recv, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _hop(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _hop(grad, ctx.group, -1), None


def ring_hop(x: torch.Tensor, group) -> torch.Tensor:
    """The tensor of the previous rank of ``group`` (this rank's goes to
    the next): one step of a ring."""
    if group is None:
        return x
    return _RingHop.apply(x, group)


def _succ(x: torch.Tensor, group, back: bool) -> torch.Tensor:
    """Forward: send ``x`` to group rank ``me + 1`` (none from the last),
    receive from ``me - 1`` (zeros on the first).  ``back``: the reverse,
    send to ``me - 1`` and receive from ``me + 1``."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    to, frm = (me - 1, me + 1) if back else (me + 1, me - 1)
    send = x.contiguous()
    recv = torch.zeros_like(send)
    ops = []
    if 0 <= to < n:
        ops.append(dist.P2POp(dist.isend, send, dist.get_global_rank(group, to), group))
    if 0 <= frm < n:
        ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, frm), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


class _SuccessorHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, anchor, group):
        ctx.group = group
        return _succ(x, group, back=False)

    @staticmethod
    def backward(ctx, grad):
        return _succ(grad, ctx.group, back=True), None, None


def successor_hop(x: torch.Tensor, group, anchor: torch.Tensor) -> torch.Tensor:
    """The previous rank's tensor (zeros on the group's first rank); this
    rank's ``x`` goes to the next (the last rank's goes nowhere).  Every
    rank of the group calls it together, forward and backward.

    A received tensor has no autograd history on this rank, and autograd
    runs only the nodes between the loss and the tensors differentiated
    for, so a hop whose ``x`` reaches no param (a fill step's zeros) would
    have its backward pruned while the neighbour waits on it.
    ``anchor``, a param every rank differentiates for, ties every hop into
    the graph (it gets no gradient from the hop)."""
    if group is None:
        return torch.zeros_like(x)
    return _SuccessorHop.apply(x, anchor, group)


class _ShareFromLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.last = dist.get_rank(group) == n - 1
        out = x.contiguous().clone()
        dist.broadcast(out, src=dist.get_global_rank(group, n - 1), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.last else torch.zeros_like(grad)), None


def share_from_last(x: torch.Tensor, group) -> torch.Tensor:
    """The group's last rank's ``x`` on every rank (each rank passes a
    tensor of one shape); the gradient reaches the last rank's ``x``
    alone."""
    if group is None:
        return x
    return _ShareFromLast.apply(x, group)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` over the leading dim (one slice per rank)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    B, H, T, hd = x.shape
    # slice j: head group j of this rank's sequence chunk, sent to rank j
    parts = x.reshape(B, n, H // n, T, hd).transpose(0, 1)
    got = _all_to_all(parts, group)  # (n, B, H/n, T, hd): rank j's chunk
    return got.permute(1, 2, 0, 3, 4).reshape(B, H // n, n * T, hd)


def _heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    B, H, T, hd = x.shape
    # slice j: sequence chunk j of this rank's head group, sent to rank j
    parts = x.reshape(B, H, n, T // n, hd).permute(2, 0, 1, 3, 4)
    got = _all_to_all(parts, group)  # (n, B, H, T/n, hd): rank j's heads
    return got.transpose(0, 1).reshape(B, n * H, T // n, hd)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_to_heads(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _heads_to_seq(grad, ctx.group), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _heads_to_seq(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _seq_to_heads(grad, ctx.group), None


def seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """(B, H, T_local, hd) sequence-sharded -> (B, H/n, T, hd) head-sharded
    over ``group`` of n ranks (``jax.lax.all_to_all(split_axis=1,
    concat_axis=2, tiled=True)``)."""
    if group is None:
        return x
    return _SeqToHeads.apply(x, group)


def heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """Inverse of :func:`seq_to_heads`."""
    if group is None:
        return x
    return _HeadsToSeq.apply(x, group)


def all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in group-rank order
    (every rank's ``x`` of one shape)."""
    if group is None:
        return x
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_objects(obj, group) -> list:
    """Every rank of ``group``'s picklable ``obj``, in group-rank order
    (``[obj]`` for a group of one)."""
    if group is None:
        return [obj]
    parts = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, obj, group=group)
    return parts


def mean_over(value: torch.Tensor, group) -> torch.Tensor:
    """The mean of a detached tensor over ``group``."""
    out = value.detach().clone()
    return all_reduce_(out, group).div_(group_size(group))


__all__ = [
    "all_gather_dim", "all_reduce_", "copy_to_group", "dist", "gather_objects",
    "group_size", "heads_to_seq", "mean_over", "rank_of", "reduce_from_group",
    "ring_hop", "seq_to_heads", "share_from_last", "successor_hop",
]
