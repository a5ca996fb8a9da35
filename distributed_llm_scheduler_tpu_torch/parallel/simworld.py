"""A world of simulated ranks in one process: the collective sweep's
stand-in for ``torch.distributed``.

The JAX package checks its hand-written parallel strategies by tracing
each one with ``jax.make_jaxpr`` and walking the jaxpr: one SPMD program,
whose ``cond`` branches must issue the same collectives.  The port runs
one process per rank and writes every collective out
(:mod:`.collectives`), so the counterpart of "two branches disagree" is
"two ranks of one group issue different collectives": the hang the
check exists to prevent.  :func:`run_ranks` runs a function on every rank
of a world of ``size`` ranks, one thread each, started by no process and
touching no card:

* while a thread runs a rank, :data:`.collectives.dist` answers for this
  world (:func:`.collectives.rank_of`): ``new_group`` hands out recording
  groups, ``get_rank``/``get_world_size`` answer for the rank;
* every collective of :mod:`.collectives` is a rendezvous of its group's
  ranks, keyed by the group and the call's index within the group.  When
  all have arrived it checks that they issued the same op on the same
  shapes and dtypes (a hop: that each send meets its receive), records
  ``(op, group, index, shapes, dtypes, perm)`` in every rank's sequence
  and computes the real result in-process (sum, broadcast, gather,
  all-to-all, the hop's copies) on the ranks' CPU tensors, so a probe
  that routes tokens from a gathered count runs as it would on cards;
* ranks that arrive with different ops or shapes, or a rank that waits
  while every other live rank waits elsewhere or has finished, stop the
  world: the divergence is recorded (:attr:`RanksRun.divergences`) and
  every rank's run ends.  A rendezvous that waits longer than
  ``timeout`` seconds is a divergence too, so a wait is a finding and
  never a hang.
"""

# dls-lint: allow-file(DET001) a rendezvous deadline on the host clock, not
#   a value any result depends on

from __future__ import annotations

import dataclasses
import pickle
import threading
import time
import types
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

#: seconds a rank waits at one rendezvous before the world calls it a
#: divergence (a deadlock among live ranks is found at once)
RENDEZVOUS_TIMEOUT = 60.0

END = "<end of program>"


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective as a rank issued it: ``op`` (the ``torch.distributed``
    call), ``group`` (its global ranks), ``index`` (the call's position
    among the group's collectives), each tensor's shape and dtype, and for
    a hop ``perm``: every ``(source, destination)`` send of the group, in
    group ranks."""

    op: str
    group: Tuple[int, ...]
    index: int
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[str, ...]
    perm: Optional[Tuple[Tuple[int, int], ...]] = None

    def describe(self) -> str:
        shapes = ", ".join(f"{tuple(s)} {d}" for s, d in zip(self.shapes, self.dtypes))
        perm = f" perm {list(self.perm)}" if self.perm is not None else ""
        return f"{self.op}[{shapes}]{perm}"


@dataclasses.dataclass
class RanksRun:
    """What :func:`run_ranks` saw: each rank's collectives in order, its
    return value, the divergences that stopped the world (messages), and
    the first exception a rank raised of its own (None if none did)."""

    size: int
    sequences: Dict[int, List[Collective]]
    results: Dict[int, Any]
    divergences: List[str]
    error: Optional[BaseException] = None


class _Group:
    def __init__(self, gid: int, ranks: Tuple[int, ...]):
        self.gid, self.ranks = gid, ranks

    def __repr__(self) -> str:
        return f"group{list(self.ranks)}"


class _Call:
    """One rank's arrival at a rendezvous: ``op``, its tensors (for a hop
    ``(kind, peer group rank, tensor)`` triples), and its other
    arguments (``extra``: broadcast's source, the reduce op)."""

    def __init__(self, op: str, tensors: Sequence[Any] = (), extra: Any = None,
                 objects: Any = None):
        self.op, self.tensors, self.extra = op, list(tensors), extra
        self.objects = objects  # all_gather_object's (output list, object)

    def signature(self) -> tuple:
        ts = [t[2] if isinstance(t, tuple) else t for t in self.tensors]
        return (self.op, tuple(tuple(t.shape) for t in ts),
                tuple(str(t.dtype).removeprefix("torch.") for t in ts), self.extra)

    def describe(self) -> str:
        op, shapes, dtypes, extra = self.signature()
        if self.op == "batch_isend_irecv":
            shapes = ", ".join(f"{k}{'->' if k == 'send' else '<-'}{p} {tuple(t.shape)}"
                               for k, p, t in self.tensors)
            return f"{op}[{shapes}]"
        body = ", ".join(f"{s} {d}" for s, d in zip(shapes, dtypes))
        return f"{op}[{body}]" + (f" {extra}" if extra is not None else "")


class _Stopped(BaseException):
    """Raised in every rank once the world has stopped (a divergence)."""


class _Request:
    def wait(self) -> bool:
        return True


class _P2POp:
    def __init__(self, op, tensor, peer, group=None, tag=0):
        self.op, self.tensor, self.peer, self.group = op, tensor, peer, group


def _isend(*_a, **_k):
    raise RuntimeError("a simulated world sends only through batch_isend_irecv")


def _irecv(*_a, **_k):
    raise RuntimeError("a simulated world receives only through batch_isend_irecv")


class SimWorld:
    """The shared state of one simulated world (:func:`run_ranks`)."""

    def __init__(self, size: int, timeout: float = RENDEZVOUS_TIMEOUT):
        self.size, self.timeout = size, timeout
        self.world = _Group(0, tuple(range(size)))
        self._groups: Dict[int, _Group] = {0: self.world}
        self._made = [0] * size  # groups each rank has made
        self._next: List[Dict[int, int]] = [{} for _ in range(size)]
        self._slots: Dict[Tuple[int, int], Dict[int, _Call]] = {}
        self._done: set = set()
        self._at: Dict[int, Optional[Tuple[int, int]]] = {}  # waiting ranks
        self._finished = [False] * size
        self._cv = threading.Condition()
        self.stopped = False
        self.sequences: Dict[int, List[Collective]] = {r: [] for r in range(size)}
        self.divergences: List[str] = []

    # -- groups ------------------------------------------------------------

    def new_group(self, rank: int, ranks: Sequence[int]) -> _Group:
        ranks = tuple(int(r) for r in ranks)
        with self._cv:
            self._made[rank] += 1
            gid = self._made[rank]
            group = self._groups.setdefault(gid, _Group(gid, ranks))
        if group.ranks != ranks:
            raise ValueError(f"rank {rank} makes its group #{gid} of ranks "
                             f"{list(ranks)}, another rank of {list(group.ranks)}")
        return group

    def group_of(self, group) -> _Group:
        return self.world if group is None else group

    # -- the rendezvous ------------------------------------------------------

    def rendezvous(self, rank: int, group: _Group, call: _Call) -> None:
        if rank not in group.ranks:
            raise ValueError(f"rank {rank} calls {call.op} on {group}, which "
                             "it is not a member of")
        with self._cv:
            if self.stopped:
                raise _Stopped()
            idx = self._next[rank].get(group.gid, 0)
            self._next[rank][group.gid] = idx + 1
            key = (group.gid, idx)
            slot = self._slots.setdefault(key, {})
            slot[rank] = call
            if len(slot) == len(group.ranks):
                self._complete(key, group)
                self._cv.notify_all()
            else:
                self._at[rank] = key
                self._check_stuck()
                deadline = time.monotonic() + self.timeout
                while key not in self._done and not self.stopped:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        self._stop_stuck(f"no rank arrived for {self.timeout:.0f} s")
                        break
                    self._cv.wait(min(left, 0.5))
                self._at.pop(rank, None)
            if self.stopped:
                raise _Stopped()

    def finish(self, rank: int) -> None:
        with self._cv:
            self._finished[rank] = True
            self._check_stuck()

    def _check_stuck(self) -> None:
        """Stop the world when no live rank can move: every one waits at a
        rendezvous that a finished or otherwise waiting rank owes."""
        if self.stopped or not self._at:
            return
        if all(self._at.get(r) is not None and self._at[r] not in self._done
               for r in range(self.size) if not self._finished[r]):
            self._stop_stuck("every live rank waits")

    def _where(self, rank: int) -> str:
        key = self._at.get(rank)
        if self._finished[rank] or key is None:
            return END
        group = self._groups[key[0]]
        return f"{self._slots[key][rank].describe()} (#{key[1]} of {group})"

    def _stop_stuck(self, why: str) -> None:
        for key in sorted(k for k in self._slots if k not in self._done):
            group, slot = self._groups[key[0]], self._slots[key]
            parts = [f"rank {r} issues {slot[r].describe()}" if r in slot
                     else f"rank {r} issues {self._where(r)}" for r in group.ranks]
            self.divergences.append(
                f"ranks of {group} diverge at its collective #{key[1]}: "
                + "; ".join(parts) + f" ({why})")
        self._stop()

    def _stop(self) -> None:
        self.stopped = True
        self._cv.notify_all()

    def _complete(self, key: Tuple[int, int], group: _Group) -> None:
        slot = self._slots[key]
        calls = [slot[r] for r in group.ranks]
        sigs = {c.signature() for c in calls} if calls[0].op != "batch_isend_irecv" \
            else {c.op for c in calls}
        if len(sigs) > 1:
            self._diverge(key, group, calls, "they issue different collectives")
            return
        with torch.no_grad():
            perm = getattr(self, "_do_" + calls[0].op)(group, calls)
        if perm is False:
            self._diverge(key, group, calls, "a send meets no receive")
            return
        self._done.add(key)
        for r, c in zip(group.ranks, calls):
            _, shapes, dtypes, _ = c.signature()
            self.sequences[r].append(Collective(c.op, group.ranks, key[1], shapes,
                                                dtypes, perm))

    def _diverge(self, key, group, calls, why: str) -> None:
        self.divergences.append(
            f"ranks of {group} diverge at its collective #{key[1]}: "
            + "; ".join(f"rank {r} issues {c.describe()}"
                        for r, c in zip(group.ranks, calls)) + f" ({why})")
        self._stop()

    # -- the collectives' results (every rank's in place) --------------------

    @staticmethod
    def _do_all_reduce(group, calls):
        ts = [c.tensors[0] for c in calls]
        op = calls[0].extra
        total = ts[0].clone()
        for t in ts[1:]:
            if op == "SUM":
                total += t
            elif op == "MAX":
                total = torch.maximum(total, t)
            elif op == "MIN":
                total = torch.minimum(total, t)
            else:
                raise NotImplementedError(f"all_reduce op {op}")
        for t in ts:
            t.copy_(total)

    @staticmethod
    def _do_broadcast(group, calls):
        src = group.ranks.index(calls[0].extra)
        for c in calls:
            c.tensors[0].copy_(calls[src].tensors[0])

    @staticmethod
    def _do_all_gather(group, calls):
        for c in calls:  # tensors: the input, then the output list
            for part, other in zip(c.tensors[1:], calls):
                part.copy_(other.tensors[0])

    @staticmethod
    def _do_all_to_all_single(group, calls):
        n = len(calls)
        chunks = [c.tensors[1].chunk(n, 0) for c in calls]  # (out, in)
        for j, c in enumerate(calls):
            c.tensors[0].copy_(torch.cat([chunks[i][j] for i in range(n)]))

    @staticmethod
    def _do_all_gather_object(group, calls):
        for c in calls:
            c.objects[0][:] = [pickle.loads(pickle.dumps(o.objects[1])) for o in calls]

    @staticmethod
    def _do_batch_isend_irecv(group, calls):
        sends = [(i, p, t) for i, c in enumerate(calls)
                 for k, p, t in c.tensors if k == "send"]
        recvs = [(i, p, t) for i, c in enumerate(calls)
                 for k, p, t in c.tensors if k == "recv"]
        pending = list(sends)
        matched = []
        for dst, src, buf in recvs:
            hit = next((s for s in pending if s[0] == src and s[1] == dst
                        and s[2].shape == buf.shape and s[2].dtype == buf.dtype), None)
            if hit is None:
                return False
            pending.remove(hit)
            matched.append((buf, hit[2]))
        if pending:
            return False
        for buf, t in matched:
            buf.copy_(t)
        return tuple((s, d) for s, d, _ in sends)


class SimRank:
    """One rank's view of a :class:`SimWorld`: the ``torch.distributed``
    calls the parallel layer makes (:data:`.collectives.dist` resolves to
    it on the rank's thread)."""

    ReduceOp = torch.distributed.ReduceOp
    P2POp = _P2POp
    isend = staticmethod(_isend)
    irecv = staticmethod(_irecv)

    def __init__(self, world: SimWorld, rank: int):
        self.sim, self.rank = world, rank
        self.group = types.SimpleNamespace(WORLD=world.world)

    def is_available(self) -> bool:
        return True

    def is_initialized(self) -> bool:
        return True

    def get_backend(self, group=None) -> str:
        return "simulated"

    def get_world_size(self, group=None) -> int:
        return len(self.sim.group_of(group).ranks)

    def get_rank(self, group=None) -> int:
        ranks = self.sim.group_of(group).ranks
        return ranks.index(self.rank) if self.rank in ranks else -1

    def get_global_rank(self, group, group_rank: int) -> int:
        return self.sim.group_of(group).ranks[group_rank]

    def new_group(self, ranks, **_kw):
        return self.sim.new_group(self.rank, ranks)

    def _meet(self, group, call: _Call) -> None:
        self.sim.rendezvous(self.rank, self.sim.group_of(group), call)

    def all_reduce(self, tensor, op=None, group=None, async_op=False):
        name = "SUM" if op is None else str(op).rsplit(".", 1)[-1].upper()
        self._meet(group, _Call("all_reduce", [tensor], extra=name))

    def broadcast(self, tensor, src, group=None, async_op=False):
        self._meet(group, _Call("broadcast", [tensor], extra=int(src)))

    def all_gather(self, tensor_list, tensor, group=None, async_op=False):
        self._meet(group, _Call("all_gather", [tensor, *tensor_list]))

    def all_to_all_single(self, output, input, group=None, **_kw):
        self._meet(group, _Call("all_to_all_single", [output, input]))

    def all_gather_object(self, object_list, obj, group=None):
        self._meet(group, _Call("all_gather_object", objects=(object_list, obj)))

    def batch_isend_irecv(self, p2p_op_list):
        ops = list(p2p_op_list)
        group = ops[0].group if ops else None
        ranks = self.sim.group_of(group).ranks
        tensors = [("send" if op.op is _isend else "recv",
                    ranks.index(op.peer), op.tensor) for op in ops]
        self._meet(group, _Call("batch_isend_irecv", tensors))
        return [_Request() for _ in ops]


def run_ranks(fn: Callable[..., Any], args: Sequence[Any] = (), size: int = 1,
              timeout: float = RENDEZVOUS_TIMEOUT) -> RanksRun:
    """``fn(*args)`` on every rank of a simulated world of ``size`` ranks,
    one thread each (module doc); returns what the world saw.  A rank's
    own exception stops nothing by itself: the ranks waiting on it find
    the world stuck, and the first such exception is
    :attr:`RanksRun.error`."""
    from .collectives import rank_of

    world = SimWorld(size, timeout)
    results: Dict[int, Any] = {}
    errors: Dict[int, BaseException] = {}

    def body(rank: int) -> None:
        try:
            with rank_of(SimRank(world, rank)):
                results[rank] = fn(*args)
        except _Stopped:
            pass
        except BaseException as e:  # the probe's own fault, reported by the caller
            errors[rank] = e
        finally:
            world.finish(rank)

    threads = [threading.Thread(target=body, args=(r,), name=f"sim-rank-{r}",
                                daemon=True) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    error = errors[min(errors)] if errors else None
    return RanksRun(size, world.sequences, results,
                    [] if error is not None else world.divergences, error)


__all__ = ["Collective", "END", "RENDEZVOUS_TIMEOUT", "RanksRun", "SimRank",
           "SimWorld", "run_ranks"]
