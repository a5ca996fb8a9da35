"""One process per device: start a ``torch.distributed`` world and run a
function on every rank.

The JAX package runs its parallel layer SPMD from one process over a
``jax.sharding.Mesh``; the port runs one process per device instead, each
holding its own shards, joined by a process group.  :func:`spawn` starts
``world`` processes with the ``spawn`` start method (a process that
already holds threads, JAX's or CUDA's, must not fork), rendezvous
through a ``file://`` store in a fresh temporary directory (no TCP port
to collide with another run on the same host), and runs ``fn(*args)`` on
every rank:

* on ``cuda``: NCCL, rank ``r`` on card ``r``;
* on ``cpu``: gloo, one intra-op thread per rank.

Rank 0's return value comes back to the caller (it crosses a process
boundary, so it must pickle: return numpy arrays or CPU tensors).  A
rank that raises stops the whole world: its traceback is re-raised in
the caller as :class:`WorkerError`, and so is a world that outlives
``timeout``.  ``fn`` is pickled by its import path, so it must be a
module-level function of a module the children can import.

A :class:`World` is the same processes kept alive: started once, they run
every call they are sent, in order, until :meth:`World.close` (the
compiled rung over several cards keeps one per program).  :func:`spawn`
is a world of one call.  Calls and results go through
``torch.multiprocessing`` queues, so a CUDA tensor in a result is shared
with the caller through CUDA IPC (it stays the rank's memory) and a CPU
tensor through shared memory.  A rank whose caller has died exits.

The CUDA kernels are built in the caller before any rank starts
(:func:`..ops.kernels.build`), so the ranks load one build and never race
on the build directory.
"""

# dls-lint: allow-file(DET001) a deadline on the world's wall time, not a
#   value any result depends on

from __future__ import annotations

import atexit
import queue
import tempfile
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.multiprocessing as mp

#: the CUDA sources every parallel path launches: flash attention and the
#: norms (the paged kernels serve the single-card engine only)
KERNEL_SOURCES = ("flash_attention", "norms")


class WorkerError(RuntimeError):
    """A rank raised, or the world did not finish within its timeout."""


def device() -> torch.device:
    """This rank's device: its card under NCCL, the CPU under gloo; with
    no process group (one process), the platform seam's: the current card,
    or the CPU under ``DLS_PLATFORM=cpu`` (no card on ``cuda`` raises
    ``utils.config.ConfigError``: nothing falls back to the CPU).  A rank
    of a simulated world (:mod:`.simworld`) is on the CPU."""
    from .collectives import dist

    if dist.is_available() and dist.is_initialized():
        if dist.get_backend() == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")
    from ..utils.config import platform, platform_devices

    if platform() == "cpu":
        return torch.device("cpu")
    platform_devices()  # raises without a card
    return torch.device("cuda", torch.cuda.current_device())


def world_devices() -> List[torch.device]:
    """One device per rank of a parallel run on the platform seam's
    platform (``utils.config.platform_world``): every visible card, or
    ``DLS_CPU_WORLD`` CPU devices (``cpu:r``).  No card on ``cuda``
    raises ``utils.config.ConfigError``.  What a ``collective_probe``
    sizes its mesh from by default, as the JAX hooks take
    ``jax.devices()``."""
    from ..utils.config import platform, platform_world

    n = platform_world()
    kind = platform()
    return [torch.device(kind, r) for r in range(n)]


def _worker(rank: int, world: int, platform: str, card: Optional[int],
            init_method: str, calls: Any, out: Any) -> None:
    import torch.distributed as dist

    try:
        if platform == "cuda":
            torch.cuda.set_device(card)
            backend = "nccl"
        else:
            torch.set_num_threads(1)
            backend = "gloo"
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank)
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        return
    out.put((rank, True, None))
    parent = mp.parent_process()
    while True:
        try:
            call = calls.get(timeout=1.0)
        except queue.Empty:
            if parent is not None and not parent.is_alive():
                return  # the caller died: nothing would ever stop this rank
            continue
        if call is None:
            break
        fn, args, reply = call
        try:
            result = fn(*args)
        except BaseException:  # reported to the caller, which stops the world
            # no teardown here: destroying the group could wait on peers
            # that are blocked in a collective this rank never reaches
            out.put((rank, False, traceback.format_exc()))
            return
        out.put((rank, True, result if reply else None))
    dist.barrier(device_ids=[card] if platform == "cuda" else None)
    dist.destroy_process_group()


#: worlds not yet closed; each is closed at interpreter exit
_LIVE: "weakref.WeakSet[World]" = weakref.WeakSet()


@atexit.register
def _close_live() -> None:
    for w in list(_LIVE):
        w.close()


class World:
    """``size`` processes joined by a process group on the platform seam's
    platform, alive until :meth:`close`; :meth:`call` runs a function on
    every rank.

    On ``cuda`` rank ``r`` runs on card ``cards[r]`` (default ``r``; NCCL
    refuses two ranks on one card, so the cards must be distinct and
    visible, else ``ValueError``); on ``cpu`` each rank is a gloo process
    on one intra-op thread.  The constructor returns when every rank has
    joined the group, ``start_s`` seconds after it began.  ``directory``
    is a temporary directory that lives as long as the world (the
    rendezvous store is in it; a caller may leave files for the ranks
    there).  A rank that raises, dies or outlasts ``timeout`` (None: no
    deadline) closes the world and raises :class:`WorkerError`; so does a
    call on a closed world.  A world the caller leaves open is closed at
    interpreter exit."""

    def __init__(self, size: int, cards: Optional[Sequence[int]] = None,
                 timeout: Optional[float] = 600.0):
        from ..utils.config import platform as platform_seam

        self.platform = platform_seam()
        if size < 1:
            raise ValueError(f"world must be >= 1, got {size}")
        if self.platform == "cuda":
            visible = torch.cuda.device_count()
            cards = tuple(range(size)) if cards is None else tuple(cards)
            if len(cards) != size or len(set(cards)) != size:
                raise ValueError(f"a world of {size} needs {size} distinct "
                                 f"cards, got {list(cards)}")
            if max(cards) >= visible:
                raise ValueError(f"a world of {size} needs {size} cards "
                                 f"{list(cards)}; {visible} visible")
            from ..ops import kernels

            kernels.build(*KERNEL_SOURCES)
        else:
            cards = (None,) * size
        self.size = size
        self.cards = cards
        self.timeout = float("inf") if timeout is None else timeout
        t0 = time.perf_counter()
        ctx = mp.get_context("spawn")
        self._tmp = tempfile.TemporaryDirectory(prefix="dls_world_")
        self.directory = Path(self._tmp.name)
        init_method = (self.directory / "store").as_uri()
        self._calls = [ctx.Queue() for _ in range(size)]
        self._out = ctx.Queue()
        self._procs: Optional[list] = [
            ctx.Process(target=_worker, daemon=True,
                        args=(r, size, self.platform, cards[r], init_method,
                              self._calls[r], self._out))
            for r in range(size)]
        _LIVE.add(self)
        for p in self._procs:
            p.start()
        try:
            self._collect()
        except BaseException:
            self.close()
            raise
        self.start_s = time.perf_counter() - t0

    @property
    def closed(self) -> bool:
        return self._procs is None

    def pids(self) -> List[int]:
        """The ranks' process ids (empty once closed)."""
        return [p.pid for p in self._procs or ()]

    def call(self, fn: Callable[..., Any], args: Sequence[Any] = (),
             rank_args: Optional[Sequence[Sequence[Any]]] = None,
             gather: bool = True) -> List[Any]:
        """``fn(*args)`` on every rank (``fn(*rank_args[r])`` on rank ``r``
        when given); the ranks' results in rank order (with ``gather``
        False only rank 0's crosses back, the others are None).  ``fn`` is
        pickled by its import path: a module-level function of a module
        the ranks can import."""
        if self._procs is None:
            raise WorkerError("this world is closed")
        for r, q in enumerate(self._calls):
            q.put((fn, tuple(args if rank_args is None else rank_args[r]),
                   gather or r == 0))
        try:
            return self._collect()
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        """Stop every rank (a clean leave of the group, or killed when that
        does not come within 30 s) and remove the directory; idempotent."""
        procs, self._procs = self._procs, None
        if procs is None:
            return
        _LIVE.discard(self)
        for q in self._calls:
            q.put(None)
        deadline = time.monotonic() + 30
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 0.0))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        for q in (*self._calls, self._out):
            q.cancel_join_thread()
            q.close()
        self._tmp.cleanup()

    def _collect(self) -> List[Any]:
        """Every rank's report, in rank order; the first failure raised as
        it arrives."""
        deadline = time.monotonic() + self.timeout
        results: List[Any] = [None] * self.size
        pending = set(range(self.size))
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                raise WorkerError(
                    f"ranks {sorted(pending)} of {self.size} did not finish "
                    f"within {self.timeout:.0f} s")
            try:
                rank, ok, payload = self._out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r in sorted(pending)
                        if not self._procs[r].is_alive()]
                if dead:
                    raise WorkerError(
                        f"rank {dead[0]} of {self.size} died with exit code "
                        f"{self._procs[dead[0]].exitcode} before reporting")
                continue
            if not ok:
                raise WorkerError(
                    f"rank {rank} of {self.size} raised:\n{payload}")
            pending.discard(rank)
            results[rank] = payload
        return results


def spawn(fn: Callable[..., Any], world: int, args: Sequence[Any] = (),
          timeout: Optional[float] = 600.0) -> Any:
    """Run ``fn(*args)`` on ``world`` new processes joined by a process
    group on the platform seam's platform (:func:`..utils.config.platform`:
    the cards, or the CPU under ``DLS_PLATFORM=cpu``); return rank 0's
    result: a :class:`World` of one call.

    On ``cuda`` the world needs ``world`` visible cards (NCCL refuses two
    ranks on one card), else ``ValueError``.  Raises :class:`WorkerError`
    with the first failing rank's traceback, or when the start or the call
    outlasts ``timeout`` seconds (None: no deadline); every process is
    stopped before this returns or raises."""
    w = World(world, timeout=timeout)
    try:
        return w.call(fn, args, gather=False)[0]
    finally:
        w.close()


__all__ = ["KERNEL_SOURCES", "World", "WorkerError", "device", "spawn",
           "world_devices"]
