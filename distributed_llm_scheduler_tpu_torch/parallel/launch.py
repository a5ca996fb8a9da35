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

The CUDA kernels are built in the caller before any rank starts
(:func:`..ops.kernels.build`), so the ranks load one build and never race
on the build directory.
"""

# dls-lint: allow-file(DET001) a deadline on the world's wall time, not a
#   value any result depends on

from __future__ import annotations

import multiprocessing as mp
import pickle
import queue
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import torch

#: the CUDA sources every parallel path launches: flash attention and the
#: norms (the paged kernels serve the single-card engine only)
KERNEL_SOURCES = ("flash_attention", "norms")


class WorkerError(RuntimeError):
    """A rank raised, or the world did not finish within its timeout."""


def device() -> torch.device:
    """This rank's device: its card under NCCL, the CPU under gloo; with
    no process group (one process), the platform seam's: the current card,
    or the CPU under ``DLS_PLATFORM=cpu`` (no card on ``cuda`` raises
    ``utils.config.ConfigError``: nothing falls back to the CPU)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        if dist.get_backend() == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")
    from ..utils.config import platform, platform_devices

    if platform() == "cpu":
        return torch.device("cpu")
    platform_devices()  # raises without a card
    return torch.device("cuda", torch.cuda.current_device())


def _worker(call: str, rank: int, world: int, platform: str,
            init_method: str, out: Any) -> None:
    import torch.distributed as dist

    try:
        # the call's bytes were written by this program's caller
        fn, args = pickle.loads(Path(call).read_bytes())
        if platform == "cuda":
            torch.cuda.set_device(rank)
            backend = "nccl"
        else:
            torch.set_num_threads(1)
            backend = "gloo"
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank)
        result = fn(*args)
        dist.barrier()
    except BaseException:  # reported to the caller, which stops the world
        # no teardown here: destroying the group could wait on peers that
        # are blocked in a collective this rank never reaches
        out.put((rank, False, traceback.format_exc()))
        return
    dist.destroy_process_group()
    out.put((rank, True, result if rank == 0 else None))


def spawn(fn: Callable[..., Any], world: int, args: Sequence[Any] = (),
          timeout: Optional[float] = 600.0) -> Any:
    """Run ``fn(*args)`` on ``world`` new processes joined by a process
    group on the platform seam's platform (:func:`..utils.config.platform`:
    the cards, or the CPU under ``DLS_PLATFORM=cpu``); return rank 0's
    result.

    On ``cuda`` the world needs ``world`` visible cards (NCCL refuses two
    ranks on one card), else ``ValueError``.  Raises :class:`WorkerError`
    with the first failing rank's traceback, or when ``timeout`` seconds
    pass (None: no deadline); every process is stopped before this returns
    or raises."""
    from ..utils.config import platform as platform_seam

    platform = platform_seam()
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if platform == "cuda":
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(f"a world of {world} needs {world} cards; "
                             f"{cards} visible")
        from ..ops import kernels

        kernels.build(*KERNEL_SOURCES)
    ctx = mp.get_context("spawn")
    if timeout is None:
        timeout = float("inf")
    with tempfile.TemporaryDirectory(prefix="dls_world_") as tmp:
        init_method = (Path(tmp) / "store").as_uri()
        # the call goes through a file: a pipe would block each start
        # until the child, importing torch first, reads a large payload
        call = Path(tmp) / "call.pkl"
        call.write_bytes(pickle.dumps((fn, tuple(args))))
        out = ctx.Queue()
        procs = [ctx.Process(target=_worker, daemon=True,
                             args=(str(call), r, world, platform,
                                   init_method, out))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            return _collect(out, procs, world, timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=30)
            out.close()


def _collect(out: Any, procs: list, world: int, timeout: float) -> Any:
    """Rank 0's result once every rank has reported; the first failure
    raised as it arrives."""
    deadline = time.monotonic() + timeout
    result, pending = None, set(range(world))
    while pending:
        left = deadline - time.monotonic()
        if left <= 0:
            raise WorkerError(f"ranks {sorted(pending)} of {world} did not "
                              f"finish within {timeout:.0f} s")
        try:
            rank, ok, payload = out.get(timeout=min(left, 1.0))
        except queue.Empty:
            dead = [r for r in sorted(pending)
                    if not procs[r].is_alive() and procs[r].exitcode]
            if dead:
                raise WorkerError(
                    f"rank {dead[0]} of {world} died with exit code "
                    f"{procs[dead[0]].exitcode} before reporting")
            continue
        if not ok:
            raise WorkerError(f"rank {rank} of {world} raised:\n{payload}")
        pending.discard(rank)
        if rank == 0:
            result = payload
    return result


__all__ = ["KERNEL_SOURCES", "WorkerError", "device", "spawn"]
