"""Profiling helpers: device traces, wall timers, device timers and FLOP
counts.

The PyTorch port of ``distributed_llm_scheduler_tpu.utils.profiling``, one
counterpart per function:

* :func:`torch_trace` — a ``torch.profiler`` trace around a block, written
  as Chrome JSON (the JAX package's ``xla_trace``);
* :func:`wall_timer` — host wall seconds of a block;
* :func:`export_chrome_trace` — a timed schedule as Chrome/Perfetto JSON;
* :func:`time_fn` — best-of-N device time of a call, between CUDA events
  on a card (host clock on the CPU);
* :func:`flop_count` — FLOPs of a call from ``torch.utils.flop_counter.
  FlopCounterMode`` (the JAX package's ``compiled_cost_analysis``).
"""

from __future__ import annotations
# dls-lint: allow-file(DET001) profiler: wall time IS the measured quantity

import contextlib
import os
import time
from typing import Any, Callable, Dict, Iterator


@contextlib.contextmanager
def torch_trace(path: str) -> Iterator[Any]:
    """Record a ``torch.profiler`` trace around a block (the card's
    activity too when one is present) and write it to ``path`` as Chrome
    JSON (open in ui.perfetto.dev).  Yields the profiler, whose
    ``key_averages()`` the caller may read after the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def wall_timer() -> Iterator[Dict[str, float]]:
    """``with wall_timer() as t: ...; t['seconds']``"""
    out: Dict[str, float] = {}
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        out["seconds"] = time.perf_counter() - t0


def export_chrome_trace(schedule: Any, path: str, graph: Any = None) -> str:
    """Write a schedule's task timeline as a Chrome/Perfetto trace JSON:
    one row per device, one complete event per task, flow arrows for
    cross-device edges when ``graph`` is given.  Delegates to
    :func:`..obs.export.export_chrome_trace`; raises ``ValueError`` when
    the schedule carries no timings (execute with ``profile=True`` or
    replay on the simulated backend first).  Returns ``path``."""
    from ..obs.export import export_chrome_trace as _export

    return _export(schedule, path, graph=graph)


def time_fn(fn: Callable[..., Any], *args: Any, repeats: int = 5) -> float:
    """Best-of-N seconds of ``fn(*args)``: between CUDA events recorded
    on the current stream of the card its first CUDA tensor argument
    lies on, else on the host clock after the call (CPU ops run
    synchronously).  One untimed call first."""
    import torch

    device = next(
        (a.device for a in args
         if isinstance(a, torch.Tensor) and a.device.type == "cuda"),
        torch.device("cpu"),
    )
    fn(*args)  # warm-up (kernel builds, allocator)
    best = float("inf")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(repeats):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(*args)
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) / 1e3)
        return best
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        best = min(best, time.perf_counter() - t0)
    return best


def flop_count(fn: Callable[..., Any], *args: Any) -> Dict[str, float]:
    """FLOPs of one ``fn(*args)`` as ``FlopCounterMode`` counts them (the
    ATen ops it knows: matmuls, convolutions, attention): ``{"flops":
    total}`` plus one entry per counted op.  A custom kernel's launch is
    not an ATen op and counts nothing."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    mode = FlopCounterMode(display=False)
    with torch.no_grad(), mode:
        fn(*args)
    out: Dict[str, float] = {"flops": float(mode.get_total_flops())}
    for op, n in mode.get_flop_counts().get("Global", {}).items():
        out[str(op)] = float(n)
    return out


__all__ = [
    "export_chrome_trace", "flop_count", "time_fn", "torch_trace",
    "wall_timer",
]
