"""One obs timebase.

Framework-free copy of ``distributed_llm_scheduler_tpu.obs.clockutil``.
Every module that timestamps events (here: the paged decode engine's TTFT
and TPOT histograms) accepts an injectable ``clock``; ``resolve_clock`` is
the one place the injected-or-None decision is made, so a run that
injects nothing falls back to the same ``time.perf_counter`` everywhere.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

#: the type every obs clock satisfies: a zero-arg monotonic read
Clock = Callable[[], float]


def default_clock() -> Clock:
    """The process-wide fallback timebase: ``time.perf_counter``."""
    return time.perf_counter


def resolve_clock(clock: Optional[Clock]) -> Clock:
    """Turn an injected-or-None clock into a callable timebase."""
    return clock if clock is not None else default_clock()


__all__ = ["Clock", "default_clock", "resolve_clock"]
