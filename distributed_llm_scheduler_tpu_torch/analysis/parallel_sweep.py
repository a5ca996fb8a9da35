"""Parallel-strategy collective sweep: COL003/COL004 over every
hand-written parallel entry point, COL008 when a probe rots.

PyTorch port of ``distributed_llm_scheduler_tpu.analysis.parallel_sweep``.
The per-strategy modules under :mod:`..parallel` each export a
``collective_probe(devices=None) -> (fn, args)`` hook (see the registry
:data:`..parallel.COLLECTIVE_ENTRY_POINTS`).  Where the JAX sweep traces
each probe with ``jax.make_jaxpr`` and walks the one SPMD program, this
one runs each probe's ``fn(*args)`` on every rank of a simulated world of
``len(devices)`` ranks (:mod:`..parallel.simworld`: a thread a rank, no
process, no card, tiny CPU tensors) and checks what the ranks issued with
:func:`.collective_pass.analyze_collectives_ranks`: ranks of one group
that disagree, or wait on a rank that never comes, are COL003; a hop
whose sends are not a partial permutation is COL004.

A probe that raises (module drifted, signature changed, divisibility
precondition broken by a config edit) is itself a finding: **COL008
(error)**, with the JAX sweep's message.  Wired into ``lint --parallel``.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, Optional, Sequence

from .collective_pass import analyze_collectives_ranks
from .diagnostics import AnalysisReport, Severity


def sweep_parallel_collectives(
    entries: Optional[Sequence[str]] = None,
    devices: Optional[Sequence[Any]] = None,
    traces: Optional[Dict[str, Dict[int, List[Any]]]] = None,
) -> AnalysisReport:
    """Run and check every registered parallel entry point.

    ``entries`` defaults to the full registry
    (:data:`..parallel.COLLECTIVE_ENTRY_POINTS`); ``devices`` defaults to
    :func:`..parallel.launch.world_devices` (the cards, or
    ``DLS_CPU_WORLD`` CPU devices under ``DLS_PLATFORM=cpu``): the probes
    size their meshes from their count and the simulated world has one
    rank per device, so the sweep runs (degenerately) on one.  With a
    ``traces`` dict, each probe's per-rank collectives
    (:class:`..parallel.simworld.Collective` lists by rank) are stored in
    it under the probe's name."""
    from .. import parallel
    from ..parallel.launch import world_devices
    from ..parallel.simworld import run_ranks

    names = tuple(entries) if entries is not None else (
        parallel.COLLECTIVE_ENTRY_POINTS
    )
    devs = list(devices) if devices is not None else world_devices()
    rep = AnalysisReport()
    for name in names:
        try:
            mod = importlib.import_module(f".{name}", parallel.__name__)
            fn, args = mod.collective_probe(devices=devs)
            run = run_ranks(fn, args, len(devs))
            if traces is not None:
                traces[name] = run.sequences
            rep.extend(analyze_collectives_ranks(run, where=name))
        except Exception as e:  # noqa: BLE001 — any probe failure is a finding
            rep.add(
                "COL008",
                Severity.ERROR,
                f"parallel entry point {name!r} failed to trace: "
                f"{type(e).__name__}: {e}",
                task=name,
            )
    return rep.dedupe()
