"""Static analysis over graphs, schedules, clusters and lowered runs.

PyTorch port of ``distributed_llm_scheduler_tpu.analysis``: a multi-pass
analyzer emitting structured :class:`Diagnostic` records with stable codes
(``DAG001`` cycle, ``MEM003`` memory overcommit, ``COL002`` unlowerable
order, ...).  Entry points:

* :func:`analyze` — run every applicable ported pass, return one report;
* :func:`pre_execution_gate` — the cheap corruption subset the backends
  run before executing a schedule; raises :class:`AnalysisError`.  Opt
  out per call with ``pre_analysis=False`` on the backend or globally
  with ``DLS_SKIP_ANALYSIS=1`` in the environment;
* :class:`IncrementalAnalyzer` — the pass suite cached per slice, for the
  placement searches (``sched/refine.py``, ``sched/search.py``);
* ``core.validate.validate_schedule`` — the historical API, a thin shim
  over the schedule and memory passes.

Ported: graph, schedule, memory, pipeline, decode, typecheck, stream,
collective (over the port's ``ProgramIR``), donation, happens-before,
lifecycle, page, sharding, quantization, cost and determinism passes, and
the ``lint --fix`` fixers.  Not ported yet: the parallel sweep and the
jaxpr walk ``analyze_collectives_jaxpr`` (with the ``collective_probe``
hooks of ``parallel/``'s strategies, ROADMAP.md A.11).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from ..core.cluster import Cluster
from ..core.graph import TaskGraph
from ..core.schedule import Schedule
from .diagnostics import (
    CODES,
    JSON_SCHEMA,
    AnalysisError,
    AnalysisReport,
    Diagnostic,
    Severity,
)
from .collective_pass import analyze_collectives, analyze_schedule_lowerability
from .cost_pass import analyze_cost
from .decode_pass import analyze_decode
from .determinism_pass import analyze_determinism
from .donation_pass import analyze_donation
from .fixes import fix_duplicate_dependencies, fix_per_node_order
from .graph_pass import analyze_graph
from .hb_pass import StageOp, analyze_happens_before, stage_programs_1f1b
from .incremental import AnalysisDelta, IncrementalAnalyzer
from .lifecycle_pass import analyze_lifecycle
from .memory_pass import analyze_memory, node_memory_slice
from .page_pass import analyze_pages, analyze_serve_artifact
from .pipeline_pass import analyze_pipeline
from .quant_pass import analyze_quantization
from .schedule_pass import analyze_schedule, placement_of
from .sharding_pass import analyze_sharding
from .stream_pass import analyze_streaming, compiled_stream_refusal, stream_verdict
from .typecheck_pass import analyze_typecheck

__all__ = [
    "CODES",
    "JSON_SCHEMA",
    "AnalysisDelta",
    "AnalysisError",
    "AnalysisReport",
    "Diagnostic",
    "IncrementalAnalyzer",
    "SKIP_ENV",
    "Severity",
    "StageOp",
    "analyze",
    "analyze_collectives",
    "analyze_cost",
    "analyze_decode",
    "analyze_determinism",
    "analyze_donation",
    "analyze_graph",
    "analyze_happens_before",
    "analyze_lifecycle",
    "analyze_memory",
    "analyze_pages",
    "analyze_pipeline",
    "analyze_quantization",
    "analyze_schedule",
    "analyze_schedule_lowerability",
    "analyze_serve_artifact",
    "analyze_sharding",
    "analyze_streaming",
    "analyze_typecheck",
    "compiled_stream_refusal",
    "fix_duplicate_dependencies",
    "fix_per_node_order",
    "gate_enabled",
    "node_memory_slice",
    "placement_of",
    "pre_execution_gate",
    "stage_programs_1f1b",
    "stream_verdict",
]

#: Setting this env var to anything non-empty (and not "0") disables the
#: backend pre-execution gate globally.
SKIP_ENV = "DLS_SKIP_ANALYSIS"


def gate_enabled() -> bool:
    from ..utils.env import env_str

    return env_str(SKIP_ENV, "0") in ("", "0")


def analyze(
    graph: TaskGraph,
    cluster: Optional[Cluster] = None,
    schedule: Optional[Schedule] = None,
    *,
    strict: bool = False,
    param_shapes: Optional[Dict[str, Tuple[int, ...]]] = None,
    mesh_axes: Optional[Dict[str, int]] = None,
    family: str = "gpt2",
    seq_parallel: bool = False,
    param_specs: Optional[Dict[str, Any]] = None,
    compiled_gb: Optional[Dict[str, float]] = None,
    analytic_gb: Optional[Dict[str, float]] = None,
    stage_programs: Optional[Dict[str, Any]] = None,
    plan: Optional[Any] = None,
    params: Optional[Dict[str, Any]] = None,
    graph_input: Any = None,
    page_events: Any = None,
    request_log: Any = None,
    request_log_final: bool = False,
    chunk_tokens: Optional[int] = None,
    decode_budget: Optional[int] = None,
) -> AnalysisReport:
    """Run every pass the provided inputs make applicable.

    Graph hygiene and the decode pass always run; schedule consistency,
    memory, pipeline, typecheck (TYP001-TYP004, fed by ``params`` —
    tensors or a table of meta tensors — and ``graph_input`` when
    available) and stream safety (STR001-STR003) run when ``cluster`` and
    ``schedule`` are given; the sharding pass runs when ``param_shapes`` +
    ``mesh_axes`` are given; the quantization pass runs when
    ``param_specs`` is given (``param_specs`` also feeds the typecheck
    pass's QNT metadata); the cost pass runs when ``compiled_gb`` (an
    ``utils.hbm.preflight_task_memory`` result, with ``analytic_gb`` the
    pre-preflight snapshot) is given; the happens-before pass runs when
    ``stage_programs`` is given; the donation pass when ``plan`` (a
    DispatchPlan/CompiledSchedule or their metadata dict) is given; the
    page-lifetime prover when ``page_events`` is given; the
    request-lifecycle checker when ``request_log`` is given.

    The returned report is stamped with ``schedule.signature()`` when a
    schedule was analyzed, so it can be handed straight back to
    :func:`pre_execution_gate` as ``precomputed=`` without re-running
    the base passes.
    """
    rep = analyze_graph(graph)
    # DEC005 (kernel eligibility) needs the pool spec shapes; either the
    # quantization spec table or the typecheck param table carries them
    rep.extend(
        analyze_decode(graph, cluster, schedule,
                       param_specs=param_specs or params,
                       chunk_tokens=chunk_tokens,
                       decode_budget=decode_budget)
    )
    if cluster is not None and schedule is not None:
        rep.extend(analyze_schedule(graph, cluster, schedule))
        rep.extend(analyze_memory(graph, cluster, schedule, strict=strict))
        rep.extend(analyze_pipeline(graph, schedule))
        rep.extend(
            analyze_typecheck(
                graph,
                cluster,
                schedule,
                params=params,
                param_specs=param_specs,
                graph_input=graph_input,
            )
        )
        rep.extend(analyze_streaming(graph, cluster, schedule))
    if param_shapes is not None and mesh_axes is not None:
        rep.extend(
            analyze_sharding(
                param_shapes,
                mesh_axes,
                family,
                seq_parallel=seq_parallel,
            )
        )
    if param_specs is not None:
        rep.extend(analyze_quantization(graph, param_specs))
    if compiled_gb is not None:
        rep.extend(analyze_cost(graph, compiled_gb, analytic_gb))
    if stage_programs is not None:
        rep.extend(analyze_happens_before(stage_programs))
    if plan is not None:
        rep.extend(analyze_donation(plan))
    if page_events is not None:
        rep.extend(analyze_pages(page_events))
    if request_log is not None:
        rep.extend(
            analyze_lifecycle(request_log, final=request_log_final)
        )
    if schedule is not None:
        rep.schedule_signature = schedule.signature()
    return rep


# Schedules the backends accept by contract are a superset of what the
# full analyzer calls clean: the device backend legalizes per-node order
# inversions (``dispatch_order``) and drops tasks whose dependencies were
# never placed (graceful degradation), and both backends accept schedules
# covering only part of the graph.  The gate therefore checks only the
# defects that would *corrupt* a replay or dispatch, per backend.
_GATE_CODES = {
    "sim": frozenset(
        {"DAG001", "DAG002", "DAG005", "DAG007", "DEC001", "DEC003",
         "SCH001", "SCH002", "SCH003", "SCH009", "PIP001", "PIP002"}
    ),
    "device": frozenset(
        {"DAG001", "DAG002", "DAG005", "DAG007", "DEC001", "DEC003",
         "SCH001", "SCH002", "SCH003"}
    ),
}


def pre_execution_gate(
    graph: TaskGraph,
    cluster: Cluster,
    schedule: Schedule,
    backend: str = "sim",
    program: Optional[Any] = None,
    plan: Optional[Any] = None,
    stage_programs: Optional[Dict[str, Any]] = None,
    precomputed: Optional[AnalysisReport] = None,
) -> Optional[AnalysisReport]:
    """Cheap (O(V+E)) corruption check run by the backends before work.

    Raises :class:`AnalysisError` when the schedule would corrupt this
    backend's execution; returns the (possibly empty) report otherwise,
    or ``None`` when the gate is disabled via ``DLS_SKIP_ANALYSIS``.

    ``precomputed``: a report :func:`analyze` just produced for THIS
    schedule — accepted, and the base passes skipped, only when its
    stamped ``schedule_signature`` matches ``schedule.signature()``; on
    any mismatch the gate silently falls back to running the passes
    itself.  Reports from other sources (e.g. ``IncrementalAnalyzer.
    report``) must not be passed here: they cover a narrower pass suite
    than the gate filters.  Extras (``program`` / ``plan`` /
    ``stage_programs``) still run fresh: the precomputed report predates
    those artifacts.

    ``program`` (compiled rung): the lowered :class:`..sched.linearize.
    ProgramIR` — the exchange-ordering pass then joins the gate (COL001
    divergent sequences, COL004 malformed permutations; COL002 deadlocks
    surface earlier, at linearization, because without a global order
    there is no program to pass here).

    ``plan`` (planned and compiled rungs): a DispatchPlan,
    CompiledSchedule, or their donation metadata — the donation pass joins
    the gate (DON001-DON003).

    ``stage_programs`` (MPMD lowerings): per-stage op sequences — the
    happens-before pass joins the gate (COL005 wait cycles, COL006
    unmatched channel cardinality; COL007 is a warning and never gates).
    """
    if not gate_enabled():
        return None
    codes = _GATE_CODES[backend]
    reused = (
        precomputed is not None
        and precomputed.schedule_signature is not None
        and precomputed.schedule_signature == schedule.signature()
    )
    if reused:
        # the caller just analyzed this exact scheduling decision: its
        # diagnostics cover everything the base passes would re-derive
        # (analyze()'s SCH004 permutation check subsumes the sim replay's
        # unplaced-order scan)
        rep = AnalysisReport(list(precomputed.diagnostics))
    else:
        rep = analyze_graph(graph)
        rep.extend(analyze_decode(graph, cluster, schedule))
        rep.extend(analyze_schedule(graph, cluster, schedule))
    if program is not None:
        rep.extend(analyze_collectives(program))
        codes = codes | {"COL001", "COL002", "COL004"}
    if plan is not None:
        rep.extend(analyze_donation(plan))
        codes = codes | {"DON001", "DON002", "DON003"}
    if stage_programs is not None:
        rep.extend(analyze_happens_before(stage_programs))
        codes = codes | {"COL005", "COL006"}
    if backend == "sim":
        if not reused:
            rep.extend(analyze_pipeline(graph, schedule))
            # the replay indexes placement[tid] for every ordered task
            placed = {t for ts in schedule.per_node.values() for t in ts}
            for tid in schedule.assignment_order:
                if tid not in placed:
                    rep.add(
                        "SCH004",
                        Severity.ERROR,
                        f"assignment_order task {tid!r} has no placement",
                        task=tid,
                    )
                    break
        codes = codes | {"SCH004"}
    gated = AnalysisReport(
        [d for d in rep.diagnostics if d.code in codes]
    )
    gated.raise_if_errors()
    return gated


def _spec_shapes(specs: Optional[Dict[str, Any]]) -> Dict[str, Tuple[int, ...]]:
    """Shape dict from a ModelDAG ``param_specs`` mapping; QParam entries
    report their int8 payload's shape (the sharded axis layout)."""
    from ..utils.quantize import QParam

    out: Dict[str, Tuple[int, ...]] = {}
    for name, spec in (specs or {}).items():
        if isinstance(spec, QParam):
            spec = spec.q
        shape = getattr(spec, "shape", None)
        if shape is not None:
            out[name] = tuple(shape)
    return out
