"""Pass 8 — schedule typechecking over meta-tensor avals.

PyTorch port of ``distributed_llm_scheduler_tpu.analysis.typecheck_pass``.
An abstract interpreter that symbolically executes the placed schedule
edge-by-edge, running every task fn on ``device="meta"`` tensors (shape
and dtype, no storage: the port's counterpart of ``jax.eval_shape``; the
kernel wrappers take their plain versions for meta tensors, so nothing
launches), tolerantly, at lint time:

* ``TYP001`` (error) — a task's fn does not typecheck against the avals
  its dependency edges deliver, or its declared ``out_shape`` disagrees
  with what the fn actually produces.  One bad edge yields one
  diagnostic: unknown inputs degrade to the declared ``out_shape``
  instead of cascading.  The message ends with the first line of the
  framework's own error, which is torch's text here and JAX's there.
* ``TYP002`` (error) — illegal dtype flow across a quantized edge, per
  the QNT metadata (``param_specs`` QParam entries): a QParam-reading
  task emitting a raw int8/uint8 payload across its output edge
  (dequantization skipped), or narrowing a floating input edge to a
  lower-precision floating output (``torch.promote_types`` disagrees).
* ``TYP003`` (warning) — a cross-device edge whose aval bytes diverge
  more than :data:`_DIVERGENCE`× from the cost model's transfer charge
  (``TaskGraph.output_gb``: ``out_bytes`` when set, else
  ``memory_required``).
* ``TYP004`` (error) — the linearized :class:`..sched.linearize.ProgramIR`
  dispatches a task whose argument is not available on its device at
  that phase (not computed locally earlier, not exchanged at an earlier
  boundary), or an exchange whose source value does not exist.

Params are symbolic throughout: a ModelDAG ``param_specs`` table (meta
tensors, or QParams of them) works directly, no weight init needed.
Dtypes in messages are named as numpy names them (``bfloat16``,
``float32``), so the messages equal the JAX package's word for word.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map

from ..core.cluster import Cluster
from ..core.graph import GB, TaskGraph
from ..core.schedule import Schedule
from .diagnostics import AnalysisReport, Severity

#: TYP003 fires when aval bytes and the cost-model charge differ by more
#: than this ratio (either direction) ...
_DIVERGENCE = 2.0
#: ... and only on edges bigger than this (skip scalar/glue edges whose
#: absolute error cannot matter).
_FLOOR_GB = 1e-3


def _dtype_name(dtype: Any) -> str:
    return str(dtype).replace("torch.", "")


def _sds(x: Any) -> torch.Tensor:
    """Meta tensor of one leaf (tensor, spec, or host scalar)."""
    if isinstance(x, torch.Tensor):
        return torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")
    if not (hasattr(x, "shape") and hasattr(x, "dtype")):
        x = np.asarray(x)
    dtype = torch.from_numpy(np.empty((), dtype=x.dtype)).dtype
    return torch.empty(tuple(x.shape), dtype=dtype, device="meta")


def _as_aval(x: Any) -> Any:
    return tree_map(_sds, x)


def _leaves(x: Any) -> List[Any]:
    return tree_leaves(_as_aval(x))


def _aval_bytes(x: Any) -> int:
    return sum(leaf.numel() * leaf.element_size() for leaf in _leaves(x))


def _aval_repr(x: Any) -> str:
    if x is None:
        return "?"
    parts = [
        f"{_dtype_name(leaf.dtype)}{list(leaf.shape)}"
        for leaf in _leaves(x)
    ]
    return parts[0] if len(parts) == 1 else "(" + ", ".join(parts) + ")"


def _avals_agree(a: Any, b: Any) -> bool:
    la, ta = tree_flatten(_as_aval(a))
    lb, tb = tree_flatten(_as_aval(b))
    if ta != tb or len(la) != len(lb):
        return False
    return all(
        tuple(x.shape) == tuple(y.shape) and x.dtype == y.dtype
        for x, y in zip(la, lb)
    )


def _eval_shape(fn: Any, *args: Any) -> Any:
    """``fn`` run on meta tensors: the output's avals, nothing computed."""
    with torch.no_grad():
        return _as_aval(fn(*args))


def _first_line(exc: BaseException) -> str:
    text = str(exc).strip() or type(exc).__name__
    return text.splitlines()[0]


def build_param_avals(
    graph: TaskGraph,
    params: Optional[Dict[str, Any]] = None,
    param_specs: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Aval pytree per global param the graph reads, from concrete host
    params or a ModelDAG ``param_specs`` table (QParam spec pytrees map
    leaf-wise, preserving the int8/float32 component dtypes)."""
    source = params if params is not None else (param_specs or {})
    out: Dict[str, Any] = {}
    for g in graph.unique_params():
        if g in source:
            out[g] = _as_aval(source[g])
    return out


def propagate_schedule_avals(
    graph: TaskGraph,
    *,
    params: Optional[Dict[str, Any]] = None,
    param_specs: Optional[Dict[str, Any]] = None,
    graph_input: Any = None,
) -> Tuple[Dict[str, Any], AnalysisReport]:
    """TYP001: tolerant meta-tensor propagation along the topo order.

    Returns ``(avals, report)`` where ``avals[tid]`` is the task's output
    aval pytree or ``None`` when undeterminable (fn-less synthetic task
    with no ``out_shape``, or inputs unknown).  Placement-independent:
    the incremental engine caches this slice across ``move_task`` calls.
    """
    rep = AnalysisReport()
    avals: Dict[str, Any] = {}
    try:
        order = graph.topo_order
    except Exception:
        return avals, rep  # cyclic graph: DAG001 territory
    param_avals = build_param_avals(graph, params, param_specs)
    in_aval = _as_aval(graph_input) if graph_input is not None else None
    for tid in order:
        task = graph[tid]
        declared = _as_aval(task.out_shape) if task.out_shape is not None else None
        computed = None
        if task.fn is not None:
            aids = task.arg_tasks or task.dependencies
            args = [avals.get(d) for d in aids] if aids else [in_aval]
            pitems = task.param_items()
            if all(g in param_avals for _, g in pitems) and all(
                a is not None for a in args
            ):
                pd = {loc: param_avals[g] for loc, g in pitems}
                try:
                    computed = _eval_shape(task.fn, pd, *args)
                except Exception as e:
                    edges = ", ".join(
                        f"{d}: {_aval_repr(avals.get(d))}" for d in aids
                    )
                    rep.add(
                        "TYP001",
                        Severity.ERROR,
                        f"{tid!r} does not typecheck against its input "
                        f"edges ({edges or 'graph input'}): "
                        f"{_first_line(e)}",
                        task=tid,
                        data={
                            "args": {d: _aval_repr(avals.get(d)) for d in aids},
                        },
                    )
        if (
            computed is not None
            and declared is not None
            and not _avals_agree(computed, declared)
        ):
            rep.add(
                "TYP001",
                Severity.ERROR,
                f"{tid!r} declares out_shape {_aval_repr(declared)} but its "
                f"fn produces {_aval_repr(computed)}",
                task=tid,
                data={
                    "declared": _aval_repr(declared),
                    "computed": _aval_repr(computed),
                },
            )
        if computed is not None:
            avals[tid] = computed  # trust the interpreter over declarations
        elif declared is not None:
            avals[tid] = declared
        else:
            avals[tid] = None
    return avals, rep


def check_quantized_edges(
    graph: TaskGraph,
    avals: Dict[str, Any],
    param_specs: Optional[Dict[str, Any]],
) -> AnalysisReport:
    """TYP002: dtype-promotion legality across quantized edges.

    Scoped to tasks reading QParam weights (the QNT metadata) so ordinary
    integer edges — token ids, argmax outputs, routing indices — never
    false-positive."""
    rep = AnalysisReport()
    if not param_specs:
        return rep
    from ..utils.quantize import QParam

    qnames = {g for g, s in param_specs.items() if isinstance(s, QParam)}
    if not qnames:
        return rep
    raw = (torch.int8, torch.uint8)

    def widest_float(x: Any):
        dt = None
        for leaf in _leaves(x):
            if leaf.dtype.is_floating_point:
                dt = leaf.dtype if dt is None else torch.promote_types(dt, leaf.dtype)
        return dt

    try:
        order = graph.topo_order
    except Exception:
        return rep
    for tid in order:
        task = graph[tid]
        if not any(g in qnames for _, g in task.param_items()):
            continue
        out = avals.get(tid)
        if out is None:
            continue
        raw_leaves = sorted(
            {_dtype_name(leaf.dtype) for leaf in _leaves(out)
             if leaf.dtype in raw}
        )
        consumers = graph.dependents(tid)
        if raw_leaves and consumers:
            rep.add(
                "TYP002",
                Severity.ERROR,
                f"{tid!r} reads quantized weights but sends raw "
                f"{'/'.join(raw_leaves)} across its output edge "
                f"(dequantization skipped)",
                task=tid,
                data={"dtypes": raw_leaves, "consumers": sorted(consumers)},
            )
        out_f = widest_float(out)
        if out_f is None:
            continue
        for d in task.arg_tasks or task.dependencies:
            src_f = widest_float(avals.get(d))
            if src_f is None:
                continue
            kept = torch.promote_types(src_f, out_f)
            if kept != out_f:
                rep.add(
                    "TYP002",
                    Severity.ERROR,
                    f"edge {d!r} -> {tid!r} narrows "
                    f"{_dtype_name(src_f)} to {_dtype_name(out_f)} "
                    f"across a quantized task (promotion would keep "
                    f"{_dtype_name(kept)})",
                    task=tid,
                    data={
                        "src_dtype": _dtype_name(src_f),
                        "out_dtype": _dtype_name(out_f),
                        "producer": d,
                    },
                )
    return rep


def check_transfer_bytes(
    graph: TaskGraph,
    schedule: Schedule,
    avals: Dict[str, Any],
    *,
    edges: Optional[Iterable[Tuple[str, str]]] = None,
    placement: Optional[Dict[str, str]] = None,
) -> AnalysisReport:
    """TYP003: cross-device edges whose aval bytes diverge >2x from the
    cost model's transfer charge.  ``edges`` restricts the sweep (the
    incremental engine passes just the edges incident to a moved task);
    default is every dependency edge in the graph."""
    rep = AnalysisReport()
    placement = placement if placement is not None else schedule.placement
    if edges is None:
        edges = [
            (d, tid)
            for tid in graph.task_ids()
            for d in (graph[tid].arg_tasks or graph[tid].dependencies)
        ]
    seen = set()
    for u, v in edges:
        if u not in graph or v not in graph:
            continue
        nu, nv = placement.get(u), placement.get(v)
        if nu is None or nv is None or nu == nv:
            continue
        a = avals.get(u)
        if a is None:
            continue
        aval_gb = _aval_bytes(a) / GB
        charged = graph.output_gb(u)
        hi, lo = max(aval_gb, charged), min(aval_gb, charged)
        if hi <= _FLOOR_GB or hi <= _DIVERGENCE * max(lo, 1e-12):
            continue
        # one finding per (u, v) EDGE, never collapsed across consumers:
        # the incremental engine re-derives exactly the edges incident to
        # a moved task, which only composes if slices are per-edge
        key = (u, v)
        if key in seen:
            continue
        seen.add(key)
        basis = "out_bytes" if graph[u].out_bytes is not None else "memory_required"
        rep.add(
            "TYP003",
            Severity.WARNING,
            f"edge {u!r} -> {v!r} moves {aval_gb:.3f} GB by aval but the "
            f"cost model charges {charged:.3f} GB ({basis}); CST "
            f"calibration and MEM residency derived from it are off by "
            f">{_DIVERGENCE:.0f}x",
            task=u,
            node=nv,
            data={
                "aval_gb": aval_gb,
                "charged_gb": charged,
                "basis": basis,
                "consumer": v,
            },
        )
    return rep


def check_program_arity(graph: TaskGraph, ir: Any) -> AnalysisReport:
    """TYP004: every argument of every dispatched task must be available
    on its device at its phase — computed there earlier, or delivered by
    an exchange at a strictly earlier boundary (exchanges at boundary
    ``b`` publish into phases ``> b``) — and every exchange must name a
    value its source device has actually computed.  A violation is the
    static form of a missing value inside ``CompiledSchedule.build``."""
    rep = AnalysisReport()
    devices = set(ir.devices)
    phase_of: Dict[str, int] = {}
    node_of: Dict[str, str] = {}
    pos_in_phase: Dict[str, int] = {}
    for ph in ir.phases:
        for n, tids in ph.compute.items():
            for i, t in enumerate(tids):
                phase_of[t] = ph.index
                node_of[t] = n
                pos_in_phase[t] = i
    # (value, dst) -> earliest boundary it is exchanged at
    delivered: Dict[Tuple[str, str], int] = {}
    for ph in ir.phases:
        for ex in ph.exchanges:
            src_phase = phase_of.get(ex.tid)
            if src_phase is None or node_of.get(ex.tid) != ex.src:
                rep.add(
                    "TYP004",
                    Severity.ERROR,
                    f"exchange at boundary {ph.index} ships {ex.tid!r} from "
                    f"{ex.src} but {ex.src} never computes it",
                    task=ex.tid,
                    node=ex.src,
                    data={"boundary": ph.index},
                )
                continue
            if src_phase > ph.index:
                rep.add(
                    "TYP004",
                    Severity.ERROR,
                    f"exchange at boundary {ph.index} ships {ex.tid!r} "
                    f"before {ex.src} computes it (phase {src_phase})",
                    task=ex.tid,
                    node=ex.src,
                    data={"boundary": ph.index, "src_phase": src_phase},
                )
                continue
            if ex.dst not in devices or ex.src not in devices:
                rep.add(
                    "TYP004",
                    Severity.ERROR,
                    f"exchange of {ex.tid!r} names a device outside the "
                    f"mesh ({ex.src} -> {ex.dst})",
                    task=ex.tid,
                    data={"src": ex.src, "dst": ex.dst},
                )
                continue
            key = (ex.tid, ex.dst)
            if key not in delivered or ph.index < delivered[key]:
                delivered[key] = ph.index
    for ph in ir.phases:
        for n, tids in ph.compute.items():
            for i, t in enumerate(tids):
                if t not in graph:
                    rep.add(
                        "TYP004",
                        Severity.ERROR,
                        f"program dispatches {t!r} which is not a graph task",
                        task=t,
                        node=n,
                    )
                    continue
                for d in graph[t].arg_tasks or graph[t].dependencies:
                    if d not in phase_of:
                        rep.add(
                            "TYP004",
                            Severity.ERROR,
                            f"{t!r} on {n} (phase {ph.index}) consumes "
                            f"{d!r}, which the program never computes",
                            task=t,
                            node=n,
                            data={"phase": ph.index, "arg": d},
                        )
                        continue
                    if node_of[d] == n:
                        ok = phase_of[d] < ph.index or (
                            phase_of[d] == ph.index and pos_in_phase[d] < i
                        )
                        if not ok:
                            rep.add(
                                "TYP004",
                                Severity.ERROR,
                                f"{t!r} on {n} (phase {ph.index}) consumes "
                                f"{d!r} before it runs (phase "
                                f"{phase_of[d]})",
                                task=t,
                                node=n,
                                data={"phase": ph.index, "arg": d},
                            )
                    else:
                        b = delivered.get((d, n))
                        if b is None or b >= ph.index:
                            rep.add(
                                "TYP004",
                                Severity.ERROR,
                                f"{t!r} on {n} (phase {ph.index}) consumes "
                                f"{d!r} from {node_of[d]} with no exchange "
                                f"at an earlier boundary",
                                task=t,
                                node=n,
                                data={
                                    "phase": ph.index,
                                    "arg": d,
                                    "producer_node": node_of[d],
                                },
                            )
    return rep


def analyze_typecheck(
    graph: TaskGraph,
    cluster: Optional[Cluster] = None,
    schedule: Optional[Schedule] = None,
    *,
    params: Optional[Dict[str, Any]] = None,
    param_specs: Optional[Dict[str, Any]] = None,
    graph_input: Any = None,
    ir: Any = None,
) -> AnalysisReport:
    """Run the full typecheck pass: TYP001/TYP002 always (they are
    placement-independent), TYP003/TYP004 when a placement exists.
    ``ir`` skips the internal :func:`..sched.linearize.linearize` when the
    caller already lowered; an un-linearizable schedule (per-node order
    deadlock) skips TYP004 — that is COL002's finding, not ours."""
    avals, rep = propagate_schedule_avals(
        graph,
        params=params,
        param_specs=param_specs,
        graph_input=graph_input,
    )
    rep.extend(check_quantized_edges(graph, avals, param_specs))
    if schedule is not None:
        rep.extend(check_transfer_bytes(graph, schedule, avals))
        if ir is None:
            try:
                from ..sched.linearize import linearize

                device_order = (
                    [d.node_id for d in cluster] if cluster is not None else None
                )
                ir = linearize(graph, schedule, device_order=device_order)
            except Exception:
                ir = None  # deadlocked/corrupt schedule: COL002/SCH territory
        if ir is not None:
            rep.extend(check_program_arity(graph, ir))
    return rep
