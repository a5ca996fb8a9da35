"""Incremental re-analysis engine for placement search.

A placement search (:mod:`..sched.search`, :mod:`..sched.refine`) wants
to validate thousands of candidate ``task -> device`` moves per second;
re-running the whole pass suite per candidate is O(V+E) python plus a
meta-tensor sweep of every fn — three orders of magnitude too slow.  This module
exploits how each pass's diagnostics *factor* over provenance slices:

* graph hygiene, aval propagation (TYP001/TYP002), MEM004, and donation
  metadata are **placement-independent** — computed once, cached under
  the ``("graph",)`` / ``("typ-graph",)`` / ``("mem-global",)`` /
  ``("don",)`` keys;
* memory residency accumulates **independently per node**
  (``memory_pass.node_memory_slice``) — a move invalidates exactly the
  ``("mem", src)`` and ``("mem", dst)`` slices;
* TYP003 factors **per dependency edge** — a move changes the
  cross-device-ness only of edges incident to the moved task, so only
  their ``("typ-edge", u, v)`` slices recompute;
* schedule consistency, collective lowerability (COL), and program
  arity (TYP004) are **invariant under the move rule** below: with a
  clean baseline, ``move_task`` preserves every property they check, so
  their slices are cached.  (Proof sketch: the global
  ``assignment_order`` never changes and stays SCH009-clean; the moved
  task is re-inserted so every per-node list remains a subsequence of
  it, which keeps SCH005 clean and — because the earliest unemitted
  placed task is then always an emittable queue head — keeps
  ``strict_dispatch_order`` deadlock-free; a successful ``linearize``
  satisfies register availability by construction.)

When the baseline is *not* clean of graph/SCH/COL/TYP004 errors the
invariants above do not hold; the analyzer then degrades to a full
recompute per move — still exact, just not fast.  ``verify()`` is the
contract's enforcement: it re-runs the full suite fresh on the current
(post-moves) schedule and asserts the cached state matches diagnostic-
for-diagnostic (compared on ``(code, severity, message, task, node,
param)`` — the same identity ``Diagnostic.__eq__`` uses).

The suite covers the placement-relevant families —
MEM/SCH/TYP/COL (+DON when donation metadata is supplied) plus graph
hygiene; decode/pipeline/sharding passes are placement-shape-independent
or schedule-free and stay with the batch :func:`..analyze` entry point.

PyTorch port's copy of ``distributed_llm_scheduler_tpu.analysis.incremental``;
its suite is the port's passes, so its slices, deltas and fast-path
verdicts are the JAX package's.
"""

from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..core.cluster import Cluster
from ..core.graph import TaskGraph
from ..core.schedule import Schedule
from .collective_pass import analyze_schedule_lowerability
from .diagnostics import AnalysisReport, Diagnostic, Severity
from .donation_pass import analyze_donation
from .graph_pass import analyze_graph
from .memory_pass import _param_sizes_gb, analyze_memory, node_memory_slice
from .schedule_pass import analyze_schedule
from .typecheck_pass import (
    check_program_arity,
    check_quantized_edges,
    check_transfer_bytes,
    propagate_schedule_avals,
)

Edge = Tuple[str, str]


@dataclass
class AnalysisDelta:
    """Outcome of one :meth:`IncrementalAnalyzer.move_task`."""

    tid: str
    src: str
    dst: str
    added: List[Diagnostic] = field(default_factory=list)
    removed: List[Diagnostic] = field(default_factory=list)
    #: which cache slices were recomputed (human-readable keys)
    recomputed: Tuple[str, ...] = ()
    wall_s: float = 0.0

    @property
    def ok(self) -> bool:
        """No *new* error appeared — the static go/no-go a search loop
        keys on before paying for an eventsim replay."""
        return not any(d.severity == Severity.ERROR for d in self.added)


class IncrementalAnalyzer:
    """Run the pass suite once, then re-validate ``task -> device`` moves
    against cached per-slice diagnostics.

    The analyzer owns a private copy of the schedule: moves mutate the
    copy (read it back via :attr:`schedule` / :attr:`placement`), never
    the caller's object.  Typecheck inputs (``params`` / ``param_specs``
    / ``graph_input``) are optional — without them the TYP slices cover
    whatever avals are derivable from declared ``out_shape``s, exactly
    like the batch pass.
    """

    def __init__(
        self,
        graph: TaskGraph,
        cluster: Cluster,
        schedule: Schedule,
        *,
        params: Optional[Dict[str, Any]] = None,
        param_specs: Optional[Dict[str, Any]] = None,
        graph_input: Any = None,
        plan: Any = None,
        strict: bool = False,
    ):
        self.graph = graph
        self.cluster = cluster
        self.strict = strict
        self._params = params
        self._param_specs = param_specs
        self._graph_input = graph_input
        self._plan = plan
        self.schedule = Schedule(
            policy=schedule.policy,
            per_node={n: list(ts) for n, ts in schedule.per_node.items()},
            assignment_order=list(schedule.assignment_order),
            completed=set(schedule.completed),
            failed=set(schedule.failed),
        )
        self._node_ids = [d.node_id for d in cluster]
        self._pos = {t: i for i, t in enumerate(self.schedule.assignment_order)}
        self._sizes = _param_sizes_gb(graph)
        # dependency edges incident to each task (for TYP003 slicing)
        self._incident: Dict[str, List[Edge]] = {}
        try:
            tids = graph.task_ids()
        except Exception:
            tids = []
        for tid in tids:
            for d in graph[tid].arg_tasks or graph[tid].dependencies:
                e = (d, tid)
                self._incident.setdefault(d, []).append(e)
                if tid != d:
                    self._incident.setdefault(tid, []).append(e)
        self._placement = dict(self.schedule.placement)
        self._avals: Dict[str, Any] = {}
        self._slices: Dict[Tuple, List[Diagnostic]] = {}
        self._typ3: Dict[Edge, List[Diagnostic]] = {}
        self._recompute_all()
        self._fast = self._baseline_clean()
        self.moves = 0

    # -- suite ------------------------------------------------------------

    def _run_suite(self, schedule: Schedule) -> Tuple[
        Dict[Tuple, List[Diagnostic]],
        Dict[Edge, List[Diagnostic]],
        Dict[str, Any],
    ]:
        """The full pass suite on ``schedule``, factored into cache
        slices.  Shared by construction, degraded-mode moves, and
        :meth:`verify` so the cached and fresh paths cannot diverge."""
        slices: Dict[Tuple, List[Diagnostic]] = {}
        slices[("graph",)] = analyze_graph(self.graph).diagnostics
        slices[("sched",)] = analyze_schedule(
            self.graph, self.cluster, schedule
        ).diagnostics
        mem = analyze_memory(self.graph, self.cluster, schedule, strict=self.strict)
        slices[("mem-global",)] = [
            d for d in mem.diagnostics if d.code == "MEM004"
        ]
        for nid in self._node_ids:
            slices[("mem", nid)] = [
                d for d in mem.diagnostics
                if d.code != "MEM004" and d.node == nid
            ]
        avals, typrep = propagate_schedule_avals(
            self.graph,
            params=self._params,
            param_specs=self._param_specs,
            graph_input=self._graph_input,
        )
        typrep.extend(
            check_quantized_edges(self.graph, avals, self._param_specs)
        )
        slices[("typ-graph",)] = typrep.diagnostics
        placement = schedule.placement
        t3 = check_transfer_bytes(
            self.graph, schedule, avals, placement=placement
        )
        typ3: Dict[Edge, List[Diagnostic]] = {}
        for d in t3.diagnostics:
            typ3.setdefault((d.task, d.data.get("consumer")), []).append(d)
        colrep, ir = analyze_schedule_lowerability(
            self.graph, schedule, device_order=self._node_ids
        )
        slices[("col",)] = colrep.diagnostics
        slices[("typ-ir",)] = (
            check_program_arity(self.graph, ir).diagnostics
            if ir is not None
            else []
        )
        slices[("don",)] = (
            analyze_donation(self._plan).diagnostics
            if self._plan is not None
            else []
        )
        return slices, typ3, avals

    def _recompute_all(self) -> None:
        self._slices, self._typ3, self._avals = self._run_suite(self.schedule)
        self._placement = dict(self.schedule.placement)

    def _baseline_clean(self) -> bool:
        """Exactness precondition for the fast path: no errors in the
        slices whose invariance the move rule relies on."""
        for key in (("graph",), ("sched",), ("col",), ("typ-ir",)):
            if any(
                d.severity == Severity.ERROR for d in self._slices.get(key, [])
            ):
                return False
        return True

    # -- views ------------------------------------------------------------

    @property
    def exact_fast_path(self) -> bool:
        """True when moves recompute only the affected slices; False when
        a dirty baseline forces full (but still exact) recomputes."""
        return self._fast

    @property
    def placement(self) -> Dict[str, str]:
        return dict(self._placement)

    def _all_diagnostics(self) -> List[Diagnostic]:
        out: List[Diagnostic] = []
        for key in (("graph",), ("sched",), ("mem-global",)):
            out.extend(self._slices.get(key, []))
        for nid in self._node_ids:
            out.extend(self._slices.get(("mem", nid), []))
        out.extend(self._slices.get(("typ-graph",), []))
        for e in sorted(self._typ3, key=lambda e: (str(e[0]), str(e[1]))):
            out.extend(self._typ3[e])
        for key in (("typ-ir",), ("col",), ("don",)):
            out.extend(self._slices.get(key, []))
        return out

    @property
    def report(self) -> AnalysisReport:
        """The current cached state as one report, stamped with the
        current schedule signature.  NOTE: this is the incremental suite
        (graph/SCH/MEM/TYP/COL/DON), not the full :func:`..analyze` set —
        do not feed it to ``pre_execution_gate(precomputed=...)``, which
        expects the decode/pipeline passes to be present."""
        rep = AnalysisReport(self._all_diagnostics())
        rep.schedule_signature = self.schedule.signature()
        return rep

    def error_count(self) -> int:
        return sum(
            1 for d in self._all_diagnostics()
            if d.severity == Severity.ERROR
        )

    # -- moves ------------------------------------------------------------

    def move_task(self, tid: str, dst: str) -> AnalysisDelta:
        """Re-place ``tid`` onto ``dst`` and re-validate.

        The task keeps its global ``assignment_order`` position; it is
        inserted into ``dst``'s list at the position that keeps the list
        a subsequence of the global order (the invariant the cached
        SCH/COL/TYP004 slices rely on).  Returns the diagnostic delta;
        ``move_task(tid, delta.src)`` is an exact undo.
        """
        # dls-lint: allow(DET001) delta.wall_s is reported metadata
        t0 = time.perf_counter()
        if dst not in self.cluster:
            raise KeyError(f"unknown device {dst!r}")
        src = self._placement.get(tid)
        if src is None:
            raise KeyError(f"{tid!r} is not placed")
        if dst == src:
            # dls-lint: allow(DET001) reported metadata
            return AnalysisDelta(tid, src, dst, wall_s=time.perf_counter() - t0)

        self.schedule.per_node[src].remove(tid)
        lst = self.schedule.per_node.setdefault(dst, [])
        pos = self._pos.get(tid)
        if pos is None:
            lst.append(tid)
            self._fast = False  # outside the order: invariants void
        else:
            i = 0
            while i < len(lst) and self._pos.get(lst[i], pos + 1) < pos:
                i += 1
            lst.insert(i, tid)
        self._placement[tid] = dst
        self.moves += 1

        old_lists: List[List[Diagnostic]] = []
        new_lists: List[List[Diagnostic]] = []
        recomputed: List[str] = []
        if self._fast:
            for nid in (src, dst):
                key = ("mem", nid)
                old_lists.append(self._slices.get(key, []))
                fresh = node_memory_slice(
                    self.graph, self.cluster, self.schedule, nid,
                    self.strict, _placed=self._placement, _sizes=self._sizes,
                ).diagnostics
                self._slices[key] = fresh
                new_lists.append(fresh)
                recomputed.append(f"mem:{nid}")
            incident = self._incident.get(tid, [])
            if incident:
                rep3 = check_transfer_bytes(
                    self.graph, self.schedule, self._avals,
                    edges=incident, placement=self._placement,
                )
                fresh3: Dict[Edge, List[Diagnostic]] = {e: [] for e in incident}
                for d in rep3.diagnostics:
                    fresh3[(d.task, d.data.get("consumer"))].append(d)
                for e, diags in fresh3.items():
                    old_lists.append(self._typ3.pop(e, []))
                    if diags:
                        self._typ3[e] = diags
                    new_lists.append(diags)
                recomputed.append(f"typ-edge:x{len(incident)}")
        else:
            old_lists.append(self._all_diagnostics())
            self._recompute_all()
            new_lists.append(self._all_diagnostics())
            recomputed.append("all")

        old_c: Counter = Counter()
        new_c: Counter = Counter()
        for lst_ in old_lists:
            old_c.update(lst_)
        for lst_ in new_lists:
            new_c.update(lst_)
        return AnalysisDelta(
            tid,
            src,
            dst,
            added=list((new_c - old_c).elements()),
            removed=list((old_c - new_c).elements()),
            recomputed=tuple(recomputed),
            # dls-lint: allow(DET001) reported metadata
            wall_s=time.perf_counter() - t0,
        )

    # -- verification -----------------------------------------------------

    def verify(self) -> AnalysisReport:
        """Re-run the FULL suite fresh on the current schedule and assert
        the cached state matches it exactly; returns the fresh report.
        Raises :class:`AssertionError` naming the first divergence — a
        failure here means an incremental invariant is wrong, never that
        the schedule is bad."""
        slices, typ3, _ = self._run_suite(self.schedule)
        fresh: List[Diagnostic] = []
        for diags in slices.values():
            fresh.extend(diags)
        for diags in typ3.values():
            fresh.extend(diags)

        def key(d: Diagnostic) -> Tuple:
            return (
                d.code, int(d.severity), d.message,
                d.task or "", d.node or "", d.param or "",
            )

        have = sorted(key(d) for d in self._all_diagnostics())
        want = sorted(key(d) for d in fresh)
        if have != want:
            missing = list((Counter(want) - Counter(have)).elements())
            spurious = list((Counter(have) - Counter(want)).elements())
            raise AssertionError(
                "incremental state diverged from fresh analysis after "
                f"{self.moves} move(s): missing={missing[:3]!r} "
                f"spurious={spurious[:3]!r}"
            )
        rep = AnalysisReport(fresh)
        rep.schedule_signature = self.schedule.signature()
        return rep
