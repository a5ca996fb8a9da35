"""Exchange-ordering analysis (COL001, COL002, COL004) of a lowered run.

PyTorch port of ``distributed_llm_scheduler_tpu.analysis.collective_pass``,
over the port's :class:`..sched.linearize.ProgramIR`.  The compiled rung
captures a placed run as one program in which every cross-node edge is an
exchange at a phase boundary (on one card: an event recorded on the
producer's stream that the consumer's stream waits on).  Exchanges are
rendezvous points: when per-node programs disagree on which exchange
comes next, a run spread over several processes hangs.  The pass checks
the property statically:

* :func:`analyze_collectives`: every node issues the identical exchange
  sequence (COL001) and each exchange's permutation is a valid partial
  permutation over the nodes (COL004: repeated sources or destinations
  make the rendezvous ill-defined).  ``program`` may also be an explicit
  ``node -> sequence`` mapping, for tests and for lowerings whose nodes
  run different programs.
* :func:`analyze_schedule_lowerability`: a schedule whose per-node orders
  admit no global linearization at all is COL002 (the lowering cannot
  even start; see :class:`..sched.linearize.OrderingDeadlock`).

* :func:`analyze_collectives_ranks`: the reference's third entry point,
  ``analyze_collectives_jaxpr``, walks the jaxpr of one SPMD program and
  flags ``cond`` branches that issue different collectives (COL003).  The
  port's parallel layer runs a process per rank, so its counterpart runs
  the program on every rank of a simulated world
  (:func:`..parallel.simworld.run_ranks`) and flags ranks of one group
  that issue different collectives, or one that waits on a rank that
  never comes (COL003: the hang itself), and every hop whose sends are
  not a partial permutation of the group (COL004).

Wired into :func:`..analysis.pre_execution_gate` through its ``program=``
parameter: the compiled rung passes its IR, and COL001/COL002/COL004 join
the gated codes, so an ill-ordered schedule is refused before any work is
enqueued.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core.graph import TaskGraph
from ..core.schedule import Schedule
from .diagnostics import AnalysisReport, Severity

#: point-to-point primitives whose permutation COL004 checks: the port's
#: IR names its exchanges ``exchange``; ``ppermute`` is the JAX package's
#: name, accepted in sequences given by hand
POINT_TO_POINT = ("exchange", "ppermute")


def _check_perm(
    rep: AnalysisReport,
    perm: Sequence[Tuple[int, int]],
    n_devices: Optional[int],
    where: str,
) -> None:
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    bad = []
    if len(set(srcs)) != len(srcs):
        bad.append("repeated source")
    if len(set(dsts)) != len(dsts):
        bad.append("repeated destination")
    if n_devices is not None and any(
        not (0 <= i < n_devices) for i in srcs + dsts
    ):
        bad.append(f"index outside mesh of {n_devices}")
    if bad:
        rep.add(
            "COL004",
            Severity.ERROR,
            f"{where}: perm {list(perm)} is not a valid partial "
            f"permutation ({', '.join(bad)})",
        )


def analyze_collectives(
    program: Any,
    graph: Optional[TaskGraph] = None,
    schedule: Optional[Schedule] = None,
) -> AnalysisReport:
    """COL001/COL004 over a lowered program.

    ``program`` is a :class:`..sched.linearize.ProgramIR` (one sequence,
    every node's), or a plain ``device -> [(primitive, perm, value_id),
    ...]`` mapping (a lowering whose nodes run different programs, or a
    corrupted one in tests).  ``graph``/
    ``schedule`` are accepted for interface symmetry with the other
    passes and unused (the IR already encodes the placement).
    """
    del graph, schedule
    rep = AnalysisReport()
    if isinstance(program, dict):
        seqs: Dict[str, List] = {d: list(s) for d, s in program.items()}
        n_devices: Optional[int] = len(seqs) or None
    else:
        seq = program.collective_sequence()
        seqs = {d: seq for d in program.devices}
        n_devices = len(program.devices)
    if not seqs:
        return rep
    ref_dev = next(iter(seqs))
    ref = seqs[ref_dev]
    for dev, seq in seqs.items():
        if seq == ref:
            continue
        # first divergence position, for an actionable message
        pos = next(
            (
                i for i, (a, b) in enumerate(zip(ref, seq))
                if a != b
            ),
            min(len(ref), len(seq)),
        )
        a = ref[pos] if pos < len(ref) else "<end of program>"
        b = seq[pos] if pos < len(seq) else "<end of program>"
        rep.add(
            "COL001",
            Severity.ERROR,
            f"collective sequence diverges at position {pos}: "
            f"{ref_dev} issues {a}, {dev} issues {b} — a real mesh "
            "deadlocks here",
            node=dev,
        )
    for prim, perm, val in ref:
        if prim in POINT_TO_POINT:
            _check_perm(rep, perm, n_devices, f"value {val!r}")
    return rep


def analyze_collectives_ranks(run: Any, where: str = "program") -> AnalysisReport:
    """COL003/COL004 over a program run on every rank of a simulated world.

    ``run`` is the :class:`..parallel.simworld.RanksRun` of
    :func:`..parallel.simworld.run_ranks`.  Every divergence the world
    stopped at is a COL003 error; every distinct hop whose sends are not
    a valid partial permutation of its group is a COL004 error.  An
    exception a rank raised of its own is re-raised (a probe that fails
    is the sweep's COL008)."""
    if run.error is not None:
        raise run.error
    rep = AnalysisReport()
    for msg in run.divergences:
        rep.add("COL003", Severity.ERROR,
                f"{where}: {msg} — per-rank divergence: a real world hangs here")
    seen = set()
    for seq in run.sequences.values():
        for c in seq:
            if c.perm is None or (c.group, c.index) in seen:
                continue
            seen.add((c.group, c.index))
            _check_perm(rep, c.perm, len(c.group),
                        f"{where}/{c.op}#{c.index} of group {list(c.group)}")
    return rep


def analyze_schedule_lowerability(
    graph: TaskGraph,
    schedule: Schedule,
    device_order: Optional[Sequence[str]] = None,
) -> Tuple[AnalysisReport, Optional[Any]]:
    """Attempt the strict linearization + phase cut; COL002 on deadlock.

    Returns ``(report, ir)`` — ``ir`` is ``None`` exactly when the
    report carries the COL002 error (there is no program to lower).  The
    compiled rung calls this before building anything; the incremental
    analyzer caches it as its ``col`` slice.
    """
    from ..sched.linearize import OrderingDeadlock, linearize

    rep = AnalysisReport()
    try:
        ir = linearize(graph, schedule, device_order=device_order)
    except OrderingDeadlock as e:
        first = sorted(e.heads)[0] if e.heads else None
        rep.add(
            "COL002",
            Severity.ERROR,
            str(e),
            node=first,
            task=e.heads[first][0] if first else None,
            data={"heads": {
                n: {"head": t, "waits_on": list(d)}
                for n, (t, d) in e.heads.items()
            }},
        )
        return rep, None
    rep.extend(analyze_collectives(ir))
    return rep, ir
