"""Per-device linearization of a placed schedule into a phase/exchange IR.

PyTorch port of ``distributed_llm_scheduler_tpu.sched.linearize``; pure
Python, so structure and results are identical to the reference's.

The compiled execution path (backends/compiled_schedule.py) captures the
ENTIRE placed run into one CUDA graph: each node's tasks on that node's
stream, each cross-node edge an event recorded on the producer's stream
and waited on by the consumer's.  A captured program has no host to
re-order work at run time, so the lowering cannot reuse
:meth:`DeviceBackend.dispatch_order`'s silent topological fallback.  This
module produces the intermediate representation the lowering reads:

* :func:`strict_dispatch_order` -- the same greedy per-node-order merge as
  the interpreted path, but a cross-node ordering cycle raises
  :class:`OrderingDeadlock` (carrying the stuck queue heads) instead of
  silently re-linearizing;
* :func:`linearize` -- cuts that global order into **phases** (per-node
  compute blocks separated by cross-node exchanges): a task lands in the
  earliest phase after every cross-node producer has been exchanged,
  never earlier than its same-node predecessor in the schedule's per-node
  order.  Phase boundaries carry the ordered :class:`Exchange` list.

:meth:`ProgramIR.signature` gives the deterministic identity the
compiled-program cache keys off.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.graph import TaskGraph
from ..core.schedule import Schedule


class OrderingDeadlock(RuntimeError):
    """Per-node orders are mutually inconsistent: the greedy merge stalled
    with every queue head waiting on a task stuck behind another head.

    ``heads`` maps each stalled node to its blocking queue head and the
    unmet dependencies that head is waiting for.
    """

    def __init__(self, heads: Dict[str, Tuple[str, Tuple[str, ...]]]):
        self.heads = dict(heads)
        detail = "; ".join(
            f"{node}: {tid!r} waits on {list(deps)}"
            for node, (tid, deps) in sorted(self.heads.items())
        )
        super().__init__(
            f"per-node orders admit no global dispatch order ({detail})"
        )


def strict_dispatch_order(
    graph: TaskGraph, schedule: Schedule
) -> List[str]:
    """Global linearization honoring per-node order — or a hard error.

    Identical greedy merge to ``DeviceBackend.dispatch_order`` (emit the
    earliest-assigned ready queue head), except that a stall raises
    :class:`OrderingDeadlock` rather than falling back to topological
    order: a compiled program built from a re-linearized order would run,
    but its exchange sequence would no longer be the schedule the
    policy decided — and in a true MPMD deployment the divergence is a
    deadlock, so it must surface as an error here.
    """
    placement = schedule.placement
    topo_pos = {tid: i for i, tid in enumerate(graph.topo_order)}
    prio = {tid: i for i, tid in enumerate(schedule.assignment_order)}
    queues = {
        n: [t for t in lst if t in topo_pos and placement.get(t) == n]
        for n, lst in schedule.per_node.items()
        if lst
    }
    queues = {n: q for n, q in queues.items() if q}
    idx = {n: 0 for n in queues}
    emitted: set = set()
    order: List[str] = []

    def unmet(t: str) -> Tuple[str, ...]:
        return tuple(
            d for d in graph[t].dependencies
            if d not in emitted and d in placement
        )

    total = sum(len(q) for q in queues.values())
    while len(order) < total:
        ready = [
            n for n in queues
            if idx[n] < len(queues[n]) and not unmet(queues[n][idx[n]])
        ]
        if not ready:
            heads = {
                n: (queues[n][idx[n]], unmet(queues[n][idx[n]]))
                for n in queues
                if idx[n] < len(queues[n])
            }
            raise OrderingDeadlock(heads)
        n = min(
            ready,
            key=lambda n: (
                prio.get(queues[n][idx[n]], topo_pos[queues[n][idx[n]]]),
                topo_pos[queues[n][idx[n]]],
            ),
        )
        t = queues[n][idx[n]]
        idx[n] += 1
        emitted.add(t)
        order.append(t)
    return order


@dataclass(frozen=True)
class Exchange:
    """One cross-node value movement at a phase boundary: the value of
    ``tid`` (computed on ``src``) becomes available on ``dst``.  Lowered
    as an event recorded on ``src``'s stream that ``dst``'s stream waits
    on (nodes on one card share its memory, so nothing is copied)."""

    tid: str
    src: str
    dst: str


@dataclass(frozen=True)
class Phase:
    """One compute block: every device runs its ``compute`` tasks (in
    per-node schedule order), then all devices issue ``exchanges`` in
    listed order."""

    index: int
    compute: Dict[str, Tuple[str, ...]]
    exchanges: Tuple[Exchange, ...]


@dataclass(frozen=True)
class ProgramIR:
    """The whole-program lowering plan: devices in mesh order, the global
    linearization, and the phase/exchange alternation."""

    devices: Tuple[str, ...]
    order: Tuple[str, ...]
    phases: Tuple[Phase, ...]

    @property
    def device_index(self) -> Dict[str, int]:
        return {d: i for i, d in enumerate(self.devices)}

    def collective_sequence(
        self,
    ) -> List[Tuple[str, Tuple[Tuple[int, int], ...], str]]:
        """The ordered exchanges the lowered program issues, as
        ``(primitive, perm, value_id)`` tuples (``primitive`` is
        ``"exchange"``, ``perm`` the ``((src_index, dst_index),)`` pair
        over :attr:`devices`).  Every node walks the same phase boundaries
        in the same order, so one sequence is every node's."""
        dix = self.device_index
        seq = []
        for ph in self.phases:
            for ex in ph.exchanges:
                seq.append(
                    ("exchange", ((dix[ex.src], dix[ex.dst]),), ex.tid)
                )
        return seq

    def signature(self) -> Tuple:
        """Hashable structural identity: equal signatures lower to the
        same program (deterministic-lowering contract)."""
        return (
            self.devices,
            self.order,
            tuple(
                (
                    ph.index,
                    tuple(sorted(
                        (n, ts) for n, ts in ph.compute.items()
                    )),
                    ph.exchanges,
                )
                for ph in self.phases
            ),
        )

    @property
    def n_exchanges(self) -> int:
        return sum(len(ph.exchanges) for ph in self.phases)


def linearize(
    graph: TaskGraph,
    schedule: Schedule,
    order: Optional[Sequence[str]] = None,
    device_order: Optional[Sequence[str]] = None,
) -> ProgramIR:
    """Cut a verified global order into the phase/exchange IR.

    ``order`` defaults to :func:`strict_dispatch_order` (raising
    :class:`OrderingDeadlock` on inconsistent per-node orders).  Tasks
    with unplaced (or transitively skipped) producers are dropped, like
    every execution path.  ``device_order`` fixes the mesh axis order
    (defaults to first-appearance order of nodes in the schedule's
    cluster iteration — callers pass the cluster's device order so mesh
    index == cluster index).

    Phase assignment: ``phase(t) = max(phase(same-device deps),
    phase(cross-device deps) + 1, phase(previous task on t's device))``.
    Each cross-device edge becomes an :class:`Exchange` at the boundary
    just before its consumer's phase, deduplicated per (value, dst) to
    the earliest consumer (received values persist in the consumer's
    registers).  Exchange order within a boundary is deterministic:
    producer's global-order position, then destination mesh index.
    """
    placement = schedule.placement
    if order is None:
        order = strict_dispatch_order(graph, schedule)
    # drop tasks whose transitive producers never run (fail-and-continue,
    # same filter as the segmented runner)
    alive: set = set()
    kept: List[str] = []
    for tid in order:
        if tid not in placement:
            continue
        aids = graph[tid].arg_tasks or graph[tid].dependencies
        if all(d in alive for d in aids):
            alive.add(tid)
            kept.append(tid)
    order = kept

    if device_order is None:
        seen: Dict[str, None] = {}
        for tid in order:
            seen.setdefault(placement[tid])
        devices = tuple(seen)
    else:
        used = {placement[t] for t in order}
        devices = tuple(d for d in device_order if d in used)

    opos = {t: i for i, t in enumerate(order)}
    dix = {d: i for i, d in enumerate(devices)}
    phase_of: Dict[str, int] = {}
    last_on: Dict[str, int] = {}
    for tid in order:
        node = placement[tid]
        p = last_on.get(node, 0)
        for d in graph[tid].arg_tasks or graph[tid].dependencies:
            if d not in phase_of:
                continue  # graph input / ext value: phase 0 is fine
            if placement[d] == node:
                p = max(p, phase_of[d])
            else:
                p = max(p, phase_of[d] + 1)
        phase_of[tid] = p
        last_on[node] = p

    n_phases = (max(phase_of.values()) + 1) if phase_of else 0
    compute: List[Dict[str, List[str]]] = [{} for _ in range(n_phases)]
    for tid in order:
        compute[phase_of[tid]].setdefault(placement[tid], []).append(tid)

    # one exchange per (value, dst), at the earliest consuming boundary
    first_need: Dict[Tuple[str, str], int] = {}
    for tid in order:
        node = placement[tid]
        for d in graph[tid].arg_tasks or graph[tid].dependencies:
            if d in phase_of and placement[d] != node:
                key = (d, node)
                b = phase_of[tid] - 1
                if key not in first_need or b < first_need[key]:
                    first_need[key] = b
    exchanges: List[List[Exchange]] = [[] for _ in range(n_phases)]
    for (val, dst), b in first_need.items():
        exchanges[b].append(Exchange(val, placement[val], dst))
    for b in range(n_phases):
        exchanges[b].sort(key=lambda ex: (opos[ex.tid], dix[ex.dst]))

    phases = tuple(
        Phase(
            index=p,
            compute={n: tuple(ts) for n, ts in compute[p].items()},
            exchanges=tuple(exchanges[p]),
        )
        for p in range(n_phases)
    )
    return ProgramIR(devices=devices, order=tuple(order), phases=phases)
