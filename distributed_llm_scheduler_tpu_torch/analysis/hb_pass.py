"""MPMD happens-before model (COL005-COL007): deadlock-freedom for
pipeline stages that run DIFFERENT programs.

The SPMD collective check (:mod:`.collective_pass`) proves every device
issues the same global collective sequence — vacuous for true MPMD
pipeline parallelism, where stage ``s`` runs a different program from
stage ``s+1`` and correctness is a property of how their send/recv
sequences *interleave* ("Scaling Deep Learning Training with MPMD
Pipeline Parallelism", PAPERS.md).  This pass builds the happens-before
graph of a set of per-stage (per-host) op sequences and checks:

* **COL005 (error)** — a cycle in the happens-before graph: stage A
  blocks on a recv whose matching send sits behind A's own unsent data.
  On hardware this is a guaranteed hang with no Python frame to debug;
  the canonical repro is the two-stage bidirectional exchange where both
  stages recv before they send.
* **COL006 (error)** — unmatched send/recv cardinality on a directed
  channel (stage A emits three microbatch activations, stage B posts two
  recvs), or matched positions that disagree on the value tag.  The
  surplus op blocks forever at drain time even if the steady state runs.
* **COL007 (warning)** — an interleaving that admits NO overlap: the
  happens-before order totally serializes every stage's compute, i.e.
  the 1F1B steady state degenerates to one active stage at a time.  This
  is the static counterpart of the bubble attribution in
  ``obs/attribution.py`` (the ``bubbles`` field of a doctor report shows
  the measured idle the serialization predicts).

Channel model: point-to-point sends are *buffered* (asynchronous) — a
send happens-before its matching recv, but does not wait for it; this
matches XLA Send/Recv and the staged microbatch exchange the compiled
path emits.  Named ``collective`` ops are rendezvous: the k-th occurrence
of a tag across all participating stages merges into one event, so two
stages that disagree on the relative order of two collectives form a
COL005 cycle.

Op vocabulary (:class:`StageOp`, or plain ``(op, peer, tag)`` tuples):
``send``/``recv`` with a peer stage and a value tag, ``compute`` with a
tag, ``collective`` with a tag.  FIFO matching per directed channel: the
k-th ``send(peer=B)`` on stage A matches the k-th ``recv(peer=A)`` on
stage B.

:func:`stage_programs_1f1b` generates the clean 1F1B schedule (warmup
forwards, steady one-forward-one-backward, cooldown backwards) as the
golden deadlock-free reference — the false-positive guard in
tests/test_analysis.py lints it with zero errors.

PyTorch port's copy of ``distributed_llm_scheduler_tpu.analysis.hb_pass``;
framework-free, so the findings are identical.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from .diagnostics import AnalysisReport, Severity

_OPS = ("send", "recv", "compute", "collective")


@dataclass(frozen=True)
class StageOp:
    """One event in a stage's program.

    ``send``/``recv`` name the peer stage and the value tag travelling
    on the channel; ``compute`` marks device work (used by the COL007
    overlap check); ``collective`` is a cross-stage rendezvous on a tag.
    """

    op: str
    peer: Optional[str] = None
    tag: str = ""

    def __post_init__(self) -> None:
        if self.op not in _OPS:
            raise ValueError(
                f"unknown stage op {self.op!r}; expected one of {_OPS}"
            )
        if self.op in ("send", "recv") and self.peer is None:
            raise ValueError(f"{self.op} requires a peer stage")


OpLike = Union[StageOp, Tuple]


def _norm(op: OpLike) -> StageOp:
    if isinstance(op, StageOp):
        return op
    return StageOp(*op)


def stage_programs_1f1b(
    n_stages: int, n_microbatches: int
) -> Dict[str, List[StageOp]]:
    """The canonical 1F1B schedule as per-stage op sequences.

    Stage ``s`` runs ``S - 1 - s`` warmup forwards, then alternates
    one-forward-one-backward until forwards are exhausted, then drains
    backwards.  Forward activations of microbatch ``m`` travel tag
    ``f{m}`` downstream; gradients travel ``g{m}`` upstream.
    """
    S, M = n_stages, n_microbatches
    if S < 1 or M < 1:
        raise ValueError("need at least one stage and one microbatch")
    programs: Dict[str, List[StageOp]] = {}
    for s in range(S):
        ops: List[StageOp] = []

        def fwd(m: int, s: int = s, ops: List[StageOp] = ops) -> None:
            if s > 0:
                ops.append(StageOp("recv", f"stage{s - 1}", f"f{m}"))
            ops.append(StageOp("compute", None, f"f{m}"))
            if s < S - 1:
                ops.append(StageOp("send", f"stage{s + 1}", f"f{m}"))

        def bwd(m: int, s: int = s, ops: List[StageOp] = ops) -> None:
            if s < S - 1:
                ops.append(StageOp("recv", f"stage{s + 1}", f"g{m}"))
            ops.append(StageOp("compute", None, f"g{m}"))
            if s > 0:
                ops.append(StageOp("send", f"stage{s - 1}", f"g{m}"))

        warmup = min(S - 1 - s, M)
        nf = nb = 0
        for _ in range(warmup):
            fwd(nf)
            nf += 1
        while nf < M:
            fwd(nf)
            nf += 1
            bwd(nb)
            nb += 1
        while nb < M:
            bwd(nb)
            nb += 1
        programs[f"stage{s}"] = ops
    return programs


def analyze_happens_before(
    stages: Mapping[str, Sequence[OpLike]],
) -> AnalysisReport:
    """COL005-COL007 over per-stage op sequences (see module doc)."""
    rep = AnalysisReport()
    progs: Dict[str, List[StageOp]] = {
        name: [_norm(o) for o in ops] for name, ops in stages.items()
    }

    # ---- channel matching (COL006) ------------------------------------
    # FIFO per directed channel: k-th send(A->B) matches k-th recv on B
    # naming A.  Node ids are (stage, index); matched pairs gain a
    # send -> recv happens-before edge.
    sends: Dict[Tuple[str, str], List[Tuple[int, str]]] = {}
    recvs: Dict[Tuple[str, str], List[Tuple[int, str]]] = {}
    for name, ops in progs.items():
        for i, op in enumerate(ops):
            if op.op == "send":
                sends.setdefault((name, op.peer), []).append((i, op.tag))
            elif op.op == "recv":
                recvs.setdefault((op.peer, name), []).append((i, op.tag))

    edges: Dict[Tuple[str, int], List[Tuple[str, int]]] = {}
    nodes: List[Tuple[str, int]] = []

    def add_edge(a: Tuple[str, int], b: Tuple[str, int]) -> None:
        edges.setdefault(a, []).append(b)

    # collective rendezvous: k-th occurrence of a tag merges across all
    # stages into one node keyed ("@coll:<tag>", k)
    coll_count: Dict[Tuple[str, str], int] = {}
    merged: Dict[Tuple[str, int], Tuple[str, int]] = {}
    for name, ops in progs.items():
        for i, op in enumerate(ops):
            if op.op == "collective":
                k = coll_count.get((name, op.tag), 0)
                coll_count[(name, op.tag)] = k + 1
                merged[(name, i)] = (f"@coll:{op.tag}", k)

    def nid(name: str, i: int) -> Tuple[str, int]:
        return merged.get((name, i), (name, i))

    for name, ops in progs.items():
        prev: Optional[Tuple[str, int]] = None
        for i in range(len(ops)):
            n = nid(name, i)
            if n not in edges:
                nodes.append(n)
                edges[n] = []
            if prev is not None and prev != n:
                add_edge(prev, n)
            prev = n

    for chan in sorted(set(sends) | set(recvs)):
        src, dst = chan
        ss = sends.get(chan, [])
        rr = recvs.get(chan, [])
        if len(ss) != len(rr):
            rep.add(
                "COL006",
                Severity.ERROR,
                f"channel {src} -> {dst}: {len(ss)} send(s) but "
                f"{len(rr)} recv(s) — the surplus side blocks forever "
                "at drain",
                node=dst,
                data={"sends": len(ss), "recvs": len(rr)},
            )
        for k, ((si, stag), (ri, rtag)) in enumerate(zip(ss, rr)):
            if stag != rtag:
                rep.add(
                    "COL006",
                    Severity.ERROR,
                    f"channel {src} -> {dst}: matched pair {k} carries "
                    f"tag {stag!r} on the send but {rtag!r} on the recv",
                    node=dst,
                )
            add_edge(nid(src, si), nid(dst, ri))

    # ---- cycle detection (COL005) -------------------------------------
    indeg: Dict[Tuple[str, int], int] = {n: 0 for n in edges}
    for a, outs in edges.items():
        for b in outs:
            indeg[b] += 1
    queue = [n for n, d in indeg.items() if d == 0]
    topo: List[Tuple[str, int]] = []
    while queue:
        n = queue.pop()
        topo.append(n)
        for b in edges[n]:
            indeg[b] -= 1
            if indeg[b] == 0:
                queue.append(b)
    if len(topo) < len(edges):
        cyclic = {n for n, d in indeg.items() if d > 0}
        cycle = _extract_cycle(edges, cyclic)
        shown = " -> ".join(_describe(progs, n) for n in cycle)
        rep.add(
            "COL005",
            Severity.ERROR,
            f"cross-stage wait cycle (guaranteed deadlock): {shown}",
            node=cycle[0][0] if cycle else None,
            data={"cycle": [list(n) for n in cycle]},
        )
        return rep  # timing analysis below needs an acyclic graph

    # ---- serialization check (COL007) ---------------------------------
    # longest-path "time" where only compute advances the clock; two
    # computes on different stages sharing a time CAN overlap.  A
    # schedule where no such pair exists runs one stage at a time.
    op_at = {
        (name, i): op
        for name, ops in progs.items()
        for i, op in enumerate(ops)
    }

    def is_compute(n: Tuple[str, int]) -> bool:
        op = op_at.get(n)
        return op is not None and op.op == "compute"

    time: Dict[Tuple[str, int], int] = {}
    for n in topo:
        t = time.get(n, 0)
        w = 1 if is_compute(n) else 0
        for b in edges[n]:
            time[b] = max(time.get(b, 0), t + w)

    computes = [n for n in edges if is_compute(n)]
    stages_with_compute = {n[0] for n in computes}
    if len(stages_with_compute) >= 2 and len(computes) >= 4:
        by_time: Dict[int, set] = {}
        for n in computes:
            by_time.setdefault(time.get(n, 0), set()).add(n[0])
        overlap = any(len(s) >= 2 for s in by_time.values())
        if not overlap:
            rep.add(
                "COL007",
                Severity.WARNING,
                "happens-before order totally serializes compute across "
                f"{len(stages_with_compute)} stages — the 1F1B steady "
                "state degenerates to one active stage at a time; the "
                "measured counterpart is the bubbles field of the obs "
                "attribution report (doctor --trace)",
                data={"computes": len(computes)},
            )
    return rep


def _extract_cycle(
    edges: Dict[Tuple[str, int], List[Tuple[str, int]]],
    cyclic: set,
) -> List[Tuple[str, int]]:
    """One concrete cycle inside the cyclic subgraph, for the message."""
    # trim to the core where every node keeps an in-core successor, so
    # the walk below can always advance (dangling descendants of a cycle
    # survive Kahn's sweep but sit on no cycle themselves)
    core = set(cyclic)
    changed = True
    while changed:
        changed = False
        for n in list(core):
            if not any(b in core for b in edges[n]):
                core.discard(n)
                changed = True
    if not core:
        return []
    start = sorted(core)[0]
    path: List[Tuple[str, int]] = []
    seen: Dict[Tuple[str, int], int] = {}
    n = start
    while n not in seen:
        seen[n] = len(path)
        path.append(n)
        n = next(b for b in edges[n] if b in core)
    return path[seen[n]:]


def _describe(
    progs: Dict[str, List[StageOp]], n: Tuple[str, int]
) -> str:
    name, i = n
    if name.startswith("@coll:"):
        return f"collective[{name[len('@coll:'):]}]"
    op = progs[name][i]
    peer = f" {op.peer}" if op.peer else ""
    tag = f"[{op.tag}]" if op.tag else ""
    return f"{name}:{op.op}{peer}{tag}"
