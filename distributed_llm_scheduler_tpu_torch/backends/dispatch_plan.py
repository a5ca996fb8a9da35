"""Pre-planned per-task dispatch: plan once, launch from a flat table.

PyTorch port of ``distributed_llm_scheduler_tpu.backends.dispatch_plan``.
The per-task loop (``DeviceBackend._run``) re-derives everything per task
per run: placement lookups, param dict comprehensions, per-argument
transfer decisions, upstream-failure checks.  Their inputs (graph,
schedule, placed params) are all fixed before the first launch, so this
module moves that work to plan time:

* **Immutable plan** (:class:`DispatchPlan`): built once per ``execute``
  from the frozen graph, the schedule's dispatch linearization and the
  placed params.  Each step carries its task fn, a prebuilt param binding
  dict, its node's stream, and integer indices into a flat value table --
  the hot loop does list indexing, event waits and calls, nothing else.
* **Transfers fixed at plan time**: transfer edges are counted statically
  with the per-(task, arg) semantics of the per-task loop; their bytes
  are filled on the first run and kept.  On one card a cross-node edge is
  a wait on the producer step's event; between cards the consumer's
  stream waits and then copies.
* **Release after the last consumer** (the counterpart of the reference's
  buffer donation): each value is dropped from the table right after the
  last step that reads it, so the caching allocator can hand its memory
  to a later output of the same run.  Never released: the caller's input,
  external (``ext_outputs``) values, the final output, every value kept
  under ``keep_outputs``, and a value read on another card (the copy
  there reads it on another device's stream).  A value read on another
  stream of its card is marked used by that stream (``record_stream``)
  first, so its memory is not reused before that read has run.
* **Coalesced launches** (opt-in ``coalesce=True``): the global dispatch
  order is first re-linearized to maximize runs of consecutive same-node
  tasks (per-node order and topological order preserved exactly); each
  run, capped at :data:`_GROUP_CAP` members, becomes ONE host call whose
  members read values produced inside the group directly.  Members run
  one after another as separate ops, so each task's output is
  bit-identical to its separate launch.

Fail-and-continue is resolved statically: tasks with failed (unplaced or
transitively skipped) upstreams are dropped at plan build, mirroring the
per-task loop's check.
"""

from __future__ import annotations
# dls-lint: allow-file(DET001) dispatch timing harness: wall time IS the measured quantity

import time
from operator import itemgetter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_leaves

from .device import StreamSwitch, _args_of, _array_bytes, _tree_to
from .rebatch import extract_steps


def _tuple_getter(slots: Sequence[int]):
    """C-speed multi-index gather over the value table (always a tuple,
    unlike bare ``itemgetter`` which unwraps a single index)."""
    if not slots:
        return lambda vals: ()
    if len(slots) == 1:
        s = slots[0]
        return lambda vals: (vals[s],)
    return itemgetter(*slots)


# sentinel naming a root member's graph-input read in a launch's external
# argument list (the staged per-node input slot backs it at run time)
GRAPH_INPUT = "__graph_input__"

# max members per coalesced launch, as in the reference
_GROUP_CAP = 16


def group_arg_binds(graph, tids: Tuple[str, ...]):
    """Argument wiring for a (possibly coalesced) launch over ``tids``.

    Returns ``(binds, ext_list)``.  ``ext_list`` is the ordered tuple of
    external inputs the launch takes after the params dict: task ids
    produced outside the group, or :data:`GRAPH_INPUT` for a root member's
    graph-input read -- one entry per (member, arg position) occurrence,
    duplicates kept, mirroring the per-task loop's per-argument semantics.
    ``binds[i]`` wires member i's arguments: ``('v', tid)`` reads an
    in-group value, ``('x', k)`` reads ``ext_list[k]``.
    """
    inside: set = set()
    binds: List[Tuple[Tuple[str, Any], ...]] = []
    ext_list: List[str] = []
    for tid in tids:
        aids = _args_of(graph[tid])
        row: List[Tuple[str, Any]] = []
        if aids:
            for d in aids:
                if d in inside:
                    row.append(("v", d))
                else:
                    row.append(("x", len(ext_list)))
                    ext_list.append(d)
        else:
            row.append(("x", len(ext_list)))
            ext_list.append(GRAPH_INPUT)
        binds.append(tuple(row))
        inside.add(tid)
    return tuple(binds), tuple(ext_list)


def _build_group_fn(graph, tids: Tuple[str, ...], exports: Tuple[str, ...]):
    """One callable running ``tids`` in order: (params-by-global-name,
    *external-args) -> tuple of export outputs.  Members read values
    produced inside the group directly and everything else from the
    external argument list (wiring from :func:`group_arg_binds`)."""
    steps = extract_steps(graph, tids)
    binds, _ext = group_arg_binds(graph, tids)

    def group_fn(gp, *ext_args):
        vals: Dict[str, Any] = {}
        for i, (tid, fn, pitems, _aids) in enumerate(steps):
            pd = {loc: gp[g] for loc, g in pitems}
            args = [
                vals[ref] if kind == "v" else ext_args[ref]
                for kind, ref in binds[i]
            ]
            vals[tid] = fn(pd, *args)
        return tuple(vals[t] for t in exports)

    return group_fn


def _relinearize(graph, schedule, alive: List[str], done: set) -> List[str]:
    """Reorder ``alive`` to maximize consecutive same-node runs.

    Legal because a stream only needs a task's upstreams *enqueued* (with
    an event to wait on) before it: the result preserves each node's
    ``Schedule.per_node`` order exactly (tasks only ever leave the front
    of their node's queue) and is a topological order of the alive
    subgraph.  Greedy: stay on the current node while its next task has
    all upstreams already dispatched; when it blocks, switch to the node
    with the longest immediately-dispatchable prefix.  A switch target
    always exists: the earliest not-yet-dispatched task of the original
    order is always its node's head with every upstream dispatched."""
    placement = schedule.placement
    from collections import deque
    from itertools import islice

    queues: Dict[str, Any] = {}
    for t in alive:
        queues.setdefault(placement[t], deque()).append(t)
    node_order = sorted(queues)
    done = set(done)
    out: List[str] = []
    cur: Optional[str] = None

    def ready(t: str) -> bool:
        return all(d in done for d in _args_of(graph[t]))

    def ready_prefix(q) -> int:
        n = 0
        local: set = set()
        for t in islice(q, _GROUP_CAP):
            if all(d in done or d in local for d in _args_of(graph[t])):
                local.add(t)
                n += 1
            else:
                break
        return n

    while len(out) < len(alive):
        q = queues.get(cur)
        if q and ready(q[0]):
            t = q.popleft()
        else:
            best_n, best_len = None, 0
            for n in node_order:
                qn = queues[n]
                if not qn or not ready(qn[0]):
                    continue
                ln = ready_prefix(qn)
                if ln > best_len:
                    best_n, best_len = n, ln
                    if ln >= _GROUP_CAP:
                        break
            if best_n is None:  # impossible per the invariant above
                raise RuntimeError("relinearize: no dispatchable node head")
            cur = best_n
            t = queues[cur].popleft()
        out.append(t)
        done.add(t)
    return out


class PlanStep:
    """One host call: a single task or a coalesced same-node group."""

    __slots__ = (
        "tids",          # task ids in this call (len 1 unless coalesced)
        "node_id",
        "dev",           # torch device the call runs on
        "stream",        # the node's stream (None on the CPU)
        "fn",            # task fn, or the group fn
        "pd",            # prebuilt param binding dict
        "arg_slots",     # value-table indices of the call's args, in order
        "get_args",      # itemgetter over arg_slots (C-speed gather)
        "waits",         # producer steps' events this step's stream waits on
        "event",         # event recorded after this step (None: no reader
                         # on another stream)
        "copy_pos",      # arg positions copied from another device
        "use_pos",       # arg positions read from another stream of the card
        "xfer_pos",      # arg positions that are transfers (edges, bytes)
        "xfer_bytes",    # per-run transferred bytes; filled on first run
        "out_slots",     # value-table indices written (exports, in order)
        "release",       # slots dropped from the table after this step
        "out_tids",      # task ids of out_slots, in order
        "xfer_src_tids",  # producer of each distinct transferred slot
        "xfer_src_nodes",  # its node ("ext" for an ext value)
        "xfer_src_pos",  # an arg position of each distinct transferred slot
        "mem_frees",     # producers whose value dies in this step in the
                         # memory model (the JAX plan's donation set)
        "group",         # True => fn returns a tuple aligned with out_slots
    )


class DispatchPlan:
    """Immutable dispatch program for one (graph, schedule, ext) triple.

    Built by :meth:`build`; executed by :meth:`run`.  The value table is a
    flat list: slots 0..len(ext)-1 hold external outputs, then one slot per
    node that roots read the graph input from, then one slot per exported
    task output.
    """

    def __init__(
        self,
        steps: List[PlanStep],
        n_slots: int,
        ext_slots: Tuple[Tuple[str, int], ...],
        input_slots: Tuple[Tuple[str, Any, int], ...],
        final_slot: Optional[int],
        keep_list: Tuple[Tuple[str, int], ...],
        transfer_edges: int,
        coalesce: bool,
        tid_of_slot: Dict[int, str],
    ):
        self.steps = steps
        self.n_slots = n_slots
        self.ext_slots = ext_slots
        self.input_slots = input_slots       # (node_id, torch device, slot)
        self.final_slot = final_slot
        self.keep_list = keep_list           # (tid, slot) when keep_outputs
        self.transfer_edges = transfer_edges
        self.coalesce = coalesce
        self.tid_of_slot = tid_of_slot
        # task id -> bytes of its value, for each value transferred; filled
        # on the first run
        self.xfer_nbytes: Dict[str, int] = {}

    # -- construction ------------------------------------------------------
    @classmethod
    def build(
        cls,
        backend,
        graph,
        schedule,
        order: Sequence[str],
        placed_params: Dict[Tuple[str, str], Any],
        ext_keys: Tuple[str, ...] = (),
        coalesce: bool = False,
        keep_outputs: bool = False,
    ) -> "DispatchPlan":
        placement = schedule.placement
        dev_of = {n: backend.cluster[n].torch_device
                  for n in sorted(set(placement.values()))}

        # static fail-and-continue: the per-task loop's upstream check
        # (ext values count as live producers)
        live: set = set(ext_keys)
        alive: List[str] = []
        for tid in order:
            aids = _args_of(graph[tid])
            if aids and any(d not in live for d in aids):
                continue
            live.add(tid)
            alive.append(tid)

        # launch groups: singletons unless coalescing is on
        groups: List[List[str]] = []
        if coalesce and alive:
            alive = _relinearize(graph, schedule, alive, set(ext_keys))
        if coalesce:
            for tid in alive:
                if (
                    groups
                    and placement[groups[-1][0]] == placement[tid]
                    and len(groups[-1]) < _GROUP_CAP
                ):
                    groups[-1].append(tid)
                else:
                    groups.append([tid])
        else:
            groups = [[t] for t in alive]

        group_of = {t: gi for gi, g in enumerate(groups) for t in g}
        consumers: Dict[str, set] = {t: set() for t in alive}
        for tid in alive:
            for d in _args_of(graph[tid]):
                if d in consumers:
                    consumers[d].add(group_of[tid])
        exports_of: List[Tuple[str, ...]] = []
        for gi, g in enumerate(groups):
            exports_of.append(tuple(
                t for t in g
                if keep_outputs or (consumers[t] - {gi}) or not consumers[t]
            ))

        # slot allocation: ext, then per-node graph input, then exports
        slot_of: Dict[str, int] = {}
        for k in ext_keys:
            slot_of[k] = len(slot_of)
        ext_slots = tuple((k, slot_of[k]) for k in ext_keys)
        input_slot: Dict[str, int] = {}
        n_slots = len(slot_of)
        for tid in alive:
            if not _args_of(graph[tid]):
                node = placement[tid]
                if node not in input_slot:
                    input_slot[node] = n_slots
                    n_slots += 1
        producer_group: Dict[int, int] = {}
        for gi, exports in enumerate(exports_of):
            for t in exports:
                slot_of[t] = n_slots
                producer_group[n_slots] = gi
                n_slots += 1
        tid_of_slot = {s: t for t, s in slot_of.items()}

        final_tid = graph.topo_order[-1] if graph.topo_order else None
        final_slot = slot_of.get(final_tid) if final_tid else None
        ext_lists = [group_arg_binds(graph, tuple(g))[1] for g in groups]

        # last reading group per slot; slots read on another device
        last_use: Dict[int, int] = {}
        cross_dev: set = set()
        for gi, ext_list in enumerate(ext_lists):
            node = placement[groups[gi][0]]
            for d in ext_list:
                if d == GRAPH_INPUT:
                    continue
                s = slot_of[d]
                last_use[s] = gi
                if d not in placement or dev_of[placement[d]] != dev_of[node]:
                    cross_dev.add(s)
        keep_slots = {slot_of[t] for exports in exports_of for t in exports} \
            if keep_outputs else set()
        protected = (
            {final_slot} | {s for _, s in ext_slots}
            | set(input_slot.values()) | keep_slots | cross_dev
        )
        release_at: Dict[int, List[int]] = {}
        for s, gi in producer_group.items():
            if s not in protected:
                release_at.setdefault(last_use.get(s, gi), []).append(s)
        # the memory model's deaths: the values the JAX plan donates (read
        # at one position of their last reading step, on the producer's
        # node, neither the final output nor a node's fence value), so a
        # memory profile of the port's run books the reference's
        # lifetimes.  The port itself drops its reference at ``release``
        fence_slots = {placement[g[0]]: slot_of[g[-1]] for g in groups}
        mem_keep = {final_slot} | set(fence_slots.values())

        # producer groups whose outputs are read on another stream
        evented: set = set()
        for gi, ext_list in enumerate(ext_lists):
            node = placement[groups[gi][0]]
            for d in ext_list:
                if d != GRAPH_INPUT and d in placement and placement[d] != node:
                    evented.add(group_of[d])
        events = {
            gi: torch.cuda.Event() for gi in evented
            if backend.stream_of(placement[groups[gi][0]]) is not None
        }

        steps: List[PlanStep] = []
        transfer_edges = 0
        for gi, g in enumerate(groups):
            node = placement[g[0]]
            dev = dev_of[node]
            ext_list = ext_lists[gi]
            arg_slots = tuple(
                input_slot[node] if d == GRAPH_INPUT else slot_of[d]
                for d in ext_list
            )
            xfer_pos: List[int] = []
            waits: Dict[int, Any] = {}
            copy_pos: List[int] = []
            use_pos: List[int] = []
            for pos, d in enumerate(ext_list):
                if d == GRAPH_INPUT or placement.get(d) == node:
                    # graph input is staged per node; same-node edges
                    # need no transfer
                    continue
                xfer_pos.append(pos)
                transfer_edges += 1
                if d in placement:
                    pg = group_of[d]
                    if pg in events:
                        waits[pg] = events[pg]
                    if dev_of[placement[d]] != dev:
                        copy_pos.append(pos)
                    elif backend.stream_of(node) is not None:
                        use_pos.append(pos)
                elif dev.type == "cuda":
                    copy_pos.append(pos)  # an ext value: moved if elsewhere

            step = PlanStep()
            step.tids = tuple(g)
            step.node_id = node
            step.dev = dev
            step.stream = backend.stream_of(node)
            step.arg_slots = arg_slots
            step.get_args = _tuple_getter(arg_slots)
            step.waits = tuple(waits.values())
            step.event = events.get(gi)
            step.copy_pos = tuple(copy_pos)
            step.use_pos = tuple(use_pos)
            step.xfer_pos = tuple(xfer_pos)
            step.xfer_bytes = None if xfer_pos else 0
            step.release = tuple(sorted(release_at.get(gi, ())))
            src_pos: Dict[int, int] = {}
            for p in xfer_pos:
                src_pos.setdefault(arg_slots[p], p)
            step.xfer_src_tids = tuple(tid_of_slot[s] for s in src_pos)
            step.xfer_src_nodes = tuple(
                placement.get(t, "ext") for t in step.xfer_src_tids)
            step.xfer_src_pos = tuple(src_pos.values())
            frees = []
            if not keep_outputs:
                for s in dict.fromkeys(arg_slots):
                    if (arg_slots.count(s) == 1 and s in producer_group
                            and last_use.get(s) == gi and s not in mem_keep
                            and placement.get(tid_of_slot[s]) == node):
                        frees.append(tid_of_slot[s])
            step.mem_frees = tuple(frees)
            step.group = len(g) > 1
            if step.group:
                exports = exports_of[gi]
                step.out_slots = tuple(slot_of[t] for t in exports)
                step.out_tids = exports
                step.fn = _build_group_fn(graph, tuple(g), exports)
                step.pd = {
                    glob: placed_params[(glob, node)]
                    for t in g
                    for _, glob in graph[t].param_items()
                }
            else:
                task = graph[g[0]]
                step.out_slots = (slot_of[g[0]],)
                step.out_tids = (g[0],)
                step.fn = task.fn
                step.pd = {
                    loc: placed_params[(glob, node)]
                    for loc, glob in task.param_items()
                }
            steps.append(step)

        keep_list = tuple(
            (t, slot_of[t]) for exports in exports_of for t in exports
        ) if keep_outputs else ()
        plan = cls(
            steps, n_slots, ext_slots,
            tuple(
                (n, dev_of[n], s) for n, s in sorted(input_slot.items())
            ),
            final_slot, keep_list, transfer_edges, coalesce, tid_of_slot,
        )
        # release self-check (analysis/donation_pass): re-derives, from
        # the exported metadata alone, that every value the plan drops at
        # a step is read by nothing after it, as the reference checks its
        # donations; part of the pre-execution gate
        if (any(st.release for st in steps)
                and getattr(backend, "pre_analysis", True)):
            from ..analysis import analyze_donation, gate_enabled

            if gate_enabled():
                analyze_donation(plan).raise_if_errors()
        return plan

    # -- analysis metadata -------------------------------------------------
    def donation_table(self) -> Dict[str, Any]:
        """Static lifetime metadata of what this plan really drops, in the
        shape the reference's ``donation_table`` gives and
        ``analysis/donation_pass`` reads: per step the distinct slots it
        reads (``arg_slots``), those it pulls from another node
        (``xfer_slots``), writes (``out_slots``) and drops after its launch
        (``donate_slots``: ``release``), plus the values the caller reads
        or owns after the run (final output, keep list, ext values) and
        the staged inputs (``input_slots``, never dropped).  A value is
        dropped after the launch that reads it last, so one value bound at
        two positions of that launch is no hazard: ``arg_slots`` lists each
        slot once.  The port reads no node's last value at the end of a run
        (its streams join), so there are no ``fence_slots``.  Pure data:
        names and slot indices only."""
        return {
            "steps": tuple(
                {
                    "tids": st.tids,
                    "node_id": st.node_id,
                    "arg_slots": tuple(dict.fromkeys(st.arg_slots)),
                    "xfer_slots": tuple(dict.fromkeys(
                        st.arg_slots[p] for p in st.xfer_pos)),
                    "donate_slots": st.release,
                    "out_slots": st.out_slots,
                }
                for st in self.steps
            ),
            "final_slot": self.final_slot,
            "keep_list": self.keep_list,
            "ext_slots": self.ext_slots,
            "input_slots": tuple((n, s) for n, _d, s in self.input_slots),
            "n_slots": self.n_slots,
        }

    @property
    def n_launches(self) -> int:
        return len(self.steps)

    # -- execution ---------------------------------------------------------
    def run(
        self,
        graph_input: Any,
        ext_outputs: Optional[Dict[str, Any]] = None,
        clocks: Optional[Dict[Any, Any]] = None,
        tracer: Any = None,
        metrics: Any = None,
        mem: Any = None,
    ) -> Tuple[Any, Dict, int, int, int, float, Dict[str, Any]]:
        """Execute the plan once.  Same return contract as the per-task
        runner: ``(final, timings, transfer_edges, transfer_bytes,
        n_dispatches, loop seconds, kept outputs)``.  ``clocks`` maps each
        card to its clock stream (restored as current on exit).

        ``tracer`` (optional) records the input staging, each step's
        transfer staging and host launch window on its node's track, and a
        flow arrow from each transferred value's producer launch;
        ``metrics`` per-edge transfer bytes; ``mem`` (a memory profiler)
        input staging, transfer copies, output births and the deaths of
        ``mem_frees``.  Every record is behind a ``None`` check."""
        vals: List[Any] = [None] * self.n_slots
        done: Optional[Dict[str, Tuple[str, float]]] = (
            {} if tracer is not None else None
        )
        t_loop0 = time.perf_counter()
        if ext_outputs:
            for k, s in self.ext_slots:
                vals[s] = ext_outputs[k]
        tbytes = 0
        with torch.no_grad(), StreamSwitch(
            {st.node_id: st.stream for st in self.steps}, clocks or {}
        ) as sw:
            t0 = time.perf_counter()
            for _n, dev, s in self.input_slots:
                sw.to(_n)
                vals[s] = _tree_to(graph_input, dev)
                if mem is not None:
                    mem.alloc(_n, "input", _array_bytes(vals[s]), "activations")
            if tracer is not None and self.input_slots:
                tracer.complete(
                    "stage_input", t0, time.perf_counter(), track="host",
                    cat="stage", devices=len(self.input_slots),
                )
            for step in self.steps:
                if tracer is not None and step.xfer_pos:
                    t_x0 = time.perf_counter()
                stream = sw.to(step.node_id)
                for ev in step.waits:
                    stream.wait_event(ev)
                args = step.get_args(vals)
                if step.xfer_bytes is None:
                    step.xfer_bytes = 0
                    for p in step.xfer_pos:
                        n = _array_bytes(args[p])
                        step.xfer_bytes += n
                        self.xfer_nbytes[
                            self.tid_of_slot[step.arg_slots[p]]] = n
                if step.copy_pos or step.use_pos:
                    args = list(args)
                    for p in step.copy_pos:
                        args[p] = _tree_to(args[p], step.dev, non_blocking=True)
                    for p in step.use_pos:
                        for t in tree_leaves(args[p]):
                            t.record_stream(stream)
                tbytes += step.xfer_bytes
                if step.xfer_pos and (metrics is not None or mem is not None):
                    per_edge = [_array_bytes(args[p]) for p in step.xfer_src_pos]
                    if metrics is not None:
                        for ui, src_node in enumerate(step.xfer_src_nodes):
                            metrics.counter(
                                f"transfer.bytes.{src_node}->{step.node_id}",
                                unit="bytes",
                            ).inc(per_edge[ui])
                    if mem is not None:
                        for ui, src in enumerate(step.xfer_src_tids):
                            mem.alloc(step.node_id, f"xfer:{src}",
                                      per_edge[ui], "transfers")
                if tracer is not None:
                    t_l0 = time.perf_counter()
                    if step.xfer_pos:
                        tracer.complete(
                            "stage", t_x0, t_l0, track=step.node_id,
                            cat="stage", transfers=len(step.xfer_src_tids),
                        )
                if step.group:
                    outs = step.fn(step.pd, *args)
                    for s, o in zip(step.out_slots, outs):
                        vals[s] = o
                else:
                    vals[step.out_slots[0]] = step.fn(step.pd, *args)
                if step.event is not None:
                    step.event.record(stream)
                if mem is not None:
                    # births, then the deaths the memory model books here
                    for t, s in zip(step.out_tids, step.out_slots):
                        mem.alloc(step.node_id, f"out:{t}",
                                  _array_bytes(vals[s]), "activations")
                    for t in step.mem_frees:
                        mem.free(step.node_id, f"out:{t}")
                if tracer is not None:
                    t_l1 = time.perf_counter()
                    name = (
                        step.tids[0] if len(step.tids) == 1
                        else f"{step.tids[0]}+{len(step.tids) - 1}"
                    )
                    tracer.complete(
                        name, t_l0, t_l1, track=step.node_id, cat="launch",
                        tasks=len(step.tids), edges=len(step.xfer_pos),
                    )
                    for t in step.tids:
                        done[t] = (step.node_id, t_l1)
                    for src in step.xfer_src_tids:
                        src_pt = done.get(src)
                        if src_pt is not None:
                            tracer.flow(
                                "transfer", src_pt[0], src_pt[1],
                                step.node_id, t_l0, src=src,
                                dst=step.tids[0],
                            )
                for s in step.release:
                    vals[s] = None
        loop_s = time.perf_counter() - t_loop0
        final = vals[self.final_slot] if self.final_slot is not None else None
        executed = {t: vals[s] for t, s in self.keep_list}
        return (
            final, {}, self.transfer_edges, tbytes, len(self.steps), loop_s,
            executed,
        )
