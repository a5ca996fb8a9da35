"""The compiled rung over several devices: a process per device, each
replaying its share of the placed run as one captured program.

PyTorch counterpart of the reference's mesh lowering
(``distributed_llm_scheduler_tpu.backends.compiled_schedule``
``_build_mesh``): there one SPMD program over a device mesh, each device's
tasks under a switch on its mesh index and every cross-device edge a
``ppermute`` at a phase boundary; here one process per device
(:class:`..parallel.launch.World`), each running its own nodes' tasks and
doing the IR's exchanges as point-to-point sends and receives.

**Which node runs where.**  A node's device is its ``torch_device``; the
world has one rank per distinct device of the placed nodes, in the order
of their indices (a card's index, or ``r`` for ``torch.device("cpu",
r)``; the CPU with no index is index 0).  On the cards rank ``k`` runs on
its card under NCCL; under ``DLS_PLATFORM=cpu`` each rank is a gloo
process standing for one card.  The placed devices must all be of the
platform seam's type (``cuda:r`` nodes on ``cuda``, ``cpu:r`` nodes under
``DLS_PLATFORM=cpu``): :func:`check_world_devices` refuses any other
placement before a process starts.

**The program of a rank** walks the :class:`..sched.linearize.ProgramIR`
phase by phase.  In each phase every node of the rank runs its tasks on
its own stream (the k-th node of a card on that card's k-th
:func:`.device.node_stream`, as in one process); then every rank walks
the phase's exchanges in the one global order
(:meth:`..sched.linearize.ProgramIR.collective_sequence`, which the COL
passes prove consistent):

* both ends on this rank: an event recorded on the source node's stream
  and waited on by the destination's (the nodes of a card share its
  memory);
* this rank holds the source: a send of each tensor of the value, issued
  on the source node's stream;
* this rank holds the destination: a receive into a new buffer of the
  value's shape, strides and type (from a run of the task functions on
  meta tensors, :func:`value_avals`), issued on the destination node's
  stream;
* any other rank: nothing.

A one-element all-reduce opens and closes the program, so every rank's
window spans the whole run.  A value dies after its last reader when
every reader runs on the stream that made it; a value that is sent, read
on another stream or returned lives to the end of the run.

On a card each rank runs its program once eagerly (opening every
communicator the exchanges use: none can be created during a capture),
then captures it, sends and receives included, into one CUDA graph
(:class:`.device.CapturedProgram`); a run is one copy of the input into
the graph's static buffer and one replay.  The owner of the final output
shares the graph's output tensor with the controller once, through CUDA
IPC: it holds until the next run.  Under gloo there is no capture and the
program runs eagerly, exchanges included; the owner copies the output into
a shared-memory buffer it shared once.

**The graph reaches the ranks through its recipe** (``TaskGraph.recipe``,
the builder's import path and arguments): task functions are closures and
do not pickle.  Each rank rebuilds the graph, re-lowers the schedule and
checks the IR's signature against the controller's before it runs
anything.  Each rank places only the parameters of its own nodes, from a
file the controller writes into the world's directory.  A parameter the
caller updates in place (an optimizer step, a ``copy_`` of new weights)
is loaded again into the ranks before the next run
(:meth:`WorldProgram.refresh`), so the world sees the update as the
one-card rung, which reads the params at their addresses, does.
"""

from __future__ import annotations
# dls-lint: allow-file(DET001) compiled-path timing harness: wall time IS the measured quantity

import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map_only, \
    tree_unflatten

from ..core.graph import TaskGraph
from ..core.schedule import Schedule
from ..sched.linearize import ProgramIR
from .device import _array_bytes, _map_leaves

#: the backend flags a rank takes from its controller, so a rank computes
#: what the controller's one-process rungs compute
FLAGS = (
    ("cuda.matmul", "allow_tf32"),
    ("cuda.matmul", "allow_bf16_reduced_precision_reduction"),
    ("cuda.matmul", "allow_fp16_reduced_precision_reduction"),
    ("cudnn", "allow_tf32"),
)


def _flag_owner(mod: str) -> Any:
    owner = torch.backends
    for part in mod.split("."):
        owner = getattr(owner, part)
    return owner


def device_index(dev: torch.device) -> int:
    """The index a node's device stands for: its card, ``r`` for
    ``cpu:r``, 0 for the CPU with no index."""
    return dev.index or 0


def world_devices(backend, nodes: Sequence[str]) -> Tuple[torch.device, ...]:
    """The distinct devices ``nodes`` are bound to, by type and then index:
    one rank each.  ``cpu`` and ``cpu:0`` are one device."""
    by_key: Dict[Tuple[str, int], torch.device] = {}
    for n in nodes:
        dev = backend.cluster[n].torch_device
        by_key.setdefault((dev.type, device_index(dev)), dev)
    return tuple(by_key[k] for k in sorted(by_key))


def check_world_devices(devices: Sequence[torch.device]) -> None:
    """Refuse (``ValueError``) a world over ``devices`` that would run on
    other devices than the ones they name: devices of two types, or of
    another type than the platform seam's (a rank runs on ``cuda:r`` on
    ``cuda``, as a gloo process under ``DLS_PLATFORM=cpu``)."""
    from ..utils.config import platform

    types = sorted({d.type for d in devices})
    named = ", ".join(str(d) for d in devices)
    if len(types) > 1:
        raise ValueError(
            f"compiled=True places nodes on {named}: a world runs one "
            "process per device of one type, and these mix "
            f"{' and '.join(types)}; bind every node to a card, or every "
            "node to torch.device('cpu', r)")
    plat = platform()
    if types[0] != plat:
        raise ValueError(
            f"compiled=True places nodes on {named}, but the platform seam "
            f"is {plat!r} (DLS_PLATFORM), whose world runs "
            f"{'cuda:r' if plat == 'cuda' else 'gloo ranks for cpu:r'}; "
            f"bind the nodes to {plat} devices, or set DLS_PLATFORM="
            f"{types[0]}")


def value_avals(graph: TaskGraph, order: Sequence[str],
                params: Dict[str, Any], graph_input: Any) -> Dict[str, Any]:
    """Each task's output in ``order`` (a topological order) as meta
    tensors with the real output's shape, strides and type: the task
    functions run on meta copies of ``params`` and ``graph_input``."""

    def meta(t: torch.Tensor) -> torch.Tensor:
        return torch.empty_strided(tuple(t.shape), t.stride(), dtype=t.dtype,
                                   device="meta")

    x = tree_map_only(torch.Tensor, meta, graph_input)
    avals: Dict[str, Any] = {}
    with torch.no_grad():
        for tid in order:
            task = graph[tid]
            aids = task.arg_tasks or task.dependencies
            pd = {loc: _map_leaves(meta, params[g])
                  for loc, g in task.param_items()}
            args = [avals[d] for d in aids] if aids else [x]
            avals[tid] = tree_map_only(torch.Tensor, meta, task.fn(pd, *args))
    return avals


@dataclass(frozen=True)
class Buffer:
    """What a receiver allocates for one tensor of a value."""

    shape: Tuple[int, ...]
    stride: Tuple[int, ...]
    dtype: torch.dtype


def _buffers_of(aval: Any) -> Any:
    """A meta value with a :class:`Buffer` for each tensor (it pickles)."""
    return tree_map_only(
        torch.Tensor,
        lambda t: Buffer(tuple(t.shape), t.stride(), t.dtype), aval)


def book_program_memory(mem, ir: ProgramIR, placement: Dict[str, str],
                        graph_input: Any, slab_bytes: Dict[str, int],
                        xfer_nbytes: Dict[str, int], final: str,
                        out_bytes: int) -> None:
    """The compiled rung's build-time memory model, booked once per run as
    the reference's compiled rung books it (labels replace across reps):
    a param slab per node (``slab_bytes``), the input on each node, each
    exchange on its destination and the final output on its owner."""
    in_bytes = _array_bytes(graph_input)
    for node in ir.devices:
        pb = (slab_bytes or {}).get(node, 0)
        if pb:
            mem.alloc(node, "slab:params", pb, "params")
        mem.alloc(node, "input", in_bytes, "activations")
    for ph in ir.phases:
        for ex in ph.exchanges:
            mem.alloc(ex.dst, f"xfer:{ex.tid}", xfer_nbytes[ex.tid],
                      "transfers")
    mem.alloc(placement[final], f"out:{final}", out_bytes, "activations")


# -- the rank side ----------------------------------------------------------

_PROGRAM: Optional["RankProgram"] = None  # this rank's program


class RankProgram:
    """One rank's share of a placed run (see the module docstring).

    ``spec`` is the controller's description (:meth:`WorldProgram.
    _rank_spec`); the process group must be up.  Build, warm-up and (on a
    card) capture happen here."""

    def __init__(self, spec: Dict[str, Any]):
        import torch.distributed as dist

        from ..core.graph import from_recipe
        from ..parallel.launch import device
        from ..sched.linearize import linearize
        from .device import CapturedProgram, node_stream

        t0 = time.perf_counter()
        self.rank = dist.get_rank()
        self.device = dev = device()
        for mod, name in FLAGS:
            setattr(_flag_owner(mod), name, spec["flags"][f"{mod}.{name}"])
        graph = from_recipe(spec["recipe"]).freeze()
        schedule = Schedule(spec["policy"], per_node=spec["per_node"],
                            assignment_order=spec["assignment_order"])
        ir = linearize(graph, schedule, device_order=spec["device_order"])
        if ir.signature() != spec["signature"]:
            raise RuntimeError(
                f"rank {self.rank} rebuilt {graph.name!r} from its recipe and "
                "lowered the schedule to another program than the "
                "controller's: the recipe does not rebuild the graph it "
                "was recorded on")
        rank_of: Dict[str, int] = spec["rank_of"]
        placement = schedule.placement
        mine = [n for n in spec["device_order"]
                if rank_of.get(n) == self.rank and n in ir.devices]
        self.streams: Dict[str, Any] = {}
        if dev.type == "cuda":
            self.streams = {n: node_stream(dev, spec["stream_index"][n])
                            for n in mine}
        loaded = torch.load(spec["params_path"], weights_only=False)
        self.params = params = {g: _map_leaves(lambda t: t.to(dev), v)
                                for g, v in loaded.items()}
        self.final = spec["final"]
        self.owner = rank_of[placement[self.final]] == self.rank
        self.takes_input = spec["takes_input"][self.rank]

        def local(t: str) -> bool:
            return rank_of[placement[t]] == self.rank

        # readers of each value on this rank, by key: a task id for a value
        # made here, (task id, node) for a value received for that node
        steps_at: List[List[Tuple[str, List[list]]]] = []
        flat: List[list] = []  # every step, in issue order
        readers: Dict[Any, List[Tuple[int, str]]] = {}
        for ph in ir.phases:
            per_node = []
            for node in mine:
                rows = []
                for tid in ph.compute.get(node, ()):
                    task = graph[tid]
                    aids = task.arg_tasks or task.dependencies
                    refs = tuple(d if local(d) else (d, node) for d in aids)
                    for r in refs:
                        readers.setdefault(r, []).append((len(flat), node))
                    pd = {loc: params[g] for loc, g in task.param_items()}
                    rows.append([tid, task.fn, pd, refs, ()])
                    flat.append(rows[-1])
                if rows:
                    per_node.append((node, rows))
            steps_at.append(per_node)
        made_on = {t: placement[t] for ph in ir.phases
                   for n, ts in ph.compute.items() for t in ts if local(t)}
        keep = {self.final}
        self.ops: List[List[tuple]] = []
        for ph in ir.phases:
            ops = []
            for ex in ph.exchanges:
                src, dst = rank_of[ex.src], rank_of[ex.dst]
                if src == dst == self.rank:
                    keep.add(ex.tid)
                    ev = torch.cuda.Event() if dev.type == "cuda" else None
                    ops.append(("event", ex.tid, ex.src, ex.dst, ev))
                elif src == self.rank:
                    keep.add(ex.tid)
                    ops.append(("send", ex.tid, ex.src, dst))
                elif dst == self.rank:
                    leaves, tree = tree_flatten(spec["avals"][ex.tid])
                    ops.append(("recv", (ex.tid, ex.dst), ex.dst, src,
                                tree, leaves))
            self.ops.append(ops)
        # releases: after the last reader, when every reader runs on the
        # stream that made the value
        for key, rs in readers.items():
            if key in keep:
                continue
            home = made_on.get(key) if isinstance(key, str) else key[1]
            if all(node == home for _, node in rs):
                flat[max(i for i, _ in rs)][4] += (key,)
        self.phases = [
            [(node, [tuple(r) for r in rows]) for node, rows in per_node]
            for per_node in steps_at]
        self._made_on, self._kept = made_on, keep
        if spec["gate"]:  # the releases checked as the planned path's are
            from ..analysis import analyze_donation

            analyze_donation(self.donation_table()).raise_if_errors()
        self._flag = torch.zeros(1, dtype=torch.int32, device=dev)
        self.launches: Dict[str, int] = {}
        self.output: Any = None
        x = spec["input"]
        ext = ({"input": tree_map_only(
            torch.Tensor, lambda t: t.to(dev), _from_numpy(x))}
            if self.takes_input else {})
        if dev.type == "cuda":
            self._program = CapturedProgram(self._forked,
                                            torch.cuda.Stream(device=dev))
            out = self._program({}, ext)  # warm-up, capture, first replay
            self.launches = dict(self._program.launches)
            torch.cuda.synchronize(dev)
            self.output = out if self.owner else None
        else:
            self._program = None
            out = self._forked(None, ext)
            if self.owner:
                self.output = tree_map_only(
                    torch.Tensor, lambda t: t.clone().share_memory_(), out)
        self.build_s = time.perf_counter() - t0

    def donation_table(self) -> Dict[str, Any]:
        """The rank's releases in the shape of :meth:`.dispatch_plan.
        DispatchPlan.donation_table`, for ``analysis/donation_pass``: a
        step per task, a slot per value (a received one per destination
        node), the values read on another stream or sent as end-of-run
        readers (``fence_slots``): none of them may be released."""
        slot: Dict[Any, int] = {}

        def at(key) -> int:
            return slot.setdefault(key, len(slot))

        def here(ref, node) -> bool:
            return self._made_on.get(ref) == node if isinstance(ref, str) \
                else ref[1] == node

        steps = tuple(
            {"tids": (tid,), "node_id": node,
             "arg_slots": tuple(dict.fromkeys(at(r) for r in refs)),
             "xfer_slots": tuple(dict.fromkeys(
                 at(r) for r in refs if not here(r, node))),
             "donate_slots": tuple(at(r) for r in release),
             "out_slots": (at(tid),)}
            for per_node in self.phases for node, rows in per_node
            for tid, _fn, _pd, refs, release in rows)
        return {
            "steps": steps,
            "final_slot": at(self.final) if self.owner else None,
            "keep_list": (),
            "ext_slots": (),
            "fence_slots": tuple((self._made_on[k], at(k))
                                 for k in sorted(self._kept)
                                 if k in self._made_on),
            "input_slots": (),
            "n_slots": len(slot),
        }

    def reload(self, path: str) -> None:
        """Copy the params saved at ``path`` into this rank's, in place:
        the captured graph reads them at their addresses."""
        loaded = torch.load(path, weights_only=False)
        for g, v in loaded.items():
            for dst, src in zip(tree_leaves(self.params[g]), tree_leaves(v)):
                dst.copy_(src)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _barrier(self) -> None:
        import torch.distributed as dist

        dist.all_reduce(self._flag, op=dist.ReduceOp.MAX)

    def _on(self, node: str):
        s = self.streams.get(node)
        return torch.cuda.stream(s) if s is not None else nullcontext()

    def _forked(self, _params, ext: Dict[str, Any]) -> Any:
        """The rank's run between two barriers, its node streams forked
        from the current stream and joined back into it: what the CUDA
        graph captures."""
        import torch.distributed as dist

        self._barrier()
        x = ext.get("input")
        cur = (torch.cuda.current_stream(self.device)
               if self.device.type == "cuda" else None)
        for s in self.streams.values():
            s.wait_stream(cur)
        vals: Dict[Any, Any] = {}
        held: List[torch.Tensor] = []  # contiguous copies being sent
        for per_node, ops in zip(self.phases, self.ops):
            for node, rows in per_node:
                with self._on(node):
                    for tid, fn, pd, refs, release in rows:
                        args = [vals[r] for r in refs] if refs else [x]
                        vals[tid] = fn(pd, *args)
                        for r in release:
                            del vals[r]
            for op in ops:
                kind = op[0]
                if kind == "event":
                    _, _tid, src, dst, ev = op
                    if ev is not None:
                        ev.record(self.streams[src])
                        self.streams[dst].wait_event(ev)
                elif kind == "send":
                    _, tid, src, peer = op
                    with self._on(src):
                        for t in tree_leaves(vals[tid]):
                            if not t.is_contiguous():
                                t = t.contiguous()
                                held.append(t)
                            dist.send(t, peer)
                else:
                    _, key, dst, peer, tree, leaves = op
                    with self._on(dst):
                        got = []
                        for b in leaves:
                            buf = torch.empty(b.shape, dtype=b.dtype,
                                              device=self.device)
                            dist.recv(buf, peer)
                            if buf.stride() != b.stride:
                                buf = torch.empty_strided(
                                    b.shape, b.stride, dtype=b.dtype,
                                    device=self.device).copy_(buf)
                            got.append(buf)
                        vals[key] = tree_unflatten(got, tree)
        for s in self.streams.values():
            cur.wait_stream(s)
        out = vals[self.final] if self.owner else None
        self._barrier()
        return out

    def run(self, x: Any, reps: int) -> Dict[str, Any]:
        """``reps`` runs back to back: each rank's window between its
        first run's start and its last run's end (CUDA events on a card,
        the host clock under gloo, with the ranks lined up by a barrier
        before it), the host seconds of its calls, its host calls per run,
        and what its kernels ran."""
        import torch.distributed as dist

        from ..ops import kernels

        ext = {"input": _from_numpy(x)} if self.takes_input else {}
        names = set(kernels.launches) | set(kernels.replayed)
        before = {k: kernels.ran(k) for k in names}
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            held = int(torch.cuda.memory_allocated(self.device))
            self._barrier()
            torch.cuda.synchronize(self.device)  # the ranks lined up
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            t0 = time.perf_counter()
            for _ in range(reps):
                self._program({}, ext)
            host = time.perf_counter() - t0
            b.record()
            b.synchronize()
            window = a.elapsed_time(b) / 1e3
            calls = len(tree_leaves(ext)) + 1
        else:
            held = 0
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(reps):
                out = self._forked(None, ext)
                if self.owner:
                    for dst, src in zip(tree_leaves(self.output),
                                        tree_leaves(out)):
                        dst.copy_(src)
            host = window = time.perf_counter() - t0
            calls = 1
        names = set(kernels.launches) | set(kernels.replayed)
        ran = {k: kernels.ran(k) - before.get(k, 0) for k in sorted(names)}
        return {
            "window_s": window / reps,
            "host_s": host / reps,
            "calls": calls,
            "ran": {k: v for k, v in ran.items() if v},
            "peak_bytes": (int(torch.cuda.max_memory_allocated(self.device))
                           if cuda else 0),
            "held_bytes": held,
        }


def _from_numpy(x: Any) -> Any:
    import numpy as np

    return tree_map_only(np.ndarray, torch.from_numpy, x)


def _to_numpy(x: Any) -> Any:
    return tree_map_only(torch.Tensor, lambda t: t.detach().cpu().numpy(), x)


def rank_build(spec: Dict[str, Any]) -> Dict[str, Any]:
    """Build this rank's program (a world holds one); its captured
    launches, build seconds and, on the owner of the final output, the
    shared output."""
    global _PROGRAM
    _PROGRAM = None
    prog = RankProgram(spec)
    _PROGRAM = prog
    return {"launches": prog.launches, "build_s": prog.build_s,
            "output": prog.output}


def rank_run(x: Any, reps: int) -> Dict[str, Any]:
    """``reps`` runs of this rank's program (:meth:`RankProgram.run`)."""
    return _PROGRAM.run(x, reps)


def rank_reload(path: Optional[str]) -> None:
    """Load the params saved at ``path`` into this rank's program (None:
    none of this rank's changed)."""
    if path is not None:
        _PROGRAM.reload(path)


def param_versions(params: Dict[str, Any]) -> Dict[str, Tuple[int, ...]]:
    """Each param's in-place version counters (an inference tensor has
    none: -1)."""
    return {g: tuple(-1 if t.is_inference() else t._version
                     for t in tree_leaves(v))
            for g, v in params.items()}


# -- the controller side ----------------------------------------------------


class WorldProgram:
    """A placed run over several devices: a :class:`..parallel.launch.
    World` with one rank per device, each holding its :class:`RankProgram`.

    Built by :meth:`.compiled_schedule.CompiledSchedule.build` after the
    gate and the lowering, in the ``world`` it started for the program
    (outside every timed window) and stops with it: when the program
    leaves the backend's cache (it is collected), when the backend closes
    (:meth:`close`), and at interpreter exit.  Building replaces the
    program the world's ranks held.  With ``gate`` each rank checks its
    releases with the donation pass before it runs.  :meth:`run` gives
    every rank's numbers and the output; :meth:`refresh` reloads params
    updated in place."""

    def __init__(self, backend, graph: TaskGraph, schedule: Schedule,
                 ir: ProgramIR, devices: Sequence[torch.device],
                 params: Dict[str, Any], graph_input: Any, world: Any,
                 gate: bool = True):
        if getattr(graph, "recipe", None) is None:
            raise ValueError(no_recipe_message(graph, devices))
        if world.size != len(devices):
            raise ValueError(f"a world of {world.size} cannot run a "
                             f"program over {len(devices)} devices")
        self.world = world
        self.ir = ir
        self.devices = tuple(devices)
        self.placement = schedule.placement
        index = [(d.type, device_index(d)) for d in self.devices]
        self.rank_of = {
            d.node_id: index.index((d.torch_device.type,
                                    device_index(d.torch_device)))
            for d in backend.cluster if d.node_id in ir.devices}
        order = set(ir.order)
        self.final = (graph.topo_order[-1] if graph.topo_order[-1] in order
                      else ir.order[-1])
        self.owner = self.rank_of[self.placement[self.final]]
        avals = value_avals(graph, ir.order, params, graph_input)
        self.xfer_nbytes = {ex.tid: _array_bytes(avals[ex.tid])
                            for ph in ir.phases for ex in ph.exchanges}
        self.transfer_edges = ir.n_exchanges
        #: the exchanges whose ends are on two ranks
        self.cross = [ex for ph in ir.phases for ex in ph.exchanges
                      if self.rank_of[ex.src] != self.rank_of[ex.dst]]
        self.transfer_bytes = sum(self.xfer_nbytes[ex.tid]
                                  for ph in ir.phases for ex in ph.exchanges)
        self.out_bytes = _array_bytes(avals[self.final])
        self.n_input = len(tree_leaves(graph_input))
        t0 = time.perf_counter()
        specs = self._rank_specs(backend, graph, schedule, params,
                                 graph_input, avals, gate)
        self._versions = param_versions(self._held)
        replies = self.world.call(rank_build, rank_args=[(s,) for s in specs])
        #: the world's start and the ranks' builds, on the host clock
        self.start_s = world.start_s + time.perf_counter() - t0
        self.rank_launches = [r["launches"] for r in replies]
        self.output = replies[self.owner]["output"]
        self.build_s = [r["build_s"] for r in replies]

    def _rank_specs(self, backend, graph, schedule, params, graph_input,
                    avals, gate: bool) -> List[Dict[str, Any]]:
        """One description per rank; each rank's params saved into the
        world's directory."""
        ir = self.ir
        n = len(self.devices)
        needed: List[Dict[str, None]] = [{} for _ in range(n)]
        takes_input = [False] * n
        for tid in ir.order:
            r = self.rank_of[self.placement[tid]]
            task = graph[tid]
            for _, g in task.param_items():
                needed[r].setdefault(g)
            if not (task.arg_tasks or task.dependencies):
                takes_input[r] = True
        stream_index: Dict[str, int] = {}
        seen: Dict[Any, int] = {}
        for d in backend.cluster:
            stream_index[d.node_id] = seen.get(d.torch_device, 0)
            seen[d.torch_device] = stream_index[d.node_id] + 1
        exchanged = {ex.tid for ph in ir.phases for ex in ph.exchanges}
        flags = {f"{mod}.{name}": getattr(_flag_owner(mod), name)
                 for mod, name in FLAGS}
        common = dict(
            recipe=graph.recipe, policy=schedule.policy,
            per_node={k: list(v) for k, v in schedule.per_node.items()},
            assignment_order=list(schedule.assignment_order),
            device_order=[d.node_id for d in backend.cluster],
            signature=ir.signature(), rank_of=self.rank_of,
            stream_index=stream_index, final=self.final,
            takes_input=takes_input, flags=flags, gate=gate,
            avals={t: _buffers_of(avals[t]) for t in exchanged},
            input=_to_numpy(graph_input),
        )
        self._needed = [list(d) for d in needed]
        self._held = {g: params[g] for d in needed for g in d}
        return [dict(common, params_path=self._save(r, self._needed[r]))
                for r in range(n)]

    def _save(self, rank: int, groups: Sequence[str]) -> str:
        """Save ``groups`` of the controller's params for ``rank`` into the
        world's directory; the file's path."""
        path = self.world.directory / f"params_{rank}.pt"
        torch.save({g: _map_leaves(lambda t: t.detach().cpu(), self._held[g])
                    for g in groups}, path)
        return str(path)

    def refresh(self) -> List[str]:
        """Reload into the ranks every param the caller updated in place
        since the build or the last refresh (its version counters moved);
        the groups reloaded."""
        now = param_versions(self._held)
        changed = sorted(g for g in now if now[g] != self._versions[g])
        if changed:
            paths = [(self._save(r, [g for g in self._needed[r]
                                     if g in changed]),)
                     if any(g in changed for g in self._needed[r]) else
                     (None,)
                     for r in range(len(self.devices))]
            self.world.call(rank_reload, rank_args=paths)
            self._versions = now
        return changed

    def donation_summary(self) -> Dict[str, Any]:
        """The program's arguments, as :meth:`.compiled_schedule.
        CompiledSchedule.donation_summary` gives them: the params
        (position 0, placed once in the ranks) and the graph input
        (position 1, copied into each rank's static buffer); neither is
        donated."""
        return {
            "path": "world",
            "param_argnums": (0,),
            "input_argnums": (1,),
            "donated_argnums": (),
        }

    @property
    def launches(self) -> Dict[str, int]:
        """The kernel launches the ranks' captures recorded, summed."""
        out: Dict[str, int] = {}
        for per in self.rank_launches:
            for k, v in per.items():
                out[k] = out.get(k, 0) + v
        return out

    def run(self, graph_input: Any, reps: int = 1) -> Dict[str, Any]:
        """``reps`` runs on every rank; the ranks' numbers and the output
        (the owner's shared tensor: it holds until the next run)."""
        t0 = time.perf_counter()
        per = self.world.call(rank_run, (_to_numpy(graph_input), reps))
        return {"ranks": per, "output": self.output,
                "wall_s": time.perf_counter() - t0}

    def close(self) -> None:
        """Stop the world (idempotent)."""
        self.output = None
        self.world.close()


def no_recipe_message(graph: TaskGraph, devices) -> str:
    return (
        f"compiled=True over {len(devices)} devices "
        f"({', '.join(str(d) for d in devices)}) runs a process per device, "
        f"and each rebuilds the graph from its recipe; graph "
        f"{graph.name!r} has none (its task functions are closures and do "
        "not pickle).  Build it with a DAG builder that records one "
        "(frontend.gpt2_dag.build_gpt2_dag), or place it on one device")


__all__ = ["RankProgram", "WorldProgram", "book_program_memory",
           "check_world_devices", "device_index", "param_versions",
           "rank_build", "rank_reload", "rank_run", "value_avals",
           "world_devices"]
