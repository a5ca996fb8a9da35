"""Real device execution backend: placed, dispatched, measured.

PyTorch port of the per-task path of ``distributed_llm_scheduler_tpu.
backends.device``.  The scheduler's placement decision becomes real
dispatch of each task's tensor fn onto the device its node is bound to:

* parameters are copied onto every device that runs a task needing them
  (the reference's ``param_locations`` bookkeeping made physical);
* a dependency edge whose producer and consumer sit on different nodes is
  a transfer, counted in ``transfer_edges`` / ``transfer_bytes`` exactly as
  the JAX package counts it; it is a physical copy when the two nodes are
  bound to different devices, while nodes bound to one card share its
  memory and the edge moves nothing;
* dispatch follows the schedule: :meth:`dispatch_order` linearizes the
  per-node lists, and every task of a node bound to a CUDA device runs on
  that device's current stream, so the dispatch order IS the execution
  order.

Timing: on a cluster bound to one CUDA device the makespan is read from
CUDA events recorded on its stream around the timed repetitions; on the
CPU, or across several cards, from the host clock after synchronizing.
Profile mode records an event pair (or host timestamps on the CPU) around
every task.  Peak device memory comes from ``torch.cuda.max_memory_allocated``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..core.cluster import Cluster
from ..core.graph import TaskGraph
from ..core.schedule import Schedule, TaskTiming


@dataclass
class DeviceReport:
    """Measured execution result for one placed DAG run."""

    policy: str
    makespan_s: float
    output: Any
    n_devices: int
    transfer_edges: int
    transfer_bytes: int
    param_bytes_placed: Dict[str, int]
    # seconds of the untimed warmup run (kernel builds, allocator and
    # library warm-up; eager PyTorch has no graph compile)
    compile_s: float
    # only in profile mode: per-task measured times
    timings: Dict[str, TaskTiming] = field(default_factory=dict)
    # peak allocated bytes per CUDA device over the timed runs
    peak_hbm_bytes: Dict[str, int] = field(default_factory=dict)
    # task fns dispatched per run
    n_dispatches: int = 0
    # host wall seconds inside the dispatch loop, per rep
    dispatch_overhead_s: float = 0.0

    @property
    def total_param_gb_placed(self) -> float:
        return sum(self.param_bytes_placed.values()) / 1024**3

    def summary(self) -> Dict[str, Any]:
        return {
            "policy": self.policy,
            "makespan_ms": self.makespan_s * 1e3,
            "n_devices": self.n_devices,
            "transfer_edges": self.transfer_edges,
            "transfer_mb": self.transfer_bytes / 1024**2,
            "param_gb_placed": self.total_param_gb_placed,
            "compile_s": self.compile_s,
            "n_dispatches": self.n_dispatches,
            "dispatch_overhead_ms": self.dispatch_overhead_s * 1e3,
            "peak_hbm_gb": {
                k: v / 1024**3 for k, v in self.peak_hbm_bytes.items()
            },
        }


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class DeviceBackend:
    """Executes a scheduled TaskGraph on torch devices.

    ``cluster`` must be built with ``Cluster.from_torch_devices`` (each
    DeviceState carries its ``torch_device``); the schedule's placement
    maps task -> DeviceState -> real device.
    """

    def __init__(self, cluster: Cluster):
        missing = [d.node_id for d in cluster if d.torch_device is None]
        if missing:
            raise ValueError(
                f"cluster devices {missing} have no bound torch_device; "
                "build the cluster with Cluster.from_torch_devices()"
            )
        self.cluster = cluster
        self.devices = list(dict.fromkeys(d.torch_device for d in cluster))
        self.cuda_devices = [d for d in self.devices if d.type == "cuda"]

    def _synchronize(self) -> None:
        for dev in self.cuda_devices:
            torch.cuda.synchronize(dev)

    # -- placement ---------------------------------------------------------
    def place_params(
        self,
        graph: TaskGraph,
        schedule: Schedule,
        params: Dict[str, torch.Tensor],
    ) -> Tuple[Dict[Tuple[str, str], torch.Tensor], Dict[str, int]]:
        """Put each param onto the device of every node that runs a task
        needing it.  Returns ``(param_name, node_id) -> tensor`` plus the
        bytes placed per node (a param needed on k nodes counts k times;
        a tensor already on the node's device is used in place)."""
        placed: Dict[Tuple[str, str], torch.Tensor] = {}
        bytes_per_node: Dict[str, int] = {d.node_id: 0 for d in self.cluster}
        for tid, node_id in schedule.placement.items():
            dev = self.cluster[node_id].torch_device
            for p in graph[tid].params_needed:
                key = (p, node_id)
                if key not in placed:
                    placed[key] = params[p].to(dev)
                    bytes_per_node[node_id] += _nbytes(params[p])
        self._synchronize()
        return placed, bytes_per_node

    # -- dispatch order ----------------------------------------------------
    @staticmethod
    def dispatch_order(graph: TaskGraph, schedule: Schedule) -> List[str]:
        """Global dispatch linearization honoring per-node scheduled order.

        A device stream executes enqueued work FIFO, so within one node
        the emitted sequence must be exactly ``schedule.per_node[node]``.
        Across nodes, a task can only be dispatched after its producers.
        Greedy merge: repeatedly emit, among node-queue heads whose deps
        are all emitted (or unplaced, i.e. failed), the one the scheduler
        assigned earliest.  If per-node orders are mutually inconsistent
        (a cross-node ordering cycle — no valid policy output does this),
        the remainder falls back to topological order rather than
        deadlocking.
        """
        placement = schedule.placement
        topo_pos = {tid: i for i, tid in enumerate(graph.topo_order)}
        prio = {tid: i for i, tid in enumerate(schedule.assignment_order)}
        # filter each node's list against `placement` (which keeps the LAST
        # per_node match): a task erroneously present in two nodes' lists is
        # dispatched once, on the node placement says, never twice
        queues = {
            n: [t for t in lst if t in topo_pos and placement.get(t) == n]
            for n, lst in schedule.per_node.items()
            if lst
        }
        queues = {n: q for n, q in queues.items() if q}
        idx = {n: 0 for n in queues}
        emitted: set = set()
        order: List[str] = []

        def head_ready(n: str) -> bool:
            i = idx[n]
            if i >= len(queues[n]):
                return False
            t = queues[n][i]
            return all(
                d in emitted or d not in placement
                for d in graph[t].dependencies
            )

        total = sum(len(q) for q in queues.values())
        while len(order) < total:
            ready_nodes = [n for n in queues if head_ready(n)]
            if not ready_nodes:
                break  # inconsistent per-node orders: topo fallback below
            n = min(
                ready_nodes,
                key=lambda n: (
                    prio.get(
                        queues[n][idx[n]], topo_pos[queues[n][idx[n]]]
                    ),
                    topo_pos[queues[n][idx[n]]],
                ),
            )
            t = queues[n][idx[n]]
            idx[n] += 1
            emitted.add(t)
            order.append(t)
        order.extend(
            t for t in graph.topo_order if t in placement and t not in emitted
        )
        return order

    # -- timing marks --------------------------------------------------------
    @staticmethod
    def _mark(dev: torch.device) -> Any:
        """A point on ``dev``'s timeline: a recorded CUDA event, or the
        host clock for the CPU (whose ops run synchronously)."""
        if dev.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(dev))
            return ev
        return time.perf_counter()

    @staticmethod
    def _seconds(a: Any, b: Any) -> float:
        """Seconds from mark ``a`` to mark ``b`` (same device; events must
        have completed)."""
        if isinstance(a, float):
            return b - a
        return a.elapsed_time(b) / 1e3

    # -- execution ---------------------------------------------------------
    def _run(
        self,
        graph: TaskGraph,
        schedule: Schedule,
        placed: Dict[Tuple[str, str], torch.Tensor],
        graph_input: torch.Tensor,
        order: List[str],
        profile: bool = False,
    ) -> Tuple[Any, Dict[str, TaskTiming], int, int, int, float]:
        placement = schedule.placement
        outputs: Dict[str, Any] = {}
        transfer_edges = 0
        transfer_bytes = 0
        # the shared graph input placed once per node, not once per root
        input_on: Dict[str, torch.Tensor] = {}
        origin = {dev: self._mark(dev) for dev in self.devices} if profile else {}
        marks: List[Tuple[str, str, torch.device, Any, Any]] = []
        t_loop0 = time.perf_counter()
        with torch.no_grad():
            for tid in order:
                if tid not in placement:
                    continue  # failed task: skip (fail-and-continue semantics)
                task = graph[tid]
                node_id = placement[tid]
                dev = self.cluster[node_id].torch_device

                arg_ids = task.arg_tasks or task.dependencies
                if arg_ids and any(d not in outputs for d in arg_ids):
                    continue  # upstream failed; propagate skip

                pd = {
                    loc: placed[(glob, node_id)]
                    for loc, glob in task.param_items()
                }
                if arg_ids:
                    args = []
                    for d in arg_ids:
                        x = outputs[d]
                        if placement.get(d) != node_id:
                            # cross-node edge; a copy only between devices
                            transfer_edges += 1
                            transfer_bytes += _nbytes(x)
                            x = x.to(dev, non_blocking=True)
                        args.append(x)
                else:
                    inp = input_on.get(node_id)
                    if inp is None:
                        inp = graph_input.to(dev)
                        input_on[node_id] = inp
                    args = [inp]

                if profile:
                    start = self._mark(dev)
                    out = task.fn(pd, *args)
                    marks.append((tid, node_id, dev, start, self._mark(dev)))
                else:
                    out = task.fn(pd, *args)
                outputs[tid] = out
        loop_s = time.perf_counter() - t_loop0

        timings: Dict[str, TaskTiming] = {}
        if profile:
            self._synchronize()
            for tid, node_id, dev, start, end in marks:
                o = origin[dev]
                timings[tid] = TaskTiming(
                    tid, node_id, self._seconds(o, start), self._seconds(o, end)
                )
        final = outputs.get(graph.topo_order[-1]) if graph.topo_order else None
        return final, timings, transfer_edges, transfer_bytes, len(outputs), loop_s

    def paged_decode_engine(
        self,
        graph: TaskGraph,
        schedule: Schedule,
        config: Any,
        weights: Dict[str, Any],
        pool: Any,
        slots: int,
        pages_per_seq: int,
        seg_steps: int = 8,
        trace: Any = None,
        metrics: Any = None,
        clock: Any = None,
        memprof: Any = None,
        flight: Any = None,
        chunk_tokens: Optional[int] = None,
    ):
        """Continuous-batching paged decode engine over a SCHEDULED paged
        decode-step DAG (``frontend.build_paged_decode_dag``), running on
        the device the schedule placed the step on.  ``pool`` is the
        host-side ``models.kv_pages.PagePool`` whose geometry must match
        the graph's pool params.  (The JAX package first runs its static
        pre-execution analysis gate here; that gate is not ported.)"""
        from .decode_loop import PagedDecodeEngine

        nodes = set(schedule.placement.values())
        if len(nodes) != 1:
            raise ValueError(
                f"paged decode needs a single-node placement, got {len(nodes)}"
            )
        device = self.cluster[nodes.pop()].torch_device
        return PagedDecodeEngine(
            graph, schedule, config, weights, pool,
            slots=slots, pages_per_seq=pages_per_seq, seg_steps=seg_steps,
            tracer=trace, metrics=metrics, clock=clock, memprof=memprof,
            flight=flight, chunk_tokens=chunk_tokens, device=device,
        )

    def execute(
        self,
        graph: TaskGraph,
        schedule: Schedule,
        params: Dict[str, torch.Tensor],
        graph_input: torch.Tensor,
        profile: bool = False,
        warmup: bool = True,
        reps: int = 1,
    ) -> DeviceReport:
        """Place params, warm up, run ``reps`` times, measure.

        ``warmup`` runs the placed DAG once untimed first (kernel builds,
        allocator and library warm-up).  ``reps > 1`` dispatches the whole
        placed run back to back and synchronizes once; ``makespan_s`` is
        the per-run time.  ``profile=True`` records per-task times into
        ``timings`` (and ``schedule.timings``); it needs ``reps == 1``.
        """
        if reps < 1:
            raise ValueError(f"reps must be >= 1, got {reps}")
        if reps > 1 and profile:
            raise ValueError("profile mode times one run; use reps=1")
        graph.freeze()
        no_fn = [t.task_id for t in graph if t.fn is None]
        if no_fn:
            raise ValueError(
                f"tasks {no_fn[:3]} have no fn; this graph is schedule-only "
                "(synthetic DAGs execute on the simulated backend)"
            )
        missing = sorted(graph.unique_params() - set(params))
        if missing:
            raise ValueError(f"params missing for placement: {missing[:5]}")

        order = self.dispatch_order(graph, schedule)
        placed, bytes_per_node = self.place_params(graph, schedule, params)

        compile_s = 0.0
        if warmup:
            t0 = time.perf_counter()
            self._run(graph, schedule, placed, graph_input, order)
            self._synchronize()
            compile_s = time.perf_counter() - t0

        for dev in self.cuda_devices:
            torch.cuda.reset_peak_memory_stats(dev)
        self._synchronize()
        # one card: CUDA events on its stream; else the host clock
        one_card = len(self.devices) == 1 and bool(self.cuda_devices)
        t0 = self._mark(self.devices[0]) if one_card else time.perf_counter()
        loop_s = 0.0
        for _ in range(reps):
            output, timings, tedges, tbytes, n_disp, rep_loop_s = self._run(
                graph, schedule, placed, graph_input, order, profile=profile
            )
            loop_s += rep_loop_s
        if one_card:
            t1 = self._mark(self.devices[0])
            self._synchronize()
            wall = self._seconds(t0, t1)
        else:
            self._synchronize()
            wall = time.perf_counter() - t0
        peaks = {
            str(dev): int(torch.cuda.max_memory_allocated(dev))
            for dev in self.cuda_devices
        }
        if timings:
            schedule.timings = timings
        return DeviceReport(
            policy=schedule.policy,
            makespan_s=max(wall / reps, 1e-9),
            output=output,
            n_devices=len(self.cluster),
            transfer_edges=tedges,
            transfer_bytes=tbytes,
            param_bytes_placed=bytes_per_node,
            compile_s=compile_s,
            timings=timings,
            peak_hbm_bytes=peaks,
            n_dispatches=n_disp,
            dispatch_overhead_s=loop_s / reps,
        )
