"""The whole placed run as one program: one CUDA graph, a stream per node.

PyTorch port of ``distributed_llm_scheduler_tpu.backends.compiled_schedule``.
The rungs below this one (per task, planned, segmented) still have the host
issue at least one call per segment.  Here the **entire** placed run,
built from the :class:`..sched.linearize.ProgramIR`, is captured into ONE
CUDA graph, so a run is one copy of the input into the graph's static
buffer and one ``replay()``:

* the program captured is the planned path's own run
  (:class:`.dispatch_plan.DispatchPlan` over the IR's dispatch order):
  each node's tasks on that node's stream, forked from the capture stream
  (every node stream waits on it first);
* a value read on another node is an event recorded on the producer's
  stream after it and waited on by the consumer's stream (nodes of one
  card share its memory, so nothing is copied); the capture therefore
  holds the schedule's parallelism across nodes and nothing more;
* every node stream is joined back into the capture stream before the
  capture ends;
* each value is released after its last consumer inside the capture, so
  the graph's private memory pool reuses it; a value read on another
  node's stream is marked used by that stream first.

The IR gives the program's signature (its cache key) and the exchanges
counted in ``transfer_edges`` and ``transfer_bytes``: one per value and
destination node, as the reference counts them.  Per-task outputs stay
bit-identical to the planned path: the same plan runs the same kernels on
the same shapes.  The reference lowers a run that spans several devices to
one SPMD program with ``ppermute`` exchanges (``_build_mesh``); its
counterpart over several cards waits for ``parallel/`` on
``torch.distributed`` (ROADMAP.md A.11), so a cluster whose nodes span
more than one device raises here.  On the CPU the plan runs eagerly, for
the tests.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import torch

from ..core.graph import TaskGraph
from ..core.schedule import Schedule
from ..sched.linearize import ProgramIR
from .device import CapturedProgram, _array_bytes
from .dispatch_plan import DispatchPlan


def one_device(backend, nodes) -> Optional[torch.device]:
    """The one device ``nodes`` are bound to (None for no node); raises
    ``ValueError`` when they span several."""
    devices = list(dict.fromkeys(
        backend.cluster[n].torch_device for n in nodes))
    if len(devices) > 1:
        raise ValueError(
            f"compiled=True captures one device's run; the placed nodes "
            f"span {len(devices)} devices "
            f"({', '.join(str(d) for d in devices)}), and the compiled "
            "rung over several cards waits for parallel/ on "
            "torch.distributed (ROADMAP.md A.11)"
        )
    return devices[0] if devices else None


class CompiledSchedule:
    """One whole-run program for a placed schedule.

    Build with :meth:`build`; run with :meth:`run` (same return contract
    as the other rungs).  On a card the program is a
    :class:`.device.CapturedProgram` of the forked planned run, captured
    on a side stream on its first run (after one eager warm-up run on the
    node streams) and replayed after; its output is the graph's own tensor
    and holds until the next replay.  ``launches`` is the kernel launches
    the capture recorded.
    """

    def __init__(self, backend, graph: TaskGraph, schedule: Schedule,
                 ir: ProgramIR, placed: Dict[Tuple[str, str], Any],
                 device: torch.device):
        self.ir = ir
        self.device = device
        self.placement = schedule.placement
        self.graph_final = graph.topo_order[-1] if graph.topo_order else None
        self.transfer_edges = ir.n_exchanges
        self.transfer_bytes = 0
        self.plan = DispatchPlan.build(backend, graph, schedule, ir.order,
                                       placed)
        self._streams = list(dict.fromkeys(
            s for s in (backend.stream_of(n) for n in ir.devices)
            if s is not None))
        self._program = (
            CapturedProgram(self._forked, torch.cuda.Stream(device=device))
            if device.type == "cuda" else None
        )

    @staticmethod
    def lower(backend, graph: TaskGraph, schedule: Schedule,
              pre_analysis: bool = True, pre_report: Any = None
              ) -> Tuple[ProgramIR, Optional[torch.device]]:
        """The gate, then the lowering of ``schedule`` to its IR; returns
        the IR and the one device its nodes are bound to.

        With the gate on (``pre_analysis`` and no ``DLS_SKIP_ANALYSIS``)
        the schedule's corruption is refused first, before ``freeze()``
        (which would raise on a cycle) and before anything is placed;
        ``pre_report`` is a fresh ``analyze()`` report for this schedule
        that lets the gate skip its base passes.  Then the per-node orders
        are linearized: no global order is :class:`..analysis.
        AnalysisError` COL002, gate or not (there is no program to build),
        and with the gate on a divergent or malformed exchange order
        (COL001/COL004) is refused too.  Raises ``ValueError`` when the
        placed nodes span more than one device."""
        from ..analysis import (
            AnalysisError,
            analyze_schedule_lowerability,
            gate_enabled,
            pre_execution_gate,
        )

        gate = pre_analysis and gate_enabled()
        if gate:
            pre_execution_gate(graph, backend.cluster, schedule,
                               backend="device", precomputed=pre_report)
        graph.freeze()
        rep, ir = analyze_schedule_lowerability(
            graph, schedule,
            device_order=[d.node_id for d in backend.cluster])
        if ir is None:
            raise AnalysisError(rep)  # COL002: unlowerable, gate or not
        if gate:
            rep.raise_if_errors()  # COL001/COL004: the exchange order
        if not ir.order:
            raise ValueError(
                "schedule places no executable tasks; nothing to lower")
        return ir, one_device(backend, ir.devices)

    @classmethod
    def build(cls, backend, graph: TaskGraph, schedule: Schedule,
              placed: Dict[Tuple[str, str], Any], graph_input: Any,
              pre_analysis: bool = True, pre_report: Any = None,
              lowered: Optional[Tuple[ProgramIR, Optional[torch.device]]]
              = None) -> "CompiledSchedule":
        """Lower ``schedule`` over ``backend``'s cluster (cached per graph,
        IR, params and input shape).  ``lowered`` is :meth:`lower`'s result
        when the caller lowered already (``execute`` does, before it places
        anything); else :meth:`lower` runs here.  A new program's
        donation metadata is checked by the donation pass when the gate
        is on."""
        ir, device = lowered or cls.lower(
            backend, graph, schedule, pre_analysis, pre_report)
        key = (
            ir.signature(),
            tuple(sorted((k, v.data_ptr()) for k, v in placed.items())),
            tuple(graph_input.shape), graph_input.dtype,
        )
        cache = backend._prog_cache.setdefault(graph, {})
        prog = cache.get(key)
        if prog is None:
            prog = cls(backend, graph, schedule, ir, placed, device)
            from ..analysis import analyze_donation, gate_enabled

            if pre_analysis and gate_enabled():
                analyze_donation(prog).raise_if_errors()
            cache[key] = prog
        return prog

    def donation_summary(self) -> Dict[str, Any]:
        """Static donation metadata for ``analysis/donation_pass``, in the
        shape of the reference's: the program's arguments are the params
        (position 0, read in place at their placed addresses, shared by
        every replay) and the graph input (position 1, copied into the
        graph's static buffer).  The captured program donates neither: the
        values it lets die are the inner plan's, which
        :meth:`.dispatch_plan.DispatchPlan.donation_table` reports and its
        build checks."""
        return {
            "path": "captured" if self._program is not None else "eager",
            "param_argnums": (0,),
            "input_argnums": (1,),
            "donated_argnums": (),
        }

    @property
    def launches(self) -> Dict[str, int]:
        return self._program.launches if self._program is not None else {}

    def _forked(self, _params, ext: Dict[str, Any]) -> Any:
        """The planned run on the node streams, forked from the current
        stream and joined back into it: what the CUDA graph captures."""
        current = torch.cuda.current_stream(self.device)
        for s in self._streams:
            s.wait_stream(current)
        out = self.plan.run(ext["input"], None, {self.device: current})[0]
        for s in self._streams:
            current.wait_stream(s)
        return out

    def run(self, graph_input: Any, tracer: Any = None, metrics: Any = None,
            mem: Any = None, dclock: Any = None,
            slab_bytes: Optional[Dict[str, int]] = None,
            ) -> Tuple[Any, Dict, int, int, int, float, Dict]:
        """One run: ``(final, timings, transfer_edges, transfer_bytes,
        host calls, loop seconds, {})``.  On a card: the input copied into
        the static buffer and one replay on the current stream (the first
        run warms up and captures first); on the CPU the plan runs
        eagerly.

        The run has no per-task boundaries, so ``tracer`` gets one
        ``program`` span per node (the attribution then works at program
        granularity): on a card the replay's window on the device, from
        CUDA events through ``dclock``, beside the host's ``replay`` call
        on the host track; on the CPU the host window.  ``metrics`` counts
        the host calls and exchanges; ``mem`` books the build-time model
        as the reference's compiled rung does, once per run (labels
        replace across reps): a param slab per node (``slab_bytes``), the
        input on each node, each exchange on its destination and the
        final output on its owner."""
        t0 = time.perf_counter()
        a = b = None
        with torch.no_grad():
            if self._program is None:
                out, calls = self.plan.run(graph_input)[0], 1
            else:
                stream = torch.cuda.current_stream(self.device)
                a = dclock.mark(stream) if dclock is not None else None
                out, calls = self._program({}, {"input": graph_input}), 2
                b = dclock.mark(stream) if dclock is not None else None
        t1 = time.perf_counter()
        if not self.transfer_bytes:  # the exchanged values' sizes, once known
            self.transfer_bytes = sum(
                self.plan.xfer_nbytes[ex.tid]
                for ph in self.ir.phases for ex in ph.exchanges)
        if tracer is not None:
            n_tasks = {
                node: sum(len(ph.compute.get(node, ()))
                          for ph in self.ir.phases)
                for node in self.ir.devices
            }
            for node in self.ir.devices:
                kw = dict(track=node, cat="program", tasks=n_tasks[node],
                          phases=len(self.ir.phases))
                if a is not None:
                    dclock.window(("program", node), "program", self.device,
                                  a, b, **kw)
                else:
                    tracer.complete("program", t0, t1, **kw)
            if self._program is not None:
                tracer.complete("replay", t0, t1, track="host", cat="launch")
        if metrics is not None:
            metrics.counter("compiled.launches").inc(calls)
            metrics.counter("compiled.exchanges").inc(self.transfer_edges)
        if mem is not None:
            in_bytes = graph_input.numel() * graph_input.element_size()
            for node in self.ir.devices:
                pb = (slab_bytes or {}).get(node, 0)
                if pb:
                    mem.alloc(node, "slab:params", pb, "params")
                mem.alloc(node, "input", in_bytes, "activations")
            for ph in self.ir.phases:
                for ex in ph.exchanges:
                    mem.alloc(ex.dst, f"xfer:{ex.tid}",
                              self.plan.xfer_nbytes[ex.tid], "transfers")
            order = set(self.ir.order)
            final = (self.graph_final if self.graph_final in order
                     else self.ir.order[-1])
            mem.alloc(self.placement[final], f"out:{final}",
                      _array_bytes(out), "activations")
        return (out, {}, self.transfer_edges, self.transfer_bytes, calls,
                t1 - t0, {})
