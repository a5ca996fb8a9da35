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
from ..sched.linearize import ProgramIR, linearize
from .device import CapturedProgram
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

    @classmethod
    def build(cls, backend, graph: TaskGraph, schedule: Schedule,
              placed: Dict[Tuple[str, str], Any], graph_input: Any
              ) -> "CompiledSchedule":
        """Lower ``schedule`` over ``backend``'s cluster (cached per graph,
        IR, params and input shape).  Raises
        :class:`..sched.linearize.OrderingDeadlock` when the per-node
        orders admit no global order, and ``ValueError`` when the placed
        nodes span more than one device."""
        graph.freeze()
        ir = linearize(graph, schedule,
                       device_order=[d.node_id for d in backend.cluster])
        if not ir.order:
            raise ValueError(
                "schedule places no executable tasks; nothing to lower")
        device = one_device(backend, ir.devices)
        key = (
            ir.signature(),
            tuple(sorted((k, v.data_ptr()) for k, v in placed.items())),
            tuple(graph_input.shape), graph_input.dtype,
        )
        cache = backend._prog_cache.setdefault(graph, {})
        prog = cache.get(key)
        if prog is None:
            prog = cls(backend, graph, schedule, ir, placed, device)
            cache[key] = prog
        return prog

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

    def run(self, graph_input: Any) -> Tuple[Any, Dict, int, int, int, float, Dict]:
        """One run: ``(final, timings, transfer_edges, transfer_bytes,
        host calls, loop seconds, {})``.  On a card: the input copied into
        the static buffer and one replay on the current stream (the first
        run warms up and captures first); on the CPU the plan runs
        eagerly."""
        t0 = time.perf_counter()
        with torch.no_grad():
            if self._program is None:
                out, calls = self.plan.run(graph_input)[0], 1
            else:
                out, calls = self._program({}, {"input": graph_input}), 2
        if not self.transfer_bytes:  # the exchanged values' sizes, once known
            self.transfer_bytes = sum(
                self.plan.xfer_nbytes[ex.tid]
                for ph in self.ir.phases for ex in ph.exchanges)
        return (out, {}, self.transfer_edges, self.transfer_bytes, calls,
                time.perf_counter() - t0, {})
