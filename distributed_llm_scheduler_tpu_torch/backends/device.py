"""Real device execution backend: placed, dispatched, measured.

PyTorch port of ``distributed_llm_scheduler_tpu.backends.device``.  The
scheduler's placement decision becomes real dispatch of each task's tensor
fn onto the device its node is bound to:

* parameters are copied onto every device that runs a task needing them
  (the reference's ``param_locations`` bookkeeping made physical);
* every node bound to a CUDA device runs on a stream of its own, so the
  nodes of one placement that share a card run side by side, as the
  reference's per-device queues do;
* a dependency edge whose producer and consumer sit on different nodes is
  a transfer, counted in ``transfer_edges`` / ``transfer_bytes`` exactly as
  the JAX package counts it.  On one card it is an event recorded on the
  producer's stream and waited on by the consumer's (nodes of one card
  share its memory, so nothing is copied); across cards the consumer's
  stream waits on that event and then issues the copy;
* dispatch follows the schedule: :meth:`dispatch_order` linearizes the
  per-node lists, and each node's stream executes its tasks in its
  scheduled order.

The execution ladder, from the finest rung to the coarsest:

1. per task (``planned=False``): :meth:`_run` walks the dispatch order;
2. planned (the default, :mod:`.dispatch_plan`): the same launches from a
   table built once per ``execute``, each value released after its last
   consumer; ``coalesce=True`` runs same-node runs as one host call;
3. segmented (``segments=True``): each maximal same-node run of the order
   (:meth:`build_segments`) is one program, its sibling microbatch tasks
   re-batched (:mod:`.rebatch`); on a card each segment is captured once
   into a CUDA graph and replayed once per run;
4. compiled (``compiled=True``, :mod:`.compiled_schedule`): the whole placed
   run is one CUDA graph with a stream per node; one replay per run.

Parameter streaming (``stream_params=True``, :class:`DeviceBackend.
_ParamStreamer`) runs a placement whose nodes cannot hold their weights:
each node loads a parameter from pinned host memory before its first use
and evicts under its budget, on the per-task and segmented rungs (a
segment is then an eager program per load, never a captured one: a
captured graph reads its parameters at fixed addresses).

Observability (``execute(trace=, metrics=, memprof=)``, or the ambient
pair under ``DLS_TRACE``): host phase spans, per-launch spans on each
node's track (a captured rung's device windows from CUDA events, through
:class:`DeviceClock`), transfer flows, counters, the run doctor's
attribution, and a per-node memory timeline; with none of them given,
every record is skipped behind a ``None`` check.

Timing: the makespan runs from an event on each card's current stream (the
clock stream), which every node stream waits on at the start of a run, to
an event on the clock stream after it has waited on every node stream; on
the CPU, or across several cards, from the host clock after synchronizing.
Profile mode records an event pair on the task's own stream (or host
timestamps on the CPU) around every task.  Peak device memory comes from
``torch.cuda.max_memory_allocated``.
"""

from __future__ import annotations
# dls-lint: allow-file(DET001) real-device execution timing: wall time IS the measured quantity

import bisect
import gc
import time
import weakref
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_leaves, tree_map_only

from ..core.cluster import Cluster
from ..core.graph import TaskGraph
from ..core.schedule import Schedule, TaskTiming
from ..ops import kernels

Segment = Tuple[str, Tuple[str, ...], Tuple[str, ...]]


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
    # library warm-up, CUDA-graph captures)
    compile_s: float
    # only in profile mode: per-task measured times
    timings: Dict[str, TaskTiming] = field(default_factory=dict)
    # peak allocated bytes per CUDA device over the timed runs
    peak_hbm_bytes: Dict[str, int] = field(default_factory=dict)
    # host calls per run: one per task (per task), one per plan step
    # (planned; a coalesced group counts once), one per segment
    # (segmented), two (compiled: the input copy and the replay)
    n_dispatches: int = 0
    # host wall seconds inside the dispatch loop, per rep
    dispatch_overhead_s: float = 0.0
    # True when the run used the planned path (dispatch_plan)
    planned: bool = False
    # True when the run was one captured program (compiled_schedule)
    compiled: bool = False
    # kernel launches inside the CUDA graphs one run replays, by kernel
    # name (a wrapper counts its launch when it is captured, not when the
    # graph replays); empty for the eager rungs
    captured_launches: Dict[str, int] = field(default_factory=dict)
    # keep_outputs=True: per-task outputs of the last run (every executed
    # task per task and planned; the segment exports under segments).
    # A captured segment's exports live in its graph's memory and hold
    # until that segment replays again
    task_outputs: Dict[str, Any] = field(default_factory=dict)
    # bytes allocated on each card when execute began (the caller's
    # tensors, earlier programs): peak_hbm_bytes minus this is the peak
    # the call itself added
    held_hbm_bytes: Dict[str, int] = field(default_factory=dict)
    # stream_params=True: streaming statistics of the timed run.
    # ``streamed`` is the mode flag (a streamed run that loaded nothing
    # still reports its all-zero counts)
    streamed: bool = False
    param_loads: int = 0
    # batched load calls (<= param_loads: a task's missing params go up in
    # one call) and the bytes loaded over the host link
    param_load_calls: int = 0
    param_load_bytes: int = 0
    param_evictions: int = 0
    # the streamer's ledger peak per node: resident plus evicted bytes not
    # yet freed
    peak_param_bytes: Dict[str, int] = field(default_factory=dict)
    # traced runs: the run doctor's attribution of this execute's span
    # window (obs/attribution.py): the makespan split into compute,
    # transfer, dispatch and idle, and the measured critical path
    attribution: Optional[Dict[str, Any]] = None
    # memprof runs: the memory profiler's summary (per-device peaks,
    # watermark buckets, the allocator's peak beside the model's)
    memory: Optional[Dict[str, Any]] = None
    # a compiled run in a world of one process per device: every rank's
    # window, host time, host calls and kernels ran per run, the world's
    # start seconds and the exchanges that crossed ranks
    world: Optional[Dict[str, Any]] = None

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
            # the dispatch loop by phase: the whole loop only (the JAX
            # package's planned path also splits staging from launching)
            "dispatch_phases_ms": {"loop_s": self.dispatch_overhead_s * 1e3},
            "planned": self.planned,
            "compiled": self.compiled,
            "captured_launches": dict(self.captured_launches),
            "peak_hbm_gb": {
                k: v / 1024**3 for k, v in self.peak_hbm_bytes.items()
            },
            **(
                {
                    "param_loads": self.param_loads,
                    "param_load_calls": self.param_load_calls,
                    "param_load_mb": self.param_load_bytes / 1024**2,
                    "param_evictions": self.param_evictions,
                    "peak_param_gb": {
                        k: v / 1024**3
                        for k, v in self.peak_param_bytes.items()
                    },
                }
                if self.streamed
                else {}
            ),
            **(
                {"attribution": self.attribution}
                if self.attribution is not None
                else {}
            ),
            **(
                {"memory": self.memory}
                if self.memory is not None
                else {}
            ),
            **({"world": self.world} if self.world is not None else {}),
        }


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _leaves(v: Any) -> List[torch.Tensor]:
    """The tensors of a parameter: a tensor, or a NamedTuple of tensors
    (``utils.quantize.QParam``)."""
    return [v] if isinstance(v, torch.Tensor) else list(v)


def _array_bytes(x: Any) -> int:
    """Bytes of a tensor, or of a dict, list or tuple of them (a QParam,
    the paged decode step's dicts), as the JAX package's ``_array_bytes``
    counts a pytree's leaves."""
    if isinstance(x, torch.Tensor):
        return _nbytes(x)
    if isinstance(x, dict):
        return sum(_array_bytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_array_bytes(v) for v in x)
    return 0


def _tree_to(x: Any, dev: torch.device, non_blocking: bool = False) -> Any:
    """A value on ``dev``: a tensor, or a dict/list/tuple nest of them (the
    training DAG's ``{"ids", "targets"}`` input and dict outputs); a
    tensor already there is kept, not copied."""
    return tree_map_only(
        torch.Tensor, lambda t: t.to(dev, non_blocking=non_blocking), x)


class DeviceClock:
    """CUDA events on the host clock, for the tracer.

    A host span around an asynchronous launch (a CUDA-graph replay above
    all) bounds the launch, not the device's work.  The device's window
    comes from a pair of CUDA events; events carry no absolute time, so
    each card gets an anchor: an event recorded right after a
    synchronize (the card is idle, so the event completes at once) and a
    ``time.perf_counter`` read taken right after it.  An event's host
    time is the anchor's read plus the event's elapsed time from the
    anchor event.  Windows are read after the run's final synchronize
    (:meth:`flush`) and recorded through ``Tracer.complete`` with those
    timestamps, with the flow arrows between them."""

    def __init__(self, devices: List[torch.device]):
        self.anchor: Dict[Any, Tuple[Any, float]] = {}
        for dev in devices:
            torch.cuda.synchronize(dev)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(dev))
            self.anchor[dev] = (ev, time.perf_counter())
        self._windows: List[Tuple[Any, ...]] = []
        self._flows: List[Tuple[Any, ...]] = []

    @staticmethod
    def mark(stream) -> Any:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def host_time(self, dev: torch.device, ev: Any) -> float:
        a, h = self.anchor[dev]
        return h + a.elapsed_time(ev) / 1e3

    def window(self, key: Any, name: str, dev: torch.device, a: Any, b: Any,
               track: str, cat: str, **args: Any) -> None:
        """A device window from event ``a`` to ``b``, recorded at flush."""
        self._windows.append((key, name, dev, a, b, track, cat, args))

    def flow(self, src_key: Any, dst_key: Any, **args: Any) -> None:
        """A transfer arrow from the end of window ``src_key`` to the
        start of window ``dst_key``."""
        self._flows.append((src_key, dst_key, args))

    def flush(self, tracer: Any) -> None:
        """Read every pending window (the events must have completed) into
        ``tracer``, then the flows between them."""
        at: Dict[Any, Tuple[str, float, float]] = {}
        for key, name, dev, a, b, track, cat, args in self._windows:
            t0, t1 = self.host_time(dev, a), self.host_time(dev, b)
            tracer.complete(name, t0, t1, track=track, cat=cat, **args)
            at[key] = (track, t0, t1)
        for src_key, dst_key, args in self._flows:
            src, dst = at.get(src_key), at.get(dst_key)
            if src is not None and dst is not None:
                tracer.flow("transfer", src[0], src[2], dst[0], dst[1],
                            **args)
        self._windows.clear()
        self._flows.clear()


def _map_leaves(fn, v: Any) -> Any:
    """``fn`` applied to each tensor of a parameter; a QParam stays one."""
    if isinstance(v, torch.Tensor):
        return fn(v)
    return type(v)(*(fn(t) for t in v))


def pin_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """``params`` with every host tensor in pinned memory (tensors that
    are pinned already are kept): a ``non_blocking`` copy to a card
    overlaps compute only from pinned memory.  Needs CUDA."""
    return {
        k: _map_leaves(lambda t: t if t.is_pinned() else t.pin_memory(), v)
        for k, v in params.items()
    }


def _args_of(task) -> List[str]:
    return task.arg_tasks or task.dependencies


_NODE_STREAMS: Dict[Tuple[Any, int], Any] = {}


def node_stream(device: torch.device, k: int):
    """The k-th node stream of a card, made once per process.  Backends
    share them: every stream that runs a matmul keeps a cuBLAS workspace
    for the life of the process, so a stream made per backend would leak
    one workspace per node and backend."""
    s = _NODE_STREAMS.get((device, k))
    if s is None:
        s = _NODE_STREAMS[(device, k)] = torch.cuda.Stream(device=device)
    return s


_CAPTURE_STREAMS: Dict[Any, Any] = {}


def capture_stream(device: torch.device):
    """The card's stream for capturing the decode loops' CUDA graphs, made
    once per process (a stream per engine would keep a cuBLAS workspace
    per engine for the life of the process, as :func:`node_stream` says).
    A graph captured here replays on whatever stream is current."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    s = _CAPTURE_STREAMS.get(device)
    if s is None:
        s = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device=device)
    return s


_COPY_STREAMS: Dict[Any, Any] = {}


def copy_stream(device: torch.device):
    """The card's parameter-load stream, made once per process.  Every
    streamer issues its host-to-card copies for that card here, so the
    memory a load frees returns to this stream's pool and the next load
    reuses it in stream order."""
    s = _COPY_STREAMS.get(device)
    if s is None:
        s = _COPY_STREAMS[device] = torch.cuda.Stream(device=device)
    return s


class StreamSwitch:
    """Makes a node's stream current as a dispatch loop moves between
    nodes, and gives every card its clock stream (and the caller its
    current device) back on exit.  A node on the CPU has no stream."""

    def __init__(self, streams: Dict[str, Any], clocks: Dict[Any, Any]):
        self.streams = streams
        self.clocks = clocks
        self.current = None
        self.device = torch.cuda.current_device() if clocks else None

    def to(self, node_id: str):
        s = self.streams.get(node_id)
        if s is not None and s is not self.current:
            torch.cuda.set_stream(s)
            self.current = s
        return s

    def __enter__(self) -> "StreamSwitch":
        return self

    def __exit__(self, *exc) -> None:
        for clock in self.clocks.values():
            torch.cuda.set_stream(clock)
        if self.device is not None:
            torch.cuda.set_device(self.device)


class CapturedProgram:
    """``fn(params, ext) -> outputs`` captured once into a CUDA graph.

    The first call warms ``fn`` up eagerly on the current stream (every
    kernel built and loaded, library handles created), copies ``ext`` into
    static buffers, captures ``fn`` over them on ``stream`` (the current
    stream when None; it must not be a card's default stream) into the
    memory pool ``pool`` (a private one when None), and replays; every
    later call copies ``ext`` into the static buffers and replays on the
    current stream.  The inputs named in ``fixed`` are the same tensor at
    every call (another program's outputs): the graph reads them in place,
    and a call that passes another tensor raises.  Programs that share a
    pool must replay in the order they were captured and never at once.
    The outputs are the graph's own tensors: they hold until the program
    replays again.  ``launches`` is
    the kernel launches the capture recorded, by kernel name (also added
    to ``kernels.captured``); each replay adds them to ``kernels.replayed``.  A capture error (a task that reads
    to the host, a launch the graph cannot hold) raises; nothing falls
    back to eager execution."""

    def __init__(self, fn, stream=None, pool=None):
        self.fn = fn
        self.stream = stream
        self.pool = pool
        self.graph = None
        self.static_in: Dict[str, torch.Tensor] = {}
        self.static_out: Any = None
        self.launches: Dict[str, int] = {}

    def __call__(self, params: Dict[str, Any], ext: Dict[str, torch.Tensor],
                 fixed: frozenset = frozenset()):
        if self.graph is None:
            self._capture(params, ext, fixed)
        else:
            for k, buf in self.static_in.items():
                if k not in fixed:
                    for dst, src in zip(tree_leaves(buf), tree_leaves(ext[k])):
                        dst.copy_(src, non_blocking=True)
                elif ext[k] is not buf:
                    raise RuntimeError(
                        f"captured program: input {k!r} was read in place "
                        "at capture and is another tensor now")
        self.graph.replay()
        _count_replay(self.launches)
        return self.static_out

    def _capture(self, params, ext, fixed) -> None:
        stream = self.stream or torch.cuda.current_stream()
        with torch.no_grad():
            self.fn(params, ext)  # warm-up
        self.static_in = {
            k: v if k in fixed else tree_map_only(torch.Tensor, torch.clone, v)
            for k, v in ext.items()}
        graph = torch.cuda.CUDAGraph()
        before = dict(kernels.launches)
        with torch.no_grad(), _no_collection(), torch.cuda.graph(
                graph, pool=self.pool, stream=stream):
            self.static_out = self.fn(params, self.static_in)
        self.launches = _recorded_since(before)
        self.graph = graph


@contextmanager
def _no_collection():
    """No garbage collection while a graph captures.  ``torch.cuda.graph``
    no longer collects on entry, so a dead CUDA graph in a reference cycle
    may be freed by a collection that a capture's own allocations set off;
    destroying a graph is not permitted while a stream captures, and the
    capture is invalidated.  Collections run between captures instead."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _recorded_since(before: Dict[str, int]) -> Dict[str, int]:
    """The launches a capture recorded since ``before`` (a copy of
    ``kernels.launches``), by kernel; added to ``kernels.captured``."""
    rec = {k: v - before.get(k, 0) for k, v in kernels.launches.items()
           if v != before.get(k, 0)}
    for k, v in rec.items():
        kernels.captured[k] = kernels.captured.get(k, 0) + v
    return rec


def _count_replay(launches: Dict[str, int]) -> None:
    """One replay of a graph that holds ``launches``: into
    ``kernels.replayed``."""
    for k, v in launches.items():
        kernels.replayed[k] = kernels.replayed.get(k, 0) + v


class CapturedStep:
    """``body()`` over state it reads and advances in place (a decode step
    that writes its cache, token and position at fixed addresses),
    captured once into a CUDA graph: the sibling of
    :class:`CapturedProgram` with nothing to copy in.

    The first call runs ``body`` eagerly on the current stream (that call's
    step; every kernel built and loaded), then captures it on the card's
    :func:`capture_stream` into a private memory pool: capture records and
    runs nothing, so the state stays as the eager step left it.  Every later call replays the
    graph on the current stream and adds the captured launches to
    ``kernels.replayed``.  A capture error raises; nothing falls back to
    eager execution."""

    def __init__(self, body, device: torch.device):
        self.body = body
        self.device = device
        self.graph = None
        self.launches: Dict[str, int] = {}

    def __call__(self) -> None:
        if self.graph is not None:
            self.graph.replay()
            _count_replay(self.launches)
            return
        with torch.no_grad():
            self.body()
        graph = torch.cuda.CUDAGraph()
        before = dict(kernels.launches)
        with torch.no_grad(), _no_collection(), torch.cuda.graph(
                graph, stream=capture_stream(self.device)):
            self.body()
        self.launches = _recorded_since(before)
        self.graph = graph


def address_key(tree: Any) -> tuple:
    """(address, shape, stride, dtype) of every tensor leaf of ``tree``, in
    order: what a captured graph reads its inputs by.  Two trees with the
    same key are the same memory for a graph, whichever tensor objects
    hold it."""
    return tuple(
        (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
        for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


class DeviceBackend:
    """Executes a scheduled TaskGraph on torch devices.

    ``cluster`` must be built with ``Cluster.from_torch_devices`` (each
    DeviceState carries its ``torch_device``); the schedule's placement
    maps task -> DeviceState -> real device.  Each node bound to a CUDA
    device runs on a stream of its own (the k-th node of a card on that
    card's k-th :func:`node_stream`, which every backend shares).

    ``world``: the compiled rung runs in a world of one process per device
    (:mod:`.compiled_world`) even when the placed nodes share one device
    (a world of one); by default only a placement over several devices
    takes a world.  :meth:`close` stops every world the backend's
    programs hold.
    """

    def __init__(self, cluster: Cluster, pre_analysis: bool = True,
                 world: bool = False):
        missing = [d.node_id for d in cluster if d.torch_device is None]
        if missing:
            raise ValueError(
                f"cluster devices {missing} have no bound torch_device; "
                "build the cluster with Cluster.from_torch_devices()"
            )
        self.cluster = cluster
        # opt-out static pre-execution gate (see analysis/):
        # pre_analysis=False per instance, DLS_SKIP_ANALYSIS=1 globally
        self.pre_analysis = pre_analysis
        self.world = world
        self.devices = list(dict.fromkeys(d.torch_device for d in cluster))
        self.cuda_devices = [d for d in self.devices if d.type == "cuda"]
        self._streams: Optional[Dict[str, Any]] = None
        # graph -> {key: segment program}; graph -> {key: compiled
        # program}.  Weak, so a dead graph releases its captured graphs
        self._seg_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._prog_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def _synchronize(self) -> None:
        for dev in self.cuda_devices:
            torch.cuda.synchronize(dev)

    def close(self) -> None:
        """Drop every cached program, stopping the worlds of the compiled
        rung's programs over several devices (their ranks exit)."""
        for cache in list(self._prog_cache.values()):
            for prog in cache.values():
                if hasattr(prog, "world"):
                    prog.close()
        self._prog_cache = weakref.WeakKeyDictionary()
        self._seg_cache = weakref.WeakKeyDictionary()

    def param_bytes(self, graph: TaskGraph, schedule: Schedule,
                    params: Dict[str, Any]) -> Dict[str, int]:
        """The bytes :meth:`place_params` would place on each node, with
        nothing placed (a world's ranks place their own)."""
        out: Dict[str, int] = {d.node_id: 0 for d in self.cluster}
        seen: set = set()
        for tid, node_id in schedule.placement.items():
            for p in graph[tid].params_needed:
                if (p, node_id) not in seen:
                    seen.add((p, node_id))
                    out[node_id] += _array_bytes(params[p])
        return out

    @property
    def streams(self) -> Dict[str, Any]:
        """node id -> its stream, for every node bound to a CUDA device:
        the k-th node of a card takes that card's k-th stream of
        :func:`node_stream`."""
        if self._streams is None:
            seen: Dict[Any, int] = {}
            self._streams = {}
            for d in self.cluster:
                if d.torch_device.type == "cuda":
                    k = seen.get(d.torch_device, 0)
                    seen[d.torch_device] = k + 1
                    self._streams[d.node_id] = node_stream(d.torch_device, k)
        return self._streams

    def stream_of(self, node_id: str):
        """The node's stream, or None for a node on the CPU."""
        return self.streams.get(node_id)

    def _clocks(self) -> Dict[Any, Any]:
        return {dev: torch.cuda.current_stream(dev) for dev in self.cuda_devices}

    def _fork(self, clocks, nodes) -> None:
        """Every node stream of ``nodes`` waits on its card's clock."""
        for n in nodes:
            s = self.streams.get(n)
            if s is not None:
                s.wait_stream(clocks[self.cluster[n].torch_device])

    def _join(self, clocks, nodes) -> None:
        """Each card's clock waits on every node stream of ``nodes``."""
        for n in nodes:
            s = self.streams.get(n)
            if s is not None:
                clocks[self.cluster[n].torch_device].wait_stream(s)

    # -- placement ---------------------------------------------------------
    def place_params(
        self,
        graph: TaskGraph,
        schedule: Schedule,
        params: Dict[str, torch.Tensor],
        mem: Any = None,
    ) -> Tuple[Dict[Tuple[str, str], torch.Tensor], Dict[str, int]]:
        """Put each param onto the device of every node that runs a task
        needing it.  Returns ``(param_name, node_id) -> tensor`` plus the
        bytes placed per node (a param needed on k nodes counts k times;
        a tensor already on the node's device is used in place; an int8
        QParam moves and counts leaf by leaf).  ``mem`` (a memory
        profiler) books each placement as a param birth."""
        placed: Dict[Tuple[str, str], Any] = {}
        for tid, node_id in schedule.placement.items():
            dev = self.cluster[node_id].torch_device
            for p in graph[tid].params_needed:
                key = (p, node_id)
                if key not in placed:
                    placed[key] = _map_leaves(lambda t: t.to(dev), params[p])
                    if mem is not None:
                        mem.alloc(node_id, f"param:{p}",
                                  _array_bytes(params[p]), "params")
        self._synchronize()
        return placed, self.param_bytes(graph, schedule, params)

    # -- parameter streaming ----------------------------------------------
    class _ParamStreamer:
        """On-demand parameter residency with eviction under a per-node
        budget: the reference's param-cache eviction model (reference
        ``schedulers.py:404-442``) made physical.  A node whose weights
        exceed its budget loads each parameter before its first use and
        evicts residents to make room.  Every host-side decision (which
        parameters load and evict, in which batched call, the ledger's
        bytes) is the JAX package's ``_ParamStreamer``'s on the same plan:

        * **plan-aware prefetch**: the schedule fixes each node's task
          order (``plan``), so the parameters of the next ``lookahead``
          units load while the current one computes; a prefetch never
          overshoots the budget;
        * **Belady eviction**: with a plan, the victim is the resident
          whose next use is farthest away; LRU without one;
        * **batched loads**: a unit's missing parameters go up in one call
          (``load_calls``), each a ``non_blocking`` copy from the host on
          the card's :func:`copy_stream`, with one event recorded after
          the batch; the consumer's node stream waits on that event before
          its first use of the batch;
        * **deferred frees**: an evicted tensor may still feed queued work,
          so it enters a graveyard with its last consumer's per-node step
          and the event recorded after that consumer on the node's stream.
          :meth:`_flush` drops it only once that event has completed (a
          host wait, in place of the JAX package's ``block_until_ready``
          on the consumer's output), and a per-node watermark makes a wait
          on an already-passed step free.  Only then can the allocator
          hand its block to the next load.

        The ``bytes`` ledger counts resident plus graveyard bytes (memory
        is not free until the drop), so ``peak`` is physically honest.  On
        the CPU a load is ``Tensor.to("cpu")``, which returns the caller's
        tensor itself: dropping it frees nothing, but the ledger counts it
        exactly as the JAX package does.
        """

        def __init__(
            self,
            cluster: Cluster,
            params: Dict[str, Any],
            plan: Optional[Dict[str, List[Tuple[str, Tuple[str, ...]]]]] = None,
            lookahead: int = 8,
            streams: Optional[Dict[str, Any]] = None,
            mem: Any = None,
        ):
            self.cluster = cluster
            self.host_params = params
            # an optional memory profiler: loads are param births, the
            # graveyard's drops the matching frees
            self.mem = mem
            # node id -> its stream, for the nodes on a card
            self.streams = streams or {}
            self.resident: Dict[str, Dict[str, Any]] = {
                d.node_id: {} for d in cluster
            }
            # node -> name -> the event after the load of a resident param
            # that the node's stream has not waited on yet
            self.ready: Dict[str, Dict[str, Any]] = {
                d.node_id: {} for d in cluster
            }
            self.bytes: Dict[str, int] = {d.node_id: 0 for d in cluster}
            self.peak: Dict[str, int] = {d.node_id: 0 for d in cluster}
            self.budget: Dict[str, int] = {
                d.node_id: int(d.total_memory * 1024**3) for d in cluster
            }
            self.last_use: Dict[str, Dict[str, int]] = {
                d.node_id: {} for d in cluster
            }
            # plan: node -> [(unit id, param globals)] in dispatch order
            self.plan = plan or {}
            self.pos: Dict[str, int] = {n: -1 for n in self.plan}
            # node -> param -> ascending plan positions where it is used
            self.uses: Dict[str, Dict[str, List[int]]] = {}
            for n, entries in self.plan.items():
                u: Dict[str, List[int]] = {}
                for i, (_tid, globs) in enumerate(entries):
                    for g in globs:
                        u.setdefault(g, []).append(i)
                self.uses[n] = u
            self.lookahead = lookahead
            # per node: dispatch step, last step known complete, each
            # param's last consumer (step, event after it), and evicted
            # tensors not yet dropped (step, event, tensor, bytes, name)
            self.node_step: Dict[str, int] = {d.node_id: 0 for d in cluster}
            self.fenced_step: Dict[str, int] = {d.node_id: 0 for d in cluster}
            self.last_consumer: Dict[str, Dict[str, Tuple[int, Any]]] = {
                d.node_id: {} for d in cluster
            }
            self.graveyard: Dict[str, List[Tuple[int, Any, Any, int, str]]] = {
                d.node_id: [] for d in cluster
            }
            self.loads = 0
            self.load_calls = 0
            self.load_bytes = 0
            # params not resident when their own unit asked for them (the
            # loads a unit's dispatch waited for) against prefetched ones
            self.demand_misses = 0
            self.evictions = 0
            self._step = 0

        def note_task(self, node_id: str, globs) -> None:
            """Record that a unit consuming ``globs`` was just issued on
            the node: an event after it on the node's stream (None on the
            CPU, whose ops are synchronous) anchors those params' frees."""
            self.node_step[node_id] += 1
            step = self.node_step[node_id]
            ev = None
            s = self.streams.get(node_id)
            if s is not None:
                ev = torch.cuda.Event()
                ev.record(s)
            for g in globs:
                self.last_consumer[node_id][g] = (step, ev)

        def _next_use(self, node_id: str, name: str) -> float:
            uses = self.uses.get(node_id, {}).get(name)
            if not uses:
                return float("inf")
            i = bisect.bisect_right(uses, self.pos.get(node_id, -1))
            return uses[i] if i < len(uses) else float("inf")

        def _flush(self, node_id: str, need_bytes: int) -> int:
            """Drop graveyard tensors, oldest consumer first, until
            ``need_bytes`` are freed or the graveyard is empty.  Waits only
            for an entry whose consumer step is past the watermark, and
            then for that consumer's event, not the node's last work."""
            g = self.graveyard[node_id]
            g.sort(key=lambda e: e[0])
            freed = 0
            while g and freed < need_bytes:
                step, ev, _arr, nbytes, name = g.pop(0)
                if step > self.fenced_step[node_id] and ev is not None:
                    ev.synchronize()
                    self.fenced_step[node_id] = step
                self.bytes[node_id] -= nbytes
                if self.mem is not None:
                    self.mem.free(node_id, f"param:{name}")
                freed += nbytes
            return freed

        def _evict_one(
            self, node_id: str, pinned: set, horizon: Optional[int]
        ) -> int:
            """Move one victim to the graveyard.  Returns its bytes, 0 when
            nothing is evictable (only pinned residents), or -1 when the
            best victim is needed at or before ``horizon`` (prefetch would
            thrash: the caller stops prefetching)."""
            res = self.resident[node_id]
            victims = [p for p in res if p not in pinned]
            if not victims:
                return 0
            if node_id in self.uses:
                victim = max(
                    victims, key=lambda p: self._next_use(node_id, p)
                )
                if (
                    horizon is not None
                    and self._next_use(node_id, victim) <= horizon
                ):
                    return -1
            else:
                lru = self.last_use[node_id]
                victim = min(victims, key=lambda p: lru.get(p, 0))
            arr = res.pop(victim)
            self.ready[node_id].pop(victim, None)
            self.last_use[node_id].pop(victim, None)
            step, ev = self.last_consumer[node_id].pop(victim, (0, None))
            nbytes = _array_bytes(arr)
            # the bytes stay on the ledger until _flush drops the tensor
            self.graveyard[node_id].append((step, ev, arr, nbytes, victim))
            self.evictions += 1
            return nbytes

        def _load(self, node_id: str, names: List[str]) -> None:
            """ONE batched load of ``names`` onto the node's device."""
            dev = self.cluster[node_id].torch_device
            cs = copy_stream(dev) if dev.type == "cuda" else None
            with torch.cuda.stream(cs) if cs is not None else nullcontext():
                arrs = [
                    _map_leaves(
                        lambda t: t.to(dev, non_blocking=True),
                        self.host_params[n],
                    )
                    for n in names
                ]
            ev = None
            if cs is not None:
                ev = torch.cuda.Event()
                ev.record(cs)
            self.load_calls += 1
            for n, a in zip(names, arrs):
                self.resident[node_id][n] = a
                if ev is not None:
                    self.ready[node_id][n] = ev
                # the ledger counts the placed bytes
                nb = _array_bytes(a)
                self.bytes[node_id] += nb
                self.load_bytes += nb
                self.loads += 1
                if self.mem is not None:
                    self.mem.alloc(node_id, f"param:{n}", nb, "params")
                self.last_use[node_id][n] = self._step
            self.peak[node_id] = max(self.peak[node_id], self.bytes[node_id])

        def _ensure(
            self,
            node_id: str,
            names: List[str],
            pinned: set,
            horizon: Optional[int] = None,
        ) -> bool:
            """Make ``names`` resident, evicting and freeing as needed.
            Returns False when stopped by the prefetch ``horizon``."""
            # a fused task can alias two local names to one global: load
            # it once
            missing = list(dict.fromkeys(
                n for n in names if n not in self.resident[node_id]
            ))
            if not missing:
                return True
            need = sum(_array_bytes(self.host_params[n]) for n in missing)
            budget = self.budget[node_id]
            while self.bytes[node_id] + need > budget:
                deficit = self.bytes[node_id] + need - budget
                if self.graveyard[node_id]:
                    self._flush(node_id, deficit)
                    continue
                r = self._evict_one(node_id, pinned, horizon)
                if r == -1:
                    return False
                if r == 0:
                    if horizon is not None:
                        # a prefetch never overshoots the budget; only a
                        # unit's own params may (it cannot run without them)
                        return False
                    break
            self._load(node_id, missing)
            return True

        def get_task(self, tid: str, node_id: str, param_items) -> Dict[str, Any]:
            """Resident params for unit ``tid`` (local name -> tensor), its
            node's stream made to wait on their loads; then prefetch the
            next ``lookahead`` planned units' params into the budget."""
            self._step += 1
            items = tuple(param_items)
            names = [g for _, g in items]
            entries = self.plan.get(node_id)
            if entries is not None:
                # advance the plan cursor to this unit; units skipped at
                # dispatch (failed upstreams) fall out of the walk
                i = self.pos[node_id] + 1
                while i < len(entries) and entries[i][0] != tid:
                    i += 1
                if i < len(entries):
                    self.pos[node_id] = i
            pinned = set(names)
            self.demand_misses += sum(
                1 for n in pinned if n not in self.resident[node_id]
            )
            self._ensure(node_id, names, pinned)
            for n in names:
                self.last_use[node_id][n] = self._step
            s = self.streams.get(node_id)
            if s is not None:
                waited = set()
                for n in pinned:
                    ev = self.ready[node_id].pop(n, None)
                    if ev is not None and ev not in waited:
                        s.wait_event(ev)
                        waited.add(ev)
            out = {loc: self.resident[node_id][g] for loc, g in items}
            if entries is not None:
                p = self.pos[node_id]
                stop = min(p + 1 + self.lookahead, len(entries))
                for j in range(p + 1, stop):
                    _t, globs = entries[j]
                    if not self._ensure(
                        node_id, list(globs), pinned | set(globs), horizon=j
                    ):
                        break
            return out

    # -- dispatch order ----------------------------------------------------
    @staticmethod
    def dispatch_order(graph: TaskGraph, schedule: Schedule) -> List[str]:
        """Global dispatch linearization honoring per-node scheduled order.

        A node's stream executes enqueued work FIFO, so within one node
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

    # -- segment fusion ----------------------------------------------------
    @staticmethod
    def build_segments(
        graph: TaskGraph,
        schedule: Schedule,
        order: List[str],
        max_union_gb: Optional[Dict[str, float]] = None,
        param_gb: Optional[Dict[str, float]] = None,
    ) -> List[Segment]:
        """Partition the dispatch order into per-node segments.

        A segment is a maximal run of consecutive (in dispatch order) tasks
        placed on the same node; each becomes ONE program, so the host
        issues one call per segment instead of one per task.  Segment
        boundaries are exactly the schedule's node switches: on one card
        the whole DAG is one program; a pipeline's interleaving yields one
        segment per microbatch-stage visit.

        Returns (node_id, tids, exports): ``exports`` are the tasks whose
        outputs are consumed by later segments or by nobody (leaves).

        ``max_union_gb`` (for segment-granular parameter streaming): a
        per-node cap on a segment's param-global union.  A run splits
        when adding a task would push its union past the cap, so each
        segment's weights fit the streaming budget and eviction happens
        between segments; a single task whose own params exceed the cap
        still gets an (over-budget) segment.  ``param_gb`` overrides
        per-name sizes (callers holding the tensors pass their true
        bytes); missing names fall back to the graph's declared sizes.
        """
        placement = schedule.placement
        runs: List[Tuple[str, List[str]]] = []
        run_names: set = set()   # current run's param-global names
        run_total = 0.0          # its union GB, a running total
        sizes = param_gb or {}

        def size_of(g: str) -> float:
            s = sizes.get(g)
            return s if s is not None else graph.param_size_gb(g)

        for tid in order:
            if tid not in placement:
                continue
            node = placement[tid]
            globs = list(dict.fromkeys(g for _, g in graph[tid].param_items()))
            same_node = bool(runs) and runs[-1][0] == node
            if same_node and max_union_gb and node in max_union_gb:
                extra = sum(size_of(g) for g in globs if g not in run_names)
                if run_total + extra > max_union_gb[node] and run_names:
                    same_node = False  # budget split (never an empty run)
            if same_node:
                runs[-1][1].append(tid)
            else:
                runs.append((node, [tid]))
                run_names = set()
                run_total = 0.0
            for g in globs:
                if g not in run_names:
                    run_names.add(g)
                    run_total += size_of(g)
        consumers: Dict[str, set] = {tid: set() for tid in placement}
        for seg_i, (_, tids) in enumerate(runs):
            for tid in tids:
                for d in _args_of(graph[tid]):
                    if d in consumers:
                        consumers[d].add(seg_i)
        segments = []
        for seg_i, (node, tids) in enumerate(runs):
            exports = tuple(
                t for t in tids
                if consumers[t] - {seg_i} or not consumers[t]
            )
            segments.append((node, tuple(tids), exports))
        return segments

    # fraction of a node's streaming budget one segment's param union may
    # take: 0.5 leaves room for the NEXT segment's union to prefetch while
    # the current segment runs
    STREAM_SEGMENT_FRAC = 0.5

    def _stream_segment_caps(self) -> Dict[str, float]:
        return {
            d.node_id: d.total_memory * self.STREAM_SEGMENT_FRAC
            for d in self.cluster
        }

    @staticmethod
    def segment_stream_plan(
        graph: TaskGraph, segments: List[Segment]
    ) -> Dict[str, List[Tuple[str, Tuple[str, ...]]]]:
        """Per-node streamer plan at segment granularity: each entry is
        (``__seg<i>``, the segment's param-global union), so one batched
        load serves a segment and the next segment prefetches while the
        current one runs."""
        plan: Dict[str, List[Tuple[str, Tuple[str, ...]]]] = {}
        for i, (node, tids, _exports) in enumerate(segments):
            seen: Dict[str, None] = {}
            for tid in tids:
                for _, g in graph[tid].param_items():
                    seen.setdefault(g)
            plan.setdefault(node, []).append((f"__seg{i}", tuple(seen)))
        return plan

    @staticmethod
    def _segment_callable(
        graph: TaskGraph,
        tids: Tuple[str, ...],
        exports: Tuple[str, ...],
        rebatch: bool = True,
    ):
        """One callable running ``tids`` in order: (params-by-global-name,
        external-inputs-by-task-id, the graph input under ``"__input__"``)
        -> {export tid: output}.

        ``rebatch=True`` applies the segment re-batching pass
        (:mod:`.rebatch`): sibling tasks marked batch-axis-0 polymorphic
        execute as ONE call on concatenated inputs.  Placement, transfers
        and the export contract are unchanged; graphs with no eligible
        siblings give the linear program, the planned path's coalesced
        group function (:func:`.dispatch_plan._build_group_fn`).
        """
        from .rebatch import build_rebatched_seg_fn, plan_rebatch

        if rebatch:
            plan = plan_rebatch(graph, tids)
            if plan.classes:
                return build_rebatched_seg_fn(graph, tids, exports, plan)
        from .dispatch_plan import GRAPH_INPUT, _build_group_fn, group_arg_binds

        group_fn = _build_group_fn(graph, tids, exports)
        ext_ids = tuple("__input__" if d == GRAPH_INPUT else d
                        for d in group_arg_binds(graph, tids)[1])

        def seg_fn(seg_params, ext):
            # KeyError here = a segment-boundary bookkeeping bug
            return dict(zip(exports, group_fn(
                seg_params, *[ext[d] for d in ext_ids])))

        return seg_fn

    def _segment_programs(
        self,
        graph: TaskGraph,
        segments: List[Segment],
        rebatch: bool,
        placed: Dict[Tuple[str, str], torch.Tensor],
    ) -> List[Any]:
        """One program per segment (:meth:`_segment_callable`).  On a card
        each is a :class:`CapturedProgram`, captured on its first call and
        replayed after; the segments of one node share one memory pool,
        since they replay on that node's stream in the order they were
        captured and never at once, so a segment reuses the memory of the
        intermediates of those before it.  That holds only while they
        replay together, so the list is cached whole, per (graph,
        segments, rebatch) and per the params' addresses (a captured graph
        reads its params where they were at capture); the reference caches
        each segment's program per (graph, tids, exports, rebatch)."""
        per_graph = self._seg_cache.setdefault(graph, {})
        key = (tuple(segments), rebatch, tuple(sorted(
            (k, tuple(t.data_ptr() for t in _leaves(v)))
            for k, v in placed.items())))
        fns = per_graph.get(key)
        if fns is None:
            fns, pools = [], {}
            for node, tids, exports in segments:
                fn = self._segment_callable(graph, tids, exports, rebatch)
                if self.cluster[node].torch_device.type == "cuda":
                    if node not in pools:
                        pools[node] = torch.cuda.graph_pool_handle()
                    fn = CapturedProgram(fn, pool=pools[node])
                fns.append(fn)
            per_graph[key] = fns
        return fns

    # -- timing marks --------------------------------------------------------
    @staticmethod
    def _mark(dev: torch.device, stream=None) -> Any:
        """A point on ``dev``'s timeline: a CUDA event recorded on
        ``stream`` (the device's current stream by default), or the host
        clock for the CPU (whose ops run synchronously)."""
        if dev.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(stream if stream is not None
                      else torch.cuda.current_stream(dev))
            return ev
        return time.perf_counter()

    @staticmethod
    def _seconds(a: Any, b: Any) -> float:
        """Seconds from mark ``a`` to mark ``b`` (same device; events must
        have completed)."""
        if isinstance(a, float):
            return b - a
        return a.elapsed_time(b) / 1e3

    @staticmethod
    def _trace_flows(tracer, done_at, flow_srcs, node: str, t0: float,
                     dst: str) -> None:
        """One transfer arrow per value ``dst`` received from another node:
        from the end of its producer's span to the start of ``dst``'s."""
        for d, nb in flow_srcs:
            src_pt = done_at.get(d)
            # (a captured producer's end is read later, through the clock)
            if src_pt is not None and isinstance(src_pt[1], float):
                tracer.flow("transfer", src_pt[0], src_pt[1], node, t0,
                            src=d, dst=dst, bytes=nb)

    # -- execution ---------------------------------------------------------
    def _run(
        self,
        graph: TaskGraph,
        schedule: Schedule,
        placed: Dict[Tuple[str, str], torch.Tensor],
        graph_input: Any,
        order: List[str],
        clocks: Dict[Any, Any],
        profile: bool = False,
        ext_outputs: Optional[Dict[str, Any]] = None,
        cross: frozenset = frozenset(),
        streamer: Optional["DeviceBackend._ParamStreamer"] = None,
        tracer: Any = None,
        metrics: Any = None,
        mem: Any = None,
        dclock: Optional[DeviceClock] = None,
    ) -> Tuple[Any, Dict[str, TaskTiming], int, int, int, float, Dict[str, Any]]:
        """Per-task rung: one host call per task, in dispatch order, each
        on its node's stream.  Every output is held to the end of the run.
        ``ext_outputs`` seed the value table with outputs produced outside
        this graph (they count as transfers when consumed).  ``cross``
        names the tasks read on another node's stream: each records an
        event after it for those readers to wait on.  With a ``streamer``
        a task's params come from it (loaded, its stream made to wait)
        instead of ``placed``.

        ``tracer`` records each task's span on its node's track (its host
        dispatch window; in profile mode its measured window, on a card
        through ``dclock``) and a flow arrow per transfer; ``metrics`` the
        bytes per edge; ``mem`` input staging, transfers and output
        births."""
        placement = schedule.placement
        # task -> (node, end of its span), for the flow arrows
        done_at: Optional[Dict[str, Tuple[str, float]]] = (
            {} if tracer is not None else None
        )
        outputs: Dict[str, Any] = dict(ext_outputs or {})
        n_ext = len(outputs)
        transfer_edges = 0
        transfer_bytes = 0
        # the shared graph input placed once per node, not once per root
        input_on: Dict[str, torch.Tensor] = {}
        # producer -> event recorded after it on its stream (cross-stream
        # consumers wait on it); (consumer stream, producer) pairs waited
        events: Dict[str, Any] = {}
        waited: set = set()
        origin = (
            {dev: self._mark(dev, clocks.get(dev)) for dev in self.devices}
            if profile else {}
        )
        marks: List[Tuple[str, str, torch.device, Any, Any]] = []
        t_loop0 = time.perf_counter()
        with torch.no_grad(), StreamSwitch(self.streams, clocks) as sw:
            for tid in order:
                if tid not in placement:
                    continue  # failed task: skip (fail-and-continue semantics)
                task = graph[tid]
                node_id = placement[tid]
                dev = self.cluster[node_id].torch_device

                arg_ids = _args_of(task)
                if arg_ids and any(d not in outputs for d in arg_ids):
                    continue  # upstream failed; propagate skip

                s = sw.to(node_id)
                if streamer is not None:
                    pd = streamer.get_task(tid, node_id, task.param_items())
                else:
                    pd = {
                        loc: placed[(glob, node_id)]
                        for loc, glob in task.param_items()
                    }
                flow_srcs = [] if tracer is not None else None
                if arg_ids:
                    args = []
                    for d in arg_ids:
                        x = outputs[d]
                        if placement.get(d) != node_id:
                            # cross-node edge: an event wait on one card,
                            # a copy between cards
                            transfer_edges += 1
                            nb = _array_bytes(x)
                            transfer_bytes += nb
                            ev = events.get(d)
                            if ev is not None and (s, d) not in waited:
                                s.wait_event(ev)
                                waited.add((s, d))
                            x = _tree_to(x, dev, non_blocking=True)
                            if tracer is not None:
                                flow_srcs.append((d, nb))
                            if metrics is not None:
                                metrics.counter(
                                    "transfer.bytes."
                                    f"{placement.get(d, 'ext')}->{node_id}",
                                    unit="bytes",
                                ).inc(nb)
                            if mem is not None:
                                mem.alloc(node_id, f"xfer:{d}", nb,
                                          "transfers")
                        args.append(x)
                else:
                    inp = input_on.get(node_id)
                    if inp is None:
                        inp = _tree_to(graph_input, dev)
                        input_on[node_id] = inp
                        if mem is not None:
                            mem.alloc(node_id, "input", _array_bytes(graph_input),
                                      "activations")
                    args = [inp]

                if profile:
                    start = self._mark(dev, s)
                    out = task.fn(pd, *args)
                    marks.append((tid, node_id, dev, start, self._mark(dev, s),
                                  flow_srcs))
                else:
                    if tracer is not None:
                        t0 = time.perf_counter()
                    out = task.fn(pd, *args)
                    if tracer is not None:
                        # the host dispatch window (a launch returns at
                        # enqueue)
                        t1 = time.perf_counter()
                        tracer.complete(tid, t0, t1, track=node_id,
                                        cat="launch")
                        done_at[tid] = (node_id, t1)
                        self._trace_flows(tracer, done_at, flow_srcs,
                                          node_id, t0, tid)
                outputs[tid] = out
                if mem is not None:
                    mem.alloc(node_id, f"out:{tid}", _array_bytes(out),
                              "activations")
                if streamer is not None:
                    streamer.note_task(
                        node_id, [g for _, g in task.param_items()])
                if s is not None and tid in cross:
                    ev = torch.cuda.Event()
                    ev.record(s)
                    events[tid] = ev
        loop_s = time.perf_counter() - t_loop0

        timings: Dict[str, TaskTiming] = {}
        if profile:
            self._synchronize()
            for tid, node_id, dev, start, end, flow_srcs in marks:
                o = origin[dev]
                timings[tid] = TaskTiming(
                    tid, node_id, self._seconds(o, start), self._seconds(o, end)
                )
                if tracer is not None:
                    # the measured window on the host clock
                    if isinstance(start, float):
                        t0, t1 = start, end
                    else:
                        t0 = dclock.host_time(dev, start)
                        t1 = dclock.host_time(dev, end)
                    tracer.complete(tid, t0, t1, track=node_id, cat="task")
                    done_at[tid] = (node_id, t1)
                    self._trace_flows(tracer, done_at, flow_srcs, node_id,
                                      t0, tid)
        final = outputs.get(graph.topo_order[-1]) if graph.topo_order else None
        executed = {
            k: v for k, v in outputs.items()
            if not ext_outputs or k not in ext_outputs
        }
        return (final, timings, transfer_edges, transfer_bytes,
                len(outputs) - n_ext, loop_s, executed)

    def _run_segmented(
        self,
        graph: TaskGraph,
        schedule: Schedule,
        placed: Dict[Tuple[str, str], torch.Tensor],
        graph_input: Any,
        segments: List[Segment],
        seg_fns: List[Any],
        clocks: Dict[Any, Any],
        ext_outputs: Optional[Dict[str, Any]] = None,
        streamer: Optional["DeviceBackend._ParamStreamer"] = None,
        tracer: Any = None,
        metrics: Any = None,
        mem: Any = None,
        dclock: Optional[DeviceClock] = None,
    ) -> Tuple[Any, Dict, int, int, int, float, Dict[str, Any]]:
        """Segment-fused execution: same placement, one call per segment,
        on its node's stream.  Cross-segment inputs are deduplicated per
        segment -- a remote value consumed by several tasks of one segment
        counts (and, between cards, moves) once, so transfer counts can be
        LOWER than per-task dispatch.  A captured segment reads an output
        of another captured segment of its card in place (the same tensor
        every run), so only the other inputs are copied before a replay.

        With a ``streamer`` (segment-granular parameter streaming) the
        segments were budget-split (:meth:`build_segments` with
        ``max_union_gb``) and are eager callables: each segment's union
        loads as one batched call (unit ``__seg<i>`` of
        :meth:`segment_stream_plan`), and the event after the segment
        anchors the frees of its params.

        ``tracer`` records one span per segment on its node's track: the
        host call's window for an eager segment; for a captured one the
        replay's window on the card (CUDA events through ``dclock``) there
        and the host's replay call on the host track; and a flow arrow per
        transferred value.  ``metrics`` counts the bytes per edge; ``mem``
        books transfers, input staging and the exports' births."""
        placement = schedule.placement
        done_at: Optional[Dict[str, Tuple[str, float]]] = (
            {} if tracer is not None else None
        )
        outputs: Dict[str, Any] = dict(ext_outputs or {})
        # task ids whose value is a captured program's own output
        static: set = set()
        transfer_edges = 0
        transfer_bytes = 0
        events: Dict[str, Any] = {}
        many = len(self.streams) > 1
        t_loop0 = time.perf_counter()
        with torch.no_grad(), StreamSwitch(self.streams, clocks) as sw:
            for seg_i, ((node, tids, exports), fn) in enumerate(
                    zip(segments, seg_fns)):
                dev = self.cluster[node].torch_device
                s = sw.to(node)
                ext: Dict[str, Any] = {}
                inside = set(tids)
                needs_input = False
                union_names: Dict[str, None] = {}
                waited: set = set()
                flow_srcs = [] if tracer is not None else None
                t_s0 = time.perf_counter() if tracer is not None else 0.0
                for tid in tids:
                    task = graph[tid]
                    for _, g in task.param_items():
                        union_names.setdefault(g)
                    aids = _args_of(task)
                    if not aids:
                        needs_input = True
                    for d in aids:
                        if d not in inside and d not in ext:
                            x = outputs[d]
                            if placement.get(d) != node:
                                transfer_edges += 1
                                nb = _array_bytes(x)
                                transfer_bytes += nb
                                ev = events.get(d)
                                if ev is not None and ev not in waited:
                                    s.wait_event(ev)
                                    waited.add(ev)
                                x = _tree_to(x, dev, non_blocking=True)
                                if tracer is not None:
                                    flow_srcs.append((d, nb))
                                if metrics is not None:
                                    metrics.counter(
                                        "transfer.bytes."
                                        f"{placement.get(d, 'ext')}->{node}",
                                        unit="bytes",
                                    ).inc(nb)
                                if mem is not None:
                                    mem.alloc(node, f"xfer:{d}", nb,
                                              "transfers")
                            ext[d] = x
                if streamer is not None:
                    union = streamer.get_task(
                        f"__seg{seg_i}", node, [(g, g) for g in union_names])
                else:
                    union = {g: placed[(g, node)] for g in union_names}
                if needs_input:
                    ext["__input__"] = _tree_to(graph_input, dev)
                    if mem is not None:
                        mem.alloc(node, "input", _array_bytes(graph_input),
                                  "activations")
                captured = isinstance(fn, CapturedProgram)
                if captured and dclock is not None:
                    a = dclock.mark(s)
                if captured:
                    seg_out = fn(union, ext, frozenset(
                        d for d, x in ext.items()
                        if d in static and x is outputs[d]))
                    static.update(seg_out)
                else:
                    seg_out = fn(union, ext)
                if mem is not None:
                    for e in exports:
                        mem.alloc(node, f"out:{e}", _array_bytes(seg_out[e]),
                                  "activations")
                if tracer is not None:
                    t_s1 = time.perf_counter()
                    name = f"seg{seg_i}"
                    if captured and dclock is not None:
                        # the replay returns at enqueue: the device window
                        # goes on the node's track, the host call on the
                        # host's
                        dclock.window(
                            seg_i, name, dev, a, dclock.mark(s), track=node,
                            cat="launch", tasks=len(tids),
                            exports=len(exports),
                        )
                        tracer.complete(
                            "replay", t_s0, t_s1, track="host",
                            cat="launch", segment=seg_i, node=node,
                        )
                        for e in exports:
                            done_at[e] = (node, seg_i)
                        for d, nb in flow_srcs:
                            src = done_at.get(d)
                            if src is not None and isinstance(src[1], int):
                                dclock.flow(src[1], seg_i, src=d, dst=name,
                                            bytes=nb)
                    else:
                        tracer.complete(
                            name, t_s0, t_s1, track=node, cat="launch",
                            tasks=len(tids), exports=len(exports),
                        )
                        for e in exports:
                            done_at[e] = (node, t_s1)
                        self._trace_flows(tracer, done_at, flow_srcs, node,
                                          t_s0, name)
                if streamer is not None:
                    streamer.note_task(node, list(union_names))
                if s is not None and many:
                    ev = torch.cuda.Event()
                    ev.record(s)
                    for e in exports:
                        events[e] = ev
                outputs.update(seg_out)
        loop_s = time.perf_counter() - t_loop0
        final = outputs.get(graph.topo_order[-1]) if graph.topo_order else None
        executed = {
            k: v for k, v in outputs.items()
            if not ext_outputs or k not in ext_outputs
        }
        return (final, {}, transfer_edges, transfer_bytes, len(segments),
                loop_s, executed)

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
        attention_impl: Optional[str] = None,
        chunk_tokens: Optional[int] = None,
        capture: bool = True,
    ):
        """Continuous-batching paged decode engine over a SCHEDULED paged
        decode-step DAG (``frontend.build_paged_decode_dag``), running on
        the device the schedule placed the step on.  ``pool`` is the
        host-side ``models.kv_pages.PagePool`` whose geometry must match
        the graph's pool params.  ``attention_impl`` (one of
        ``ops.attention.PAGED_IMPLS``), when given, must be the impl the
        DAG's layer tasks were built with (they choose the path; the engine
        reports it), else ValueError; ``chunk_tokens`` turns on chunked
        prefill.  On a card each K-step segment replays one CUDA graph
        captured at the engine's first segment; ``capture=False`` keeps it
        eager.

        Runs the same static pre-execution gate as :meth:`execute` first
        (the DEC0xx decode-loop pass checks cache/page-table placement
        coherence), so a schedule that would mis-place the paged cache is
        refused at build time, not discovered as garbage tokens."""
        if self.pre_analysis:
            from ..analysis import pre_execution_gate

            pre_execution_gate(
                graph, self.cluster, schedule, backend="device"
            )
        from ..ops.attention import PAGED_IMPLS
        from .decode_loop import PagedDecodeEngine

        if attention_impl not in PAGED_IMPLS:
            raise ValueError(
                f"attention_impl must be one of {PAGED_IMPLS}, got "
                f"{attention_impl!r}")
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
            flight=flight, attention_impl=attention_impl,
            chunk_tokens=chunk_tokens, device=device, capture=capture,
        )

    def execute(
        self,
        graph: TaskGraph,
        schedule: Schedule,
        params: Dict[str, torch.Tensor],
        graph_input: Any,
        profile: bool = False,
        warmup: bool = True,
        segments: bool = False,
        ext_outputs: Optional[Dict[str, Any]] = None,
        keep_outputs: bool = False,
        stream_params: bool = False,
        reps: int = 1,
        rebatch: bool = True,
        planned: Optional[bool] = None,
        coalesce: bool = False,
        compiled: bool = False,
        trace: Any = None,
        metrics: Any = None,
        memprof: Any = None,
        pre_report: Any = None,
    ) -> DeviceReport:
        """Place params, warm up, run ``reps`` times, measure.

        ``warmup`` runs the placed DAG once untimed first (kernel builds,
        allocator and library warm-up, CUDA-graph captures).  ``reps > 1``
        dispatches the whole placed run back to back and synchronizes
        once; ``makespan_s`` is the per-run time.  Each run starts when
        every node stream has waited on the clock and ends when the clock
        has waited on every node stream.

        ``planned`` selects the pre-planned dispatch path
        (:mod:`.dispatch_plan`): a table built once per call, integer
        indices into a flat value table, each value released after its
        last consumer.  Default (``None``) turns it on unless ``profile``
        (per-task timing hooks) or ``segments`` (already fused).  Outputs
        are bit-identical to the per-task path.  ``coalesce`` (planned
        only) runs runs of consecutive same-node tasks as one host call.

        ``segments=True`` runs each node's contiguous scheduled run as one
        program (:meth:`build_segments`), with sibling microbatch tasks
        re-batched unless ``rebatch=False``; on a card each segment is
        captured once into a CUDA graph and replayed per run: an output of
        another captured segment of its card is read in place, and its
        other inputs are copied into static buffers first.  Incompatible with
        ``profile``.

        ``compiled=True`` captures the whole placed run into ONE CUDA
        graph, each node's tasks on its stream and each exchange an event
        between two streams (:mod:`.compiled_schedule`); a run is one
        replay.  Incompatible with ``profile``, ``segments``,
        ``coalesce``, ``keep_outputs``, ``ext_outputs`` and ``planned``.
        On the CPU the program runs eagerly.  A placement whose nodes
        span several devices runs in a world of one process per device
        (:mod:`.compiled_world`): the graph needs its recipe, the
        controller places nothing (each rank places its own nodes'
        params), each rank captures its share with the exchanges as NCCL
        sends and receives (gloo, eagerly, under ``DLS_PLATFORM=cpu``)
        and replays it once per run.  The ranks time themselves:
        ``makespan_s`` is the largest rank's window (each opens and
        closes on a barrier), ``dispatch_overhead_s`` and
        ``n_dispatches`` the largest rank's host time and calls per run,
        and ``world`` carries every rank's numbers.

        The output of a captured rung (segments or compiled on a card) is
        the graph's own tensor: it holds until the same program runs
        again; clone it to keep it longer.

        ``ext_outputs`` seeds task outputs produced OUTSIDE this graph (the
        elastic-recovery path); ``keep_outputs=True`` returns per-task
        outputs in ``task_outputs``.  ``profile=True`` records per-task
        times into ``timings`` (and ``schedule.timings``); it needs
        ``reps == 1``.

        ``stream_params=True`` replaces up-front placement with planned
        streaming under each node's ``total_memory`` budget
        (:class:`_ParamStreamer`): batched loads from pinned host memory
        on the card's copy stream, prefetched 8 units ahead of the dispatch
        cursor, Belady eviction and deferred frees,
        so a node whose weights exceed its budget still runs.  ``params``
        must lie on the host (parameters already on a card are resident
        whatever the budget says, and raise) and, for a card, in pinned
        memory (:func:`pin_params`; unpinned ones raise).  It runs on the per-task rung
        (``planned`` off by default, refused when asked for) and, with
        ``segments=True``, on budget-split eager segments, one batched
        load per segment.  ``reps > 1`` is refused: a streamed run starts
        cold (the warm-up streams through a streamer of its own).  With
        ``compiled=True`` the stream-safety pass decides
        (:func:`..analysis.analyze_streaming`): a schedule whose every
        node's union fits its budget runs the compiled rung with every
        parameter resident; any other raises ``AnalysisError`` with the
        per-node STR002/STR003 diagnosis.  The report carries
        ``param_loads``, ``param_load_calls``, ``param_load_bytes``,
        ``param_evictions`` and ``peak_param_bytes``.

        ``trace`` / ``metrics`` attach an :class:`..obs.trace.Tracer` /
        :class:`..obs.metrics.MetricsRegistry` to this run: host phase
        spans (``dispatch_order``, ``place_params``, ``plan_build`` or
        ``program_build``, ``warmup``, one ``rep<r>`` per run, the final
        ``fence``), per-launch spans on each node's track (a captured
        rung's from CUDA events, :class:`DeviceClock`), transfer flow
        arrows, per-edge byte counters, launch and transfer counters and
        makespan/overhead histograms; the report then carries
        ``attribution`` (:func:`..obs.attribution.attribute_run` over the
        ``execute`` span).  ``None`` falls back to the ambient pair under
        ``DLS_TRACE=1``; else nothing is recorded (every record is behind a
        ``None`` check).  ``memprof`` attaches an :class:`..obs.memprof.
        MemoryProfiler`: param placements and streamed loads, input
        staging, transfers, output births and the planned rung's deaths
        (the JAX plan's donation lifetimes) on per-node timelines of
        tensor bytes; the warm-up is not recorded, and the report carries
        ``memory`` with the allocator's peak
        (``torch.cuda.max_memory_allocated``) reconciled in on a card.

        Before anything is placed, the static pre-execution gate
        (:func:`..analysis.pre_execution_gate`) refuses a schedule that
        would corrupt the run, with :class:`..analysis.AnalysisError`;
        the compiled rung gates inside :meth:`.compiled_schedule.
        CompiledSchedule.lower`, where the lowered program's exchange
        order joins the checks.  ``pre_report``: a report
        ``analysis.analyze()`` just produced for this exact schedule, which
        lets the gate skip its base passes (used only when its signature
        matches).  ``DeviceBackend(pre_analysis=False)`` or
        ``DLS_SKIP_ANALYSIS=1`` turns the gate off.

        Left out against the reference: ``fence_rtt`` (CUDA events time
        the device, so there is no readback fence to net out) and
        ``donate`` (the planned path releases each value after its last
        consumer instead).
        """
        if segments and profile:
            raise ValueError(
                "profile=True needs per-task dispatch; run without segments"
            )
        if stream_params:
            on_card = sorted(
                k for k, v in params.items()
                if any(t.device.type == "cuda" for t in _leaves(v)))
            if on_card:
                raise ValueError(
                    f"stream_params=True: params {on_card[:3]} are on a "
                    "card, so the whole model is resident whatever the "
                    "budget says; pass the params on the host"
                )
        if compiled:
            if stream_params:
                # the stream-safety pass decides: every node's union fits
                # its budget -> the compiled rung with every param
                # resident; anything that must evict stays on the eager
                # streamed rungs and is refused with the diagnosis
                from ..analysis import (
                    AnalysisError,
                    analyze_streaming,
                    compiled_stream_refusal,
                    stream_verdict,
                )

                srep = analyze_streaming(graph, self.cluster, schedule)
                if stream_verdict(srep) != "compilable":
                    raise AnalysisError(compiled_stream_refusal(srep))
                stream_params = False
            incompatible = [
                name for name, flag in (
                    ("profile", profile),
                    ("segments", segments), ("coalesce", coalesce),
                    ("keep_outputs", keep_outputs),
                    ("ext_outputs", ext_outputs is not None),
                    ("planned", bool(planned)),
                ) if flag
            ]
            if incompatible:
                raise ValueError(
                    "compiled=True lowers the whole run into one program "
                    f"and is incompatible with {incompatible}"
                )
            planned = False
        if planned is None:
            planned = not (profile or stream_params or segments)
        elif planned and (profile or stream_params or segments):
            raise ValueError(
                "planned dispatch is incompatible with profile (per-task "
                "timing hooks), stream_params (param residency changes "
                "mid-run), and segments (already fused)"
            )
        if coalesce and not planned:
            raise ValueError("coalesce=True requires the planned path")
        if reps < 1:
            raise ValueError(f"reps must be >= 1, got {reps}")
        if reps > 1 and profile:
            raise ValueError("profile mode times one run; use reps=1")
        if reps > 1 and stream_params:
            raise ValueError(
                "stream_params runs must start cold: a later rep would "
                "measure a warm param cache; use reps=1"
            )
        lowered = None
        world = False
        if compiled:
            # the gate and the lowering, before anything is placed
            from .compiled_schedule import CompiledSchedule, in_world

            lowered = CompiledSchedule.lower(self, graph, schedule,
                                             self.pre_analysis, pre_report)
            world = in_world(self, lowered[1])
        elif self.pre_analysis:
            from ..analysis import pre_execution_gate

            pre_execution_gate(
                graph, self.cluster, schedule, backend="device",
                precomputed=pre_report,
            )
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

        nodes = sorted(set(schedule.placement.values()))
        # explicit trace=/metrics= win, else the DLS_TRACE ambient pair,
        # else None: every instrumented path below records nothing then
        from ..obs import ambient_metrics, ambient_tracer

        tracer = trace if trace is not None else ambient_tracer()
        mreg = metrics if metrics is not None else ambient_metrics()
        ev_exec = None
        if tracer is not None:
            ev_exec = tracer.begin(
                "execute", cat="schedule", policy=schedule.policy,
                segments=segments, reps=reps,
            )
        held = {
            str(dev): int(torch.cuda.memory_allocated(dev))
            for dev in self.cuda_devices
        }
        stream_plan: Dict[str, List[Tuple[str, Tuple[str, ...]]]] = {}
        if stream_params:
            if self.cuda_devices:
                unpinned = sorted(
                    k for k, v in params.items()
                    if not all(t.is_pinned() for t in _leaves(v)))
                if unpinned:
                    raise ValueError(
                        f"stream_params=True: params {unpinned[:3]} are not "
                        "pinned, so a non_blocking load would run in step "
                        "with the host; pin them once with pin_params"
                    )
            placed, bytes_per_node = {}, {d.node_id: 0 for d in self.cluster}
        elif world:  # each rank places its own nodes' params
            placed = {}
            bytes_per_node = self.param_bytes(graph, schedule, params)
        else:
            t_ph = time.perf_counter() if tracer is not None else 0.0
            # the compiled rung books its params as one slab per node at
            # each run, as the reference's does
            placed, bytes_per_node = self.place_params(
                graph, schedule, params, mem=None if compiled else memprof)
            if tracer is not None:
                tracer.complete(
                    "place_params", t_ph, time.perf_counter(),
                    track="host", cat="stage",
                    bytes=sum(bytes_per_node.values()),
                )
        prog = plan = None
        order: List[str] = []
        cross: frozenset = frozenset()
        segs: List[Segment] = []
        seg_fns: List[Any] = []
        if compiled:
            from .compiled_schedule import CompiledSchedule

            t_ph = time.perf_counter() if tracer is not None else 0.0
            prog = CompiledSchedule.build(
                self, graph, schedule, placed, graph_input,
                pre_analysis=self.pre_analysis, lowered=lowered,
                params=params)
            if tracer is not None:
                tracer.complete(
                    "program_build", t_ph, time.perf_counter(),
                    track="host", cat="plan", phases=len(prog.ir.phases),
                    exchanges=prog.ir.n_exchanges,
                )
            if world:
                return self._execute_world(
                    prog, schedule, graph_input, reps, warmup,
                    bytes_per_node, held, tracer, mreg, memprof, ev_exec)
        else:
            t_ph = time.perf_counter() if tracer is not None else 0.0
            order = self.dispatch_order(graph, schedule)
            if tracer is not None:
                tracer.complete(
                    "dispatch_order", t_ph, time.perf_counter(),
                    track="host", cat="schedule", tasks=len(order),
                )
        if planned:
            from .dispatch_plan import DispatchPlan

            t_ph = time.perf_counter() if tracer is not None else 0.0
            plan = DispatchPlan.build(
                self, graph, schedule, order, placed,
                ext_keys=tuple(ext_outputs or ()), coalesce=coalesce,
                keep_outputs=keep_outputs,
            )
            if tracer is not None:
                tracer.complete(
                    "plan_build", t_ph, time.perf_counter(),
                    track="host", cat="plan", steps=len(plan.steps),
                )
        elif not segments and not compiled:
            placement = schedule.placement
            cross = frozenset(
                d for t in order for d in _args_of(graph[t])
                if placement.get(d) not in (None, placement[t])
            )
        elif segments:
            # drop tasks whose (transitive) producers never run, host side
            # (ext_outputs count as alive producers)
            alive: set = set(ext_outputs or ())
            for tid in order:
                if all(d in alive for d in _args_of(graph[tid])):
                    alive.add(tid)
            kept = [t for t in order
                    if t in alive and t not in (ext_outputs or ())]
            if stream_params:
                # budget-split by the params' true bytes; eager callables,
                # since a captured graph would read a streamed param at an
                # address the next load frees
                segs = self.build_segments(
                    graph, schedule, kept,
                    max_union_gb=self._stream_segment_caps(),
                    param_gb={g: _array_bytes(params[g]) / 1024**3
                              for g in graph.unique_params()})
                seg_fns = [self._segment_callable(graph, tids, exports, rebatch)
                           for _node, tids, exports in segs]
                stream_plan = self.segment_stream_plan(graph, segs)
            else:
                segs = self.build_segments(graph, schedule, kept)
                seg_fns = self._segment_programs(graph, segs, rebatch, placed)
        if stream_params and not segments:
            for tid in order:
                node = schedule.placement.get(tid)
                if node is not None:
                    stream_plan.setdefault(node, []).append(
                        (tid, tuple(g for _, g in graph[tid].param_items())))

        def streamer(mem=None):
            return self._ParamStreamer(
                self.cluster, params, plan=stream_plan, streams=self.streams,
                mem=mem)

        def one_rep(clocks, prof: bool = False, st=None, obs=None):
            """One placed run (its params from ``st`` when streaming;
            recorded into ``obs`` = (tracer, metrics, memprof, device
            clock) when given): (output, timings, transfer edges, transfer
            bytes, host calls, loop seconds, executed outputs)."""
            tr, mr, mem, dc = obs or (None, None, None, None)
            if prog is not None:  # the graph forks and joins its streams
                return prog.run(graph_input, tracer=tr, metrics=mr, mem=mem,
                                dclock=dc, slab_bytes=bytes_per_node)
            self._fork(clocks, nodes)
            if plan is not None:
                out = plan.run(graph_input, ext_outputs, clocks,
                               tracer=tr, metrics=mr, mem=mem)
            elif segments:
                out = self._run_segmented(
                    graph, schedule, placed, graph_input, segs, seg_fns,
                    clocks, ext_outputs, st, tracer=tr, metrics=mr, mem=mem,
                    dclock=dc)
            else:
                out = self._run(graph, schedule, placed, graph_input, order,
                                clocks, prof, ext_outputs, cross, st,
                                tracer=tr, metrics=mr, mem=mem, dclock=dc)
            self._join(clocks, nodes)
            return out

        compile_s = 0.0
        if warmup:
            t0 = time.perf_counter()
            # a throwaway streamer, so the timed run's starts cold; it
            # drops its params only after the card has finished with them.
            # The warm-up is not recorded: its launches are builds and
            # captures, not the steady state
            warm = streamer() if stream_params else None
            one_rep(self._clocks(), st=warm)
            self._synchronize()
            del warm
            compile_s = time.perf_counter() - t0
            if tracer is not None:
                tracer.complete(
                    "warmup", t0, time.perf_counter(), track="host",
                    cat="plan", compile_s=compile_s,
                )

        for dev in self.cuda_devices:
            torch.cuda.reset_peak_memory_stats(dev)
        self._synchronize()
        # CUDA events onto the host clock, anchored after this synchronize
        dclock = (
            DeviceClock(self.cuda_devices)
            if tracer is not None and self.cuda_devices else None
        )
        obs = ((tracer, mreg, memprof, dclock)
               if tracer is not None or mreg is not None
               or memprof is not None else None)
        clocks = self._clocks()
        # one card: CUDA events on its clock stream; else the host clock
        one_card = len(self.devices) == 1 and bool(self.cuda_devices)
        t0 = self._mark(self.devices[0]) if one_card else time.perf_counter()
        loop_s = 0.0
        st = streamer(memprof) if stream_params else None
        for r in range(reps):
            t_ph = time.perf_counter() if tracer is not None else 0.0
            # the last run's outputs die before this run's are made
            output = executed = None
            output, timings, tedges, tbytes, n_disp, rep_loop_s, executed = (
                one_rep(clocks, profile, st, obs))
            loop_s += rep_loop_s
            if tracer is not None:
                tracer.complete(
                    f"rep{r}", t_ph, time.perf_counter(), track="host",
                    cat="launch", dispatches=n_disp, fenced=r == reps - 1,
                )
        t_f0 = time.perf_counter() if tracer is not None else 0.0
        if one_card:
            t1 = self._mark(self.devices[0])
            self._synchronize()
            wall = self._seconds(t0, t1)
        else:
            self._synchronize()
            wall = time.perf_counter() - t0
        if tracer is not None:
            tracer.complete(
                "fence", t_f0, time.perf_counter(), track="host",
                cat="collect", devices=len(self.cuda_devices),
            )
            if dclock is not None:
                dclock.flush(tracer)
        makespan = max(wall / reps, 1e-9)
        peaks = {
            str(dev): int(torch.cuda.max_memory_allocated(dev))
            for dev in self.cuda_devices
        }
        if memprof is not None:
            # the allocator's peak beside the model's, per node of a card
            # (the nodes of one card share its allocator, so each carries
            # the card's peak)
            memprof.reconcile({
                d.node_id: peaks[str(d.torch_device)]
                for d in self.cluster if str(d.torch_device) in peaks
            })
        if timings:
            schedule.timings = timings
        if mreg is not None:
            self._record_metrics(mreg, n_disp, tedges, tbytes, reps,
                                 loop_s / reps, makespan, compile_s, timings)
        attribution = self._attribute(tracer, ev_exec, makespan)
        captured: Dict[str, int] = {}
        for p in ([prog] if prog is not None else seg_fns):
            for k, v in getattr(p, "launches", {}).items():
                captured[k] = captured.get(k, 0) + v
        return DeviceReport(
            policy=schedule.policy,
            makespan_s=makespan,
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
            planned=plan is not None,
            compiled=prog is not None,
            captured_launches=captured,
            task_outputs=executed if keep_outputs else {},
            held_hbm_bytes=held,
            streamed=st is not None,
            param_loads=st.loads if st else 0,
            param_load_calls=st.load_calls if st else 0,
            param_load_bytes=st.load_bytes if st else 0,
            param_evictions=st.evictions if st else 0,
            peak_param_bytes=dict(st.peak) if st else {},
            attribution=attribution,
            memory=memprof.summary() if memprof is not None else None,
        )

    def _execute_world(self, prog, schedule: Schedule, graph_input: Any,
                       reps: int, warmup: bool,
                       bytes_per_node: Dict[str, int], held: Dict[str, int],
                       tracer, mreg, memprof, ev_exec) -> DeviceReport:
        """:meth:`execute`'s runs of a :class:`.compiled_world.WorldProgram`
        and its report: an untimed run first under ``warmup``, then
        ``reps`` runs that every rank times itself."""
        from .compiled_world import book_program_memory

        compile_s = 0.0
        if warmup:
            t0 = time.perf_counter()
            prog.run(graph_input, 1)
            compile_s = time.perf_counter() - t0
            if tracer is not None:
                tracer.complete("warmup", t0, time.perf_counter(),
                                track="host", cat="plan",
                                compile_s=compile_s)
        t0 = time.perf_counter()
        res = prog.run(graph_input, reps)
        t1 = time.perf_counter()
        ranks = res["ranks"]
        windows = [r["window_s"] for r in ranks]
        makespan = max(max(windows), 1e-9)
        n_disp = max(r["calls"] for r in ranks)
        loop_s = max(r["host_s"] for r in ranks)
        ir = prog.ir
        if tracer is not None:
            tracer.complete("world_run", t0, t1, track="host", cat="launch",
                            dispatches=n_disp, ranks=len(ranks), reps=reps)
            for node in ir.devices:
                tracer.complete(
                    "program", t0, t1, track=node, cat="program",
                    tasks=sum(len(ph.compute.get(node, ()))
                              for ph in ir.phases),
                    phases=len(ir.phases), rank=prog.rank_of[node])
        tedges, tbytes = prog.transfer_edges, prog.transfer_bytes
        if mreg is not None:
            mreg.counter("compiled.launches").inc(n_disp * reps)
            mreg.counter("compiled.exchanges").inc(tedges * reps)
            self._record_metrics(mreg, n_disp, tedges, tbytes, reps, loop_s,
                                 makespan, compile_s, {})
        peaks: Dict[str, int] = {}
        if prog.devices[0].type == "cuda":
            peaks = {str(d): r["peak_bytes"]
                     for d, r in zip(prog.devices, ranks)}
            held = {str(d): r["held_bytes"]
                    for d, r in zip(prog.devices, ranks)}
        if memprof is not None:
            for _ in range(reps):  # once per run, as the one-device rung
                book_program_memory(memprof, ir, prog.placement, graph_input,
                                    bytes_per_node, prog.xfer_nbytes,
                                    prog.final, prog.out_bytes)
            memprof.reconcile({
                d.node_id: peaks[str(d.torch_device)]
                for d in self.cluster if str(d.torch_device) in peaks})
        attribution = self._attribute(tracer, ev_exec, makespan)
        return DeviceReport(
            policy=schedule.policy,
            makespan_s=makespan,
            output=res["output"],
            n_devices=len(self.cluster),
            transfer_edges=tedges,
            transfer_bytes=tbytes,
            param_bytes_placed=bytes_per_node,
            compile_s=compile_s,
            peak_hbm_bytes=peaks,
            n_dispatches=n_disp,
            dispatch_overhead_s=loop_s,
            compiled=True,
            captured_launches=prog.launches,
            held_hbm_bytes=held,
            attribution=attribution,
            memory=memprof.summary() if memprof is not None else None,
            world={
                "ranks": len(ranks),
                "devices": [str(d) for d in prog.devices],
                "start_s": prog.start_s,
                "build_s_by_rank": prog.build_s,
                "makespan_s_by_rank": windows,
                "makespan_spread_s": max(windows) - min(windows),
                "dispatch_overhead_s_by_rank": [r["host_s"] for r in ranks],
                "n_dispatches_by_rank": [r["calls"] for r in ranks],
                "n_dispatches_sum": sum(r["calls"] for r in ranks),
                "ran_by_rank": [r["ran"] for r in ranks],
                "captured_by_rank": prog.rank_launches,
                "exchanges_across_ranks": len(prog.cross),
                "bytes_across_ranks": sum(prog.xfer_nbytes[ex.tid]
                                          for ex in prog.cross),
            },
        )

    @staticmethod
    def _attribute(tracer, ev_exec, makespan: float) -> Optional[Dict]:
        """Close the ``execute`` span and attribute its window (an ambient
        tracer holds earlier runs too); None untraced.  Diagnosis only: a
        failure here never fails the run, and leaves the attribution
        None."""
        if ev_exec is None:
            return None
        tracer.end(ev_exec, makespan_s=makespan)
        try:
            from ..obs.attribution import attribute_run

            att = attribute_run(tracer, window=(ev_exec["t0"], ev_exec["t1"]))
        except Exception:
            return None
        return att.summary() if att.critical_path else None

    @staticmethod
    def _record_metrics(mreg, n_disp: int, tedges: int, tbytes: int,
                        reps: int, overhead_s: float, makespan: float,
                        compile_s: float,
                        timings: Dict[str, TaskTiming]) -> None:
        """One execute's totals into the registry: per-run counts times
        ``reps`` (every rep is the same run), one histogram sample each,
        and in profile mode each node's busy fraction of the measured
        span."""
        mreg.counter("dispatch.launches").inc(n_disp * reps)
        mreg.counter("dispatch.transfer_edges").inc(tedges * reps)
        mreg.counter("dispatch.transfer_bytes", unit="bytes").inc(
            tbytes * reps)
        mreg.histogram("dispatch.overhead_s", unit="s").observe(overhead_s)
        mreg.histogram("execute.makespan_s", unit="s").observe(makespan)
        mreg.histogram("execute.compile_s", unit="s").observe(compile_s)
        if timings:
            span_end = max(t.finish for t in timings.values())
            busy: Dict[str, float] = {}
            for t in timings.values():
                busy[t.node_id] = busy.get(t.node_id, 0.0) + t.duration
            for n, b in busy.items():
                mreg.gauge(f"device.utilization.{n}", unit="frac").set(
                    b / span_end if span_end > 0 else 0.0)
