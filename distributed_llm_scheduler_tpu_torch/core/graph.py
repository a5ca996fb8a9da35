"""Core task-graph model.

The unit of work is a :class:`Task`: a named computation with an activation
memory footprint, an (estimated or measured) compute time, a set of
dependencies, and a set of named parameters it needs resident on whichever
device executes it.  A :class:`TaskGraph` is a validated DAG of tasks with the
topological utilities every scheduling policy needs (topo order, DAG depth,
downstream critical-path length).

PyTorch port of ``distributed_llm_scheduler_tpu.core.graph``; framework-free,
so structure and semantics are identical.  Mirrors the reference's ``Task``
(reference ``schedulers.py:7-17``) with these additions:

* parameters carry **real byte sizes** (``param_bytes``) instead of the
  reference's hard-coded 0.5 GB unit (reference ``schedulers.py:70,89``);
  the 0.5 GB unit survives only as the *default* for tasks that don't
  specify sizes, so synthetic workloads reproduce reference behavior.
* a task may own a tensor ``fn`` plus a meta-tensor output spec so the
  device backend can dispatch it on a GPU; the scheduler layer never
  looks at ``fn``.
* mutable scheduling state (status, assigned node) lives on the task, as in
  the reference, but graph structure is immutable after ``freeze()``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Set, Tuple

# The reference models every parameter as exactly 0.5 GB
# (reference schedulers.py:70,89 and simulation.py:202,211).  We keep that
# as the *default* size so synthetic DAGs and parity tests reproduce the
# reference numbers; real model frontends supply true byte sizes.
DEFAULT_PARAM_GB: float = 0.5
GB: int = 1024**3


def mark_batch0(fn):
    """Declare ``fn`` batch-axis-0 polymorphic: for any split of its array
    arguments along axis 0, ``fn(p, concat(xs, 0), ...) ==
    concat([fn(p, x, ...) for x], 0)``.  True of per-token/per-row ops
    (layer norms, matmuls on trailing dims, attention over independent
    batch entries, residual adds) and false of axis-0 reductions or
    axis-0 concats.  The segment re-batching pass
    (:mod:`..backends.rebatch`) only folds sibling tasks whose fns carry
    this marker — an unmarked fn is never batched, so correctness is
    opt-in per op, not guessed."""
    fn._dls_batch0 = True
    return fn


def is_batch0(fn) -> bool:
    return bool(getattr(fn, "_dls_batch0", False))


def mark_concat0(fn):
    """Declare ``fn(p, x1, ..., xn) == concatenate(xs, axis=0)`` (ignoring
    params).  The re-batching pass uses this to skip materializing a
    concat whose inputs are exactly a batched class's members in order —
    the batched value IS the concat, so the op becomes identity instead
    of a slice-and-recopy round-trip of the full output."""
    fn._dls_concat0 = True
    return fn


def is_concat0(fn) -> bool:
    return bool(getattr(fn, "_dls_concat0", False))


def mark_rootslice(fn, family, lo: int, hi: int, make):
    """Declare a ROOT task fn (consumes the shared graph input, no task
    args) to be the static batch-slice ``[lo, hi)`` instance of a slice
    family: ``make(a, b)`` builds the family's fn for any range, and for
    any split point ``a <= b <= c``::

        make(a, c)(p, x) == concat([make(a, b)(p, x), make(b, c)(p, x)], 0)

    True of per-row input transforms (embedding gathers over a batch
    slice); the segment re-batching pass merges sibling roots whose
    slices tile one contiguous range into a single ``make(lo0, hiN)``
    call — the fused forward's full-batch gather, recovered whenever
    placement co-locates the roots.  ``family`` must pin every closure
    variable other than the slice (e.g. the vocab-shard bounds) so only
    true siblings compare equal."""
    fn._dls_rootslice = (family, int(lo), int(hi), make)
    return fn


def rootslice_of(fn):
    """The ``(family, lo, hi, make)`` marker, or None."""
    return getattr(fn, "_dls_rootslice", None)


class TaskStatus(enum.Enum):
    PENDING = "pending"
    ASSIGNED = "assigned"
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"


@dataclass
class Task:
    """One schedulable unit of work.

    Args:
      task_id: unique name, e.g. ``"layer_3_attention"``.
      memory_required: activation/workspace footprint in GB while running.
      compute_time: estimated wall seconds on a speed-1.0 device.  Replaced
        by measured compiled timings when a cost model calibration runs.
      dependencies: task_ids that must complete before this task starts.
      params_needed: names of weight tensors that must be resident.
      param_bytes: optional true sizes for (a subset of) ``params_needed``;
        missing entries fall back to ``DEFAULT_PARAM_GB``.
      fn: optional tensor computation ``fn(params_dict, *inputs) -> output``.
      arg_tasks: which dependency outputs feed ``fn``, in order.  Defaults to
        ``dependencies`` order.
      param_alias: optional mapping local->global param names.  When set,
        ``fn`` reads params by *local* name (e.g. ``"g"``) and the backend
        feeds it ``{local: params[global]}``.  This lets structurally
        identical tasks (every layer's ln1) share ONE fn object.
      out_shape: optional spec of the output (a ``device="meta"`` tensor).
      out_bytes: optional true output size in bytes; cost models charge
        cross-node transfers by this when present, falling back to
        ``memory_required`` (which also covers temps and so over-charges
        transfers).
      flops: optional analytic FLOP count (feeds the cost model).
      group: optional label (e.g. layer index) for fusion/visualization.
    """

    task_id: str
    memory_required: float
    compute_time: float
    dependencies: List[str] = field(default_factory=list)
    params_needed: Set[str] = field(default_factory=set)
    param_bytes: Dict[str, int] = field(default_factory=dict)
    fn: Optional[Callable[..., Any]] = None
    arg_tasks: Optional[List[str]] = None
    param_alias: Optional[Dict[str, str]] = None
    out_shape: Optional[Any] = None
    out_bytes: Optional[int] = None
    flops: Optional[float] = None
    group: Optional[str] = None

    # mutable scheduling state
    status: TaskStatus = TaskStatus.PENDING
    assigned_node: Optional[str] = None

    def __post_init__(self) -> None:
        self.dependencies = list(self.dependencies)
        self.params_needed = set(self.params_needed)

    def param_items(self) -> List[Tuple[str, str]]:
        """(fn-facing local name, global param name) pairs.

        Without an alias the names coincide; with one, backends feed ``fn``
        a dict keyed by local names resolved from global param storage.
        """
        if self.param_alias is not None:
            return list(self.param_alias.items())
        return [(p, p) for p in sorted(self.params_needed)]

    # -- param sizing ------------------------------------------------------
    def param_size_gb(self, param: str) -> float:
        """Size of one named parameter in GB **as declared on this task**
        (0.5 GB default).  Declaration-local: a task using a param another
        task declared sees the default here.  All scheduling/memory
        accounting uses the authoritative graph-wide table instead
        (``TaskGraph.param_size_gb``, fixed at ``freeze()``)."""
        if param in self.param_bytes:
            return self.param_bytes[param] / GB
        return DEFAULT_PARAM_GB

    def total_param_gb(self) -> float:
        """Declaration-local total; see :meth:`param_size_gb`."""
        return sum(self.param_size_gb(p) for p in self.params_needed)

    @property
    def completed(self) -> bool:
        return self.status is TaskStatus.COMPLETED

    @property
    def failed(self) -> bool:
        return self.status is TaskStatus.FAILED

    def reset(self) -> None:
        """Clear scheduling state (graphs are reused across scheduler runs)."""
        self.status = TaskStatus.PENDING
        self.assigned_node = None

    def __repr__(self) -> str:  # concise, used in error messages
        return (
            f"Task({self.task_id!r}, mem={self.memory_required:.3f}GB, "
            f"t={self.compute_time:.4f}s, deps={len(self.dependencies)}, "
            f"params={len(self.params_needed)})"
        )


class GraphValidationError(ValueError):
    pass


#: ``(import path "module:function", args, kwargs)`` of a DAG builder
#: call: a picklable record of how a graph was built
Recipe = Tuple[str, Tuple[Any, ...], Dict[str, Any]]


def from_recipe(recipe: Recipe) -> "TaskGraph":
    """The graph a recorded builder call gives when made again: the
    builder's result, or its ``.graph`` when it returns a model DAG."""
    import importlib

    path, args, kwargs = recipe
    module, _, name = path.partition(":")
    built = getattr(importlib.import_module(module), name)(*args, **kwargs)
    return getattr(built, "graph", built)


class TaskGraph:
    """A validated DAG of tasks plus the topological utilities schedulers use.

    Unlike the reference — where the "graph" is an implicit dict inside the
    scheduler (reference ``schedulers.py:34-48``) — the graph is a first-class
    object: built once, validated (missing deps, duplicate ids, cycles),
    frozen, and shared read-only by schedulers, backends, and visualization.
    Per-run mutable state lives in scheduler-owned structures, not here, so a
    graph can be scheduled many times without deep copies (the reference must
    deep-copy tasks per trial, reference ``simulation.py:309-317``).
    """

    def __init__(self, tasks: Iterable[Task] = (), name: str = "dag"):
        self.name = name
        # how to build this graph again in another process (its task fns
        # are closures and do not pickle): set by the DAG builders that
        # record one; see :func:`from_recipe`
        self.recipe: Optional[Recipe] = None
        self._tasks: Dict[str, Task] = {}
        self._dependents: Dict[str, List[str]] = {}
        self._param_gb: Dict[str, float] = {}
        self._topo: Optional[List[str]] = None
        for t in tasks:
            self.add_task(t)

    # -- construction ------------------------------------------------------
    def add_task(self, task: Task) -> None:
        if task.task_id in self._tasks:
            raise GraphValidationError(f"duplicate task id {task.task_id!r}")
        self._tasks[task.task_id] = task
        self._topo = None  # invalidate

    def freeze(self) -> "TaskGraph":
        """Validate, compute topo order, and fix the param size table.

        The size table is the single source of truth for every byte of
        scheduler memory accounting: a param's size is its ``param_bytes``
        entry (first task to declare one wins; conflicting declarations
        raise) or ``DEFAULT_PARAM_GB``.  Idempotent.
        """
        self._validate()
        self._dependents = {tid: [] for tid in self._tasks}
        for t in self._tasks.values():
            for d in t.dependencies:
                self._dependents[d].append(t.task_id)
        self._topo = self._toposort()
        self._param_gb = {}
        for t in self._tasks.values():
            for p in t.params_needed:
                declared = t.param_bytes.get(p)
                size = declared / GB if declared is not None else None
                prev = self._param_gb.get(p)
                if prev is None:
                    if size is not None:
                        self._param_gb[p] = size
                elif size is not None and abs(prev - size) > 1e-12:
                    raise GraphValidationError(
                        f"param {p!r} declared with conflicting sizes "
                        f"({prev:.6f} vs {size:.6f} GB)"
                    )
        return self

    def _validate(self) -> None:
        for t in self._tasks.values():
            for d in t.dependencies:
                if d not in self._tasks:
                    raise GraphValidationError(
                        f"task {t.task_id!r} depends on unknown task {d!r}"
                    )
            if t.memory_required < 0:
                raise GraphValidationError(
                    f"task {t.task_id!r} has negative memory"
                )

    def _toposort(self) -> List[str]:
        """Kahn's algorithm over self._dependents; stable w.r.t. insertion
        order for determinism."""
        indeg = {tid: len(t.dependencies) for tid, t in self._tasks.items()}
        ready = [tid for tid in self._tasks if indeg[tid] == 0]
        order: List[str] = []
        i = 0
        while i < len(ready):
            tid = ready[i]
            i += 1
            order.append(tid)
            for dep in self._dependents[tid]:
                indeg[dep] -= 1
                if indeg[dep] == 0:
                    ready.append(dep)
        if len(order) != len(self._tasks):
            cyclic = sorted(set(self._tasks) - set(order))
            raise GraphValidationError(f"cycle involving tasks {cyclic[:5]}")
        return order

    # -- access ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._tasks)

    def __contains__(self, tid: str) -> bool:
        return tid in self._tasks

    def __iter__(self):
        return iter(self.tasks())

    def __getitem__(self, tid: str) -> Task:
        return self._tasks[tid]

    def get(self, tid: str) -> Optional[Task]:
        return self._tasks.get(tid)

    def task_ids(self) -> List[str]:
        return list(self._tasks)

    def tasks(self) -> List[Task]:
        return list(self._tasks.values())

    @property
    def topo_order(self) -> List[str]:
        if self._topo is None:
            self.freeze()
        return list(self._topo)

    def dependents(self, tid: str) -> List[str]:
        if self._topo is None:
            self.freeze()
        return list(self._dependents[tid])

    def roots(self) -> List[str]:
        return [tid for tid, t in self._tasks.items() if not t.dependencies]

    def leaves(self) -> List[str]:
        if self._topo is None:
            self.freeze()
        return [tid for tid in self._tasks if not self._dependents[tid]]

    def reset(self) -> None:
        for t in self._tasks.values():
            t.reset()

    # -- analysis (mirrors reference analyze_dag, test_gpt2.py:218-243) ----
    def unique_params(self) -> Set[str]:
        out: Set[str] = set()
        for t in self._tasks.values():
            out |= t.params_needed
        return out

    def param_size_gb(self, param: str) -> float:
        """O(1) lookup in the size table fixed at freeze()."""
        if self._topo is None:
            self.freeze()
        return self._param_gb.get(param, DEFAULT_PARAM_GB)

    def total_param_gb(self) -> float:
        return sum(self.param_size_gb(p) for p in self.unique_params())

    def output_gb(self, tid: str) -> float:
        """Bytes a consumer actually receives from ``tid``: the task's true
        output size when known (pre-flight analysis), else its activation
        footprint (the reference-era proxy, which also counts temps)."""
        t = self._tasks[tid]
        if t.out_bytes is not None:
            return t.out_bytes / GB
        return t.memory_required

    def total_activation_gb(self) -> float:
        return sum(t.memory_required for t in self._tasks.values())

    def total_compute_time(self) -> float:
        return sum(t.compute_time for t in self._tasks.values())

    def max_task_memory(self) -> float:
        return max((t.memory_required for t in self._tasks.values()), default=0.0)

    # -- topological metrics used by policies ------------------------------
    def depths(self) -> Dict[str, int]:
        """Depth from roots: root=0, else 1 + max(dep depth).

        Same quantity DFSScheduler memoizes per-task (reference
        ``schedulers.py:140-152``), computed here in one topo pass.
        """
        depth: Dict[str, int] = {}
        for tid in self.topo_order:
            deps = self._tasks[tid].dependencies
            depth[tid] = 0 if not deps else 1 + max(depth[d] for d in deps)
        return depth

    def critical_path_lengths(self) -> Dict[str, float]:
        """Downstream critical-path length: own time + max over dependents.

        Same quantity CriticalPathScheduler memoizes (reference
        ``schedulers.py:301-321``), one reverse-topo pass.
        """
        cpl: Dict[str, float] = {}
        for tid in reversed(self.topo_order):
            t = self._tasks[tid]
            down = [cpl[d] for d in self._dependents[tid]]
            cpl[tid] = t.compute_time + (max(down) if down else 0.0)
        return cpl

    def critical_path_time(self) -> float:
        """Length of the DAG's critical path in compute seconds (speed 1.0)."""
        cpl = self.critical_path_lengths()
        return max(cpl.values(), default=0.0)

    def summary(self) -> Dict[str, Any]:
        """Headline DAG statistics (parity with reference analyze_dag)."""
        n = len(self._tasks)
        deps = [len(t.dependencies) for t in self._tasks.values()]
        return {
            "name": self.name,
            "num_tasks": n,
            "total_activation_gb": self.total_activation_gb(),
            "max_task_memory_gb": self.max_task_memory(),
            "num_unique_params": len(self.unique_params()),
            "total_param_gb": self.total_param_gb(),
            "sequential_compute_s": self.total_compute_time(),
            "critical_path_s": self.critical_path_time(),
            "max_deps": max(deps, default=0),
            "avg_deps": (sum(deps) / n) if n else 0.0,
        }

    def __repr__(self) -> str:
        return f"TaskGraph({self.name!r}, {len(self._tasks)} tasks)"
