"""Pre-flight device-memory accounting: what each task really takes.

PyTorch port of ``distributed_llm_scheduler_tpu.utils.hbm``.  A task's
``memory_required`` starts as an analytic activation estimate, while the
kernels and the caching allocator take temporaries the estimate does not
see.  :func:`preflight_task_memory` measures, and RAISES each task's
``memory_required`` to the measured footprint when the estimate was
lower; estimates are never lowered.  Where the JAX package reads XLA's
``compiled.memory_analysis()`` (temp + output bytes), the port reads the
CUDA caching allocator's peak around one run of the task on the card.

Shapes propagate through the DAG on the ``meta`` device (no FLOPs
spent), and each distinct (fn, input shapes and dtypes) runs once: with
shared fns, the 537-task GPT-2 flagship runs a few dozen.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..core.graph import GB, TaskGraph


def _leaves(x: Any) -> List[torch.Tensor]:
    """The tensors of a task output or argument (a tensor, or tuples,
    lists and dicts of them)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [leaf for item in x for leaf in _leaves(item)]
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in _leaves(x[k])]
    return []


def _nbytes(x: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(x))


def _meta(x: Any) -> Any:
    """``x`` (a tensor or a dict/list/tuple nest of them) on meta."""
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    return _zeros(x, torch.device("meta"))


def _zeros(spec: Any, device: torch.device) -> Any:
    """Zero-filled tensors on ``device`` in the structure of ``spec``."""
    if isinstance(spec, torch.Tensor):
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if isinstance(spec, (tuple, list)):
        return type(spec)(_zeros(s, device) for s in spec)
    if isinstance(spec, dict):
        return {k: _zeros(v, device) for k, v in spec.items()}
    return spec


def _key_of(fn: Any, pd: Dict[str, torch.Tensor], args: Tuple[Any, ...]):
    return (id(fn), tuple(
        (tuple(t.shape), str(t.dtype)) for t in _leaves((pd, args))
    ))


def _warm_libraries(device) -> None:
    """Make the one-time allocations of the math libraries before any
    footprint is read: cuBLAS takes its workspace (32 MB on an H100) from
    the caching allocator at the first matmul on a stream and keeps it, so
    without this the first task measured with a matmul carries it."""
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.ones((8, 8), dtype=dtype, device=device)
        torch.addmm(a[0], a, a)
        torch.mm(a, a)
    torch.cuda.synchronize(device)


def _measure_on_card(fn, pd, args, device) -> int:
    """Peak bytes the caching allocator holds above what it held before
    one run of ``fn`` (temporaries and output), at least the output's own
    bytes (an output that is a view of an input allocates nothing, yet it
    is memory the task hands on)."""
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    out = fn(pd, *args)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - before
    return max(peak, _nbytes(out))


def preflight_task_memory(
    graph: TaskGraph,
    params: Dict[str, torch.Tensor],
    graph_input: Any,
) -> Dict[str, float]:
    """Set each task's ``out_bytes`` from its output shapes, and on a card
    raise its ``memory_required`` to what one run of it takes there.

    Runs on the device of ``graph_input`` (a tensor, or a dict of them
    such as the training DAG's ``{"ids", "targets"}``).  A training task's
    footprint includes the activations its backward saves: it
    differentiates inside the call.  On CUDA, each distinct (fn, input
    shapes and dtypes) runs once on the card, on the real params and
    zero-filled activations of the right shapes (the graph input itself
    for a root task), after ``torch.cuda.reset_peak_memory_stats``; its
    footprint is the peak allocated above what was allocated before the
    call.  Returns ``task_id -> footprint GB`` for every task with an fn;
    tasks keep ``max(analytic, footprint)``.

    On the CPU there is no allocator peak to read: shapes propagate on the
    ``meta`` device only, ``out_bytes`` is set, ``memory_required`` is left
    as it is, and the result is empty.  Schedule-only tasks (no fn) are
    left untouched.
    """
    if all(t.fn is None for t in graph):
        return {}
    device = _leaves(graph_input)[0].device
    on_card = device.type == "cuda"
    out_specs: Dict[str, Any] = {}
    footprint_gb: Dict[str, float] = {}
    cache: Dict[Any, Tuple[float, int]] = {}
    input_spec = _meta(graph_input)
    if on_card:
        _warm_libraries(device)

    with torch.no_grad():
        for tid in graph.topo_order:
            task = graph[tid]
            if task.fn is None:
                continue
            pd_spec = {
                loc: _meta(params[glob]) for loc, glob in task.param_items()
            }
            arg_ids = task.arg_tasks or task.dependencies
            args = (
                tuple(out_specs[d] for d in arg_ids) if arg_ids
                else (input_spec,)
            )
            out_specs[tid] = task.fn(pd_spec, *args)

            key = _key_of(task.fn, pd_spec, args)
            entry = cache.get(key)
            if entry is None:
                out_bytes = _nbytes(out_specs[tid])
                gb = None
                if on_card:
                    pd = {loc: params[glob].to(device)
                          for loc, glob in task.param_items()}
                    real = _zeros(args, device) if arg_ids else (graph_input,)
                    gb = _measure_on_card(task.fn, pd, real, device) / GB
                    del pd, real
                entry = cache[key] = (gb, out_bytes)
            gb, out_bytes = entry
            if gb is not None:
                footprint_gb[tid] = gb
                if gb > task.memory_required:
                    task.memory_required = gb
            # true output size: cost models charge cross-node transfers by
            # this instead of the temp-inflated activation footprint
            task.out_bytes = out_bytes
    return footprint_gb
