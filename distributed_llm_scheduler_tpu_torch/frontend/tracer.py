"""``torch.fx`` model tracer.

PyTorch port of ``distributed_llm_scheduler_tpu.frontend.tracer``, the
analog of the reference's dynamic trace path (``extract_from_traced_model``,
reference ``test_gpt2.py:170-216``): the reference registers torch forward
hooks on leaf modules and emits a **linear chain** of tasks in execution
order (each task depending only on the previous op).  Here any function of
tensors is traced with ``torch.fx.experimental.proxy_tensor.make_fx`` into
an ATen-level graph, and each (non-trivial) op becomes one task, chained
linearly in trace order, with real output byte sizes from the op's traced
value.

Where the JAX tracer reads a jaxpr, this one reads ATen ops, so the tasks
are not the JAX tracer's one for one (ROADMAP.md C): an ATen op is not a
``lax`` primitive.  What holds is structural: a linear chain, the closed-
over tensors (``_tensor_constant*`` ``get_attr`` nodes, the JAX tracer's
``constvars``) as the tasks' named params with their real sizes, and every
weight, even one read only through a view, transpose or cast, charged to
the task that consumes it.

Trace on CPU or ``meta`` tensors: a hand-written kernel launched on a card
runs outside the dispatcher, so ``make_fx`` would not see it (the port's
kernel wrappers take their plain versions on CPU and meta tensors).

This intentionally keeps the reference's linear-chain fidelity — it's a
fallback extractor for arbitrary models.  Structured frontends (e.g.
``build_gpt2_dag``) produce true-dependency DAGs and should be preferred.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Set

import torch

from ..core.graph import GB, Task, TaskGraph

# ops too trivial to stand as scheduling units on their own — folded into
# the following op's task: views, transposes, casts, slices and copies,
# the ATen counterparts of the JAX tracer's broadcast_in_dim, reshape,
# transpose, convert_element_type, squeeze, expand_dims, slice,
# concatenate, iota, copy and stop_gradient (``getitem`` picks one output
# of a multi-output op; ``scalar_tensor`` is a literal, which a jaxpr
# inlines)
_TRIVIAL_OPS = frozenset({
    "expand", "view", "_unsafe_view", "reshape", "permute", "transpose",
    "t", "_to_copy", "squeeze", "unsqueeze", "slice", "select", "split",
    "unbind", "cat", "arange", "clone", "alias", "detach",
    "lift_fresh_copy", "contiguous", "getitem", "scalar_tensor",
})

# rough per-op seed times (seconds), mirroring the reference's class-based
# constants (test_gpt2.py:33-43); calibration replaces these.  Keyed by
# ATen op name: the matmuls for ``dot_general``, ``convolution`` for
# ``conv_general_dilated``, the softmaxes for JAX's ``custom_jvp_call``
_OP_TIME = {
    "mm": 1e-4,
    "addmm": 1e-4,
    "bmm": 1e-4,
    "baddbmm": 1e-4,
    "convolution": 1e-4,
    "_softmax": 5e-5,
    "_log_softmax": 5e-5,
}
_DEFAULT_TIME = 2e-5


def _op_name(node: torch.fx.Node) -> str:
    """``mm`` for ``aten.mm.default``; the function's name otherwise."""
    packet = getattr(node.target, "overloadpacket", None)
    if packet is not None:
        return packet.__name__
    return getattr(node.target, "__name__", str(node.target))


def _value_bytes(val: Any) -> int:
    """Bytes of a traced value: a tensor, or a tuple/list of them."""
    if isinstance(val, torch.Tensor):
        return val.numel() * val.element_size()
    if isinstance(val, (tuple, list)):
        return sum(_value_bytes(v) for v in val)
    return 0


def trace_to_chain(
    fn: Callable[..., Any],
    *example_args: Any,
    name: str = "traced",
    min_task_bytes: int = 0,
) -> TaskGraph:
    """Trace ``fn(*example_args)`` and build a linear-chain TaskGraph.

    Closed-over tensors (``make_fx``'s ``_tensor_constant*`` attributes)
    become the traced tasks' named params ``{name}_const_{i}``, numbered in
    the order the trace first reads them, with real byte sizes.
    """
    from torch.fx.experimental.proxy_tensor import make_fx

    gm = make_fx(fn)(*example_args)

    tasks = []
    prev: Optional[str] = None
    pending_trivial = 0
    const_names: Dict[str, str] = {}  # attribute -> param name
    const_sizes: Dict[str, int] = {}
    # node -> the const names it (transitively) derives from.  Trivial ops
    # carry origins to their outputs, so a weight consumed only through a
    # transpose/cast/view still charges the downstream task.
    const_origin: Dict[torch.fx.Node, Set[str]] = {}

    def origins_of(node: torch.fx.Node) -> Set[str]:
        out: Set[str] = set()
        for v in node.all_input_nodes:
            out |= const_origin.get(v, set())
        return out

    idx = 0
    for node in gm.graph.nodes:
        if node.op == "get_attr":
            if node.target not in const_names:
                pname = f"{name}_const_{len(const_names)}"
                const_names[node.target] = pname
                value = getattr(gm, node.target)
                const_sizes[pname] = value.numel() * value.element_size()
            const_origin[node] = {const_names[node.target]}
            continue
        if node.op != "call_function":
            continue
        op = _op_name(node)
        out_bytes = _value_bytes(node.meta.get("val"))
        if op in _TRIVIAL_OPS or out_bytes < min_task_bytes:
            pending_trivial += 1
            carried = origins_of(node)
            if carried:
                const_origin[node] = const_origin.get(node, set()) | carried
            idx += 1
            continue
        tid = f"{name}_op{idx}_{op}"
        params = origins_of(node)
        tasks.append(
            Task(
                tid,
                memory_required=out_bytes / GB,
                compute_time=_OP_TIME.get(op, _DEFAULT_TIME)
                * (1 + pending_trivial * 0.1),
                dependencies=[prev] if prev else [],
                params_needed=params,
                param_bytes={p: const_sizes[p] for p in params},
                group=op,
            )
        )
        pending_trivial = 0
        prev = tid
        idx += 1

    return TaskGraph(tasks, name=name).freeze()


__all__ = ["trace_to_chain"]
