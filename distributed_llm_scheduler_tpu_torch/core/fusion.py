"""Task fusion: merge linear chains into composite tasks.

PyTorch port of ``distributed_llm_scheduler_tpu.core.fusion``; framework-
free, and it must give the same fused task ids.

The reference's task granularity (8 tasks per transformer layer, reference
``test_gpt2.py:63-147``) is right for *placement* but wasteful for
*dispatch*: every task costs a host-side dispatch (~10-100 µs) plus the
replay's per-edge latency floor, and a LayerNorm task finishes in single-
digit µs.  SURVEY.md §7 ranks this the #1 hard part of the rebuild: fuse
trivial ops into their neighbors so the dispatch count drops without
changing what the scheduler can decide.

:func:`fuse_linear_chains` rewrites a graph by collapsing maximal linear
chains — runs ``a → b → …`` where each link is the only dependent of its
predecessor and the only dependency of its successor, and every member
shares the same ``group`` — into one composite task:

* the fused task keeps the **last** member's id, so downstream dependency
  lists (and any code holding task ids of chain exits) are untouched;
* its ``fn`` composes the member fns with namespaced parameter aliases
  (``t0_…, t1_…``), and composite fns are cached per member-fn tuple so
  structurally identical chains (every layer's ln2→ffn run) share ONE fn
  object;
* compute_time/flops sum; params/bytes union; activation footprint is the
  max member output (intermediates live transiently inside the fused fn).

Placement granularity is preserved where it matters: chains never span
groups, so pipeline stages and parked shard groups see the same group
structure, just fewer tasks inside each.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from .graph import Task, TaskGraph

def _make_fused_fn(member_fns: List[Callable[..., Any]],
                   member_locals: List[List[str]],
                   cache: Dict[Tuple, Callable[..., Any]]) -> Callable[..., Any]:
    """Compose a linear chain of task fns into one fn.

    The fused fn reads params by namespaced local names (``t{i}_{local}``);
    member 0 receives the external inputs, each later member receives its
    predecessor's output (linear chain contract).  ``cache`` is scoped to
    one :func:`fuse_linear_chains` call — member fns are per-build closures,
    so within-graph sharing (every layer's identical chain → one fused fn)
    is all the sharing that exists; a global
    cache would only pin dead graphs' closures.  Fns are identity-hashed;
    locals are part of the key because the same fn tuple can appear with
    different param namings in alias-free graphs.
    """
    key = (tuple(member_fns), tuple(tuple(l) for l in member_locals))
    cached = cache.get(key)
    if cached is not None:
        return cached

    def fused(p, *ext_inputs):
        sub = {loc: p[f"t0_{loc}"] for loc in member_locals[0]}
        x = member_fns[0](sub, *ext_inputs)
        for i in range(1, len(member_fns)):
            sub = {loc: p[f"t{i}_{loc}"] for loc in member_locals[i]}
            x = member_fns[i](sub, x)
        return x

    # a chain of batch-axis-0-polymorphic ops is itself batch-axis-0
    # polymorphic: the composite inherits rebatch eligibility
    from .graph import is_batch0, mark_batch0

    if all(is_batch0(f) for f in member_fns):
        mark_batch0(fused)
    cache[key] = fused
    return fused


def _fuse_chain(members: List[Task],
                fn_cache: Dict[Tuple, Callable[..., Any]]) -> Task:
    """Build the composite task for a maximal chain (>= 2 members)."""
    first, last = members[0], members[-1]
    have_fns = all(t.fn is not None for t in members)

    alias: Dict[str, str] = {}
    param_bytes: Dict[str, int] = {}
    params: set = set()
    member_locals: List[List[str]] = []
    for i, t in enumerate(members):
        locals_i = []
        for loc, glob in t.param_items():
            alias[f"t{i}_{loc}"] = glob
            locals_i.append(loc)
            params.add(glob)
        member_locals.append(locals_i)
        param_bytes.update(t.param_bytes)

    fn = (
        _make_fused_fn([t.fn for t in members], member_locals, fn_cache)
        if have_fns else None
    )
    return Task(
        last.task_id,  # keep the exit id: downstream dep lists unchanged
        memory_required=max(t.memory_required for t in members),
        compute_time=sum(t.compute_time for t in members),
        dependencies=list(first.dependencies),
        params_needed=params,
        param_bytes=param_bytes,
        fn=fn,
        arg_tasks=list(first.arg_tasks or first.dependencies),
        param_alias=alias if fn is not None else None,
        out_shape=last.out_shape,
        flops=sum(t.flops or 0.0 for t in members) or None,
        group=last.group,
    )


def fuse_linear_chains(
    graph: TaskGraph,
    min_chain: int = 2,
    max_chain: Optional[int] = None,
) -> TaskGraph:
    """Return a new graph with maximal same-group linear chains fused.

    Args:
      graph: frozen source graph (unchanged).
      min_chain: only fuse runs of at least this many tasks.
      max_chain: optional cap on members per fused task (None = unlimited).

    The result's name gains a ``_fused`` suffix so measured cost-model
    caches never mix fused and unfused timings.
    """
    graph.freeze()

    def can_extend(a: str, b: str) -> bool:
        """b directly follows a in a linear same-group chain.

        ``b`` must actually CONSUME ``a``'s output as its sole fn input:
        the Task contract allows ``arg_tasks`` to differ from
        ``dependencies`` (control-only edges, reordered inputs), and fusing
        such a task would silently feed the predecessor's output into an fn
        that doesn't want it (ADVICE r1).
        """
        ta, tb = graph[a], graph[b]
        return (
            len(graph.dependents(a)) == 1
            and len(tb.dependencies) == 1
            and tb.dependencies[0] == a
            and (tb.arg_tasks is None or tb.arg_tasks == tb.dependencies)
            and ta.group == tb.group
            and (ta.fn is None) == (tb.fn is None)
        )

    chains: List[List[str]] = []
    in_chain: Dict[str, int] = {}
    for tid in graph.topo_order:
        if tid in in_chain:
            continue
        chain = [tid]
        while True:
            if max_chain is not None and len(chain) >= max_chain:
                break
            deps_out = graph.dependents(chain[-1])
            if len(deps_out) == 1 and can_extend(chain[-1], deps_out[0]):
                chain.append(deps_out[0])
            else:
                break
        chains.append(chain)
        for t in chain:
            in_chain[t] = len(chains) - 1

    tasks: List[Task] = []
    fn_cache: Dict[Tuple, Callable[..., Any]] = {}
    for chain in chains:
        if len(chain) >= min_chain:
            tasks.append(_fuse_chain([graph[t] for t in chain], fn_cache))
        else:
            # every member survives unfused (chains can be shorter than
            # min_chain but still hold interior tasks when min_chain > 2)
            for tid in chain:
                src = graph[tid]
                # shallow re-create: the fused graph owns fresh mutable state
                tasks.append(Task(
                    src.task_id,
                    memory_required=src.memory_required,
                    compute_time=src.compute_time,
                    dependencies=list(src.dependencies),
                    params_needed=set(src.params_needed),
                    param_bytes=dict(src.param_bytes),
                    fn=src.fn,
                    arg_tasks=list(src.arg_tasks) if src.arg_tasks else None,
                    param_alias=dict(src.param_alias) if src.param_alias else None,
                    out_shape=src.out_shape,
                    flops=src.flops,
                    group=src.group,
                ))

    # remap any dependency that points at a fused-away (non-exit) member;
    # only members of chains that actually fused are remapped — sub-min
    # chains keep all their tasks and internal edges
    exit_of: Dict[str, str] = {}
    for chain in chains:
        if len(chain) >= min_chain:
            for t in chain:
                exit_of[t] = chain[-1]
    for t in tasks:
        t.dependencies = [exit_of.get(d, d) for d in t.dependencies]
        if t.arg_tasks is not None:
            t.arg_tasks = [exit_of.get(d, d) for d in t.arg_tasks]

    fused = TaskGraph(tasks, name=f"{graph.name}_fused").freeze()
    if graph.recipe is not None:  # the same fusion of the rebuilt graph
        fused.recipe = (f"{__name__}:fuse_recipe", (graph.recipe,),
                        dict(min_chain=min_chain, max_chain=max_chain))
    return fused


def fuse_recipe(recipe, min_chain: int = 2,
                max_chain: Optional[int] = None) -> TaskGraph:
    """:func:`fuse_linear_chains` of the graph ``recipe`` builds: the
    recipe of a fused graph (``TaskGraph.recipe``)."""
    from .graph import from_recipe

    return fuse_linear_chains(from_recipe(recipe), min_chain, max_chain)
