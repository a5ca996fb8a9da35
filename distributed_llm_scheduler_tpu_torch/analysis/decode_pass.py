"""Pass 7 — decode-loop composability (DEC0xx).

The scan-loop composers in ``backends/decode_loop.py`` have contracts the
generic passes cannot see: every ``cache_*`` param is a *mutable* buffer
donated through the scan carry, so it must live on exactly one node; the
whole decode step must sit on one node to be scan-eligible at all; and a
paged graph (one with a ``page_table`` param) must wire the indirection
consistently — every layer that reads a pool must read the table, pools
must share one geometry.  Violations surface here as structured
diagnostics instead of mid-``compose_step_fn`` exceptions.

The pass self-detects decode graphs: a graph with no ``cache_*`` params
gets an empty report, so it is safe to run unconditionally.

PyTorch port of ``distributed_llm_scheduler_tpu.analysis.decode_pass``.
DEC001-DEC004 are framework-free and identical.  DEC005 and DEC006 quote
the port's own kernel rules (:func:`..ops.attention.
paged_kernel_constraints` of the Hopper paged kernels), and a CUDA call
whose geometry breaks them raises instead of falling back, so their
messages name that consequence; dtypes are named as numpy names them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Set

from ..core.cluster import Cluster
from ..core.graph import TaskGraph
from ..core.schedule import Schedule
from .diagnostics import AnalysisReport, Severity


def dtype_name(dtype: Any) -> str:
    """A dtype named as numpy names it (``torch.bfloat16`` ->
    ``bfloat16``), the word the JAX package's messages use."""
    return str(dtype).replace("torch.", "")


def _is_cache_param(name: str) -> bool:
    return name.startswith("cache_")


def analyze_decode(
    graph: TaskGraph,
    cluster: Optional[Cluster] = None,
    schedule: Optional[Schedule] = None,
    param_specs: Optional[Dict[str, Any]] = None,
    chunk_tokens: Optional[int] = None,
    decode_budget: Optional[int] = None,
) -> AnalysisReport:
    """Decode-loop composability checks (no-op on non-decode graphs).

    * ``DEC001`` (error, needs ``schedule``): a ``cache_*`` param is
      needed by tasks placed on more than one node — the loop composers
      donate ONE buffer per cache param, so a multi-node alias means two
      devices would own the same mutable state.  (``page_table`` is a
      read-only broadcast input; sharing it across nodes is legal.)
    * ``DEC002`` (warning, needs ``schedule``): the decode step spans
      multiple nodes at all — legal for plain dispatch, but
      ``build_decode_loop`` / ``build_paged_decode_loop`` will reject it
      (scan-loop ineligible).
    * ``DEC003`` (error): inconsistent paged wiring — a task reads pools
      without the page table (or vice versa), or the per-layer pools
      disagree on geometry.
    * ``DEC004`` (info): per-step KV residency payload
      (``data={"kv_bytes": ..., "paged": ...}``).
    * ``DEC005`` (warning, needs ``param_specs``): the paged pool
      geometry (page_size / head_dim / kv-head layout read off the
      ``cache_*`` pool specs) makes the Hopper paged kernels ineligible,
      so every call on a card raises and only ``impl="plain"`` runs the
      graph.  The message names each violated kernel rule.  A warning,
      never a gate: the plain version is correct, just slower.
    * ``DEC006`` (warning, needs ``chunk_tokens``): the configured
      chunked-prefill chunk size is degenerate — either it violates the
      ragged multi-token-q kernel's rules
      (``paged_kernel_constraints(..., q_tokens=chunk_tokens)``), so
      every chunk wave on a card raises, or it exceeds
      ``decode_budget`` (the engine's per-segment decode-token capacity
      ``slots * seg_steps``), so a single chunk monopolizes the
      segment's prefill budget and chunking degenerates to one chunk
      per segment regardless of load.  Like DEC005, a warning and never
      a gate: the engine's output is bitwise-correct either way.
    """
    rep = AnalysisReport()
    tasks = graph.tasks()
    cache_users = [
        t for t in tasks if any(_is_cache_param(p) for p in t.params_needed)
    ]
    if not cache_users:
        return rep
    paged = any("page_table" in t.params_needed for t in tasks)

    # DEC001 / DEC002: placement of the mutable decode state ------------
    if schedule is not None:
        placement: Dict[str, str] = {
            tid: node
            for node, tids in schedule.per_node.items()
            for tid in tids
        }
        param_nodes: Dict[str, Set[str]] = {}
        step_nodes: Set[str] = set()
        for t in tasks:
            node = placement.get(t.task_id)
            if node is None:
                continue
            step_nodes.add(node)
            for p in t.params_needed:
                if _is_cache_param(p):
                    param_nodes.setdefault(p, set()).add(node)
        for p, nodes in sorted(param_nodes.items()):
            if len(nodes) > 1:
                rep.add(
                    "DEC001",
                    Severity.ERROR,
                    f"mutable decode param {p!r} is aliased by tasks on "
                    f"{len(nodes)} nodes ({sorted(nodes)[:4]}): the scan "
                    "carry donates one buffer per cache param",
                    param=p,
                    data={"nodes": sorted(nodes)},
                )
        if len(step_nodes) > 1 and not rep.has("DEC001"):
            rep.add(
                "DEC002",
                Severity.WARNING,
                f"decode step is placed across {len(step_nodes)} nodes "
                f"({sorted(step_nodes)[:4]}): dispatchable, but scan-loop "
                "composition requires single-node placement",
                data={"nodes": sorted(step_nodes)},
            )

    # DEC003: paged wiring consistency ----------------------------------
    if paged:
        for t in tasks:
            has_pool = any(_is_cache_param(p) for p in t.params_needed)
            has_table = "page_table" in t.params_needed
            if has_pool != has_table:
                what = (
                    "reads KV pools without the page_table indirection"
                    if has_pool
                    else "reads page_table without any KV pool"
                )
                rep.add(
                    "DEC003",
                    Severity.ERROR,
                    f"task {t.task_id!r} {what}",
                    task=t.task_id,
                )
        pool_bytes: Dict[str, int] = {}
        for t in tasks:
            for p, nbytes in t.param_bytes.items():
                if _is_cache_param(p):
                    pool_bytes[p] = nbytes
        if len(set(pool_bytes.values())) > 1:
            lo = min(pool_bytes, key=pool_bytes.get)
            hi = max(pool_bytes, key=pool_bytes.get)
            rep.add(
                "DEC003",
                Severity.ERROR,
                "KV page pools disagree on geometry: "
                f"{lo!r} is {pool_bytes[lo]} bytes but {hi!r} is "
                f"{pool_bytes[hi]} bytes (one pool shape per graph)",
                param=hi,
                data={"pool_bytes": dict(sorted(pool_bytes.items()))},
            )

    # DEC005: fused-kernel eligibility of the pool geometry --------------
    pool_spec = None
    if paged and param_specs:
        pool_spec = next(
            (
                param_specs[p]
                for p in sorted(param_specs)
                if _is_cache_param(p) and getattr(param_specs[p], "ndim", 0) == 4
            ),
            None,
        )
        if pool_spec is not None:
            from ..ops.attention import paged_kernel_constraints

            _n_pages, page_size, n_kv, hd = pool_spec.shape
            violated = paged_kernel_constraints(
                page_size, hd, n_kv, dtype=pool_spec.dtype
            )
            if violated:
                rep.add(
                    "DEC005",
                    Severity.WARNING,
                    "paged pool geometry is ineligible for the Hopper "
                    "paged attention kernels (a call on a card raises; "
                    "only impl='plain' runs it): "
                    + "; ".join(violated),
                    data={
                        "page_size": int(page_size),
                        "head_dim": int(hd),
                        "n_kv_heads": int(n_kv),
                        "dtype": dtype_name(pool_spec.dtype),
                        "constraints": list(violated),
                    },
                )

    # DEC006: chunked-prefill chunk-size degeneracy ----------------------
    if paged and chunk_tokens is not None:
        problems = []
        data: Dict[str, Any] = {"chunk_tokens": int(chunk_tokens)}
        if pool_spec is not None:
            from ..ops.attention import paged_kernel_constraints

            _n_pages, page_size, n_kv, hd = pool_spec.shape
            ragged_violated = paged_kernel_constraints(
                page_size, hd, n_kv, dtype=pool_spec.dtype,
                q_tokens=int(chunk_tokens),
            )
            if ragged_violated:
                problems.append(
                    "the ragged multi-token-q kernel is ineligible at "
                    "this chunk size (every chunk wave on a card "
                    "raises): " + "; ".join(ragged_violated)
                )
                data["constraints"] = list(ragged_violated)
        if decode_budget is not None and chunk_tokens > decode_budget:
            problems.append(
                f"chunk_tokens {chunk_tokens} exceeds the per-segment "
                f"decode-token capacity {decode_budget} (slots * "
                "seg_steps): one chunk monopolizes each segment's "
                "prefill budget, so chunked admission degenerates to "
                "one chunk per segment regardless of load"
            )
            data["decode_budget"] = int(decode_budget)
        if problems:
            rep.add(
                "DEC006",
                Severity.WARNING,
                "chunked-prefill chunk size is degenerate: "
                + " AND ".join(problems),
                data=data,
            )

    # DEC004: per-step KV residency payload ------------------------------
    kv_bytes: Dict[str, int] = {}
    for t in tasks:
        for p, nbytes in t.param_bytes.items():
            if _is_cache_param(p):
                kv_bytes[p] = nbytes
    total = sum(kv_bytes.values())
    rep.add(
        "DEC004",
        Severity.INFO,
        f"decode step holds {total / (1 << 20):.1f} MiB of KV cache "
        f"across {len(kv_bytes)} params"
        + (" (paged pools)" if paged else " (dense slabs)"),
        data={
            "kv_bytes": total,
            "n_cache_params": len(kv_bytes),
            "paged": paged,
        },
    )
    return rep
