"""Multi-step decode over a scheduled decode-step DAG: the dense K-step
loop and continuous-batching paged serving.

PyTorch port of ``distributed_llm_scheduler_tpu.backends.decode_loop``.
A placed decode-step DAG is composed, in the schedule's order, into one
step function.  Dense (``frontend/decode_dag.build_decode_dag_any``, all
three families): :func:`compose_step_fn` and :func:`build_decode_loop`,
which iterates it K times per call with each layer's new K/V rows written
into its cache slab in place.  Paged (``build_paged_decode_dag``):
:func:`compose_paged_step_fn`, ``build_paged_decode_loop`` and
:class:`PagedDecodeEngine`, which admits and retires variable-length
requests between segments.

Where JAX jits one ``lax.scan`` program per call with the caches donated,
here each loop is one CUDA graph on a card, captured at its first call and
replayed after (``backends.device.CapturedProgram``): the dense K-step loop
per (batch, K) and the caches it is given, the paged segment once per
engine.  The caches and pools are the graphs' fixed inputs, read and
written in place at the addresses they were captured with; the steps run
on device tensors (argmax on the device, the position a device scalar,
tokens stacked on the device, no host read inside the loop), and the
caller's one device-to-host copy is the tokens.  On the CPU (and on meta
tensors) the same bodies run eagerly.  A capture or replay error raises:
nothing falls back to eager execution; ``capture=False`` asks for the
eager loop on a card.

Single-node placements only, as in the JAX package: a multi-node
placement needs per-step host-mediated transfers, which is the per-task
dispatch path (``DeviceBackend.execute``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.graph import TaskGraph
from ..core.schedule import Schedule
from ..frontend.decode_dag import apply_cache_updates, cache_dims, decode_inputs


def _placed_order(graph: TaskGraph, schedule: Schedule) -> list:
    """Schedule assignment order, single-node-validated and re-linearized
    topologically."""
    placement = schedule.placement
    nodes = {placement[tid] for tid in placement}
    if len(nodes) > 1:
        raise ValueError(
            f"decode loop requires a single-node placement, got {len(nodes)} "
            "nodes — multi-node decode steps go through per-task dispatch "
            "(DeviceBackend.execute)"
        )
    topo_pos = {tid: i for i, tid in enumerate(graph.topo_order)}
    order = sorted(
        (tid for tid in schedule.assignment_order if tid in placement),
        key=topo_pos.__getitem__,
    )
    missing = set(graph.task_ids()) - set(order)
    if missing:
        raise ValueError(f"placement does not cover tasks {sorted(missing)}")
    sinks = [tid for tid in order if not graph.dependents(tid)]
    if len(sinks) != 1:
        raise ValueError(f"expected one sink (logits) task, got {sinks}")
    return order


def _run_tasks(graph: TaskGraph, order: list, inputs: Dict[str, Any],
               param_of: Callable[[str], Any]) -> Dict[str, Any]:
    """Run the placed tasks in ``order``, params resolved through each
    task's alias table by ``param_of(global_name)``; every task's output."""
    outs: Dict[str, Any] = {}
    for tid in order:
        task = graph[tid]
        p = {loc: param_of(glob)
             for loc, glob in (task.param_alias or {}).items()}
        if task.dependencies:
            args = [outs[d] for d in (task.arg_tasks or task.dependencies)]
        else:
            args = [inputs]
        outs[tid] = task.fn(p, *args)
    return outs


def compose_step_fn(
    graph: TaskGraph,
    schedule: Schedule,
    config: Any,
) -> Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """Compose the placed dense decode-step DAG into one step function.

    Tasks run in the schedule's order (re-linearized topologically), params
    resolve through each task's alias table, and after the tasks
    :func:`apply_cache_updates` writes each layer's ``k_new``/``v_new``
    into its cache slab at ``pos``, in place, as after a placed run.

    Returns ``step(weights, caches, ids, pos) -> (logits, caches)``, with
    ``pos`` a 0-d int32 tensor on the card (or an int)."""
    order = _placed_order(graph, schedule)
    sink = [tid for tid in order if not graph.dependents(tid)][0]

    def step(weights, caches, ids, pos):
        outs = _run_tasks(
            graph, order, decode_inputs(ids, pos),
            lambda glob: caches[glob] if glob in caches else weights[glob])
        apply_cache_updates(caches, outs, config, pos)
        return outs[sink], caches

    return step


# captured K-step programs one dense loop keeps, least recently used first
LOOP_PROGRAMS = 2


def build_decode_loop(
    graph: TaskGraph,
    schedule: Schedule,
    config: Any,
    steps: int,
    capture: bool = True,
) -> Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """Greedily decode ``steps`` tokens through the scheduled step DAG.

    ``run(weights, caches, ids, pos) -> (tokens, caches)``: ``ids`` the
    (B, 1) current token, ``pos`` its cache position (an int or a 0-d
    tensor), ``tokens`` the (B, steps) int32 greedy continuation on the
    device, ``caches`` the same slabs, written in place.  The caller
    chains calls by feeding ``tokens[:, -1:]`` and ``pos + steps`` back
    in.  Greedy argmax runs on the logits' own dtype, as the whole-model
    generation's.

    On a card the K steps are one CUDA graph, captured at the first call
    for a batch size, the weights' addresses and the ``caches`` dict (the
    graph's fixed input, read and written in place; the run keeps the
    last ``LOOP_PROGRAMS`` such graphs) and replayed with ``ids`` and
    ``pos`` copied in; ``tokens`` is a copy of the graph's output.  The
    first call runs the loop eagerly once (the warm-up) and then replays
    it: the replay rewrites the same rows, so its tokens are the warm-up's.
    ``capture=False`` runs the loop eagerly on a card too."""
    from .device import CapturedProgram, address_key, capture_stream

    step = compose_step_fn(graph, schedule, config)

    def body(weights, ext):
        ids, pos, caches = ext["ids"], ext["pos"], ext["caches"]
        toks = []
        for _ in range(steps):
            logits, caches = step(weights, caches, ids, pos)
            ids = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
            toks.append(ids[:, 0])
            pos = pos + 1
        return torch.stack(toks, dim=1)

    programs: Dict[tuple, Any] = {}

    @torch.no_grad()
    def run(weights, caches, ids, pos):
        ids = ids.to(torch.int32)
        if not isinstance(pos, torch.Tensor):
            pos = torch.full((), int(pos), dtype=torch.int32, device=ids.device)
        ext = {"ids": ids, "pos": pos, "caches": caches}
        if ids.device.type != "cuda" or not capture:
            return body(weights, ext), caches
        key = (tuple(ids.shape), ids.device, address_key(weights), id(caches))
        prog = programs.pop(key, None) or CapturedProgram(
            body, stream=capture_stream(ids.device))
        programs[key] = prog  # the most recent last
        while len(programs) > LOOP_PROGRAMS:
            programs.pop(next(iter(programs)))
        toks = prog(weights, ext, fixed=frozenset({"caches"}))
        return toks.clone(), caches

    return run


def split_cache_params(
    params: Dict[str, Any],
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(weights, caches) views of a decode-DAG param dict."""
    weights = {k: v for k, v in params.items() if not k.startswith("cache_")}
    caches = {k: v for k, v in params.items() if k.startswith("cache_")}
    return weights, caches


def compose_paged_step_fn(
    graph: TaskGraph,
    schedule: Schedule,
    config: Any,
) -> Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """Compose the placed paged decode-step DAG into one step function.

    Tasks run in the schedule's order with params resolved through each
    task's alias table.  After the tasks, each layer's ``k_new``/``v_new``
    is written into its pools at each slot's length, in place, gated by
    ``active``: inactive slots write the trash page.  This is
    :func:`...models.kv_pages.write_token_kv` per pool, with the rows
    it writes to (:func:`...models.kv_pages.token_slots`) computed once
    per step rather than once per pool.

    Returns ``step(weights, pools, page_table, ids, lengths, active) ->
    (logits, pools)``."""
    from ..models.kv_pages import token_slots

    order = _placed_order(graph, schedule)
    sink = [tid for tid in order if not graph.dependents(tid)][0]
    n_layers, _, _ = cache_dims(config)

    def step(weights, pools, page_table, ids, lengths, active):
        def param_of(glob):
            if glob == "page_table":
                return page_table
            return pools[glob] if glob in pools else weights[glob]

        outs = _run_tasks(graph, order, {"ids": ids, "lengths": lengths},
                          param_of)
        pid, slot = token_slots(
            page_table, lengths, active, pools["cache_k_0"].shape[1])
        for i in range(n_layers):
            o = outs[f"layer_{i}"]
            for kind in ("k", "v"):
                pool = pools[f"cache_{kind}_{i}"]
                pool[pid, slot] = o[f"{kind}_new"][:, :, 0, :].to(pool.dtype)
        return outs[sink], pools

    return step


def build_paged_decode_loop(
    graph: TaskGraph,
    schedule: Schedule,
    config: Any,
    steps: int,
    weights: Optional[Dict[str, Any]] = None,
) -> Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """One K-step greedy segment over the scheduled paged step DAG.

    ``seg(weights, pools, page_table, lengths, cur_tok, remaining) ->
    (tokens, pools)``: device tensors in, ``tokens`` the (S, steps) int32
    greedy continuation on the device (rows past a slot's ``remaining``
    are garbage — the caller truncates).  A slot is active exactly while
    ``remaining > 0``; its length stops advancing and its pool writes go
    to the trash page the step after it finishes.  Greedy argmax runs on
    the logits' own dtype.  With ``weights`` given they are bound and the
    callable drops its leading ``weights`` argument."""
    step = compose_paged_step_fn(graph, schedule, config)

    @torch.no_grad()
    def seg(weights, pools, page_table, lengths, cur_tok, remaining):
        toks = []
        for _ in range(steps):
            active = remaining > 0
            logits, pools = step(
                weights, pools, page_table, cur_tok, lengths, active
            )
            nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
            cur_tok = torch.where(active[:, None], nxt, cur_tok)
            lengths = lengths + active.to(torch.int32)
            remaining = (remaining - 1).clamp(min=0)
            toks.append(nxt[:, 0])
        return torch.stack(toks, dim=1), pools

    if weights is not None:
        w = weights
        return lambda pools, page_table, lengths, cur_tok, remaining: seg(
            w, pools, page_table, lengths, cur_tok, remaining
        )
    return seg


class PagedDecodeEngine:
    """Continuous-batching paged decode: admit and retire variable-length
    requests between K-step segments.

    ``slots`` static batch lanes share one paged KV pool; a host-side
    :class:`...models.kv_pages.PagePool` hands each admitted request the
    pages its ``prompt + max_new`` horizon needs (exhaustion leaves
    requests queued — backpressure, not corruption); retirement returns
    them.  Slot bookkeeping (``lengths``, ``cur_tok``, ``remaining``,
    ``page_table``) stays host numpy and is copied to the card once per
    segment; only the pools live on the device.

    As in the JAX package: prompts longer than ``chunk_tokens`` prefill
    one chunk per segment beside the decode (chunked prefill); a pool
    built with ``sharing=True`` aliases resident full prefix pages
    (prefix sharing, copy-on-write before a write into an aliased page);
    ``preempt`` evicts an in-flight request and hands back its generated
    prefix; ``begin_drain``/``end_drain`` close and reopen submission;
    every request's lifecycle goes to ``reqlog`` (:class:`...obs.reqlog.
    RequestLog`) and, when one is attached, every page event to a
    :class:`...models.kv_pages.PageOwnershipLog`.

    Observability, as in the JAX package: ``tracer`` (explicit, or the
    ambient one under ``DLS_TRACE``) records the engine's segment, wave,
    prefill and chunk spans and its queue, pool and compile-class
    counters on the ``decode`` track; ``flight`` (explicit, or ambient
    under ``DLS_FLIGHT``) tees its ring into that stream; a tracer brings a
    :class:`...obs.reqtrace.RequestTraceRecorder` (``reqtrace``) with it;
    ``memprof`` folds each request's KV pages onto a memory timeline.
    Every record is behind a ``None`` check, so a bare engine does no
    observability work.  Construct via ``DeviceBackend.paged_decode_engine``.
    """

    def __init__(
        self,
        graph: TaskGraph,
        schedule: Schedule,
        config: Any,
        weights: Dict[str, Any],
        pool: Any,
        slots: int,
        pages_per_seq: int,
        seg_steps: int = 8,
        tracer: Any = None,
        metrics: Any = None,
        clock: Any = None,
        memprof: Any = None,
        flight: Any = None,
        attention_impl: Optional[str] = None,
        chunk_tokens: Optional[int] = None,
        device: Any = None,
        capture: bool = True,
    ):
        self.config = config
        self.device = torch.device(
            device if device is not None else next(iter(weights.values())).device
        )
        self.weights = {k: v.to(self.device) for k, v in weights.items()}
        self.pool = pool
        self.slots = slots
        self.pages_per_seq = pages_per_seq
        # the impl the graph's layer tasks were built with: they, not the
        # engine, choose the attention path; the engine reports it.  A
        # caller's impl that names another path is refused, not relabelled
        self.attention_impl = getattr(graph, "attention_impl", None)
        if attention_impl is not None and (
                attention_impl or "auto") != (self.attention_impl or "auto"):
            raise ValueError(
                f"attention_impl {attention_impl!r} differs from the graph's "
                f"{self.attention_impl!r}, whose layer tasks choose the path: "
                f"build the graph with it")
        self.page_size = pool.page_size
        self.capacity = pages_per_seq * pool.page_size
        self.seg_steps = seg_steps
        # chunked prefill: prompts longer than this admit in fixed-token
        # chunks co-scheduled with decode segments; None keeps whole-prompt
        # admission.  Mutable: the serve bench toggles it between legs
        if chunk_tokens is not None and chunk_tokens < 1:
            raise ValueError(f"chunk_tokens must be >= 1, got {chunk_tokens}")
        self.chunk_tokens = chunk_tokens
        # called with the real token count right before every prefill
        # (whole wave, stitched tail or chunk), so a virtual-clock frontend
        # can charge prefill time by tokens
        self.prefill_time_charge: Optional[Callable[[int], None]] = None
        n_layers, n_kv, hd = cache_dims(config)
        self.n_layers = n_layers
        self._seg = build_paged_decode_loop(
            graph, schedule, config, seg_steps, weights=self.weights
        )
        # the segment's CUDA graph (made at the first segment on a card,
        # kept across reset(), as the JAX package keeps its jitted
        # programs), its pools the graph's fixed input; capture=False runs
        # the segment eagerly on a card too
        self.capture = capture
        self._captured_seg = None
        self.pools = None
        self._new_state()
        # bytes of one physical page over every pool: page_size rows x
        # (Hkv, hd) x k+v x n_layers, the memory profiler's kv page size
        self._page_bytes = (
            n_layers * 2 * pool.page_size * n_kv * hd
            * torch.empty((), dtype=config.dtype).element_size()
        )
        # the pools are one placed slab: kv pages count on the node the
        # schedule put the decode step on
        self._mem_node = next(iter(schedule.placement.values()), "node0")
        self.ownlog = None
        self._wire_obs(clock, tracer, metrics, flight, memprof)
        self.reqlog = None
        self._new_log()

    def _wire_obs(self, clock, tracer, metrics, flight, memprof) -> None:
        """Bind the observability surfaces (the JAX package's order):
        the tracer (or the ambient one), the registry (explicit, ambient or
        a fresh one: it always exists, so a run can snapshot TTFT/TPOT and
        occupancy unconditionally), the clock, the flight recorder (its
        ring tracer joins the span stream, alone or teed beside the
        tracer), the request waterfalls (they ride the tracer), and the
        memory profiler (explicit only)."""
        from ..obs import (
            MetricsRegistry,
            RequestTraceRecorder,
            TeeTracer,
            ambient_flight,
            ambient_metrics,
            ambient_tracer,
            resolve_clock,
        )

        self.tracer = tracer if tracer is not None else ambient_tracer()
        self.metrics = (
            metrics if metrics is not None
            else (ambient_metrics() or MetricsRegistry())
        )
        self._clock = resolve_clock(clock)
        self.flight = flight if flight is not None else ambient_flight()
        if self.flight is not None:
            if self.tracer is None:
                self.tracer = self.flight.tracer
            else:
                self.tracer = TeeTracer(self.tracer, self.flight.tracer)
        self.reqtrace = (
            RequestTraceRecorder(self.tracer)
            if self.tracer is not None else None
        )
        self.memprof = memprof

    def _new_log(self) -> None:
        """A fresh request lifecycle log (timestamps are the same clock
        reads the ttft/tpot histograms observe), its sinks (the flight
        ring's log too, which survives across runs) and a fresh waterfall
        recorder state."""
        from ..obs import RequestLog

        self.reqlog = RequestLog(clock=self._clock)
        self._reqlogs = (
            (self.reqlog, self.flight.reqlog) if self.flight is not None
            else (self.reqlog,)
        )
        if self.reqtrace is not None:
            self.reqtrace.reset()

    def _new_state(self) -> None:
        """Zeroed pools and empty slot, queue and request state.  The pools
        are allocated once and zeroed in place after, so the captured
        segment reads them where it was captured."""
        from ..models.kv_pages import TRASH_PAGE, init_paged_kv

        if self.pools is None:
            _, n_kv, hd = cache_dims(self.config)
            self.pools = init_paged_kv(
                self.n_layers, self.pool.n_pages, self.pool.page_size, n_kv,
                hd, self.config.dtype, self.device,
            )
        else:
            for p in self.pools.values():
                p.zero_()
        self.page_table = np.full(
            (self.slots, self.pages_per_seq), TRASH_PAGE, np.int32
        )
        self.lengths = np.zeros((self.slots,), np.int32)
        self.cur_tok = np.zeros((self.slots, 1), np.int32)
        self.remaining = np.zeros((self.slots,), np.int32)
        self._queue: list = []
        # the per-run seen-set of prefill compile classes, keyed as the JAX
        # package keys its jitted prefills ((P, b, impl), ("shared", P, h,
        # b, impl), ("chunk", chunk_tokens, 1, impl)): eager kernels need
        # no build per class, but the soak's compile-class series
        # (``jit.prefill_entries``, HLT003) counts exactly these
        self._prefill_cache: Dict[Any, Any] = {}
        self._slot_req: list = [None] * self.slots  # request id per busy slot
        self._slot_pages: list = [[] for _ in range(self.slots)]
        self._tokens: Dict[Any, list] = {}
        self.results: Dict[Any, Any] = {}
        self.segments_run = 0
        self._submit_t: Dict[Any, float] = {}     # rid -> submit() time
        self._first_tok_t: Dict[Any, float] = {}  # rid -> first-token time
        # slot -> {rid, ids (np (1, P)), P, max_new, next}: a slot mid
        # chunked prefill is occupied but decodes nothing (remaining == 0
        # sends its segment writes to the trash page) until its last chunk
        self._chunk_state: Dict[int, Dict[str, Any]] = {}
        self._chunk_rr = 0
        # while set, submit() refuses new work; queued and in-flight
        # requests run to completion
        self._draining = False

    def attach_ownership_log(self, log: Any) -> None:
        """Wire (or, with ``None``, unwire) the page-ownership event seam
        (:class:`...models.kv_pages.PageOwnershipLog`): the engine records
        the owner-attributed ``assign``/``release``/``cow``/``write``
        events, the pool itself the ``alloc``/``free`` (and sharing)
        events.  A fault injector wrapping the pool keeps it as
        ``_inner``; the recorder goes on the inner pool."""
        self.ownlog = log
        pool = getattr(self.pool, "_inner", None) or self.pool
        pool.ownlog = log
        if log is not None and getattr(log, "n_pages", None) is None:
            log.n_pages = pool.n_pages

    def reset(self, fresh_metrics: bool = False) -> None:
        """Fresh pool/table/queue state and a fresh request log; the
        engine's weights and step composition are kept, so a warmed
        engine re-times a workload.  ``fresh_metrics`` also starts a new
        registry, so the next run's histograms and counters are its
        own."""
        from ..obs import MetricsRegistry

        for s, pages in enumerate(self._slot_pages):
            if pages:
                self._release_pages(pages, str(self._slot_req[s]), "reset")
                if self.memprof is not None:
                    self.memprof.free(
                        self._mem_node, f"kv:{self._slot_req[s]}")
        # the KV arrays are zeroed: a retained prefix intern entry would
        # point at zeroed pages, and a warm cache would make same-seed
        # repeat runs diverge (a fault-injecting wrapper may lack it)
        drop = getattr(self.pool, "drop_cached", None)
        if drop is not None:
            drop()
        self._new_state()
        self._new_log()
        if fresh_metrics:
            self.metrics = MetricsRegistry()

    def rebind_obs(
        self,
        *,
        clock: Any = None,
        tracer: Any = None,
        metrics: Any = None,
        flight: Any = None,
        memprof: Any = None,
        ownlog: Any = None,
    ) -> None:
        """Re-wire the observability surfaces and wipe run state, keeping
        the weights and the step composition: one engine serves many
        independent legs, each with its own clock, tracer, metrics, flight
        recorder, memory profiler and ownership log, indistinguishable
        from a fresh build.  A wrapped pool (a fault injector) is replaced
        by a pristine :class:`...models.kv_pages.PagePool` of the same
        geometry, and an instance-level ``step_segment`` override is
        dropped."""
        from ..models.kv_pages import PagePool

        self._wire_obs(clock, tracer, metrics, flight, memprof)
        # drop the slot pages before the pool swap: a wrapped pool must not
        # receive the stale pages reset() would free
        self._slot_pages = [[] for _ in range(self.slots)]
        self.pool = PagePool(
            n_pages=self.pool.n_pages, page_size=self.pool.page_size,
            sharing=bool(getattr(self.pool, "sharing", False)),
        )
        self.attach_ownership_log(ownlog)
        # the hook belongs to the leg that set it
        self.prefill_time_charge = None
        self.__dict__.pop("step_segment", None)
        self.reset()

    # -- prefix sharing ------------------------------------------------------
    @property
    def sharing(self) -> bool:
        """Whether the pool interns prefix chunks (read off the pool)."""
        return bool(getattr(self.pool, "sharing", False))

    def _release_pages(self, pages, owner: str, site: str) -> None:
        """The one page-release path of retire, preempt and reset: records
        the owner-attributed ``release`` (with live refcounts when
        sharing), then drops the reference — the last release frees the
        page, earlier ones only decrement."""
        if self.sharing:
            if self.ownlog is not None:
                self.ownlog.record(
                    "release", pages, owner=owner, site=site,
                    refcounts=[self.pool.refcount(p) for p in pages],
                )
            self.pool.release_ref(pages)
        else:
            if self.ownlog is not None:
                self.ownlog.record("release", pages, owner=owner, site=site)
            self.pool.free(pages)

    def fresh_pages_needed(self, prompt_ids: Any, max_new_tokens: int) -> int:
        """Pages a request would newly allocate if admitted now: its
        ``prompt + max_new`` footprint less its resident shared prefix
        pages (plus one free-list page per matched page that is cached-free
        and must be revived).  Without sharing, ``pages_needed``."""
        from ..models.kv_pages import pages_needed, prefix_chunk_keys

        P = int(prompt_ids.shape[1])
        need = pages_needed(P + max_new_tokens, self.page_size)
        if not self.sharing:
            return need
        h_max = (P - 1) // self.page_size
        keys = prefix_chunk_keys(prompt_ids, self.page_size)[:h_max]
        h, spages = self.pool.match_prefix(keys)
        is_cached = getattr(self.pool, "is_cached", None)
        revive = (sum(1 for p in spages if is_cached(p))
                  if is_cached is not None else 0)
        return need - h + revive

    def chunk_eligible(self, prompt_len: int) -> bool:
        """Whether a prompt admits chunked: chunking is on, the prompt is
        longer than one chunk, and the padded chunk grid fits the per-slot
        capacity (otherwise it takes whole-prompt admission)."""
        ct = self.chunk_tokens
        if ct is None or prompt_len <= ct:
            return False
        return -(-prompt_len // ct) * ct <= self.capacity

    def admission_pages_needed(self, prompt_ids: Any, max_new_tokens: int) -> int:
        """Free-list pages admission must find for this request now: the
        first chunk's only when it admits chunked (later chunks allocate
        per segment), the fresh-tail footprint otherwise."""
        from ..models.kv_pages import pages_needed

        P = int(prompt_ids.shape[1])
        if self.chunk_eligible(P):
            return pages_needed(min(self.chunk_tokens, P), self.page_size)
        return self.fresh_pages_needed(prompt_ids, max_new_tokens)

    def is_prefilling(self, rid: Any) -> bool:
        """Whether ``rid`` holds a slot mid chunked prefill (not
        preemptible: it has no first token, so no resumable prefix)."""
        return any(st["rid"] == rid for st in self._chunk_state.values())

    def _ensure_exclusive(self) -> None:
        """Copy-on-write before a segment: a page the coming writes would
        land in while other requests still alias it is split — a fresh
        page is allocated, the content copied on the device, and the
        shared reference released (alloc before release).  The admission
        rule keeps generation in exclusive tail pages, so this runs only
        when a test forces an alias onto a write page."""
        if not self.sharing:
            return
        for s in range(self.slots):
            if self._slot_req[s] is None or self.remaining[s] <= 0:
                continue
            lo = int(self.lengths[s])
            hi = lo + min(int(self.remaining[s]), self.seg_steps)
            for li in range(lo // self.page_size, (hi - 1) // self.page_size + 1):
                src = int(self.page_table[s, li])
                if self.pool.refcount(src) <= 1:
                    continue
                t_c0 = (self._clock()
                        if self.reqtrace is not None else None)
                dst = self.pool.alloc(1)[0]
                rid = str(self._slot_req[s])
                if self.ownlog is not None:
                    self.ownlog.record(
                        "cow", [src, dst], owner=rid, site="cow",
                        refcounts=[self.pool.refcount(src),
                                   self.pool.refcount(dst)],
                    )
                for pool in self.pools.values():
                    pool[dst] = pool[src]
                self.page_table[s, li] = dst
                pages = self._slot_pages[s]
                pages[pages.index(src)] = dst
                self.pool.release_ref([src])
                if self.ownlog is not None:
                    self.ownlog.record(
                        "write", [dst], owner=rid, site="cow",
                        refcounts=[self.pool.refcount(dst)],
                    )
                self.metrics.counter("decode.cow_splits").inc()
                if self.reqtrace is not None:
                    self.reqtrace.cow(rid, t_c0, self._clock(),
                                      src=src, dst=dst)

    # -- drain ---------------------------------------------------------------
    @property
    def draining(self) -> bool:
        """True while the engine refuses new submissions."""
        return self._draining

    def begin_drain(self) -> None:
        """Stop accepting new work: ``submit()`` raises until the drain
        ends.  Queued and in-flight requests keep running to completion,
        so a draining engine empties itself.  Idempotent."""
        if not self._draining:
            self._draining = True
            self.metrics.counter("decode.drains_begun").inc()
            if self.tracer is not None:
                self.tracer.instant(
                    "drain_begin", track="decode", cat="decode",
                    t=self._clock(),
                )

    def end_drain(self) -> None:
        """Reopen submission (``reset()`` and ``rebind_obs()`` also clear
        the drain)."""
        self._draining = False

    # -- pool headroom -------------------------------------------------------
    @property
    def free_slots(self) -> int:
        """Batch lanes currently unoccupied."""
        return sum(1 for r in self._slot_req if r is None)

    def page_occupancy(self) -> Dict[str, Any]:
        """Pool headroom: free/used totals plus per-request page counts;
        with sharing, the logical-vs-physical books and each request's
        exclusive pages too."""
        per_request = {
            str(self._slot_req[s]): len(self._slot_pages[s])
            for s in range(self.slots)
            if self._slot_req[s] is not None
        }
        occ = {
            "n_pages": self.pool.n_pages - 1,  # page 0 is the trash page
            "free_pages": self.pool.free_pages,
            "used_pages": self.pool.used_pages,
            "per_request": per_request,
        }
        if self.sharing:
            occ["logical_pages"] = self.pool.logical_pages
            occ["shared_pages"] = self.pool.shared_pages
            occ["per_request_exclusive"] = {
                str(self._slot_req[s]): sum(
                    1 for p in self._slot_pages[s] if self.pool.refcount(p) == 1
                )
                for s in range(self.slots)
                if self._slot_req[s] is not None
            }
        return occ

    def _emit_pool_occupancy(self) -> None:
        """Pool occupancy to the gauge and, when tracing, the counter
        track: one value for both."""
        used = self.pool.used_pages
        self.metrics.gauge(
            "decode.page_pool_occupancy_pages", unit="pages"
        ).set(used)
        if self.tracer is not None:
            self.tracer.counter("decode.page_pool_occupancy_pages", used)

    def _emit_queue_depth(self) -> None:
        depth = len(self._queue)
        self.metrics.gauge("decode.queue_depth").set(depth)
        if self.tracer is not None:
            self.tracer.counter("decode.queue_depth", depth)

    def _emit_jit_cache_size(self) -> None:
        """The compile-class seen-set's size per segment: the soak's
        recompile-churn series, flat once warm-up has met every class."""
        entries = len(self._prefill_cache)
        self.metrics.gauge(
            "decode.jit_cache_entries", unit="entries"
        ).set(entries)
        if self.tracer is not None:
            self.tracer.counter("decode.jit_cache_entries", entries)

    def summary(self) -> Dict[str, Any]:
        """Engine-state snapshot at this segment boundary."""
        out = {
            "slots": self.slots,
            "free_slots": self.free_slots,
            "queued": len(self._queue),
            "in_flight": self.slots - self.free_slots,
            "completed": len(self.results),
            "segments_run": self.segments_run,
            "attention_impl": self.attention_impl or "auto",
            "page_occupancy": self.page_occupancy(),
        }
        if self.sharing:
            out["prefix_sharing"] = True
        if self.chunk_tokens is not None:
            out["chunk_tokens"] = self.chunk_tokens
            out["prefilling"] = len(self._chunk_state)
        if self._draining:
            out["draining"] = True
        return out

    # -- request intake ------------------------------------------------------
    def submit(self, rid: Any, prompt_ids: Any, max_new_tokens: int) -> None:
        """Queue a request; it is admitted into a free slot (and its pages
        allocated) at the next segment boundary.  Request ids must be
        unique for the life of the engine state: a preempted rid is spent
        too (the serving layer re-queues under a derived rid)."""
        if self._draining:
            raise RuntimeError(
                f"engine is draining: rejecting submit of rid {rid!r}")
        if rid in self.results:
            raise ValueError(f"duplicate rid {rid!r}: already retired")
        if rid in self._tokens:
            raise ValueError(f"duplicate rid {rid!r}: already in flight")
        if any(q[0] == rid for q in self._queue):
            raise ValueError(f"duplicate rid {rid!r}: already queued")
        if self.reqlog.get(rid) is not None:
            raise ValueError(
                f"duplicate rid {rid!r}: already has a lifecycle record")
        if isinstance(prompt_ids, torch.Tensor):
            prompt_ids = prompt_ids.cpu().numpy()
        prompt_ids = np.asarray(prompt_ids, dtype=np.int32)
        if prompt_ids.ndim != 2 or prompt_ids.shape[0] != 1:
            raise ValueError("prompt_ids must be (1, prompt_len)")
        total = prompt_ids.shape[1] + max_new_tokens
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if total > self.capacity:
            raise ValueError(
                f"request needs {total} rows > per-slot capacity "
                f"{self.capacity} ({self.pages_per_seq} pages x "
                f"{self.page_size})"
            )
        self._queue.append((rid, prompt_ids, max_new_tokens))
        t_sub = self._clock()
        self._submit_t[rid] = t_sub
        for rl in self._reqlogs:
            rl.submit(rid, int(prompt_ids.shape[1]), max_new_tokens, t_sub)
        if self.reqtrace is not None:
            # idempotent: a serving frontend may have registered the rid
            # at its arrival already; a resume rid joins the first pass's
            # track
            self.reqtrace.submit(
                rid, t_sub, prompt_len=int(prompt_ids.shape[1]),
                max_new_tokens=max_new_tokens,
            )
        self.metrics.counter("decode.requests_submitted").inc()
        self._emit_queue_depth()

    # -- prefill + page scatter ----------------------------------------------
    def _dense_cache(self, b: int):
        from ..models import decode as _decode

        _, n_kv, hd = cache_dims(self.config)
        return _decode.init_cache(
            self.n_layers, b, n_kv, self.capacity, hd, self.config.dtype,
            self.device,
        )

    def _gather(self, cache, pages: np.ndarray, rows: int) -> None:
        """Copy pages ``pages`` (b, n) of every layer's pools into the
        dense cache's first ``rows`` = n * page_size positions."""
        b = pages.shape[0]
        _, n_kv, hd = cache_dims(self.config)
        flat = torch.from_numpy(pages.reshape(-1).astype(np.int64)).to(self.device)
        for i in range(self.n_layers):
            for kind in ("k", "v"):
                got = self.pools[f"cache_{kind}_{i}"].index_select(0, flat)
                got = got.reshape(b, rows, n_kv, hd).transpose(1, 2)
                cache[kind][i, :, :, :rows] = got.to(cache[kind].dtype)

    def _scatter(self, cache, pt_rows: np.ndarray) -> None:
        """Write every row of the dense cache into the pages of
        ``pt_rows`` (b, pages_per_seq); trash entries all write page 0,
        which is harmless by design."""
        b = pt_rows.shape[0]
        _, n_kv, hd = cache_dims(self.config)
        flat = torch.from_numpy(pt_rows.reshape(-1).astype(np.int64)).to(
            self.device)
        ppseq, ps = self.pages_per_seq, self.page_size
        for i in range(self.n_layers):
            for kind in ("k", "v"):
                # (b, cap, Hkv, hd), page-chunked
                rows = cache[kind][i].transpose(1, 2)
                paged = rows.reshape(b * ppseq, ps, n_kv, hd)
                pool = self.pools[f"cache_{kind}_{i}"]
                pool.index_copy_(0, flat, paged.to(pool.dtype))

    @torch.no_grad()
    def _prefill_scatter(self, prompt_ids: np.ndarray, pt_rows: np.ndarray):
        """Prefill ``b`` same-length prompts over a dense cache of
        ``capacity`` rows and write all their cache rows into their pages.

        ``prompt_ids`` (b, P); ``pt_rows`` (b, pages_per_seq) physical page
        rows (trash-padded tails).  Returns the (b,) first greedy tokens on
        the device."""
        from ..models import gpt2

        b, P = prompt_ids.shape
        self._prefill_cache.setdefault((P, b, self.attention_impl))
        cache = self._dense_cache(b)
        ids = torch.from_numpy(prompt_ids).to(self.device)
        if self.prefill_time_charge is not None:
            self.prefill_time_charge(b * P)
        logits, cache = gpt2.forward_cached(self.weights, ids, cache, 0, self.config)
        first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        self._scatter(cache, pt_rows)
        return first

    @torch.no_grad()
    def _prefill_scatter_shared(self, prompt_ids: np.ndarray, h: int,
                                shared_rows: np.ndarray, wt_rows: np.ndarray):
        """Stitched prefill for a wave whose first ``h`` prefix pages are
        resident: gather the shared pages into the dense cache, run the
        model over only the tail ``[h * page_size, P)`` at ``pos_start =
        h * page_size``, and scatter through the write table ``wt_rows``
        (shared entries diverted to the trash page, so aliased content is
        never rewritten).  ``cached_attention`` masks cache columns past
        the write cursor, and resident rows are what a full prefill writes
        (a position's K/V depend only on the tokens up to it), so the
        first token and every page match the unshared run.

        ``prompt_ids`` (b, P) full prompts; ``shared_rows`` (b, h) the
        resident prefix pages.  Returns the (b,) first tokens."""
        from ..models import gpt2

        b, P = prompt_ids.shape
        self._prefill_cache.setdefault(
            ("shared", P, int(h), b, self.attention_impl))
        pre = int(h) * self.page_size
        cache = self._dense_cache(b)
        self._gather(cache, shared_rows, pre)
        tail = torch.from_numpy(np.ascontiguousarray(prompt_ids[:, pre:])).to(
            self.device)
        if self.prefill_time_charge is not None:
            self.prefill_time_charge(b * (P - pre))
        logits, cache = gpt2.forward_cached(
            self.weights, tail, cache, pre, self.config)
        first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        self._scatter(cache, wt_rows)
        return first

    # -- chunked prefill (co-scheduled with decode segments) ----------------
    @torch.no_grad()
    def _chunk_prefill(self, ids_chunk: np.ndarray, pt_row: np.ndarray,
                       base: int, creal: int):
        """Run one prefill chunk for one slot: gather the slot's pages
        (all ``pages_per_seq`` table entries) into a dense cache of
        ``capacity`` rows, run the model over the ``chunk_tokens`` chunk at
        ``pos_start = base``, and scatter every page back through the
        slot's table row.  The final chunk is padded with token 0 to
        ``chunk_tokens``: causal masking keeps the pad rows out of every
        real row, and their K/V land at positions >= P, masked until
        decode overwrites them.  Returns the first token (the logits of
        the chunk's last real row, ``creal - 1``) as a (1,) tensor."""
        from ..models import gpt2

        self._prefill_cache.setdefault(
            ("chunk", self.chunk_tokens, 1, self.attention_impl))
        cache = self._dense_cache(1)
        self._gather(cache, pt_row[None, :], self.capacity)
        ids = torch.from_numpy(ids_chunk).to(self.device)
        if self.prefill_time_charge is not None:
            self.prefill_time_charge(int(creal))
        logits, cache = gpt2.forward_cached(
            self.weights, ids, cache, base, self.config)
        first = torch.argmax(logits[:, creal - 1, :], dim=-1).to(torch.int32)
        self._scatter(cache, pt_row[None, :])
        return first

    def _record_assign(self, pages, rid: Any) -> None:
        if self.ownlog is None:
            return
        if self.sharing:
            self.ownlog.record(
                "assign", pages, owner=str(rid), site="admit",
                refcounts=[self.pool.refcount(p) for p in pages],
            )
        else:
            self.ownlog.record("assign", pages, owner=str(rid), site="admit")

    def _admit_chunked(self, s: int) -> None:
        """Admit the queue head into slot ``s`` chunked: the slot and the
        first chunk's pages are claimed now; the prefill runs one chunk per
        segment in :meth:`_advance_chunks`, and the first token is
        delivered when the last chunk folds."""
        from ..models.kv_pages import TRASH_PAGE, pages_needed

        rid, ids, max_new = self._queue.pop(0)
        P = int(ids.shape[1])
        need = pages_needed(min(self.chunk_tokens, P), self.page_size)
        pages = self.pool.alloc(need)
        t0 = self._clock()
        self._slot_req[s] = rid
        self._slot_pages[s] = list(pages)
        # the whole row is rewritten: a previous occupant's entries would
        # make the chunk's scatter-back land in pages others now own
        self.page_table[s] = TRASH_PAGE
        self.page_table[s, :len(pages)] = pages
        self.lengths[s] = 0
        self.cur_tok[s, 0] = 0
        self.remaining[s] = 0
        self._chunk_state[s] = {
            "rid": rid, "ids": np.asarray(ids), "P": P, "max_new": max_new,
            "next": 0,
        }
        if self.memprof is not None:
            # the full-horizon footprint, as whole-prompt admission books
            # it: the profiler tracks the request's eventual residency
            self.memprof.alloc(
                self._mem_node, f"kv:{rid}",
                pages_needed(P + max_new, self.page_size) * self._page_bytes,
                "kv_pages",
            )
        self._record_assign(pages, rid)
        for rl in self._reqlogs:
            rl.admit(rid, t0)
        self.metrics.counter("decode.chunk_admitted").inc()
        if self.tracer is not None:
            self.tracer.instant(
                "admit_chunked", track="decode", cat="decode", t=t0,
                rid=str(rid), prompt_len=P,
            )
        if self.reqtrace is not None:
            self.reqtrace.admitted(rid, t0, chunked=True)
        self._emit_pool_occupancy()
        self._emit_queue_depth()

    def _advance_chunks(self, budget: Optional[int] = None) -> int:
        """Advance pending prefills by up to ``budget`` prompt tokens this
        segment (default: the segment's decode capacity ``slots *
        seg_steps``, at least one chunk), round-robin across prefilling
        slots; a slot whose next chunk cannot get its pages stalls
        (``decode.chunk_stalls``) and retries next segment without
        blocking the others.  Returns tokens prefilled."""
        if not self._chunk_state:
            return 0
        from ..models.kv_pages import pages_needed

        ct = self.chunk_tokens
        if budget is None:
            budget = max(ct, self.slots * self.seg_steps)
        advanced = 0
        spent_by: list = []   # rids whose chunks spent budget here
        order = sorted(self._chunk_state)
        n = len(order)
        rr = self._chunk_rr % n
        for k in range(n):
            if budget <= 0:
                self._trace_budget_stalls(spent_by)
                break
            s = order[(rr + k) % n]
            st = self._chunk_state[s]
            P, base = st["P"], st["next"]
            C = min(ct, P - base)
            if C > budget:
                self._trace_budget_stalls(spent_by)
                break
            final = base + C >= P
            target_rows = P + st["max_new"] if final else base + C
            need = pages_needed(target_rows, self.page_size) - len(
                self._slot_pages[s])
            if need > 0:
                if not self.pool.can_alloc(need):
                    self.metrics.counter("decode.chunk_stalls").inc()
                    if self.tracer is not None:
                        # the total rides the ring, so the flight
                        # recorder's chunk-stall trigger sees its growth
                        self.tracer.counter(
                            "decode.chunk_stalls",
                            self.metrics.counter("decode.chunk_stalls").value,
                        )
                    if self.reqtrace is not None:
                        self.reqtrace.wait(
                            st["rid"], self._clock(), "page_pool",
                            by=[str(r) for r in self._slot_req
                                if r is not None and r != st["rid"]],
                        )
                    continue
                fresh = self.pool.alloc(need)
                k0 = len(self._slot_pages[s])
                self._slot_pages[s].extend(fresh)
                self.page_table[s, k0:k0 + len(fresh)] = fresh
                self._record_assign(fresh, st["rid"])
            chunk = np.zeros((1, ct), np.int32)
            chunk[0, :C] = st["ids"][0, base:base + C]
            ev = None
            if self.tracer is not None:
                ev = self.tracer.begin(
                    "prefill_chunk", track="decode", cat="decode",
                    rid=str(st["rid"]), base=base, tokens=C,
                )
            first = self._chunk_prefill(chunk, self.page_table[s], base, C)
            if ev is not None:
                self.tracer.end(ev)
                if self.reqtrace is not None:
                    # the decode-track span's own timestamps
                    self.reqtrace.chunk(
                        st["rid"], ev["t0"], ev["t1"], base=base, tokens=C,
                    )
            spent_by.append(str(st["rid"]))
            st["next"] = base + C
            advanced += C
            budget -= C
            self.metrics.counter("decode.chunk_prefill_tokens").inc(C)
            self.metrics.counter("decode.chunk_waves").inc()
            if st["next"] >= P:
                self._fold_chunked(s, st, first.cpu().numpy())
        self._chunk_rr = (rr + 1) % n
        if advanced:
            self._emit_pool_occupancy()
        return advanced

    def _fold_chunked(self, s: int, st: Dict[str, Any], first) -> None:
        """The last chunk folded: its final row's logits give the first
        token, the slot flips from prefilling to decoding, and TTFT
        anchors here."""
        rid = st["rid"]
        t_done = self._clock()
        self.lengths[s] = st["P"]
        self.cur_tok[s, 0] = int(first[0])
        self.remaining[s] = st["max_new"] - 1
        self._tokens[rid] = [int(first[0])]
        self._first_tok_t[rid] = t_done
        del self._chunk_state[s]
        for rl in self._reqlogs:
            rl.first_token(rid, t_done)
        if self.reqtrace is not None:
            self.reqtrace.first_token(rid, t_done)
        sub_t = self._submit_t.pop(rid, None)
        if sub_t is not None:
            self.metrics.histogram("decode.ttft_s", unit="s").observe(
                t_done - sub_t)
        if st["max_new"] == 1:  # the fold produced the only token
            self._retire(s)

    def _trace_budget_stalls(self, spent_by: list) -> None:
        """The segment's prefill token budget ran out: every slot still
        mid prefill waits on ``chunk_budget``, charged to the requests
        whose chunks spent it and to the co-resident decoders."""
        rt = self.reqtrace
        if rt is None:
            return
        t = self._clock()
        decoders = [
            str(self._slot_req[s]) for s in range(self.slots)
            if self._slot_req[s] is not None and self.remaining[s] > 0
        ]
        by = list(dict.fromkeys(list(spent_by) + decoders))
        for st in self._chunk_state.values():
            rid = str(st["rid"])
            if rid in spent_by or st["next"] >= st["P"]:
                continue
            rt.wait(rid, t, "chunk_budget", by=by)

    def _trace_queue_block(self, cause: str) -> None:
        """Why admission stopped, on every queued request's waterfall:
        the head waits on ``cause`` (held by the residents), everyone
        behind it on the head."""
        rt = self.reqtrace
        if rt is None or not self._queue:
            return
        t = self._clock()
        holders = [str(r) for r in self._slot_req if r is not None]
        head = str(self._queue[0][0])
        rt.wait(head, t, cause, by=holders)
        for entry in self._queue[1:]:
            rt.wait(str(entry[0]), t, "head_of_line", by=[head])

    # -- admission / retirement (between segments) ---------------------------
    def _admit(self) -> int:
        """FIFO admission, batched: the longest same-prompt-length prefix
        of the queue that fits the free slots and the page pool is
        prefilled in one call.  Head-of-line blocking is deliberate.

        With prefix sharing a wave also shares its number ``h`` of
        resident prefix pages: each request's need drops to its fresh
        tail, and the wave runs the stitched prefill that skips the
        resident part.  A chunk-eligible head is admitted alone, chunked."""
        from ..models.kv_pages import TRASH_PAGE, pages_needed, prefix_chunk_keys

        admitted = 0
        sharing = self.sharing
        while self._queue:
            free_slots = [
                s for s in range(self.slots) if self._slot_req[s] is None
            ]
            if not free_slots:
                self._trace_queue_block("slots_full")
                break
            P = self._queue[0][1].shape[1]
            if self.chunk_eligible(int(P)):
                if pages_needed(min(self.chunk_tokens, int(P)),
                                self.page_size) > self.pool.free_pages:
                    self._trace_queue_block("page_pool")
                    break  # backpressure: the head waits for frees
                self._admit_chunked(free_slots[0])
                admitted += 1
                continue
            h0 = 0
            if sharing:
                h_max = (P - 1) // self.page_size
                keys0 = prefix_chunk_keys(self._queue[0][1], self.page_size)
                h0, _ = self.pool.match_prefix(keys0[:h_max])
            batch, hits, budget = [], [], self.pool.free_pages
            seen_keys: set = set()
            for rid, ids, max_new in self._queue:
                if ids.shape[1] != P or len(batch) >= len(free_slots):
                    break
                if self.chunk_eligible(int(ids.shape[1])):
                    break
                if sharing:
                    keys = prefix_chunk_keys(ids, self.page_size)
                    kt = tuple(keys[:h_max])
                    if kt and kt in seen_keys:
                        # a same-wave twin: defer it one wave, so it aliases
                        # the pages this wave interns
                        break
                    h, spages = self.pool.match_prefix(keys[:h_max])
                    if h != h0:
                        break
                    # a matched cached-free page is revived from the free list
                    revive = sum(1 for p in spages if self.pool.is_cached(p))
                    need = pages_needed(ids.shape[1] + max_new,
                                        self.page_size) - h
                    if need + revive > budget:
                        break
                    budget -= revive
                else:
                    need = pages_needed(ids.shape[1] + max_new, self.page_size)
                if need > budget:
                    break
                budget -= need
                batch.append((rid, ids, max_new, need))
                if sharing:
                    if kt:
                        seen_keys.add(kt)
                    hits.append((spages, keys))
            if not batch:
                self._trace_queue_block("page_pool")
                break  # backpressure: the head waits for frees
            del self._queue[:len(batch)]
            ev_wave = None
            if self.tracer is not None:
                ev_wave = self.tracer.begin(
                    "admission_wave", track="decode", cat="decode",
                    requests=len(batch), prompt_len=P,
                )
            pt_rows = np.full((len(batch), self.pages_per_seq), TRASH_PAGE,
                              np.int32)
            wt_rows = sh_rows = None
            if sharing and h0 > 0:
                # write table: shared prefix pages send the prefill's
                # scatter to the trash page; gather table: their sources
                wt_rows = pt_rows.copy()
                sh_rows = np.zeros((len(batch), h0), np.int32)
            page_lists = []
            for j, (rid, _, _, need) in enumerate(batch):
                if sharing:
                    spages, keys = hits[j]
                    if spages:
                        # share before alloc: a matched cached-free page must
                        # be revived before alloc pressure can evict it
                        self.pool.share(spages)
                    fresh = self.pool.alloc(need)
                    pages = list(spages) + fresh
                    # intern every full prompt page now, before the prefill,
                    # so a twin deferred to the next wave aliases them
                    for i in range(P // self.page_size):
                        self.pool.register(int(pages[i]), keys[i])
                    if h0 > 0:
                        wt_rows[j, :len(pages)] = [TRASH_PAGE] * h0 + fresh
                        sh_rows[j] = spages
                else:
                    pages = self.pool.alloc(need)
                page_lists.append(pages)
                pt_rows[j, :len(pages)] = pages
                if self.memprof is not None:
                    self.memprof.alloc(
                        self._mem_node, f"kv:{rid}",
                        need * self._page_bytes, "kv_pages",
                    )
                self._record_assign(pages, rid)
            # each request's admission timestamp in the lifecycle log
            t_pf0 = self._clock()
            all_ids = np.concatenate([ids for _, ids, _, _ in batch], axis=0)
            if sharing and h0 > 0:
                first = self._prefill_scatter_shared(all_ids, h0, sh_rows, wt_rows)
            else:
                first = self._prefill_scatter(all_ids, pt_rows)
            first = first.cpu().numpy()
            # the first token exists now (the prefill's readback): each
            # request's TTFT anchor, and the end of the wave's prefill
            t_adm = self._clock()
            if self.tracer is not None:
                self.tracer.complete(
                    "prefill", t_pf0, t_adm, track="decode", cat="decode",
                    requests=len(batch), prompt_len=P,
                )
            self.metrics.histogram("decode.prefill_s", unit="s").observe(
                t_adm - t_pf0)
            ttft_h = self.metrics.histogram("decode.ttft_s", unit="s")
            for j, (rid, ids, max_new, _) in enumerate(batch):
                s = free_slots[j]
                self.page_table[s] = pt_rows[j]
                self.lengths[s] = P
                self.cur_tok[s, 0] = int(first[j])
                self.remaining[s] = max_new - 1
                self._slot_req[s] = rid
                self._slot_pages[s] = page_lists[j]
                self._tokens[rid] = [int(first[j])]
                self._first_tok_t[rid] = t_adm
                if sharing and self.ownlog is not None:
                    # the prefill wrote the fresh pages
                    freshp = page_lists[j][h0:]
                    self.ownlog.record(
                        "write", freshp, owner=str(rid), site="admit",
                        refcounts=[self.pool.refcount(p) for p in freshp],
                    )
                for rl in self._reqlogs:
                    rl.admit(rid, t_pf0)
                    rl.first_token(rid, t_adm)
                if self.reqtrace is not None:
                    self.reqtrace.admitted(
                        rid, t_pf0, wave=[b[0] for b in batch],
                    )
                    self.reqtrace.prefill(
                        rid, t_pf0, t_adm, tokens=int(P),
                        wave_size=len(batch), shared_pages=h0,
                    )
                    self.reqtrace.first_token(rid, t_adm)
                sub_t = self._submit_t.pop(rid, None)
                if sub_t is not None:
                    ttft_h.observe(t_adm - sub_t)
                if max_new == 1:  # prefill produced the only token
                    self._retire(s)
            admitted += len(batch)
            self.metrics.counter("decode.admission_waves").inc()
            if sharing:
                self.metrics.counter("decode.prefix_shared_pages").inc(
                    h0 * len(batch))
                self.metrics.counter("decode.prefix_tokens_skipped").inc(
                    h0 * self.page_size * len(batch))
            if ev_wave is not None:
                self.tracer.end(ev_wave)
            self._emit_pool_occupancy()
            self._emit_queue_depth()
        return admitted

    def _retire(self, s: int) -> None:
        rid = self._slot_req[s]
        self._release_pages(self._slot_pages[s], str(rid), "retire")
        if self.memprof is not None:
            self.memprof.free(self._mem_node, f"kv:{rid}")
        self.results[rid] = np.asarray(self._tokens.pop(rid), dtype=np.int32)
        self._slot_req[s] = None
        self._slot_pages[s] = []
        self.metrics.counter("decode.requests_completed").inc()
        # TPOT = steady-state inter-token gap: last token's arrival (this
        # retire happens at the segment fold that produced it) minus the
        # first token's, over n-1 gaps; single-token requests have none.
        # One clock read feeds the histogram, the lifecycle log and the
        # trace marker
        n = len(self.results[rid])
        t_first = self._first_tok_t.pop(rid, None)
        t_ret = self._clock()
        if t_first is not None and n > 1:
            self.metrics.histogram("decode.tpot_s", unit="s").observe(
                (t_ret - t_first) / (n - 1)
            )
        for rl in self._reqlogs:
            rl.retire(rid, t_ret)
        if self.tracer is not None:
            self.tracer.instant(
                "retire", track="decode", cat="decode", t=t_ret,
                rid=str(rid), tokens=n,
            )
        if self.reqtrace is not None:
            self.reqtrace.retire(rid, t_ret, tokens=n)

    def preempt(
        self, rid: Any, *, cause: Optional[str] = None, by: Any = None,
    ) -> Dict[str, Any]:
        """Evict an in-flight request between segments: free its pages
        and hand its generated prefix back for re-queueing.  ``cause``
        stamps the lifecycle record's terminal cause; ``by`` names the
        request the eviction made room for (the waterfall's interference
        arrow).

        Greedy decode is deterministic, so re-submitting ``prompt +
        tokens`` under a new rid with the returned ``remaining`` budget
        reproduces the continuation an unpreempted run would generate.
        Raises for a rid that holds no slot or is mid chunked prefill.
        Returns ``{"rid", "tokens", "remaining"}``: ``tokens`` the (k,)
        int32 generated prefix (the prefill's token included),
        ``remaining`` the decode steps still owed."""
        from ..models.kv_pages import TRASH_PAGE

        slot = next(
            (s for s in range(self.slots) if self._slot_req[s] == rid), None)
        if slot is None:
            raise ValueError(f"rid {rid!r} is not in flight")
        if slot in self._chunk_state:
            raise ValueError(
                f"rid {rid!r} is mid-chunked-prefill and not preemptible "
                "(no first token yet — there is no resumable prefix)"
            )
        tokens = np.asarray(self._tokens.pop(rid), dtype=np.int32)
        remaining = int(self.remaining[slot])
        self._release_pages(self._slot_pages[slot], str(rid), "preempt")
        if self.memprof is not None:
            self.memprof.free(self._mem_node, f"kv:{rid}")
        self.page_table[slot] = TRASH_PAGE
        self.lengths[slot] = 0
        self.cur_tok[slot, 0] = 0
        self.remaining[slot] = 0
        self._slot_req[slot] = None
        self._slot_pages[slot] = []
        self._first_tok_t.pop(rid, None)
        t_pre = self._clock()
        for rl in self._reqlogs:
            rl.preempt(rid, t_pre, cause)
        self.metrics.counter("decode.requests_preempted").inc()
        if self.tracer is not None:
            self.tracer.instant(
                "preempt", track="decode", cat="decode", t=t_pre,
                rid=str(rid), tokens=int(tokens.shape[0]),
                remaining=remaining,
            )
        if self.reqtrace is not None:
            self.reqtrace.preempt(rid, t_pre, by=by, cause=cause)
        self._emit_pool_occupancy()
        return {"rid": rid, "tokens": tokens, "remaining": remaining}

    # -- the serving loop ----------------------------------------------------
    def step_segment(self) -> int:
        """Advance pending prefill chunks, admit, run ONE K-step segment,
        fold tokens, retire finished slots.  Returns the number of tokens
        delivered to requests."""
        # in-flight prefills advance before admission so chunk slots claim
        # their next pages first; a freshly chunk-admitted request then
        # spends what prefill budget is left
        ct = self.chunk_tokens
        full = max(ct, self.slots * self.seg_steps) if ct is not None else 0
        spent = self._advance_chunks() if self._chunk_state else 0
        self._admit()
        if (ct is not None and spent < full and any(
                st["next"] == 0 for st in self._chunk_state.values())):
            self._advance_chunks(full - spent)
        owed = self.remaining.copy()
        if not owed.any():
            # nothing to decode: the per-segment prefill budget protects
            # nobody, so pending chunks run back to back until one folds
            # into decodable work (or all stall on pages)
            while self._chunk_state and not self.remaining.any():
                if not self._advance_chunks():
                    break
            owed = self.remaining.copy()
            if not owed.any():
                return 0
        self._ensure_exclusive()
        dev = self.device
        t_sg0 = self._clock()
        toks = self._run_segment(
            torch.from_numpy(self.page_table).to(dev),
            torch.from_numpy(self.lengths).to(dev),
            torch.from_numpy(self.cur_tok).to(dev),
            torch.from_numpy(self.remaining).to(dev),
        )
        # the one readback per segment: a host copy (on a card the tokens
        # are the graph's own tensor, rewritten by its next replay)
        toks = toks.cpu().numpy()
        # every token this segment delivered became host-visible here: the
        # readback waited for the segment's work, so the host span bounds
        # the device's
        t_fold = self._clock()
        if self.tracer is not None:
            self.tracer.complete(
                "segment", t_sg0, t_fold, track="decode", cat="decode",
                steps=self.seg_steps, active=int((owed > 0).sum()),
            )
        if self.reqtrace is not None:
            # per-request decode spans reuse the segment's two clock reads
            residents = [
                str(self._slot_req[s]) for s in range(self.slots)
                if self._slot_req[s] is not None and owed[s] > 0
            ]
            for s in range(self.slots):
                rid = self._slot_req[s]
                if rid is None or owed[s] <= 0:
                    continue
                self.reqtrace.segment(
                    rid, t_sg0, t_fold,
                    tokens=int(min(int(owed[s]), self.seg_steps)),
                    co_resident=residents,
                )
        # slot state advances host-side: each slot ran min(owed, K) active
        # steps, its current token is the last one it emitted
        ran = np.minimum(owed, self.seg_steps)
        self.lengths = self.lengths + ran
        self.remaining = np.maximum(owed - self.seg_steps, 0)
        delivered = 0
        for s in range(self.slots):
            rid = self._slot_req[s]
            if rid is None:
                continue
            n = int(ran[s])
            if n:
                self._tokens[rid].extend(int(t) for t in toks[s, :n])
                self.cur_tok[s, 0] = toks[s, n - 1]
                delivered += n
                for rl in self._reqlogs:
                    rl.deliver(rid, t_fold, n)
            # owed == 0: the slot is mid chunked prefill, retired only
            # after its fold
            if 0 < owed[s] <= self.seg_steps:
                self._retire(s)
        self.segments_run += 1
        self.metrics.counter("decode.segments_run").inc()
        self.metrics.counter("decode.tokens_delivered").inc(delivered)
        self._emit_pool_occupancy()
        self._emit_queue_depth()
        self._emit_jit_cache_size()
        return delivered

    def _run_segment(self, page_table, lengths, cur_tok, remaining):
        """One K-step segment over the pools: eagerly off the card (or with
        ``capture=False``), else the engine's captured graph, with the slot
        state copied into its static buffers.  Returns the (S, K) tokens."""
        if self.device.type != "cuda" or not self.capture:
            toks, _ = self._seg(
                self.pools, page_table, lengths, cur_tok, remaining)
            return toks
        if self._captured_seg is None:
            from .device import CapturedProgram, capture_stream

            seg = self._seg
            self._captured_seg = CapturedProgram(
                lambda _params, e: seg(e["pools"], e["page_table"],
                                       e["lengths"], e["cur_tok"],
                                       e["remaining"]),
                stream=capture_stream(self.device))
        toks, _ = self._captured_seg(
            {}, {"pools": self.pools, "page_table": page_table,
                 "lengths": lengths, "cur_tok": cur_tok,
                 "remaining": remaining},
            fixed=frozenset({"pools"}))
        return toks

    def run(self) -> Dict[Any, Any]:
        """Drain the queue and all active slots; returns {rid: np.int32
        tokens} (prompt excluded; exactly ``max_new_tokens`` each)."""
        def _sig():
            # any admission, decode step, chunk advance or retirement
            # changes it; two equal ones in a row mean nothing can move
            return (
                len(self.results), len(self._queue),
                int(self.lengths.sum()), int(self.remaining.sum()),
                tuple(sorted((s, st["next"])
                             for s, st in self._chunk_state.items())),
            )

        while self._queue or any(r is not None for r in self._slot_req):
            before = _sig()
            self.step_segment()
            if _sig() == before:
                raise RuntimeError(
                    "engine stalled: queued requests cannot be admitted "
                    f"({self.pool.free_pages} free pages)"
                )
        # every retire returned its pages, so this is 0 on a clean drain
        self.metrics.gauge("decode.pages_leaked", unit="pages").set(
            (self.pool.n_pages - 1) - self.pool.free_pages
        )
        return self.results


__all__ = [
    "PagedDecodeEngine",
    "build_paged_decode_loop",
    "compose_paged_step_fn",
]
