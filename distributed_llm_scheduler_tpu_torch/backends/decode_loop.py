"""Continuous-batching paged decode over a scheduled decode-step DAG.

PyTorch port of the paged path of ``distributed_llm_scheduler_tpu.
backends.decode_loop``.  The placed paged decode-step DAG
(``frontend/decode_dag.build_paged_decode_dag``) is composed, in the
schedule's order, into one step function; ``build_paged_decode_loop``
iterates it K times per segment; :class:`PagedDecodeEngine` admits and
retires variable-length requests between segments.

Where JAX jits one ``lax.scan`` program per segment with the pools
donated, here a segment is a Python loop of eager steps on the current
stream of one card: the slot state is copied to the device once per
segment, the K steps run on device tensors (argmax on the device, tokens
stacked on the device, no host read inside the loop), the pools are
written in place, and the one device-to-host copy is the segment's
tokens.

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
from ..frontend.decode_dag import cache_dims


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
        inputs = {"ids": ids, "lengths": lengths}
        outs: Dict[str, Any] = {}
        for tid in order:
            task = graph[tid]
            p = {}
            for loc, glob in (task.param_alias or {}).items():
                if glob == "page_table":
                    p[loc] = page_table
                elif glob in pools:
                    p[loc] = pools[glob]
                else:
                    p[loc] = weights[glob]
            if task.dependencies:
                args = [outs[d] for d in (task.arg_tasks or task.dependencies)]
            else:
                args = [inputs]
            outs[tid] = task.fn(p, *args)
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

    Not ported yet, and refused rather than ignored: prefix sharing
    (``pool.sharing``), chunked prefill (``chunk_tokens``), ``preempt``,
    drain, and the tracer / memprof / flight hooks.  Construct via
    ``DeviceBackend.paged_decode_engine``.
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
        chunk_tokens: Optional[int] = None,
        device: Any = None,
    ):
        from ..models.kv_pages import TRASH_PAGE, init_paged_kv
        from ..obs import MetricsRegistry, resolve_clock

        for name, val in (("tracer", tracer), ("memprof", memprof),
                          ("flight", flight), ("chunk_tokens", chunk_tokens)):
            if val is not None:
                raise NotImplementedError(
                    f"PagedDecodeEngine: {name} is not ported yet")
        if getattr(pool, "sharing", False):
            raise NotImplementedError(
                "PagedDecodeEngine: prefix sharing is not ported yet")
        self.config = config
        self.device = torch.device(
            device if device is not None else next(iter(weights.values())).device
        )
        self.weights = {k: v.to(self.device) for k, v in weights.items()}
        self.pool = pool
        self.slots = slots
        self.pages_per_seq = pages_per_seq
        # the impl the graph's layer tasks were built with: they, not the
        # engine, choose the attention path
        self.attention_impl = getattr(graph, "attention_impl", None)
        self.page_size = pool.page_size
        self.capacity = pages_per_seq * pool.page_size
        self.seg_steps = seg_steps
        n_layers, n_kv, hd = cache_dims(config)
        self.n_layers = n_layers
        self._seg = build_paged_decode_loop(
            graph, schedule, config, seg_steps, weights=self.weights
        )
        self.pools = init_paged_kv(
            n_layers, pool.n_pages, pool.page_size, n_kv, hd, config.dtype,
            self.device,
        )
        self.page_table = np.full((slots, pages_per_seq), TRASH_PAGE, np.int32)
        self.lengths = np.zeros((slots,), np.int32)
        self.cur_tok = np.zeros((slots, 1), np.int32)
        self.remaining = np.zeros((slots,), np.int32)
        self._queue: list = []
        self._slot_req: list = [None] * slots   # request id per busy slot
        self._slot_pages: list = [[] for _ in range(slots)]
        self._tokens: Dict[Any, list] = {}
        self.results: Dict[Any, Any] = {}
        self.segments_run = 0
        # the registry always exists, so a run can snapshot TTFT/TPOT and
        # occupancy unconditionally; recording happens at segment
        # boundaries, on the host
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._clock = resolve_clock(clock)
        self._submit_t: Dict[Any, float] = {}     # rid -> submit() time
        self._first_tok_t: Dict[Any, float] = {}  # rid -> first-token time

    def reset(self, fresh_metrics: bool = False) -> None:
        """Fresh pool/table/queue state; the engine's weights and step
        composition are kept, so a warmed engine re-times a workload.
        ``fresh_metrics`` also starts a new registry, so the next run's
        histograms and counters are its own."""
        from ..models.kv_pages import TRASH_PAGE, init_paged_kv
        from ..obs import MetricsRegistry

        for pages in self._slot_pages:
            if pages:
                self.pool.free(pages)
        n_kv, hd = self.pools["cache_k_0"].shape[2:]
        self.pools = init_paged_kv(
            self.n_layers, self.pool.n_pages, self.pool.page_size, n_kv, hd,
            self.config.dtype, self.device,
        )
        self.page_table = np.full(
            (self.slots, self.pages_per_seq), TRASH_PAGE, np.int32
        )
        self.lengths = np.zeros((self.slots,), np.int32)
        self.cur_tok = np.zeros((self.slots, 1), np.int32)
        self.remaining = np.zeros((self.slots,), np.int32)
        self._queue = []
        self._slot_req = [None] * self.slots
        self._slot_pages = [[] for _ in range(self.slots)]
        self._tokens = {}
        self.results = {}
        self.segments_run = 0
        self._submit_t = {}
        self._first_tok_t = {}
        if fresh_metrics:
            self.metrics = MetricsRegistry()

    def preempt(self, rid: Any, **_kw) -> Dict[str, Any]:
        raise NotImplementedError("PagedDecodeEngine: preempt is not ported yet")

    def begin_drain(self) -> None:
        raise NotImplementedError("PagedDecodeEngine: drain is not ported yet")

    # -- pool headroom -------------------------------------------------------
    @property
    def free_slots(self) -> int:
        """Batch lanes currently unoccupied."""
        return sum(1 for r in self._slot_req if r is None)

    def page_occupancy(self) -> Dict[str, Any]:
        """Pool headroom: free/used totals plus per-request page counts."""
        per_request = {
            str(self._slot_req[s]): len(self._slot_pages[s])
            for s in range(self.slots)
            if self._slot_req[s] is not None
        }
        return {
            "n_pages": self.pool.n_pages - 1,  # page 0 is the trash page
            "free_pages": self.pool.free_pages,
            "used_pages": self.pool.used_pages,
            "per_request": per_request,
        }

    def _emit_pool_occupancy(self) -> None:
        self.metrics.gauge(
            "decode.page_pool_occupancy_pages", unit="pages"
        ).set(self.pool.used_pages)

    def _emit_queue_depth(self) -> None:
        self.metrics.gauge("decode.queue_depth").set(len(self._queue))

    def summary(self) -> Dict[str, Any]:
        """Engine-state snapshot at this segment boundary."""
        return {
            "slots": self.slots,
            "free_slots": self.free_slots,
            "queued": len(self._queue),
            "in_flight": self.slots - self.free_slots,
            "completed": len(self.results),
            "segments_run": self.segments_run,
            "attention_impl": self.attention_impl or "auto",
            "page_occupancy": self.page_occupancy(),
        }

    # -- request intake ------------------------------------------------------
    def submit(self, rid: Any, prompt_ids: Any, max_new_tokens: int) -> None:
        """Queue a request; it is admitted into a free slot (and its pages
        allocated) at the next segment boundary.  Request ids must be
        unique for the life of the engine state."""
        if rid in self.results:
            raise ValueError(f"duplicate rid {rid!r}: already retired")
        if rid in self._tokens:
            raise ValueError(f"duplicate rid {rid!r}: already in flight")
        if any(q[0] == rid for q in self._queue):
            raise ValueError(f"duplicate rid {rid!r}: already queued")
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
        self._submit_t[rid] = self._clock()
        self.metrics.counter("decode.requests_submitted").inc()
        self._emit_queue_depth()

    # -- prefill + page scatter (one call per admission wave) ----------------
    @torch.no_grad()
    def _prefill_scatter(self, prompt_ids: np.ndarray, pt_rows: np.ndarray):
        """Prefill ``b`` same-length prompts over a dense cache of
        ``capacity`` rows and write all their cache rows into their pages.

        ``prompt_ids`` (b, P); ``pt_rows`` (b, pages_per_seq) physical page
        rows (trash-padded tails: those entries all write page 0, which is
        harmless by design).  Returns the (b,) first greedy tokens on the
        device."""
        from ..models import decode as _decode
        from ..models import gpt2

        b, _ = prompt_ids.shape
        n_kv, hd = self.pools["cache_k_0"].shape[2:]
        cache = _decode.init_cache(
            self.n_layers, b, n_kv, self.capacity, hd, self.config.dtype,
            self.device,
        )
        ids = torch.from_numpy(prompt_ids).to(self.device)
        logits, cache = gpt2.forward_cached(self.weights, ids, cache, 0, self.config)
        first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        flat_pages = torch.from_numpy(pt_rows.reshape(-1).astype(np.int64)).to(
            self.device)
        ppseq, ps = self.pages_per_seq, self.page_size
        for i in range(self.n_layers):
            for kind in ("k", "v"):
                # (b, cap, Hkv, hd), page-chunked
                rows = cache[kind][i].transpose(1, 2)
                paged = rows.reshape(b * ppseq, ps, n_kv, hd)
                self.pools[f"cache_{kind}_{i}"].index_copy_(0, flat_pages, paged)
        return first

    # -- admission / retirement (between segments) ---------------------------
    def _admit(self) -> int:
        """FIFO admission, batched: the longest same-prompt-length prefix
        of the queue that fits the free slots and the page pool is
        prefilled in one call.  Head-of-line blocking is deliberate."""
        from ..models.kv_pages import TRASH_PAGE, pages_needed

        admitted = 0
        while self._queue:
            free_slots = [
                s for s in range(self.slots) if self._slot_req[s] is None
            ]
            if not free_slots:
                break
            P = self._queue[0][1].shape[1]
            batch, budget = [], self.pool.free_pages
            for rid, ids, max_new in self._queue:
                if ids.shape[1] != P or len(batch) >= len(free_slots):
                    break
                need = pages_needed(ids.shape[1] + max_new, self.page_size)
                if need > budget:
                    break
                budget -= need
                batch.append((rid, ids, max_new, need))
            if not batch:
                break  # backpressure: the head waits for frees
            del self._queue[:len(batch)]
            t_wave = self._clock()
            pt_rows = np.full(
                (len(batch), self.pages_per_seq), TRASH_PAGE, np.int32
            )
            page_lists = []
            for j, (_, _, _, need) in enumerate(batch):
                pages = self.pool.alloc(need)
                page_lists.append(pages)
                pt_rows[j, :len(pages)] = pages
            all_ids = np.concatenate([ids for _, ids, _, _ in batch], axis=0)
            first = self._prefill_scatter(all_ids, pt_rows).cpu().numpy()
            # the first token exists now (the prefill's readback): each
            # request's TTFT anchor, and the end of the wave's prefill
            t_adm = self._clock()
            self.metrics.histogram("decode.prefill_s", unit="s").observe(
                t_adm - t_wave)
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
                sub_t = self._submit_t.pop(rid, None)
                if sub_t is not None:
                    ttft_h.observe(t_adm - sub_t)
                if max_new == 1:  # prefill produced the only token
                    self._retire(s)
            admitted += len(batch)
            self.metrics.counter("decode.admission_waves").inc()
            self._emit_pool_occupancy()
            self._emit_queue_depth()
        return admitted

    def _retire(self, s: int) -> None:
        rid = self._slot_req[s]
        self.pool.free(self._slot_pages[s])
        self.results[rid] = np.asarray(self._tokens.pop(rid), dtype=np.int32)
        self._slot_req[s] = None
        self._slot_pages[s] = []
        self.metrics.counter("decode.requests_completed").inc()
        # TPOT = steady-state inter-token gap: last token's arrival (this
        # retire happens at the segment fold that produced it) minus the
        # first token's, over n-1 gaps; single-token requests have none
        n = len(self.results[rid])
        t_first = self._first_tok_t.pop(rid, None)
        t_ret = self._clock()
        if t_first is not None and n > 1:
            self.metrics.histogram("decode.tpot_s", unit="s").observe(
                (t_ret - t_first) / (n - 1)
            )

    # -- the serving loop ----------------------------------------------------
    def step_segment(self) -> int:
        """Admit, run ONE K-step segment, fold tokens, retire finished
        slots.  Returns the number of tokens delivered to requests."""
        self._admit()
        owed = self.remaining.copy()
        if not owed.any():
            return 0
        dev = self.device
        toks, self.pools = self._seg(
            self.pools,
            torch.from_numpy(self.page_table).to(dev),
            torch.from_numpy(self.lengths).to(dev),
            torch.from_numpy(self.cur_tok).to(dev),
            torch.from_numpy(self.remaining).to(dev),
        )
        toks = toks.cpu().numpy()  # the one readback per segment
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
            if 0 < owed[s] <= self.seg_steps:
                self._retire(s)
        self.segments_run += 1
        self.metrics.counter("decode.segments_run").inc()
        self.metrics.counter("decode.tokens_delivered").inc(delivered)
        self._emit_pool_occupancy()
        self._emit_queue_depth()
        return delivered

    def run(self) -> Dict[Any, Any]:
        """Drain the queue and all active slots; returns {rid: np.int32
        tokens} (prompt excluded; exactly ``max_new_tokens`` each)."""
        def _sig():
            return (
                len(self.results), len(self._queue),
                int(self.lengths.sum()), int(self.remaining.sum()),
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
