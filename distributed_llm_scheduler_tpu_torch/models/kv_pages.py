"""Block-allocated KV-cache pool: fixed-size pages + per-sequence tables.

PyTorch port of ``distributed_llm_scheduler_tpu.models.kv_pages``.  Cache
rows live in fixed-size **pages** drawn from one shared pool per layer;
each sequence holds a **page table** (logical page index -> physical page
id); a host-side free-list allocator recycles pages as requests retire, so
the pool is sized for the working set, not ``slots x max_len``.

* :class:`PagePool` — the host-side free-list allocator, a framework-free
  copy of the JAX package's (same alloc/free order, same errors).
* :class:`PageOwnershipLog` — the append-only page-ownership event stream
  the pool and the decode engine record into, which
  ``analysis/page_pass.py`` replays (the JAX package's, whole).
* :func:`init_paged_kv` — the device-side per-layer page pools
  ``(n_pages, page_size, n_kv_heads, head_dim)``, pages on the leading
  axis, the layout the paged-attention kernels read.
* :func:`write_token_kv` / :func:`write_prompt_kv` — scatters of one
  step's rows or a prefilled prompt into their pages.  JAX returns new
  arrays; these write the pool IN PLACE (the counterpart of the JAX
  engine donating its pools) and return it.
* :func:`gather_kv` / :func:`gather_kv_flat` — per-sequence views.

Physical page 0 is RESERVED as the trash page: unallocated page-table
entries point at it and inactive batch slots redirect their writes to it,
so every index a scatter or gather sees is a valid page id.  Index
tensors are widened to int64 for torch indexing; page tables stay int32,
the kernels' ABI.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

#: Default tokens per page.
DEFAULT_PAGE_SIZE = 16

#: Physical page id reserved for unallocated table entries and inactive
#: slot writes (never handed out by the allocator).
TRASH_PAGE = 0

#: Schema tag for :meth:`PageOwnershipLog.snapshot`.
OWNERSHIP_SCHEMA = "dls.pages/1"


class PageOwnershipLog:
    """Append-only page ownership event stream.

    The :class:`PagePool` records ``alloc``/``free`` (with its free/used
    counts after the event, the tiling witness) and, with prefix sharing,
    ``share``/``unshare`` (refcounts up/down, the free list untouched);
    the decode engine records ``assign``/``release`` (the owning request
    id and the lifecycle edge: ``admit``/``retire``/``preempt``/``reset``),
    ``cow`` (``pages=[src, dst]`` of a copy-on-write split, dst allocated
    before src is released) and ``write`` (a first write into a page).
    Ref-counted events carry ``refcounts`` (post-event, aligned with
    ``pages``); producers without sharing omit the key.  The page-lifetime
    prover (``analysis/page_pass.py``) replays the stream.  Recording is a
    dict append per pool operation; with no log attached nothing is
    recorded and the engine behaves identically."""

    def __init__(self, n_pages: Optional[int] = None):
        self.n_pages = n_pages
        self.events: List[Dict[str, Any]] = []

    def record(
        self,
        kind: str,
        pages: Sequence[int],
        *,
        owner: Optional[str] = None,
        site: Optional[str] = None,
        free_pages: Optional[int] = None,
        used_pages: Optional[int] = None,
        refcounts: Optional[Sequence[int]] = None,
    ) -> None:
        e: Dict[str, Any] = {
            "seq": len(self.events),
            "kind": kind,
            "pages": [int(p) for p in pages],
            "owner": owner,
            "site": site,
            "free_pages": free_pages,
            "used_pages": used_pages,
        }
        if refcounts is not None:
            e["refcounts"] = [int(r) for r in refcounts]
        self.events.append(e)

    def __len__(self) -> int:
        return len(self.events)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready view (schema ``dls.pages/1``)."""
        return {
            "schema": OWNERSHIP_SCHEMA,
            "n_pages": self.n_pages,
            "events": [dict(e) for e in self.events],
        }


def _itemsize(dtype: Any) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def pages_needed(n_tokens: int, page_size: int) -> int:
    """Pages covering ``n_tokens`` rows (ceil division)."""
    if n_tokens < 0:
        raise ValueError(f"n_tokens must be >= 0, got {n_tokens}")
    return -(-n_tokens // page_size)


def prefix_chunk_keys(tokens: Any, page_size: int) -> List[str]:
    """Chain-hash intern keys for every FULL page of a token prefix.

    Key ``i`` digests the entire prefix ``tokens[0:(i+1)*page_size]``, so
    a match on key ``i`` implies matches on all earlier keys.  Only full
    pages get keys (a partial tail page is always exclusive)."""
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    toks = _flatten_tokens(tokens)
    h = hashlib.sha256()
    keys: List[str] = []
    for i in range(len(toks) // page_size):
        chunk = toks[i * page_size:(i + 1) * page_size]
        h.update((",".join(map(str, chunk)) + ";").encode())
        keys.append(h.hexdigest())
    return keys


def _flatten_tokens(tokens: Any) -> List[int]:
    """Host-side flatten of a token container (list, numpy row, or
    tensor) into plain ints."""
    if hasattr(tokens, "reshape"):
        flat = tokens.reshape(-1)
        return [int(t) for t in flat.tolist()]
    return [int(t) for t in tokens]


def pool_bytes_per_layer(
    n_pages: int, page_size: int, n_kv_heads: int, head_dim: int, dtype: Any
) -> int:
    """Device bytes of ONE layer's K+V pools at this geometry."""
    return 2 * n_pages * page_size * n_kv_heads * head_dim * _itemsize(dtype)


@dataclass
class PagePool:
    """Host-side free-list page allocator over ``n_pages`` physical pages.

    Page ids are ints in ``[1, n_pages)`` — id 0 is :data:`TRASH_PAGE`
    and is never allocated.  ``alloc``/``free`` are O(k); exhaustion
    raises so callers (the continuous-batching engine) can hold requests
    queued instead of silently corrupting the pool — backpressure, not
    clamping.

    With ``sharing=True`` the pool additionally interns full prefix
    chunks (:func:`prefix_chunk_keys`): a resident page whose chain hash
    matches a new request's prefix is aliased via :meth:`share` instead
    of re-allocated, reference counts track logical owners per physical
    page, and :meth:`release_ref` returns a page to the LIFO free list
    only on last release.  With sharing off (the default) every page has
    refcount 1.
    """

    n_pages: int
    page_size: int = DEFAULT_PAGE_SIZE
    _free: List[int] = field(default_factory=list, repr=False)
    _allocated: set = field(default_factory=set, repr=False)
    #: optional :class:`PageOwnershipLog`; every alloc/free appends one
    #: event carrying the post-event free/used counts.  None — the
    #: default — records nothing and costs nothing.
    ownlog: Optional[Any] = field(default=None, repr=False, compare=False)
    #: enable content-addressed prefix sharing (intern table + refcounts)
    sharing: bool = False
    _refs: Dict[int, int] = field(default_factory=dict, repr=False)
    _intern: Dict[str, int] = field(default_factory=dict, repr=False)
    _page_key: Dict[int, str] = field(default_factory=dict, repr=False)
    #: free pages whose intern entries are RETAINED (LRU cache of
    #: last-released shared prefixes), insertion-ordered; always a subset
    #: of ``_free``
    _cached: Dict[int, None] = field(default_factory=dict, repr=False)

    def __post_init__(self) -> None:
        if self.n_pages < 2:
            raise ValueError(
                f"pool needs >= 2 pages (one is the reserved trash page), "
                f"got {self.n_pages}"
            )
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        # LIFO free list: recently-freed pages are re-issued first, which
        # keeps the hot working set compact
        self._free = list(range(self.n_pages - 1, TRASH_PAGE, -1))

    @classmethod
    def from_budget(
        cls,
        budget_bytes: int,
        n_layers: int,
        n_kv_heads: int,
        head_dim: int,
        dtype: Any,
        page_size: int = DEFAULT_PAGE_SIZE,
    ) -> "PagePool":
        """Size the pool so ALL layers' K+V pools fit ``budget_bytes``."""
        per_page = n_layers * pool_bytes_per_layer(
            1, page_size, n_kv_heads, head_dim, dtype
        )
        n_pages = int(budget_bytes // per_page)
        if n_pages < 2:
            raise ValueError(
                f"budget {budget_bytes} bytes fits {n_pages} page(s); "
                f"need >= 2 ({per_page} bytes/page across {n_layers} "
                "layers)"
            )
        return cls(n_pages=n_pages, page_size=page_size)

    # -- accounting --------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        """Physical pages allocated (unique — aliases count once)."""
        return len(self._allocated)

    @property
    def logical_pages(self) -> int:
        """Sum of refcounts: what a sharing-oblivious pool would hold."""
        return sum(self._refs.values())

    @property
    def shared_pages(self) -> int:
        """Physical pages with more than one live reference."""
        return sum(1 for rc in self._refs.values() if rc > 1)

    def refcount(self, page: int) -> int:
        return self._refs.get(int(page), 0)

    @property
    def cached_pages(self) -> int:
        """Free pages whose prefix intern entries are retained (LRU)."""
        return len(self._cached)

    def is_cached(self, page: int) -> bool:
        """True when ``page`` is physically free but its intern entry is
        retained."""
        return int(page) in self._cached

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    # -- alloc / free ------------------------------------------------------
    def alloc(self, n: int) -> List[int]:
        """Take ``n`` pages off the free list; raises on exhaustion
        (callers queue the request — the pool never over-allocates)."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            raise MemoryError(
                f"page pool exhausted: want {n}, have {len(self._free)} "
                f"free of {self.n_pages - 1} allocatable"
            )
        if not self._cached:
            pages = [self._free.pop() for _ in range(n)]
        else:
            # lazy LRU eviction: serve uncached free pages first (LIFO),
            # and only under pressure evict cached prefixes, oldest first
            pages = []
            held: List[int] = []
            while len(pages) < n and self._free:
                p = self._free.pop()
                if p in self._cached:
                    held.append(p)
                else:
                    pages.append(p)
            self._free.extend(reversed(held))
            for p in list(self._cached):
                if len(pages) >= n:
                    break
                self._evict_cached(p)
                self._free.remove(p)
                pages.append(p)
        self._allocated.update(pages)
        for p in pages:
            self._refs[p] = 1
        if self.ownlog is not None:
            self.ownlog.record(
                "alloc", pages,
                free_pages=len(self._free), used_pages=len(self._allocated),
            )
        return pages

    def alloc_for_tokens(self, n_tokens: int) -> List[int]:
        return self.alloc(pages_needed(n_tokens, self.page_size))

    def free(self, pages: Sequence[int]) -> None:
        """Return pages to the free list; double-free and trash-page
        frees are hard errors, and so is freeing a page other references
        still alias (callers drop refs via :meth:`release_ref`)."""
        pages = list(pages)
        for p in pages:
            if p == TRASH_PAGE:
                raise ValueError("page 0 is reserved and never allocated")
            if p not in self._allocated:
                raise ValueError(f"double free of page {p}")
            if self._refs.get(p, 1) > 1:
                raise ValueError(
                    f"page {p} is shared (refcount "
                    f"{self._refs[p]}); release the reference instead"
                )
            self._allocated.discard(p)
            self._free.append(p)
            self._refs.pop(p, None)
            if self.sharing and p in self._page_key:
                # retain the intern entry: the page is physically free but
                # stays matchable until alloc pressure evicts it
                self._cached[p] = None
            else:
                key = self._page_key.pop(p, None)
                if key is not None and self._intern.get(key) == p:
                    del self._intern[key]
        if self.ownlog is not None:
            self.ownlog.record(
                "free", pages,
                free_pages=len(self._free), used_pages=len(self._allocated),
            )

    def _evict_cached(self, p: int) -> None:
        """Drop a cached-free page's retained intern entry."""
        del self._cached[p]
        key = self._page_key.pop(p, None)
        if key is not None and self._intern.get(key) == p:
            del self._intern[key]

    def drop_cached(self) -> int:
        """Evict every retained intern entry, returning how many were
        dropped (an engine reset rebuilds the KV arrays, so a retained
        entry would point at zeroed storage)."""
        n = len(self._cached)
        for p in list(self._cached):
            self._evict_cached(p)
        return n

    # -- prefix sharing ----------------------------------------------------
    def match_prefix(self, keys: Sequence[str]) -> Tuple[int, List[int]]:
        """Longest resident run of ``keys``: ``(h, pages)`` where the
        first ``h`` keys are interned.  Pure lookup."""
        if not self.sharing:
            return 0, []
        pages: List[int] = []
        for k in keys:
            p = self._intern.get(k)
            if p is None:
                break
            pages.append(p)
        return len(pages), pages

    def share(self, pages: Sequence[int]) -> None:
        """Take one additional reference on each page (aliasing commit);
        a cached-free page is revived (leaves the free list, refcount 1,
        recorded as ``alloc``)."""
        if not self.sharing:
            raise ValueError("share() on a pool with sharing disabled")
        revived: List[int] = []
        bumped: List[int] = []
        for p in pages:
            p = int(p)
            if p in self._cached:
                del self._cached[p]
                self._free.remove(p)
                self._allocated.add(p)
                self._refs[p] = 1
                revived.append(p)
            elif p in self._allocated:
                self._refs[p] = self._refs.get(p, 0) + 1
                bumped.append(p)
            else:
                raise ValueError(f"share of unallocated page {p}")
        if self.ownlog is not None:
            if revived:
                self.ownlog.record(
                    "alloc", revived,
                    free_pages=len(self._free),
                    used_pages=len(self._allocated),
                )
            if bumped:
                self.ownlog.record(
                    "share", bumped,
                    free_pages=len(self._free),
                    used_pages=len(self._allocated),
                    refcounts=[self._refs[p] for p in bumped],
                )

    def register(self, page: int, key: str) -> None:
        """Intern ``page`` under chain-hash ``key`` (first writer wins).
        No-op with sharing disabled."""
        if not self.sharing:
            return
        page = int(page)
        if page not in self._allocated:
            raise ValueError(f"register of unallocated page {page}")
        if key in self._intern or page in self._page_key:
            return
        self._intern[key] = page
        self._page_key[page] = key

    def release_ref(self, pages: Sequence[int]) -> None:
        """Drop one reference per page: last release frees physically,
        earlier releases only decrement and record ``unshare``."""
        to_free: List[int] = []
        unshared: List[int] = []
        for p in pages:
            p = int(p)
            if p not in self._allocated:
                raise ValueError(f"release_ref of unallocated page {p}")
            rc = self._refs.get(p, 1)
            if rc <= 1:
                to_free.append(p)
            else:
                self._refs[p] = rc - 1
                unshared.append(p)
        if unshared and self.ownlog is not None:
            self.ownlog.record(
                "unshare", unshared,
                free_pages=len(self._free), used_pages=len(self._allocated),
                refcounts=[self._refs[p] for p in unshared],
            )
        if to_free:
            self.free(to_free)


def init_paged_kv(
    n_layers: int,
    n_pages: int,
    page_size: int,
    n_kv_heads: int,
    head_dim: int,
    dtype: torch.dtype,
    device: Any = "cuda",
) -> Dict[str, torch.Tensor]:
    """Zeroed per-layer page pools keyed ``cache_k_{i}`` / ``cache_v_{i}``,
    layout ``(n_pages, page_size, n_kv_heads, head_dim)``: pages lead, so
    assembling a sequence is one gather on axis 0."""
    shape = (n_pages, page_size, n_kv_heads, head_dim)
    out: Dict[str, torch.Tensor] = {}
    for i in range(n_layers):
        out[f"cache_k_{i}"] = torch.zeros(shape, dtype=dtype, device=device)
        out[f"cache_v_{i}"] = torch.zeros(shape, dtype=dtype, device=device)
    return out


def page_table_array(
    tables: Sequence[Sequence[int]], pages_per_seq: int, device: Any = "cuda"
) -> torch.Tensor:
    """Stack per-sequence page-id lists into the device table
    ``(slots, pages_per_seq) int32``, padding unallocated entries with
    the trash page."""
    rows = []
    for t in tables:
        if len(t) > pages_per_seq:
            raise ValueError(
                f"sequence holds {len(t)} pages > pages_per_seq "
                f"{pages_per_seq}"
            )
        rows.append(list(t) + [TRASH_PAGE] * (pages_per_seq - len(t)))
    return torch.tensor(rows, dtype=torch.int32, device=device)


def token_slots(
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    active: torch.Tensor,
    page_size: int,
):
    """``(page ids, rows within the page)``, each (S,) int64: where each
    slot's row at position ``lengths[s]`` lands.  Inactive slots land on
    row 0 of the trash page; a logical page past the table's end reads
    its last entry, as the JAX gather clamps."""
    ppseq = page_table.shape[1]
    lengths = lengths.long()
    s_idx = torch.arange(page_table.shape[0], device=page_table.device)
    logical = torch.where(active, lengths // page_size, 0).clamp(max=ppseq - 1)
    pid = torch.where(active, page_table[s_idx, logical].long(), TRASH_PAGE)
    slot = torch.where(active, lengths % page_size, 0)
    return pid, slot


def write_token_kv(
    pool: torch.Tensor,
    new: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    active: torch.Tensor,
) -> torch.Tensor:
    """Write one step's K (or V) rows into their page slots, in place.

    ``pool`` (P, ps, Hkv, hd); ``new`` (S, Hkv, 1, hd) — this step's row
    per slot; ``page_table`` (S, pages_per_seq) int32; ``lengths`` (S,)
    int32 — tokens already cached per slot (the write position);
    ``active`` (S,) bool.  Inactive slots write row 0 of the trash page
    (:func:`token_slots`).  Returns ``pool``."""
    pid, slot = token_slots(page_table, lengths, active, pool.shape[1])
    pool[pid, slot] = new[:, :, 0, :].to(pool.dtype)
    return pool


def write_prompt_kv(
    pool: torch.Tensor, rows: torch.Tensor, pages: torch.Tensor
) -> torch.Tensor:
    """Write a prefilled prompt's rows into a sequence's pages, in place.

    ``rows`` (cap, Hkv, hd) — the sequence's cache rows padded to its
    full page capacity ``cap = len(pages) * page_size``; ``pages``
    (n_pages_seq,) int32 physical ids (tail entries may be the trash page
    — overwriting it is harmless by design).  Returns ``pool``."""
    n_pg = pages.shape[0]
    ps = pool.shape[1]
    if rows.shape[0] != n_pg * ps:
        raise ValueError(
            f"rows cover {rows.shape[0]} tokens, pages cover {n_pg * ps}"
        )
    paged = rows.reshape(n_pg, ps, *rows.shape[1:]).to(pool.dtype)
    pool.index_copy_(0, pages.long(), paged)
    return pool


def gather_kv(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Per-sequence contiguous KV views in the dense-cache orientation:
    ``pool`` (P, ps, Hkv, hd), ``page_table`` (S, n_pg) ->
    ``(S, Hkv, n_pg * ps, hd)``.  Unallocated entries gather the trash
    page; its rows are masked by the caller's per-sequence lengths."""
    S, n_pg = page_table.shape
    ps, hkv, hd = pool.shape[1], pool.shape[2], pool.shape[3]
    pages = pool.index_select(0, page_table.reshape(-1).long())
    view = pages.reshape(S, n_pg, ps, hkv, hd)
    return view.permute(0, 3, 1, 2, 4).reshape(S, hkv, n_pg * ps, hd)


def gather_kv_flat(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Token-major per-sequence view ``(S, n_pg * ps, Hkv, hd)``: the
    same gather as :func:`gather_kv` without the transpose."""
    S, n_pg = page_table.shape
    ps, hkv, hd = pool.shape[1], pool.shape[2], pool.shape[3]
    pages = pool.index_select(0, page_table.reshape(-1).long())
    return pages.reshape(S, n_pg * ps, hkv, hd)


def paged_param_bytes(
    n_layers: int,
    n_pages: int,
    page_size: int,
    n_kv_heads: int,
    head_dim: int,
    dtype: Any,
    slots: int,
    pages_per_seq: int,
) -> Dict[str, int]:
    """Byte sizes of every paged-cache param the decode DAG declares."""
    per_pool = pool_bytes_per_layer(
        n_pages, page_size, n_kv_heads, head_dim, dtype
    ) // 2
    out: Dict[str, int] = {}
    for i in range(n_layers):
        out[f"cache_k_{i}"] = per_pool
        out[f"cache_v_{i}"] = per_pool
    out["page_table"] = slots * pages_per_seq * 4
    return out


__all__ = [
    "DEFAULT_PAGE_SIZE",
    "OWNERSHIP_SCHEMA",
    "TRASH_PAGE",
    "PageOwnershipLog",
    "PagePool",
    "pages_needed",
    "prefix_chunk_keys",
    "pool_bytes_per_layer",
    "init_paged_kv",
    "page_table_array",
    "token_slots",
    "write_token_kv",
    "write_prompt_kv",
    "gather_kv",
    "gather_kv_flat",
    "paged_param_bytes",
]
