"""Pass — page-lifetime prover (PGL001-PGL007).

Replays the append-only ownership event stream recorded by the
:class:`~..models.kv_pages.PageOwnershipLog` seam against a REF-COUNTED
ownership lattice.  Three event families interleave in the stream:

* pool-level ``alloc`` / ``free`` — emitted by :class:`~..models.
  kv_pages.PagePool` itself, carrying the post-event free/used counts
  (the tiling witness: ``free + used`` must equal ``n_pages - 1``,
  page 0 being the reserved trash page);
* pool-level ``share`` / ``unshare`` — prefix-sharing reference
  traffic: a reference taken on (dropped from) an already-allocated
  page, carrying the post-event refcounts AND the (unchanged)
  free/used counts, so the physical tiling witness extends across
  aliasing;
* engine-level ``assign`` / ``release`` / ``cow`` / ``write`` —
  emitted by :class:`~..backends.decode_loop.PagedDecodeEngine` at its
  lifecycle edges (admit / retire / preempt / reset) and at
  copy-on-write splits, attributing each page to the owning request
  id(s).  Under sharing these carry the live refcounts too.

The lattice each PHYSICAL page moves through is ``unallocated →
allocated (refcount 1) → owned (by up to refcount requests) → released
→ unallocated``; any edge skipped or repeated is a diagnostic:

======  ==========================================================
PGL001  orphaned page: allocated but never freed (end-of-log), with
        the exact alloc event and last owner rid + site
PGL002  double-free: ``free`` of a page not currently allocated
PGL003  use-after-free hazard: ``free`` of a page whose owner never
        released it (the page table still references it)
PGL004  the reserved trash page crossed the allocator
PGL005  accounting mismatch: the free list + allocated set stop
        tiling the pool, or the ownership protocol itself is violated
        (assign of an unallocated page, more live owners than
        references, release by a non-owner, unknown event kind)
PGL006  refcount underflow/overflow: ``unshare`` that would drop an
        allocated page's count below one, ``free`` of a page other
        requests still reference, or a carried ``refcounts`` witness
        disagreeing with the replayed count
PGL007  copy-on-write violation: a ``write`` on a page with
        refcount > 1 and no preceding split (aliased readers would
        observe it), or a ``cow`` split whose destination was not
        allocated before the source reference was dropped
======  ==========================================================

A shared page with any live owner is NOT an orphan — PGL001 is judged
over physical pages after the last reference drops.

This is exactly how the ``_LeakyPool`` soak injector is caught
statically: the wrapper withholds pages *between* the engine's
``release`` and the inner pool's ``free``, so the withheld page shows an
``alloc``/``assign`` pair with no matching ``free`` — PGL001 with the
owning rid and alloc site, no hour of soak required.

:func:`analyze_serve_artifact` applies the same gate offline to a
committed ``dls.serve/1`` / ``dls.soak/1`` artifact (the ``doctor
--serve`` path).

The PyTorch port's copy of ``distributed_llm_scheduler_tpu.analysis.
page_pass``, whole (framework-free).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

from ..models.kv_pages import TRASH_PAGE
from .diagnostics import AnalysisReport, Severity


def _events_of(source: Any) -> List[Dict[str, Any]]:
    """Normalize a PageOwnershipLog, its ``snapshot()`` dict, or a bare
    event list into the event list."""
    if source is None:
        return []
    events = getattr(source, "events", None)
    if events is not None:
        return list(events)
    if isinstance(source, dict):
        return list(source.get("events", []))
    return list(source)


def _n_pages_of(source: Any, n_pages: Optional[int]) -> Optional[int]:
    if n_pages is not None:
        return int(n_pages)
    got = getattr(source, "n_pages", None)
    if got is None and isinstance(source, dict):
        got = source.get("n_pages")
    return int(got) if got is not None else None


def analyze_pages(
    source: Any,
    *,
    n_pages: Optional[int] = None,
    final: bool = True,
) -> AnalysisReport:
    """Replay an ownership event stream; one diagnostic per violation.

    ``source``: a ``PageOwnershipLog``, its ``snapshot()`` dict
    (``dls.pages/1``), or a raw event list.  ``n_pages`` (pool size
    incl. the trash page) enables the tiling check; it is read off the
    source when not given.  ``final=False`` suppresses the end-of-log
    orphan scan (PGL001) for streams snapshotted mid-run.
    """
    rep = AnalysisReport()
    events = _events_of(source)
    pool_pages = _n_pages_of(source, n_pages)

    # page -> seq of the alloc event currently covering it
    allocated: Dict[int, int] = {}
    # page -> replayed reference count (alloc -> 1)
    rc: Dict[int, int] = {}
    # page -> {owner rid: (site, assign seq)} while owners are live
    owner_of: Dict[int, Dict[Any, tuple]] = {}
    # page -> (owner rid, site, assign seq) surviving release, for
    # orphan attribution at end-of-log
    last_owner: Dict[int, tuple] = {}

    def _check_rc(ev: Dict[str, Any], seq: Any, kind: Any) -> None:
        """Carried ``refcounts`` witness vs the replayed counts: the
        pool's own accounting must agree with the event stream
        (disagreement == an under/overflowed counter, PGL006)."""
        carried = ev.get("refcounts")
        if carried is None:
            return
        for p, want in zip(ev.get("pages", ()), carried):
            if p == TRASH_PAGE:
                continue
            got = rc.get(p)
            if got is not None and got != want:
                rep.add(
                    "PGL006",
                    Severity.ERROR,
                    f"event {seq} ({kind}): page {p} carries refcount "
                    f"{want} but the event stream replays to {got}",
                    data={"page": p, "event": seq, "carried": want,
                          "replayed": got},
                )

    for ev in events:
        seq = ev.get("seq")
        kind = ev.get("kind")
        pages = ev.get("pages", ())
        owner = ev.get("owner")
        site = ev.get("site")

        if TRASH_PAGE in pages:
            rep.add(
                "PGL004",
                Severity.ERROR,
                f"event {seq} ({kind}) touches the reserved trash page "
                f"{TRASH_PAGE}",
                data={"event": seq, "kind": kind},
            )

        if kind == "alloc":
            for p in pages:
                if p == TRASH_PAGE:
                    continue
                if p in allocated:
                    rep.add(
                        "PGL005",
                        Severity.ERROR,
                        f"event {seq}: page {p} allocated twice without "
                        f"an intervening free (first at event "
                        f"{allocated[p]})",
                        data={"page": p, "event": seq},
                    )
                allocated[p] = seq
                rc[p] = 1
            _check_rc(ev, seq, kind)
        elif kind == "assign":
            for p in pages:
                if p == TRASH_PAGE:
                    continue
                if p not in allocated:
                    rep.add(
                        "PGL005",
                        Severity.ERROR,
                        f"event {seq}: page {p} assigned to "
                        f"{owner!r} without a covering alloc",
                        task=owner,
                        data={"page": p, "owner": owner, "event": seq},
                    )
                live = owner_of.setdefault(p, {})
                if owner not in live and len(live) >= rc.get(p, 1):
                    prev = next(iter(live))
                    rep.add(
                        "PGL005",
                        Severity.ERROR,
                        f"event {seq}: page {p} assigned to {owner!r} "
                        f"while still owned by {prev!r} "
                        f"(assigned at event {live[prev][1]}) with only "
                        f"{rc.get(p, 1)} reference(s)",
                        task=owner,
                        data={"page": p, "owner": owner,
                              "prev_owner": prev},
                    )
                live[owner] = (site, seq)
                last_owner[p] = (owner, site, seq)
            _check_rc(ev, seq, kind)
        elif kind == "release":
            _check_rc(ev, seq, kind)  # carries pre-drop counts
            for p in pages:
                if p == TRASH_PAGE:
                    continue
                live = owner_of.get(p) or {}
                if not live:
                    rep.add(
                        "PGL005",
                        Severity.ERROR,
                        f"event {seq}: {owner!r} releases page {p} "
                        f"({site}) which has no live owner",
                        task=owner,
                        data={"page": p, "owner": owner, "event": seq},
                    )
                elif owner not in live:
                    other = next(iter(live))
                    rep.add(
                        "PGL005",
                        Severity.ERROR,
                        f"event {seq}: {owner!r} releases page {p} "
                        f"({site}) owned by {other!r}",
                        task=owner,
                        data={"page": p, "owner": owner,
                              "live_owner": other},
                    )
                else:
                    live.pop(owner)
                if not live:
                    owner_of.pop(p, None)
        elif kind == "share":
            for p in pages:
                if p == TRASH_PAGE:
                    continue
                if p not in allocated:
                    rep.add(
                        "PGL005",
                        Severity.ERROR,
                        f"event {seq}: reference taken on page {p} "
                        "without a covering alloc",
                        data={"page": p, "event": seq},
                    )
                rc[p] = rc.get(p, 0) + 1
            _check_rc(ev, seq, kind)  # carries post-increment counts
        elif kind == "unshare":
            for p in pages:
                if p == TRASH_PAGE:
                    continue
                if p not in allocated:
                    rep.add(
                        "PGL005",
                        Severity.ERROR,
                        f"event {seq}: reference dropped from page {p} "
                        "without a covering alloc",
                        data={"page": p, "event": seq},
                    )
                cur = rc.get(p, 1)
                if cur <= 1:
                    rep.add(
                        "PGL006",
                        Severity.ERROR,
                        f"event {seq}: unshare of page {p} with "
                        f"refcount {cur} would underflow (the last "
                        "reference must free, not unshare)",
                        data={"page": p, "event": seq, "refcount": cur},
                    )
                rc[p] = cur - 1
            _check_rc(ev, seq, kind)  # carries post-decrement counts
        elif kind == "cow":
            _check_rc(ev, seq, kind)
            if len(pages) != 2:
                rep.add(
                    "PGL007",
                    Severity.ERROR,
                    f"event {seq}: cow split must name [src, dst], got "
                    f"{list(pages)!r}",
                    task=owner,
                    data={"event": seq, "pages": list(pages)},
                )
            else:
                src, dst = pages
                for which, p in (("source", src), ("destination", dst)):
                    if p != TRASH_PAGE and p not in allocated:
                        rep.add(
                            "PGL007",
                            Severity.ERROR,
                            f"event {seq}: cow split {which} page {p} "
                            "is not allocated (the split must "
                            "alloc-before-release)",
                            task=owner,
                            data={"page": p, "event": seq,
                                  "role": which},
                        )
                # the split retargets the writer: ownership of src
                # transfers to dst, the shared reference on src is
                # dropped by the unshare that follows
                live = owner_of.get(src) or {}
                if owner not in live:
                    rep.add(
                        "PGL005",
                        Severity.ERROR,
                        f"event {seq}: {owner!r} cow-splits page {src} "
                        "without owning it",
                        task=owner,
                        data={"page": src, "owner": owner, "event": seq},
                    )
                else:
                    live.pop(owner)
                    if not live:
                        owner_of.pop(src, None)
                owner_of.setdefault(dst, {})[owner] = (site, seq)
                last_owner[dst] = (owner, site, seq)
        elif kind == "write":
            _check_rc(ev, seq, kind)
            for p in pages:
                if p == TRASH_PAGE:
                    continue
                if p not in allocated:
                    rep.add(
                        "PGL005",
                        Severity.ERROR,
                        f"event {seq}: {owner!r} writes page {p} "
                        "without a covering alloc",
                        task=owner,
                        data={"page": p, "owner": owner, "event": seq},
                    )
                    continue
                cur = rc.get(p, 1)
                if cur > 1:
                    rep.add(
                        "PGL007",
                        Severity.ERROR,
                        f"event {seq}: {owner!r} writes page {p} "
                        f"({site}) with refcount {cur} and no cow "
                        "split — aliased readers would observe the "
                        "write",
                        task=owner,
                        data={"page": p, "owner": owner, "event": seq,
                              "refcount": cur},
                    )
        elif kind == "free":
            for p in pages:
                if p == TRASH_PAGE:
                    continue
                if p not in allocated:
                    rep.add(
                        "PGL002",
                        Severity.ERROR,
                        f"event {seq}: double-free of page {p} "
                        "(not currently allocated)",
                        data={"page": p, "event": seq},
                    )
                    continue
                cur = rc.get(p, 1)
                if cur > 1:
                    rep.add(
                        "PGL006",
                        Severity.ERROR,
                        f"event {seq}: page {p} freed with refcount "
                        f"{cur} — other requests still reference it",
                        data={"page": p, "event": seq, "refcount": cur},
                    )
                live = owner_of.get(p) or {}
                if live:
                    first = next(iter(live))
                    rep.add(
                        "PGL003",
                        Severity.ERROR,
                        f"event {seq}: page {p} freed while still "
                        f"referenced by live owner {first!r}'s page "
                        f"table (assigned at event {live[first][1]})",
                        task=first,
                        data={"page": p, "owner": first,
                              "event": seq},
                    )
                    owner_of.pop(p, None)
                allocated.pop(p, None)
                rc.pop(p, None)
        else:
            rep.add(
                "PGL005",
                Severity.ERROR,
                f"event {seq}: unknown event kind {kind!r}",
                data={"event": seq, "kind": kind},
            )

        # tiling witness: pool-level events carry post-event counts
        # (share/unshare carry them too — aliasing must leave the
        # physical free/used split untouched)
        if kind in ("alloc", "free", "share", "unshare") \
                and pool_pages is not None:
            free_ct = ev.get("free_pages")
            used_ct = ev.get("used_pages")
            if free_ct is not None and used_ct is not None:
                if free_ct + used_ct != pool_pages - 1:
                    rep.add(
                        "PGL005",
                        Severity.ERROR,
                        f"event {seq}: free ({free_ct}) + used "
                        f"({used_ct}) pages do not tile the pool "
                        f"({pool_pages - 1} usable)",
                        data={"event": seq, "free": free_ct,
                              "used": used_ct},
                    )
                if used_ct != len(allocated):
                    rep.add(
                        "PGL005",
                        Severity.ERROR,
                        f"event {seq}: pool reports {used_ct} pages "
                        f"used but the event stream accounts for "
                        f"{len(allocated)}",
                        data={"event": seq, "used": used_ct,
                              "replayed": len(allocated)},
                    )

    if final:
        for p in sorted(allocated):
            who = last_owner.get(p)
            if who is not None:
                owner, site, aseq = who
                rep.add(
                    "PGL001",
                    Severity.ERROR,
                    f"orphaned page {p}: allocated at event "
                    f"{allocated[p]} for request {owner!r} "
                    f"(site={site}, assign event {aseq}) and never "
                    "freed",
                    task=owner,
                    data={"page": p, "owner": owner, "site": site,
                          "alloc_event": allocated[p]},
                )
            else:
                rep.add(
                    "PGL001",
                    Severity.ERROR,
                    f"orphaned page {p}: allocated at event "
                    f"{allocated[p]} and never freed (no recorded "
                    "owner)",
                    data={"page": p, "alloc_event": allocated[p]},
                )
    return rep


def analyze_serve_artifact(art: Dict[str, Any]) -> AnalysisReport:
    """Offline gate over a committed ``dls.serve/1`` or ``dls.soak/1``
    artifact: re-checks the page-leak counters, replays any embedded
    ownership event stream, and lints any embedded request rows through
    the lifecycle pass.  Raises :class:`ValueError` on an unknown
    schema (the ``doctor --serve`` exit-2 path).
    """
    from .lifecycle_pass import analyze_lifecycle

    rep = AnalysisReport()
    schema = art.get("schema")
    if schema == "dls.serve/1":
        legs = dict(art.get("legs", {}))
        for name, body in art.get("prefix", {}).get("legs", {}).items():
            legs[f"prefix.{name}"] = body
        for leg, body in legs.items():
            leaked = body.get("pages_leaked", 0)
            if leaked:
                rep.add(
                    "PGL001",
                    Severity.ERROR,
                    f"leg {leg!r}: artifact reports {leaked} leaked "
                    "page(s); events are not embedded — run "
                    "`lint --serving` for per-page attribution",
                    task=leg,
                    data={"leg": leg, "pages_leaked": leaked},
                )
            if "page_events" in body:
                rep.extend(analyze_pages(body["page_events"]))
            if "requests" in body:
                rep.extend(
                    analyze_lifecycle(
                        body["requests"], final=True, label=leg
                    )
                )
    elif schema == "dls.soak/1":
        serving = art.get("serving", {})
        leaked = serving.get("pages_leaked", 0)
        if leaked:
            rep.add(
                "PGL001",
                Severity.ERROR,
                f"soak artifact reports {leaked} leaked page(s)",
                data={"pages_leaked": leaked},
            )
        if "page_events" in serving:
            rep.extend(analyze_pages(serving["page_events"]))
        if "requests" in serving:
            rep.extend(
                analyze_lifecycle(
                    serving["requests"], final=True, label="soak"
                )
            )
    else:
        raise ValueError(
            f"not a serve/soak artifact (schema={schema!r}; expected "
            "dls.serve/1 or dls.soak/1)"
        )
    return rep
