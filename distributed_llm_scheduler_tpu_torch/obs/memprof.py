"""Measured per-device HBM timelines: the memory half of the run doctor.

The span tracer and the critical-path attribution measure the *time*
domain.  This module is the symmetric *memory* domain: a
:class:`MemoryProfiler` receives allocation/free events from the
instrumented backends — param placement and slab sizes
(``backends/device._array_bytes``), task-output births, the deaths the
JAX plan's donation lifetimes give (``DispatchPlan`` ``mem_frees``),
cross-device transfers, and KV page-pool occupancy
(``backends/decode_loop``) — and maintains one byte-exact timeline per
device.

On top of the timeline:

* **watermark attribution** — the exact live-buffer set at each
  device's peak, bucketed ``params`` / ``activations`` / ``kv_pages`` /
  ``transfers``.  The analog of ``obs/attribution.py``'s "tiles the
  makespan exactly" invariant: bucket sums equal the peak, and the
  live-set byte sum equals the timeline value at *every* event
  (:meth:`MemoryProfiler.verify` recomputes both from the raw event log
  alone, so golden tests assert the invariant against an independent
  replay, not against the bookkeeping that produced it);
* **platform reconciliation** — on a card the allocator's peak
  (``torch.cuda.max_memory_allocated``) sits next to the model-derived
  one with their ratio; on the CPU, which has no allocator peak, the
  model-derived bytes stand alone, explicitly labeled
  (``source: "model"``).

Design rules inherited from the tracer (``obs/trace.py``):

* **Zero overhead when off.**  There is no no-op profiler object; every
  instrumented hot path guards with ``if mem is not None`` and records
  nothing otherwise.
* **Injectable clock.**  Golden tests drive a fake clock and assert
  exact timelines; default is ``time.perf_counter`` — the same timebase
  as the tracer, so memory samples land on the run's unified timeline.
* **Recording must never break a run.**  ``free`` of an unknown label
  and re-``alloc`` of a live label (the rep loop re-bearing the same
  task outputs) are defined, not errors: the former is a no-op, the
  latter replaces the previous buffer (its bytes are released first).

When constructed with a ``tracer``, every event also emits a
``mem.hbm_bytes.<device>`` counter sample — each device gets its own
Perfetto counter track through the existing exporter, viewable next to
the span rows at ui.perfetto.dev.

The PyTorch port's copy of ``distributed_llm_scheduler_tpu.obs.memprof``: framework-free,
so the port keeps it without importing the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from .clockutil import resolve_clock

#: watermark attribution buckets, in render order
BUCKETS = ("params", "activations", "kv_pages", "transfers")

#: counter-track prefix (one Perfetto row per device)
COUNTER_PREFIX = "mem.hbm_bytes."


class MemoryProfiler:
    """Append-only allocation/free recorder with per-device timelines.

    Events are dicts on one list (the golden-test replay surface):

    * ``alloc``: {kind, device, label, bucket, bytes, t, total}
    * ``free``:  {kind, device, label, bucket, bytes, t, total}

    ``total`` is the device's live-byte sum *after* the event — the
    timeline value.  ``bytes`` is always the positive buffer size; the
    sign lives in ``kind``.  Not thread-safe, same as the tracer: the
    dispatch loop and the decode engine are single-threaded host code.
    """

    def __init__(
        self,
        clock: Optional[Callable[[], float]] = None,
        tracer: Any = None,
    ):
        self.clock: Callable[[], float] = resolve_clock(clock)
        self.tracer = tracer
        self.events: List[Dict[str, Any]] = []
        # device -> {label: (bytes, bucket)} — the live set
        self._live: Dict[str, Dict[str, Tuple[int, str]]] = {}
        self._cur: Dict[str, int] = {}
        self._peak: Dict[str, int] = {}
        self._peak_t: Dict[str, float] = {}
        # live-set snapshot at each device's peak (watermark attribution)
        self._peak_live: Dict[str, Dict[str, Tuple[int, str]]] = {}
        # the allocator's peaks, when reconcile() gets any
        self._platform_peak: Dict[str, int] = {}

    # -- recording ---------------------------------------------------------
    def alloc(
        self,
        device: str,
        label: str,
        nbytes: int,
        bucket: str = "activations",
        t: Optional[float] = None,
    ) -> None:
        """A buffer of ``nbytes`` becomes live on ``device``.

        Re-allocating a live label replaces it (the old bytes are
        released in the same event — the rep loop re-bears the same
        outputs under the same labels and must not accumulate).
        """
        nbytes = int(nbytes)
        if nbytes < 0:
            nbytes = 0
        when = self.clock() if t is None else t
        live = self._live.setdefault(device, {})
        prev = live.pop(label, None)
        cur = self._cur.get(device, 0)
        if prev is not None:
            cur -= prev[0]
        live[label] = (nbytes, bucket)
        cur += nbytes
        self._cur[device] = cur
        if cur > self._peak.get(device, -1):
            self._peak[device] = cur
            self._peak_t[device] = when
            self._peak_live[device] = dict(live)
        self.events.append({
            "kind": "alloc", "device": device, "label": label,
            "bucket": bucket, "bytes": nbytes, "t": when, "total": cur,
            **({"replaced": prev[0]} if prev is not None else {}),
        })
        if self.tracer is not None:
            self.tracer.counter(COUNTER_PREFIX + device, cur, t=when)

    def free(
        self, device: str, label: str, t: Optional[float] = None,
    ) -> int:
        """The buffer behind ``label`` dies; returns its size (0 and a
        no-op when the label is not live — a donated buffer the
        profiler never saw born must not corrupt the timeline)."""
        live = self._live.get(device)
        if not live or label not in live:
            return 0
        when = self.clock() if t is None else t
        nbytes, bucket = live.pop(label)
        cur = self._cur.get(device, 0) - nbytes
        self._cur[device] = cur
        self.events.append({
            "kind": "free", "device": device, "label": label,
            "bucket": bucket, "bytes": nbytes, "t": when, "total": cur,
        })
        if self.tracer is not None:
            self.tracer.counter(COUNTER_PREFIX + device, cur, t=when)
        return nbytes

    # -- introspection -----------------------------------------------------
    def devices(self) -> List[str]:
        return sorted(self._cur)

    def live_bytes(self, device: str) -> int:
        return self._cur.get(device, 0)

    def peak(self, device: str) -> Tuple[int, Optional[float]]:
        return self._peak.get(device, 0), self._peak_t.get(device)

    def timeline(self, device: str) -> List[Tuple[float, int]]:
        """``(t, live_total_bytes)`` per event on ``device``."""
        return [
            (ev["t"], ev["total"]) for ev in self.events
            if ev["device"] == device
        ]

    def watermark(self, device: str) -> Dict[str, Any]:
        """The live-buffer set at the device's peak, bucketed.  Bucket
        sums tile the peak exactly by construction; :meth:`verify`
        re-derives the same from the raw event log."""
        live = self._peak_live.get(device, {})
        buckets = {b: 0 for b in BUCKETS}
        for nbytes, bucket in live.values():
            buckets[bucket] = buckets.get(bucket, 0) + nbytes
        top = sorted(
            ((lbl, nb, bk) for lbl, (nb, bk) in live.items()),
            key=lambda x: (-x[1], x[0]),
        )
        return {
            "peak_bytes": self._peak.get(device, 0),
            "peak_t": self._peak_t.get(device),
            "buckets": buckets,
            "n_live": len(live),
            "live_top": [
                {"label": lbl, "bytes": nb, "bucket": bk}
                for lbl, nb, bk in top[:10]
            ],
        }

    def task_output_bytes(self) -> Dict[str, int]:
        """Last observed ``out:<tid>`` birth size per task (the per-task
        measured footprint memdrift compares against
        ``memory_required``)."""
        out: Dict[str, int] = {}
        for ev in self.events:
            if ev["kind"] == "alloc" and ev["label"].startswith("out:"):
                out[ev["label"][4:]] = ev["bytes"]
        return out

    # -- the invariant -----------------------------------------------------
    def verify(self) -> List[str]:
        """Replay the raw event log independently of the incremental
        bookkeeping; returns problems (empty when the invariant holds):

        * the live-set byte sum equals the recorded timeline ``total``
          at every event;
        * each device's replayed maximum equals the recorded peak, and
          the watermark bucket sums tile that peak exactly.
        """
        errs: List[str] = []
        live: Dict[str, Dict[str, int]] = {}
        peak: Dict[str, int] = {}
        for i, ev in enumerate(self.events):
            dl = live.setdefault(ev["device"], {})
            if ev["kind"] == "alloc":
                dl[ev["label"]] = ev["bytes"]
            else:
                dl.pop(ev["label"], None)
            total = sum(dl.values())
            if total != ev["total"]:
                errs.append(
                    f"events[{i}] ({ev['device']}/{ev['label']}): live-set "
                    f"sum {total} != recorded total {ev['total']}"
                )
            if total > peak.get(ev["device"], -1):
                peak[ev["device"]] = total
        for dev in self.devices():
            want, got = peak.get(dev, 0), self._peak.get(dev, 0)
            if want != got:
                errs.append(
                    f"{dev}: replayed peak {want} != recorded peak {got}"
                )
            wm = self.watermark(dev)
            tiled = sum(wm["buckets"].values())
            if tiled != wm["peak_bytes"]:
                errs.append(
                    f"{dev}: watermark buckets sum {tiled} != peak "
                    f"{wm['peak_bytes']}"
                )
        return errs

    # -- platform reconciliation -------------------------------------------
    def reconcile(self, platform_peaks: Dict[str, int]) -> None:
        """Attach the allocator's peaks (``DeviceReport.peak_hbm_bytes``,
        by node) for the devices that report them; the summary then
        carries both numbers and their ratio.  Devices absent here keep
        the model-derived timeline alone (``source: "model"``)."""
        for dev, nbytes in (platform_peaks or {}).items():
            self._platform_peak[dev] = int(nbytes)

    # -- export ------------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        devices: Dict[str, Any] = {}
        for dev in self.devices():
            wm = self.watermark(dev)
            entry: Dict[str, Any] = {
                "peak_bytes": self._peak.get(dev, 0),
                "current_bytes": self._cur.get(dev, 0),
                "n_events": sum(
                    1 for ev in self.events if ev["device"] == dev
                ),
                "watermark": wm,
                "source": "model",
            }
            plat = self._platform_peak.get(dev)
            if plat is not None:
                entry["platform_peak_bytes"] = plat
                entry["source"] = "platform"
                if entry["peak_bytes"]:
                    entry["platform_ratio"] = plat / entry["peak_bytes"]
            devices[dev] = entry
        return {
            "schema": "dls.memprof/1",
            "buckets": list(BUCKETS),
            "devices": devices,
        }

    def __len__(self) -> int:
        return len(self.events)


__all__ = ["BUCKETS", "COUNTER_PREFIX", "MemoryProfiler"]
