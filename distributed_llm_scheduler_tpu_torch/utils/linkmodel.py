"""Measured link model: calibrate transfer bandwidth/latency, persist, apply.

PyTorch port of ``distributed_llm_scheduler_tpu.utils.linkmodel``.  The
replay's :class:`~..backends.sim.LinkModel` charges parameter loads and
cross-node activations by bandwidth and latency; this module measures
what the device backend pays on the card:

* **param load** (host → device): a CPU tensor copied onto the card with
  ``Tensor.to(device)``, the copy ``DeviceBackend.place_params`` makes for
  a parameter that lives on the host.  The source is pageable host
  memory (not pinned), as a host-side parameter is, so CUDA stages the
  copy through its own pinned buffer;
* **interconnect** (device → device): a tensor on one card copied onto a
  second card (a peer copy over NVLink where the cards have it).  It is
  measured only when two distinct CUDA devices are given; with one card
  (nodes sharing it copy nothing between them) it keeps the H100
  estimate below and says so in its provenance;
* **on the CPU** (CPU devices passed explicitly, as the CPU tests and
  the rank check's CPU legs do): the port's CPU nodes share the host's
  memory and ``Tensor.to`` moves nothing, so both legs time the copy a
  move would make if it copied, a host ``Tensor.clone`` on the host
  clock — a conservative charge, never an erased one;
* **sustained** (host → device, ``calibrate_link(sustained=True)``): a
  back-to-back train of copies timed as one window, the copy the
  parameter streamer issues (``backends.device._ParamStreamer``): from
  pinned host memory, ``non_blocking``, on the card's copy stream.  It is
  the floor of a streamed run, which moves hundreds of MB back to back.

Each copy is timed with CUDA events on the stream that runs it, best of
``repeats`` per size, with a fresh source tensor every repeat.  The
bandwidth is the slope of a least-squares fit of the size sweep to
``t(bytes) = latency + bytes / bandwidth``, the form ``LinkModel``
charges; the latency is the best time of the sweep's smallest copy
(:func:`_fixed_cost`), not the fit's intercept.  A measurement that
fails raises: it never turns into the estimate.
"""

from __future__ import annotations
# dls-lint: allow-file(DET001) link calibration measures real transfer time

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Estimates for a leg that cannot be measured, in the package's GB
# (2**30 bytes) per second.  NVIDIA H100 SXM5 data sheet: NVLink 4 moves
# 900 GB/s (10**9 bytes) per card, 450 GB/s each way; the host link is
# PCIe Gen5 x16, 128 GB/s, 64 GB/s each way.
EST_ICI_GBPS = 450e9 / 1024**3
EST_HOST_GBPS = 64e9 / 1024**3
EST_ICI = "estimated(h100 nvlink4 450GB/s each way)"
EST_HOST = "estimated(h100 pcie gen5 x16 64GB/s each way)"

_SIZES = (1 << 10, 1 << 14, 1 << 18, 1 << 22, 1 << 25, 1 << 26)


def _fit_affine(samples: Sequence[Tuple[int, float]]) -> Tuple[float, float]:
    """Least-squares fit of t = latency + bytes/bandwidth.

    Returns (latency_s, bandwidth_gbps); latency clamped non-negative and
    bandwidth positive (tiny-transfer noise can otherwise produce a negative
    intercept or slope).
    """
    n = len(samples)
    xs = [b for b, _ in samples]
    ys = [t for _, t in samples]
    mx = sum(xs) / n
    my = sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    slope = sxy / sxx if sxx > 0 else 0.0
    if slope <= 0:
        # Noise made the fit non-monotonic.  An infinite bandwidth here
        # would silently zero every transfer charge downstream, so take a
        # degraded two-point estimate: latency from the fastest sample,
        # bandwidth from the largest sample net of that latency — both
        # finite and conservative (transfers over-charged, never erased).
        b_max, t_max = max(samples, key=lambda s: s[0])
        lat = max(min(ys), 0.0)
        if t_max > lat and b_max > 0:
            return lat, (b_max / (t_max - lat)) / 1024**3
        if t_max > 0 and b_max > 0:
            return 0.0, (b_max / t_max) / 1024**3
        return max(my, 0.0), float("inf")
    lat = max(my - slope * mx, 0.0)
    gbps = (1.0 / slope) / 1024**3
    return lat, gbps


def _fixed_cost(samples: Sequence[Tuple[int, float]]) -> float:
    """A copy's fixed cost: the best time of the sweep's smallest copies
    (1 KB, whose bytes take a small fraction of it at these rates).

    The affine fit's intercept is not used for it: over 1 KB-64 MB the
    least-squares line is set by the large copies, and its intercept
    swings around 0 by more than the fixed cost itself, so it clamps to 0.
    """
    smallest = min(b for b, _ in samples)
    return min(t for b, t in samples if b == smallest)


@dataclass
class LinkCalibration:
    """Measured (or estimated) link parameters, with provenance per leg."""

    platform: str
    param_load_gbps: float = EST_HOST_GBPS
    interconnect_gbps: float = EST_ICI_GBPS
    # no estimate: calibrate_link always measures it on the host leg
    latency_s: float = 0.0
    # last known HEALTHY measured host rate: survives a degraded-window
    # save, so the degradation guard keeps a baseline to compare future
    # calibrations against (otherwise one degraded save would blind it)
    baseline_gbps: Optional[float] = None
    provenance: Dict[str, str] = field(
        default_factory=lambda: {
            "param_load": EST_HOST,
            "interconnect": EST_ICI,
        }
    )
    samples: Dict[str, List[List[float]]] = field(default_factory=dict)
    measured_at: str = ""
    # GB/s of a back-to-back train of pinned, asynchronous copies on the
    # streamer's copy stream (calibrate_link(sustained=True)); None until
    # measured
    sustained_gbps: Optional[float] = None

    def to_link_model(self):
        from ..backends.sim import LinkModel

        return LinkModel(
            param_load_gbps=self.param_load_gbps,
            interconnect_gbps=self.interconnect_gbps,
            latency_s=self.latency_s,
        )

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(
                {
                    "platform": self.platform,
                    "param_load_gbps": self.param_load_gbps,
                    "interconnect_gbps": self.interconnect_gbps,
                    "latency_s": self.latency_s,
                    "provenance": self.provenance,
                    "samples": self.samples,
                    "measured_at": self.measured_at,
                    "baseline_gbps": self.baseline_gbps,
                    "sustained_gbps": self.sustained_gbps,
                },
                f,
                indent=1,
            )
        return path

    @classmethod
    def load(cls, path: str) -> "LinkCalibration":
        with open(path) as f:
            d = json.load(f)
        return cls(
            platform=d["platform"],
            param_load_gbps=d["param_load_gbps"],
            interconnect_gbps=d["interconnect_gbps"],
            latency_s=d["latency_s"],
            provenance=d.get("provenance", {}),
            samples=d.get("samples", {}),
            measured_at=d.get("measured_at", ""),
            baseline_gbps=d.get("baseline_gbps"),
            sustained_gbps=d.get("sustained_gbps"),
        )


def _time_transfer(make_src, dst, repeats: int) -> float:
    """Best-of-``repeats`` seconds for one ``make_src().to(dst)``, between
    CUDA events on the stream that runs the copy: the destination's for a
    host source, the source card's for a peer copy (PyTorch runs a copy
    between two cards on the source's stream).  The source is rebuilt each
    round so no repeat can reuse the last one's copy."""
    import torch

    best = float("inf")
    for _ in range(repeats):
        src = make_src()
        on = src.device if src.device.type == "cuda" else dst
        stream = torch.cuda.current_stream(on)
        torch.cuda.synchronize(on)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = src.to(dst)
        end.record(stream)
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
        del out, src
    return best


def _time_host_copy(make_src, repeats: int) -> float:
    """Best-of-``repeats`` host-clock seconds for one ``Tensor.clone`` of
    a fresh ``make_src()``: the CPU legs' copy."""
    best = float("inf")
    for _ in range(repeats):
        src = make_src()
        t0 = time.perf_counter()
        out = src.clone()
        best = min(best, time.perf_counter() - t0)
        del out, src
    return best


def _calibrate_host(devices, sizes: Sequence[int], repeats: int
                    ) -> LinkCalibration:
    """CPU nodes: one sweep of host copies stands for the param-load leg
    and, with two or more nodes, the interconnect leg (module
    docstring)."""
    import numpy as np
    import torch

    _time_host_copy(lambda: torch.ones(1024, dtype=torch.uint8), 1)
    samples: List[Tuple[int, float]] = []
    for size in sizes:
        arr = np.random.default_rng(0).integers(0, 255, size, np.uint8)
        samples.append((size, _time_host_copy(
            lambda a=arr: torch.from_numpy(a.copy()), repeats)))
    _, gbps = _fit_affine(samples)
    cal = LinkCalibration(platform="cpu", latency_s=_fixed_cost(samples))
    legs = ["param_load"] + (["interconnect"] if len(devices) >= 2 else [])
    for leg in legs:
        setattr(cal, f"{leg}_gbps", gbps)
        cal.provenance[leg] = "measured(host copy)"
        cal.samples[leg] = [[b, t] for b, t in samples]
    from .costmodel import _utc_stamp

    cal.measured_at = _utc_stamp()
    return cal


def calibrate_link(
    devices: Optional[Sequence[Any]] = None,
    sizes: Sequence[int] = _SIZES,
    repeats: int = 5,
    sustained: bool = False,
) -> LinkCalibration:
    """Measure host->card and card->card copy costs.

    ``devices``: CUDA devices (default: every visible one), or CPU
    devices passed explicitly (both legs then time host copies, module
    docstring).  The first is the host-load target; the first two form
    the interconnect pair when they are two distinct cards (nodes sharing
    one card copy nothing between them).  One warm-up copy per leg
    absorbs one-time CUDA and allocator set-up before timing.  Raises
    when none are given and there is no card, and on a list that mixes
    the CPU and cards.

    ``sustained=True`` also times a back-to-back train of host->card
    copies as the parameter streamer issues them (pinned source,
    ``non_blocking``, on the card's copy stream): 8 buffers of the largest
    size (at most 16 MB), between two events on that stream, best of 2
    windows with fresh buffers each, into ``sustained_gbps``.
    """
    import numpy as np
    import torch

    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if devices and all(d.type == "cpu" for d in devices):
        if sustained:
            raise ValueError("the sustained leg times a card's copy stream; "
                             "CPU devices have none")
        return _calibrate_host(devices, sizes, repeats)
    if not devices or any(d.type != "cuda" for d in devices):
        raise RuntimeError(
            f"calibrate_link measures CUDA devices (or CPU devices passed "
            f"explicitly) only, got {devices}"
        )
    dev0 = devices[0]
    cal = LinkCalibration(platform=dev0.type)

    # host -> device (param load leg)
    host_samples: List[Tuple[int, float]] = []
    torch.ones(1024, dtype=torch.uint8).to(dev0)
    torch.cuda.synchronize(dev0)
    for size in sizes:
        arr = np.random.default_rng(0).integers(0, 255, size, dtype=np.uint8)
        t = _time_transfer(lambda a=arr: torch.from_numpy(a.copy()), dev0, repeats)
        host_samples.append((size, t))
    _, gbps_h = _fit_affine(host_samples)
    lat_h = _fixed_cost(host_samples)
    cal.param_load_gbps = gbps_h
    cal.provenance["param_load"] = "measured"
    cal.samples["param_load"] = [[s, t] for s, t in host_samples]

    if sustained:
        from ..backends.device import copy_stream

        chunk = min(max(sizes), 16 << 20)
        n_bufs = 8
        cs = copy_stream(dev0)
        with torch.cuda.stream(cs):
            torch.ones(1024, dtype=torch.uint8).pin_memory().to(
                dev0, non_blocking=True)
        windows: List[float] = []
        for w in range(2):
            train = [
                torch.from_numpy(np.random.default_rng(w * n_bufs + r).integers(
                    0, 255, chunk, dtype=np.uint8)).pin_memory()
                for r in range(n_bufs)
            ]
            torch.cuda.synchronize(dev0)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(cs):
                start.record(cs)
                outs = [a.to(dev0, non_blocking=True) for a in train]
                end.record(cs)
            end.synchronize()
            windows.append(start.elapsed_time(end) / 1e3)
            del outs, train
        t_train = min(windows)
        if t_train <= 0:
            raise RuntimeError(f"sustained link: windows {windows} s")
        cal.sustained_gbps = (n_bufs * chunk) / t_train / 1024**3
        cal.provenance["sustained"] = "measured"
        cal.samples["sustained"] = [[n_bufs * chunk, w] for w in windows]

    # device -> device (interconnect leg) — needs a second card
    lat_d = None
    if len(devices) >= 2 and devices[1] != dev0:
        dev1 = devices[1]
        ici_samples: List[Tuple[int, float]] = []
        torch.ones(1024, dtype=torch.uint8, device=dev0).to(dev1)
        torch.cuda.synchronize(dev1)
        for size in sizes:
            # a distinct source tensor per repeat, made before timing
            pool = [
                torch.from_numpy(
                    np.random.default_rng(r).integers(0, 255, size, np.uint8)
                ).to(dev0)
                for r in range(repeats)
            ]
            it = iter(pool)
            t = _time_transfer(lambda it=it: next(it), dev1, repeats)
            ici_samples.append((size, t))
            del pool
        _, gbps_d = _fit_affine(ici_samples)
        lat_d = _fixed_cost(ici_samples)
        cal.interconnect_gbps = gbps_d
        cal.provenance["interconnect"] = "measured"
        cal.samples["interconnect"] = [[s, t] for s, t in ici_samples]

    # one shared latency: the smaller leg's fixed cost (LinkModel has a
    # single latency knob)
    cal.latency_s = min([lat_h] + ([lat_d] if lat_d is not None else []))
    from .costmodel import _utc_stamp

    cal.measured_at = _utc_stamp()
    return cal


# A fresh measurement this much slower than the cache's healthy measured
# value marks a degraded transfer window (a stall that outlives the whole
# sweep, which best-of-k within the sweep cannot see past)
_DEGRADED_RATIO = 8.0


def _healthy_baseline(prior: Optional[LinkCalibration]) -> Optional[float]:
    """The best known-good measured host rate from a prior calibration:
    ``baseline_gbps`` survives degraded-window saves, so the guard keeps
    working after it trips once."""
    if prior is None:
        return None
    if prior.baseline_gbps and prior.baseline_gbps > 0:
        return prior.baseline_gbps
    if (prior.provenance.get("param_load") == "measured"
            and prior.param_load_gbps > 0):
        return prior.param_load_gbps
    return None


def _looks_degraded(fresh: LinkCalibration,
                    prior: Optional[LinkCalibration]) -> bool:
    base = _healthy_baseline(prior)
    if base is None or fresh.param_load_gbps <= 0:
        return False
    return base / fresh.param_load_gbps > _DEGRADED_RATIO


def calibrate_link_cached(
    cache_dir: str,
    devices: Optional[Sequence[Any]] = None,
    repeats: int = 5,
) -> LinkCalibration:
    """Measure the link now, guarded by the calibration saved in
    ``cache_dir/link_cuda.json``, and save the new one there.

    The saved file is never returned: it only holds the degradation
    guard's baseline.  A fresh measurement more than 8x slower than that
    baseline is taken again after a pause; if it is still slow it is kept,
    and its provenance says so.
    """
    import torch

    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise RuntimeError("calibrate_link_cached: no CUDA device given")
    path = os.path.join(cache_dir, f"link_{devices[0].type}.json")
    prior: Optional[LinkCalibration] = None
    if os.path.exists(path):
        try:
            prior = LinkCalibration.load(path)
        except (OSError, ValueError, KeyError):
            prior = None  # an unreadable cache is no baseline
    cal = calibrate_link(devices, repeats=repeats)
    if _looks_degraded(cal, prior):
        time.sleep(5.0)
        retry = calibrate_link(devices, repeats=repeats)
        if retry.param_load_gbps > cal.param_load_gbps:
            cal = retry
        if _looks_degraded(cal, prior):
            base = _healthy_baseline(prior)
            cal.provenance["param_load"] = (
                f"measured-degraded(cache was {base:.2f}GB/s)"
            )
            cal.baseline_gbps = base
    if cal.provenance.get("param_load") == "measured":
        cal.baseline_gbps = cal.param_load_gbps
    cal.save(path)
    return cal
