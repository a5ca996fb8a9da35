"""Oversubscribed execution: a model bigger than the node's budget, on a card.

PyTorch port of ``distributed_llm_scheduler_tpu.eval.stream_bench``.  The
reference's headline scenario is a 37.5 GB-param model on 28 GB of
laptops (reference ``test_gpt2.py:274-299``) with parameter eviction
(reference ``schedulers.py:404-442``), only ever simulated there.  This
bench makes it physical: one node's parameter budget is capped at a
fraction of the model's parameter bytes and the placement runs with
``stream_params=True`` (prefetched batched loads from pinned host memory,
Belady eviction), so the model runs though its weights never co-reside.
Two more legs take the same budget: segment-fused dispatch, and int8
weights (about half the bytes over the link).

Run on the card::

    python -m distributed_llm_scheduler_tpu_torch.eval.stream_bench [budget_frac]

It prints one JSON dict with the JAX bench's keys: uncapped (every param
resident) against capped and streamed makespans, load and eviction
counts, the ledger's peak resident bytes (which must respect the budget),
the host link's burst and sustained rates and the run's distance to its
floor (``bound_utilization``), and each leg's oracle against the fused
forward.  The uncapped run takes the streamed run's rung (per task), so
the two differ by the streaming alone.  Four keys are the port's own:
``device`` (the card's name), the allocator's peak of each of the two
runs beyond what was allocated before it (``uncapped_peak_hbm_gb``,
``capped_peak_hbm_gb``), and ``launches``, the kernel launches of each
leg.  A failed leg raises and the run exits non-zero.  On the CPU the
link calibration must be injected (``link=``): it is measured only on a
card.
"""

from __future__ import annotations

import math
import sys
from typing import Any, Callable, Dict, Optional

import torch


def run_peak_gb(rep) -> Optional[float]:
    """The allocator's peak of the run beyond what was allocated when it
    began; None off CUDA."""
    if not rep.peak_hbm_bytes:
        return None
    return max(
        rep.peak_hbm_bytes[d] - rep.held_hbm_bytes.get(d, 0)
        for d in rep.peak_hbm_bytes
    ) / 1024**3


def measure_streaming(
    config: Any = None,
    batch: int = 8,
    seq_len: int = 512,
    budget_frac: float = 0.3,
    policy: str = "greedy",
    device: Any = "cuda",
    link: Any = None,
    log: Callable[[str], None] = lambda m: print(m, file=sys.stderr, flush=True),
) -> Dict[str, Any]:
    """Execute a forward DAG per task with params capped at
    ``budget_frac`` x total param bytes, against the uncapped placed run.

    One node by design: it holds the whole model (uncapped) or streams it
    (capped).  The host params are made on the CPU from a numpy seed and
    pinned once, before any timed run.  ``link`` (a
    ``utils.linkmodel.LinkCalibration``) replaces the live link
    measurement; off CUDA it is required.
    """
    from ..backends.device import DeviceBackend, _map_leaves, pin_params
    from ..core.cluster import Cluster
    from ..frontend.gpt2_dag import build_gpt2_dag
    from ..models.gpt2 import GPT2Config
    from ..sched.policies import get_scheduler
    from ..utils.quantize import quantize_dag
    from .bench import _leg
    from .benchlib import device_kind, oracle_close

    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError("stream_bench: no CUDA device visible")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif link is None:
        raise ValueError(
            f"stream_bench on {device} needs an injected link calibration: "
            "the link is measured only on a card"
        )
    if config is None:
        config = GPT2Config.medium(dtype=torch.bfloat16)
    dag = build_gpt2_dag(config, batch=batch, seq_len=seq_len)
    graph = dag.graph
    params = dag.init_params(seed=0, device="cpu")
    if on_card:
        params = pin_params(params)
    ids = dag.make_inputs(seed=1, device=device)
    total_param_gb = graph.total_param_gb()

    cluster = Cluster.from_torch_devices([device])
    backend = DeviceBackend(cluster)
    sched = get_scheduler(policy).schedule(graph, cluster)
    if sched.failed:
        raise RuntimeError(
            f"stream_bench: {len(sched.failed)} tasks failed on one uncapped "
            "node")

    dtype_name = str(config.dtype).removeprefix("torch.")

    def on_device(ps):  # the fused oracle's copy of the params
        return {k: _map_leaves(lambda t: t.to(device), v) for k, v in ps.items()}

    launches: Dict[str, Dict[str, int]] = {}

    def uncapped(leg):  # every param placed up front, all resident
        return _leg(launches, leg, lambda: backend.execute(
            graph, sched, params, ids, planned=False))

    rep_full = uncapped("uncapped")
    with torch.no_grad():
        fused = _leg(launches, "fused", lambda: dag.reference_forward(
            on_device(params), ids))
    full_ok = oracle_close(fused, rep_full.output, dtype_name)
    log(f"stream_bench: uncapped makespan {rep_full.makespan_s*1e3:.3f} ms "
        f"({total_param_gb:.3f} GB params resident); oracle: {full_ok}")

    # capped: the budget is set AFTER scheduling, so the placement is the
    # same and the comparison isolates the capacity mechanism
    budget_gb = total_param_gb * budget_frac
    orig_budgets = {d.node_id: d.total_memory for d in cluster}
    for d in cluster:
        d.total_memory = budget_gb
    rep_cap = _leg(launches, "capped", lambda: backend.execute(
        graph, sched, params, ids, stream_params=True))
    # the capped run does strictly more work: a faster capped measurement
    # means a contended uncapped one, so re-measure the floor, bounded,
    # keeping the minimum
    tries = 0
    while rep_cap.makespan_s < rep_full.makespan_s and tries < 2:
        for d in cluster:
            d.total_memory = orig_budgets[d.node_id]
        rerun = uncapped(f"uncapped_rerun{tries}")
        if rerun.makespan_s < rep_full.makespan_s:
            rep_full = rerun
            full_ok = oracle_close(fused, rep_full.output, dtype_name)
            log(f"stream_bench: uncapped floor re-measured "
                f"{rep_full.makespan_s*1e3:.3f} ms; oracle: {full_ok}")
        for d in cluster:
            d.total_memory = budget_gb
        tries += 1
    cap_ok = oracle_close(fused, rep_cap.output, dtype_name)
    peak_gb = max(rep_cap.peak_param_bytes.values()) / 1024**3
    log(f"stream_bench: capped@{budget_frac:.2f}x makespan "
        f"{rep_cap.makespan_s*1e3:.3f} ms; {rep_cap.param_loads} loads "
        f"({rep_cap.param_load_calls} batched calls, "
        f"{rep_cap.param_load_bytes/1024**2:.1f} MB), "
        f"{rep_cap.param_evictions} evictions, peak resident "
        f"{peak_gb:.3f} GB on {budget_gb:.3f} GB budget; oracle: {cap_ok}")

    # the floor: the larger of compute (the uncapped makespan) and the
    # link's time for the bytes actually streamed
    if link is None:
        from ..utils.linkmodel import calibrate_link

        link = calibrate_link(
            [device], sizes=(1 << 20, 1 << 24), repeats=3, sustained=True)
    host_gbps: Optional[float] = link.param_load_gbps
    if not math.isfinite(host_gbps) or host_gbps <= 0:
        log(f"stream_bench: WARNING burst link fit degenerate ({host_gbps}); "
            "the floor falls back to sustained/achieved")
        host_gbps = None
    # streaming moves hundreds of MB back to back: its floor is the
    # sustained rate of the streamer's own kind of copy
    sustained_gbps: Optional[float] = link.sustained_gbps
    if sustained_gbps is not None and (
        not math.isfinite(sustained_gbps) or sustained_gbps <= 0
    ):
        sustained_gbps = None
    achieved = (
        rep_cap.param_load_bytes / 1024**3 / max(rep_cap.makespan_s, 1e-12)
    )
    floor_gbps = sustained_gbps or host_gbps
    floor_source = "sustained_probe" if sustained_gbps else (
        "burst_probe" if host_gbps else None
    )
    if floor_gbps is not None and achieved > floor_gbps:
        # the run proved the link at least this fast: the probe under-read
        floor_gbps = achieved
        floor_source = "achieved(probe under-read)"
    link_bound_s = (
        rep_cap.param_load_bytes / (floor_gbps * 1024**3)
        if floor_gbps else None
    )
    floor_s = max(rep_full.makespan_s, link_bound_s or 0.0)
    bound_utilization = floor_s / max(rep_cap.makespan_s, 1e-12)
    log("stream_bench: host link burst "
        + (f"{host_gbps:.2f} GB/s" if host_gbps else "unknown")
        + ", sustained "
        + (f"{sustained_gbps:.4f} GB/s" if sustained_gbps else "unknown")
        + " -> transfer bound "
        + (f"{link_bound_s*1e3:.3f} ms" if link_bound_s else "n/a")
        + f", compute {rep_full.makespan_s*1e3:.3f} ms; "
        f"bound utilization {bound_utilization:.1%}")

    # segment-granular streaming: the same budget, fused dispatch
    rep_seg = _leg(launches, "segmented", lambda: backend.execute(
        graph, sched, params, ids, stream_params=True, segments=True))
    seg_ok = oracle_close(fused, rep_seg.output, dtype_name)
    seg_ms = rep_seg.makespan_s * 1e3
    seg_peak_gb = max(rep_seg.peak_param_bytes.values()) / 1024**3
    log(f"stream_bench: segmented capped makespan {seg_ms:.3f} ms "
        f"({rep_seg.n_dispatches} launches, {rep_seg.param_load_calls} "
        f"batched loads, peak {seg_peak_gb:.3f} GB); oracle: {seg_ok}")

    # int8 weights: the same budget, about half the streamed bytes
    qdag = quantize_dag(dag)
    qparams = qdag.derive_params(params)
    if on_card:
        qparams = pin_params(qparams)
    qcluster = Cluster.from_torch_devices([device])
    qsched = get_scheduler(policy).schedule(qdag.graph, qcluster)
    if qsched.failed:
        raise RuntimeError(
            f"stream_bench: {len(qsched.failed)} int8 tasks failed")
    for d in qcluster:
        d.total_memory = budget_gb  # the SAME capped budget
    rep_q = _leg(launches, "quantized", lambda: DeviceBackend(qcluster).execute(
        qdag.graph, qsched, qparams, ids, stream_params=True))
    with torch.no_grad():
        qfused = _leg(launches, "quantized_fused", lambda: qdag.reference_forward(
            on_device(qparams), ids))
    q_ok = oracle_close(qfused, rep_q.output, dtype_name)
    del qfused
    q_ms = rep_q.makespan_s * 1e3
    q_load_gb = rep_q.param_load_bytes / 1024**3
    q_total_gb = qdag.graph.total_param_gb()
    q_peak_gb = max(rep_q.peak_param_bytes.values()) / 1024**3
    q_budget_ok = bool(q_peak_gb <= budget_gb * 1.02 + 1e-6)
    log(f"stream_bench: int8 capped makespan {q_ms:.3f} ms "
        f"({q_load_gb:.3f} GB streamed vs {total_param_gb:.3f}, peak "
        f"{q_peak_gb:.3f} on the same {budget_gb:.3f} GB budget, "
        f"respected={q_budget_ok}); oracle: {q_ok}")

    return {
        "model": graph.name,
        "platform": device.type,
        "device": device_kind(device),
        "n_tasks": len(graph),
        "n_params": len(graph.unique_params()),
        "total_param_gb": round(total_param_gb, 4),
        "budget_frac": budget_frac,
        "budget_gb": round(budget_gb, 4),
        "uncapped_makespan_ms": round(rep_full.makespan_s * 1e3, 3),
        "capped_makespan_ms": round(rep_cap.makespan_s * 1e3, 3),
        "slowdown": round(
            rep_cap.makespan_s / max(rep_full.makespan_s, 1e-12), 3),
        "param_loads": rep_cap.param_loads,
        "param_load_calls": rep_cap.param_load_calls,
        "param_load_gb": round(rep_cap.param_load_bytes / 1024**3, 4),
        "param_evictions": rep_cap.param_evictions,
        "host_link_gbps": round(host_gbps, 3) if host_gbps else None,
        "sustained_gbps": round(sustained_gbps, 4) if sustained_gbps else None,
        "link_bound_ms": (
            round(link_bound_s * 1e3, 3) if link_bound_s else None),
        "bound_utilization": round(bound_utilization, 4),
        "floor_source": floor_source,
        "achieved_gbps": round(achieved, 4),
        "peak_resident_param_gb": round(peak_gb, 4),
        "budget_respected": bool(peak_gb <= budget_gb * 1.02 + 1e-6),
        "oracle_ok": bool(full_ok and cap_ok),
        "uncapped_peak_hbm_gb": run_peak_gb(rep_full),
        "capped_peak_hbm_gb": run_peak_gb(rep_cap),
        "segmented_capped_makespan_ms": round(seg_ms, 3),
        "segmented_oracle_ok": seg_ok,
        "segmented_peak_resident_gb": round(seg_peak_gb, 4),
        "segmented_n_dispatches": rep_seg.n_dispatches,
        "segmented_load_calls": rep_seg.param_load_calls,
        "quantized_capped_makespan_ms": round(q_ms, 3),
        "quantized_oracle_ok": q_ok,
        "quantized_param_load_gb": round(q_load_gb, 4),
        "quantized_total_param_gb": round(q_total_gb, 4),
        "quantized_peak_resident_gb": round(q_peak_gb, 4),
        "quantized_budget_respected": q_budget_ok,
        "capped_forwards_per_s": round(
            1.0 / max(rep_cap.makespan_s, 1e-12), 3),
        "launches": launches,
    }


if __name__ == "__main__":
    import json

    frac = float(sys.argv[1]) if len(sys.argv) > 1 else 0.3
    print(json.dumps(measure_streaming(budget_frac=frac)))
