"""North-star bench of the port: GPT-2 forward DAG makespan, best policy
vs round-robin, on an NVIDIA card.

    python -m distributed_llm_scheduler_tpu_torch.eval.bench [small|medium]

The counterpart of the JAX package's ``bench.py`` (``main`` and
``measure``) for the legs the port runs today:

1. build the GPT-2 forward DAG, the flagship build: bf16, batch 8 split
   into 8 microbatches, 8 vocab shards, linear chains fused (537 tasks for
   ``small``), weights from numpy seed 0 on the card;
2. load the graph's saved calibration (``.costmodel_torch/{graph}_cuda.
   json``, the JAX bench's choice: ``eval/benchlib.py`` through
   ``calibrate_cached``) when it covers the graph's tasks; otherwise, or
   under ``DLS_RECALIBRATE``, calibrate per-task times live on the card
   (``calibrate``) in 3 windows, apply each task's median over them and
   save that; the line records ``cache_hit`` and the calibration's age;
3. execute the DAG placed by ``greedy`` on one card (3 repeat-captured
   windows of ``reps`` back-to-back runs, median quoted), time the fused
   forward the same way (with its logits, and as its f32 sum, the MFU
   anchor), and hold the placed output against the fused one under
   ``oracle_close``;
4. run the same placement segment-fused (one program per same-node run,
   sibling microbatch tasks re-batched; on the card one CUDA graph) and
   compiled (the whole run one CUDA graph), each in 3 windows of ``reps``
   runs with the median quoted, each held against the fused output, and
   the compiled leg's host wall per run taken from 3 single-run windows;
5. measure each task's device-memory footprint (``preflight_task_memory``);
6. place the DAG with each of the 10 policies (``search`` at the JAX
   bench's reduced budget of 120 evaluations) on an 8-node cluster model of
   this card (each node's budget is the card's memory less what was
   already taken when the bench started), replay each placement under the
   full-fidelity cost model with the link measured on this card, and
   report the best policy's makespan and ``vs_baseline`` = round-robin /
   best, with the interconnect sensitivity sweep, the winner's modeled
   per-node peak, and the single-card replay beside the measured makespan;
   the winner's placement is replayed again under each calibration
   window's times, so the line shows how far the calibration alone moves
   ``value``.  Each policy's entry in the line also carries its
   scheduling wall and its ``placement_digest``.

The measured legs (steps 3-5) run live on every run.  Prints ONE JSON
line (``BenchResult.to_json``) on stdout; progress goes to stderr.  Nothing falls back: a failed build, launch, calibration, capture,
replay or link measurement raises, and the run exits non-zero (the JAX
bench only logs a failed segment-fused or whole-program leg).  Left out
against the JAX bench: its watchdog and retries, the light-rep mode, the
f32 fallback and the tracing block.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch

from ..backends.device import DeviceBackend
from ..backends.sim import LinkModel, SimulatedBackend
from ..core.cluster import Cluster, DeviceState
from ..core.fusion import fuse_linear_chains
from ..core.graph import GB
from ..core.validate import validate_schedule
from ..frontend.gpt2_dag import build_gpt2_dag
from ..models.gpt2 import GPT2Config
from ..ops import kernels
from ..sched.policies import ALL_SCHEDULERS, get_scheduler
from ..sched.search import placement_digest
from ..utils.costmodel import (
    CostModel,
    cache_age_days,
    calibrate,
    calibration_path,
    load_cached,
    median_cost_model,
    recalibrate_requested,
    repeat_capture,
)
from ..utils.hbm import preflight_task_memory
from .benchlib import (
    BenchResult,
    choose_link,
    compute_mfu,
    device_kind,
    graph_flops,
    ici_sensitivity,
    modeled_kv_pages_peak,
    oracle_close,
    pick_best,
    spread_stats,
)

# the saved calibrations and the link calibration's cache (the degradation
# guard's baseline), in the checkout and ignored by git
CACHE_DIR = str(Path(__file__).resolve().parents[2] / ".costmodel_torch")

# config name -> (config factory, model tag, DAG shape).  small and medium
# are the JAX bench's (bench.py:185-198); tiny is the tests' size
CONFIGS = {
    "small": (GPT2Config.small, "gpt2s",
              dict(batch=8, seq_len=512, microbatches=8, vocab_shards=8)),
    "medium": (GPT2Config.medium, "gpt2m",
               dict(batch=8, seq_len=512, microbatches=8, vocab_shards=8)),
    "tiny": (GPT2Config.tiny, "gpt2t",
             dict(batch=4, seq_len=32, microbatches=2, vocab_shards=4)),
}
# back-to-back runs per captured window; 3 windows per measured leg
REPS = 6
WINDOWS = 3
# calibration windows, and profile runs in each
CAL_WINDOWS = 3
CAL_REPEATS = 3
REPLAY_NODES = 8
# the annealed search's eval budget in the policy loop, the JAX bench's
# (bench.py:554): its full-budget margin is the search bench's to show
SEARCH_BUDGET = 120


def policy_kwargs(name: str) -> Dict[str, Any]:
    """The constructor arguments the policy loop gives ``name``."""
    return {"budget": SEARCH_BUDGET} if name == "search" else {}
# the port's budget for a CPU node (core/cluster.py), where no card
# memory can be read
CPU_NODE_GB = 16.0


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def nvidia_smi_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "-i", str(device.index or 0),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def _delta(counts: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in sorted(counts.items())
            if v != before.get(k, 0)}


def _leg(launches: Dict[str, Dict[str, int]], name: str, fn: Callable[[], Any]):
    """Run one leg of the bench and record the kernel launches it made
    (the change in ``kernels.launches`` across it)."""
    before = dict(kernels.launches)
    out = fn()
    launches[name] = _delta(kernels.launches, before)
    return out


def _timed(fn: Callable[[], Any], reps: int, device: torch.device) -> float:
    """Seconds per call over ``reps`` back-to-back calls: CUDA events on
    the card's stream around them, the host clock on the CPU.  Events on
    the stream time the device itself, so no host readback fence (and no
    fence round-trip to subtract) is needed."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        stream = torch.cuda.current_stream(device)
        start.record(stream)
        for _ in range(reps):
            out = fn()
        end.record(stream)
        end.synchronize()
        del out
        return start.elapsed_time(end) / 1e3 / reps
    # dls-lint: allow(DET001) bench timer: wall time IS the measured quantity
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    # dls-lint: allow(DET001) bench timer: wall time IS the measured quantity
    return (time.perf_counter() - t0) / reps


def run(
    config_name: str = "small",
    device: Any = "cuda",
    *,
    dtype: torch.dtype = torch.bfloat16,
    cost_model: Optional[CostModel] = None,
    link: Optional[LinkModel] = None,
    reps: int = REPS,
    refresh: Optional[bool] = None,
    cache_dir: str = CACHE_DIR,
) -> BenchResult:
    """Run the bench on ``device`` and return its result.

    ``cost_model`` and ``link`` replace the calibration and the live link
    measurement (tests inject both to run on the CPU).  Without
    ``cost_model`` the graph's calibration saved under ``cache_dir`` is
    replayed when it covers the graph's tasks, unless ``refresh`` (by
    default :func:`recalibrate_requested`, ``DLS_RECALIBRATE``) asks for
    a new one; a calibration measured here is saved there.  Off CUDA the
    link is required and the cost model must be injected or saved (only
    a card is measured), and the result says ``fallback``.  ``dtype`` is
    the model's (the bench's own runs are bf16)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("bench: no CUDA device visible")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif link is None:
        raise ValueError(
            f"bench on {device} needs an injected cost model (or a saved "
            "calibration) and an injected link: only a card is measured"
        )
    if refresh is None:
        refresh = recalibrate_requested()
    make_cfg, model_tag, shape = CONFIGS[config_name]
    # dls-lint: allow(DET001) bench timer: wall time IS the measured quantity
    t_start = time.perf_counter()
    on_card = device.type == "cuda"
    if on_card:
        # each replay node is one such card: its total memory less what
        # was already taken when the bench started (total - free), i.e.
        # what was free then
        free, _total = torch.cuda.mem_get_info(device)
        node_hbm_gb = free / GB
        kind, smi = device_kind(device), nvidia_smi_line(device)
    else:
        node_hbm_gb, kind, smi = CPU_NODE_GB, device.type, device.type
    log(f"{kind} ({smi}); node budget {node_hbm_gb:.3f} GB")

    dag = build_gpt2_dag(make_cfg(dtype=dtype), **shape)
    graph = fuse_linear_chains(dag.graph)
    params = dag.init_params(seed=0, device=device)
    ids = dag.make_inputs(seed=1, device=device)
    dtype_name = str(dtype).replace("torch.", "")
    log(f"built {graph.name}: {len(graph)} tasks, "
        f"{graph.total_param_gb():.3f} GB params")

    launches: Dict[str, Dict[str, int]] = {}
    cache_hit = None
    if cost_model is None:
        path = calibration_path(cache_dir, graph.name, device.type)
        cost_model = None if refresh else load_cached(path, graph)
        if cost_model is None and not on_card:
            raise ValueError(
                f"bench on {device} needs an injected cost model or a saved "
                f"calibration at {path}: only a card is measured")
        cache_hit = cost_model is not None
    if cache_hit:
        windows, calibration_runs = [cost_model], None
        log(f"calibration replayed from {path} (measured "
            f"{cost_model.measured_at or 'at an unknown time'})")
    elif cost_model is None:
        # dls-lint: allow(DET001) bench timer: wall time IS the measured quantity
        t0 = time.perf_counter()
        windows = _leg(launches, "calibrate", lambda: repeat_capture(
            lambda: calibrate(graph, params, ids, device=device,
                              repeats=CAL_REPEATS), CAL_WINDOWS))
        cost_model = median_cost_model(windows)
        cost_model.save(path)
        calibration_runs = CAL_WINDOWS * CAL_REPEATS
        log(f"calibrated on {cost_model.platform} in "
            # dls-lint: allow(DET001) bench timer: wall time IS the measured quantity
            f"{time.perf_counter() - t0:.1f} s: per-task totals " + ", ".join(
                f"{sum(w.task_seconds.values()) * 1e3:.3f}" for w in windows)
            + f" ms; saved to {path}")
    else:
        windows, calibration_runs = [cost_model], None
    applied = cost_model.apply(graph)
    log(f"cost model applied to {applied} tasks: per-task total "
        f"{sum(cost_model.task_seconds.values()) * 1e3:.3f} ms, critical "
        f"path {graph.critical_path_time() * 1e3:.3f} ms")

    # per-task leg: greedy on one node bound to the card
    one_core = Cluster([DeviceState("core_0", node_hbm_gb, torch_device=device)])
    backend = DeviceBackend(one_core)
    sched_one = get_scheduler("greedy").schedule(graph, one_core)

    def per_task_leg():
        first = backend.execute(graph, sched_one, params, ids)  # warms up
        return first, repeat_capture(lambda: backend.execute(
            graph, sched_one, params, ids, warmup=False, reps=reps,
        ), WINDOWS)

    rep, pt_reports = _leg(launches, "per_task", per_task_leg)
    pt_samples = [r.makespan_s for r in pt_reports]
    pt_makespan = statistics.median(pt_samples)
    spread = {"pt_makespan": spread_stats(pt_samples)}
    dispatch_overhead_ms = statistics.median(
        [r.dispatch_overhead_s for r in pt_reports]) * 1e3
    peak_measured = (
        max(rep.peak_hbm_bytes.values()) / GB if rep.peak_hbm_bytes else None
    )

    # fused leg: the same forward as one program, with logits (the
    # like-for-like baseline) and reduced to its f32 sum (the MFU anchor)
    def forward():
        with torch.no_grad():
            return dag.reference_forward(params, ids)

    def forward_sum():
        with torch.no_grad():
            return dag.reference_forward(params, ids).float().sum()

    def fused_leg():
        fused = forward()
        forward_sum()  # warm-up
        scalar = repeat_capture(
            lambda: _timed(forward_sum, reps, device), WINDOWS)
        like = repeat_capture(lambda: _timed(forward, reps, device), WINDOWS)
        return fused, scalar, like

    fused, scalar_samples, like_samples = _leg(launches, "fused", fused_leg)
    fused_scalar_s = statistics.median(scalar_samples)
    fused_like_s = statistics.median(like_samples)
    spread["fused_scalar"] = spread_stats(scalar_samples)
    spread["fused_forward"] = spread_stats(like_samples)

    oracle_ok = oracle_close(fused, rep.output, dtype_name)
    flops = graph_flops(graph)
    mfu = compute_mfu(flops, pt_makespan, kind, dtype_name)
    mfu_fused = compute_mfu(flops, fused_scalar_s, kind, dtype_name)
    overhead = pt_makespan / fused_like_s - 1.0 if fused_like_s > 0 else None
    log(f"per-task makespan {pt_makespan * 1e3:.3f} ms (median of {WINDOWS} "
        f"windows of {reps}), dispatch loop {dispatch_overhead_ms:.3f} ms; "
        f"fused {fused_like_s * 1e3:.3f} ms with logits, "
        f"{fused_scalar_s * 1e3:.3f} ms summed; MFU {mfu} / {mfu_fused}; "
        f"oracle {oracle_ok}")

    # the captured legs: a replay's output is the graph's own tensor, so
    # each leg's oracle reads its first run's output before the next run.
    # A wrapper counts its kernel when the graph is captured (the leg's
    # ``<name>_eager`` launches: its warm-up and its capture); the leg's
    # own launches are those its graphs' replays made (``kernels.replayed``)
    def captured_leg(name: str, single_runs: bool = False, **kw):
        def leg():
            first = backend.execute(graph, sched_one, params, ids, **kw)
            ok = oracle_close(fused, first.output, dtype_name)
            reports = repeat_capture(lambda: backend.execute(
                graph, sched_one, params, ids, warmup=False, reps=reps, **kw,
            ), WINDOWS)
            # the host wall of one run alone (copy and replay)
            alone = repeat_capture(lambda: backend.execute(
                graph, sched_one, params, ids, warmup=False, reps=1, **kw,
            ).dispatch_overhead_s, WINDOWS) if single_runs else None
            return first, ok, reports, alone

        before = dict(kernels.replayed)
        first, ok, reports, alone = _leg(launches, f"{name}_eager", leg)
        launches[name] = _delta(kernels.replayed, before)
        samples = [r.makespan_s for r in reports]
        spread[name] = spread_stats(samples)
        return first, ok, statistics.median(samples), alone

    srep, seg_ok, seg_makespan, _ = captured_leg("segmented", segments=True)
    _, comp_ok, comp_makespan, alone = captured_leg(
        "compiled", single_runs=True, compiled=True)
    comp_overhead_ms = statistics.median(alone) * 1e3
    del fused
    mfu_seg = compute_mfu(flops, seg_makespan, kind, dtype_name)
    mfu_comp = compute_mfu(flops, comp_makespan, kind, dtype_name)
    log(f"segment-fused makespan {seg_makespan * 1e3:.3f} ms "
        f"({srep.n_dispatches} host calls vs {rep.n_dispatches}), oracle "
        f"{seg_ok}, MFU {mfu_seg}; compiled {comp_makespan * 1e3:.3f} ms, "
        f"host wall per run {comp_overhead_ms:.4f} ms, oracle {comp_ok}, "
        f"MFU {mfu_comp}")
    oracle_ok = oracle_ok and seg_ok and comp_ok

    # dls-lint: allow(DET001) bench timer: wall time IS the measured quantity
    t0 = time.perf_counter()
    footprints = _leg(launches, "preflight",
                      lambda: preflight_task_memory(graph, params, ids))
    preflight_max_gb = max(footprints.values()) if footprints else None
    log(f"pre-flight over {len(graph)} tasks in "
        # dls-lint: allow(DET001) bench timer: wall time IS the measured quantity
        f"{time.perf_counter() - t0:.1f} s; max footprint {preflight_max_gb}")

    # replay on an 8-node model of this card, link measured on the card
    cluster = Cluster([
        DeviceState(f"core_{i}", node_hbm_gb) for i in range(REPLAY_NODES)
    ])
    if link is None:
        link, link_prov = choose_link(device, CACHE_DIR)
    else:
        link_prov = "injected"
    log(f"link [{link_prov}] host {link.param_load_gbps:.3f} GB/s, "
        f"interconnect {link.interconnect_gbps:.3f} GB/s, latency "
        f"{link.latency_s * 1e6:.3f} us")
    dag_type = f"gpt2_{config_name}"
    sim = SimulatedBackend(fidelity="full", link=link,
                           dispatch_s=cost_model.dispatch_s)
    singlechip_replay_s = sim.execute(
        graph, one_core, sched_one, dag_type=dag_type).makespan
    log(f"single-card replay {singlechip_replay_s * 1e3:.3f} ms vs measured "
        f"{pt_makespan * 1e3:.3f} ms")

    makespans, schedules, sched_s, digests, stats = {}, {}, {}, {}, {}
    for name in sorted(ALL_SCHEDULERS):
        # dls-lint: allow(DET001) bench timer: wall time IS the measured quantity
        t0 = time.perf_counter()
        policy = get_scheduler(name, link=link, **policy_kwargs(name))
        s = policy.schedule(graph, cluster)
        # dls-lint: allow(DET001) bench timer: wall time IS the measured quantity
        sched_s[name] = time.perf_counter() - t0
        if getattr(policy, "stats", None):
            stats[name] = dict(policy.stats)
        r = sim.execute(graph, cluster, s, dag_type=dag_type)
        makespans[name] = (r.makespan, r.completed_tasks / r.num_tasks)
        schedules[name] = s
        digests[name] = placement_digest(s.placement)
        log(f"{name:10s} makespan {r.makespan * 1e3:.3f} ms, completion "
            f"{makespans[name][1]:.3f}, scheduled in {sched_s[name]:.3f} s"
            + (f", stats {stats[name]}" if name in stats else ""))
    best_name, best, rr = pick_best(makespans)
    if makespans["roundrobin"][1] < 1.0:
        log("round-robin did not complete; its makespan is a lower bound")
    sens = ici_sensitivity(graph, cluster, schedules, link,
                           dispatch_s=cost_model.dispatch_s, dag_type=dag_type)

    vrep = validate_schedule(graph, cluster, schedules[best_name])
    peak_modeled = (
        max(vrep.peak_no_evict_gb.values()) if vrep.peak_no_evict_gb else None
    )
    peak_bytes = {
        node: int(round(gb * GB))
        for node, gb in sorted(vrep.peak_no_evict_gb.items())
    } or None

    # how far the calibration alone moves the headline: the winner's
    # placement replayed under each calibration window's task times
    values = []
    for window in windows:
        window.apply(graph)
        values.append(sim.execute(graph, cluster, schedules[best_name],
                                  dag_type=dag_type).makespan)
    cost_model.apply(graph)
    spread["value"] = spread_stats(values)
    spread["calibrated_task_sum"] = spread_stats(
        [sum(w.task_seconds.values()) for w in windows])

    result = BenchResult(
        n_policies=len(makespans),
        platform_suffix=f"_{device.type}",
        best_policy=best_name,
        best_makespan_s=best,
        baseline_makespan_s=rr,
        oracle_ok=oracle_ok,
        fallback=not on_card,
        peak_hbm_gb_measured=peak_measured,
        peak_hbm_gb_modeled=peak_modeled,
        peak_hbm_bytes=peak_bytes,
        kv_pages_peak=modeled_kv_pages_peak(
            slots=2, prompt_len=8, max_new=6, page_size=8),
        mfu_single_chip=mfu,
        dispatch_overhead=overhead,
        segmented_makespan_s=seg_makespan,
        mfu_segmented=mfu_seg,
        compiled_makespan_s=comp_makespan,
        mfu_compiled=mfu_comp,
        compiled_dispatch_overhead_ms=comp_overhead_ms,
        link_provenance=link_prov,
        fused_forward_s=fused_like_s,
        fused_scalar_s=fused_scalar_s,
        # CUDA events time the device directly: there is no readback
        # fence whose round-trip would need measuring and subtracting
        fence_rtt_s=None,
        singlechip_replay_s=singlechip_replay_s,
        ici_sensitivity=sens,
        spread=spread,
        dispatch_overhead_ms=dispatch_overhead_ms,
        model_tag=model_tag,
        device=smi,
        node_hbm_gb=node_hbm_gb,
        policies=makespans,
        policy_sched_s=sched_s,
        placement_digests=digests,
        policy_stats=stats,
        schedules=schedules,
        mfu_fused=mfu_fused,
        preflight_max_gb=preflight_max_gb,
        launches=launches,
        cost_measured_at=cost_model.measured_at or None,
        calibrated_task_s=sum(cost_model.task_seconds.values()),
        calibration_runs=calibration_runs,
        cache_hit=cache_hit,
        calibration_age_days=(
            cache_age_days(cost_model.measured_at) if cache_hit else None),
        link_model=link,
    )
    log(f"best={best_name} ({best * 1e3:.3f} ms) vs roundrobin "
        f"({rr * 1e3:.3f} ms) -> {result.vs_baseline:.3f}x; total "
        # dls-lint: allow(DET001) bench timer: wall time IS the measured quantity
        f"{time.perf_counter() - t_start:.1f} s")
    return result


def main(argv=None) -> int:
    import json

    argv = sys.argv[1:] if argv is None else argv
    config_name = argv[0] if argv else "small"
    if config_name not in ("small", "medium"):
        raise SystemExit(f"usage: bench [small|medium], got {config_name!r}")
    result = run(config_name, "cuda")
    print(json.dumps(result.to_json()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
