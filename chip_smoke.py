#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):

1. device: a CUDA device must be present; TF32 is turned off for matmuls
   and cuDNN, so float32 means float32;
2. build: the CUDA kernel ``distributed_llm_scheduler_tpu_torch/csrc/
   flash_attention.cu`` is compiled with nvcc for sm_90a;
3. kernel check: the kernel against its plain PyTorch version on the
   card, at the main path's shape (also as strided head views of a fused
   qkv product, the layout the model hands it) and at edge shapes, with
   its time, the plain version's, one PyTorch library call's as a
   yardstick, and the least time the card could take (its bound);
4. main path: the flagship GPT-2 small DAG (bf16, batch 8, seq 512,
   8 microbatches, 8 vocab shards, linear chains fused: 537 tasks) is
   calibrated on the card, placed by ``greedy`` on the card and by
   ``heft`` on 8 virtual nodes sharing it, and executed through
   ``DeviceBackend``; each of these three runs has its launch count set
   to 0 just before it and read just after, and must launch the kernel
   once per attention task per forward; the output must meet the fused
   forward;
5. f32 leg: a 2-layer GPT-2 small-width DAG placed on the card must be
   allclose to the port's fused forward run on the CPU with the plain
   versions.

The last lines are one JSON object of per-kernel numbers (``launches`` is
the greedy run's count, ``launches_by_path`` each run's own), the card's
name and power limit as nvidia-smi reports them, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): device memory rate and the
# compute rate for each input type (bf16 on the tensor cores; float32
# outside them)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# main path: GPT-2 small, as bench.py's flagship build
FLAGSHIP = dict(batch=8, seq_len=512, microbatches=8, vocab_shards=8)
FLAGSHIP_TASKS = 537
REPS = 3
# bf16 output oracle, the JAX package's eval/benchlib.oracle_close rule:
# elements outside the 5e-2 band (abs + rel) may number at most
# max(1, 1e-6 * N), and the relative Frobenius error must stay <= 2e-2
BAND, MAX_VIOL_FRAC, MAX_REL_FRO = 5e-2, 1e-6, 2e-2
# f32 leg: the repo's placed-vs-fused tolerance (__graft_entry__.py:333)
F32_RTOL = F32_ATOL = 2e-4
# kernel vs plain version on the same inputs: f32 differs by summation
# order only; in bf16 the plain version rounds scores and probabilities
# to bf16 and both round the output (5e-2 is oracle_close's bf16 band)
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# kernel vs the plain version in f32 on the same (bf16-valued) inputs: the
# kernel computes in f32 and rounds once on output, so every element must
# lie within bf16's unit roundoff 2^-8 of the exact value, plus 1e-4 for
# f32 summation order; in f32 the limit is KERNEL_TOL's
BF16_ROUNDOFF, F32_SLACK = 2.0 ** -8, 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int, warm: int = 5) -> float:
    """Mean milliseconds per call of ``fn`` over ``n`` back-to-back calls,
    between CUDA events on the current stream, after ``warm`` calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def oracle_close(expected, got):
    """(ok, violations, allowed, rel_fro) under the bf16 oracle rule."""
    import torch

    a, b = expected.float(), got.float()
    if a.shape != b.shape:
        return False, -1, 0, math.inf
    diff = (a - b).abs()
    viol = int((diff > BAND + BAND * a.abs()).sum())
    allowed = max(1, int(MAX_VIOL_FRAC * a.numel()))
    rel = float(torch.linalg.vector_norm(diff) /
                torch.linalg.vector_norm(a).clamp_min(1e-12))
    return viol <= allowed and rel <= MAX_REL_FRO, viol, allowed, rel


def attention_bound_ms(shape, dtype_name: str, causal: bool) -> tuple:
    """Least time for one attention call: q, k, v read once and o written
    once over the memory rate, against the QK^T and PV products over the
    type's peak (causal: only the (T+1)/2 keys each query sees on
    average)."""
    B, H, T, hd = shape
    itemsize = 2 if dtype_name == "bfloat16" else 4
    nbytes = 4 * B * H * T * hd * itemsize
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    flops = 2 * 2 * hd * pairs
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_inputs(torch, rng, dev, shape, dname, layout):
    """q, k and v for one kernel case: contiguous (B, H, T, hd) tensors,
    or with ``layout="qkv"`` the strided head views of one (B, T, 3*H*hd)
    product that ``models/gpt2.causal_attention`` hands the kernel."""
    import numpy as np

    dt = getattr(torch, dname)
    B, H, T, hd = shape
    if layout == "qkv":
        qkv = torch.from_numpy(
            rng.standard_normal((B, T, 3 * H * hd)).astype(np.float32)
        ).to(dev, dt)
        return tuple(t.reshape(B, T, H, hd).transpose(1, 2)
                     for t in qkv.split(H * hd, dim=-1))
    return tuple(
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        .to(dev, dt) for _ in range(3)
    )


def check_attention_kernel(torch, A, dev) -> dict:
    """Phase 3: the flash kernel against its plain version; returns the
    numbers of the kernel line at the main path's shape."""
    import numpy as np
    import torch.nn.functional as F

    cases = [
        ((1, 12, 512, 64), "bfloat16", True, "heads"),  # main path, per task
        ((1, 12, 512, 64), "bfloat16", True, "qkv"),    # ... as the model's views
        ((1, 12, 512, 64), "float32", True, "heads"),
        ((2, 3, 100, 64), "float32", False, "heads"),   # ragged T, full attention
        ((1, 4, 256, 32), "bfloat16", True, "heads"),
        ((1, 4, 300, 128), "float32", True, "heads"),
        ((1, 4, 300, 128), "bfloat16", False, "heads"),
    ]
    rng = np.random.default_rng(0)
    main = None
    for shape, dname, causal, layout in cases:
        q, k, v = attention_inputs(torch, rng, dev, shape, dname, layout)
        got = A.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = A.reference_mha(q, k, v, causal=causal)
        err = (got.float() - want.float()).abs().max().item()
        # the same function in f32 from the same inputs: isolates the
        # kernel's own output rounding from the plain version's bf16 steps
        want32 = A.reference_mha(q.float(), k.float(), v.float(), causal=causal)
        diff32 = (got.float() - want32).abs()
        err32 = diff32.max().item()
        if dname == "bfloat16":
            out32 = int((diff32 > BF16_ROUNDOFF * want32.abs() + F32_SLACK).sum())
            rule32 = f"{out32} elements beyond 2^-8*|x|+{F32_SLACK:g}"
        else:
            out32 = 0 if err32 < KERNEL_TOL[dname] else 1
            rule32 = f"tol {KERNEL_TOL[dname]:g}"
        ok = (math.isfinite(err) and err < KERNEL_TOL[dname]
              and math.isfinite(err32) and out32 == 0)
        log(f"  flash_attention {shape} {dname} causal={causal} {layout}: "
            f"max_abs_err {err:.3e} vs plain (tol {KERNEL_TOL[dname]:g}), "
            f"{err32:.3e} vs plain in f32 ({rule32}) -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(
                f"flash kernel disagrees at {shape} {dname} {layout}")
        if main is None:
            ms = cuda_ms(lambda: A.flash_attention(q, k, v, causal=True), 200)
            plain_ms = cuda_ms(
                lambda: A.reference_mha(q, k, v, causal=True), 50
            )
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True), 200)
            bound_ms, bound_by = attention_bound_ms(shape, dname, True)
            main = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=lib_ms)
            log(f"  at the main path's shape {shape} {dname}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
                f"bound {bound_ms * 1e3:.3f} us ({bound_by})")
    return main


def device_time_breakdown(torch, label: str, makespan_s: float, run) -> None:
    """Trace one more placed forward with torch.profiler: device time per
    forward, the device's idle share of the untraced makespan, and the
    kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    rows = [
        (getattr(e, "self_device_time_total", 0.0), e.count, e.key)
        for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ]
    busy_ms = sum(r[0] for r in rows) / 1e3
    if busy_ms <= 0:
        log(f"  {label} trace: no device time in the trace (not measured)")
        return
    share = 1.0 - busy_ms / (makespan_s * 1e3)
    log(f"  {label} trace: device busy {busy_ms:.3f} ms per forward, idle "
        f"share {share:.3f} of the {makespan_s * 1e3:.3f} ms makespan; "
        f"{sum(r[1] for r in rows)} device ops")
    for us, n, key in sorted(rows, reverse=True)[:6]:
        log(f"    {us / 1e3:8.3f} ms  {n:5d}x  {key[:90]}")


def counted(label: str, n_attn: int, forwards: int, run):
    """Run ``run()`` with the kernel's launch count set to 0 just before
    and read just after; it must equal one launch per attention task per
    forward.  Returns (run's result, the count)."""
    from distributed_llm_scheduler_tpu_torch.ops import kernels

    kernels.reset_launches()
    out = run()
    got = kernels.launches["flash_attention"]
    log(f"  {label}: flash_attention launched {got} times over {forwards} "
        f"forwards ({got / forwards:g} per forward; expected {n_attn})")
    if got != n_attn * forwards:
        raise AssertionError(
            f"{label}: launch count {got} != {n_attn * forwards}")
    return out, got


def run_main_path(torch, P, dev) -> dict:
    """Phase 4: the flagship DAG, calibrated, placed twice, executed.
    Returns each run's own launch count."""
    cfg = P.GPT2Config.small(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    dag = P.build_gpt2_dag(cfg, **FLAGSHIP)
    graph = P.fuse_linear_chains(dag.graph)
    if len(graph) != FLAGSHIP_TASKS:
        raise AssertionError(f"flagship has {len(graph)} tasks")
    n_attn = sum(1 for t in graph if t.task_id.endswith("_attention"))
    params = dag.init_params(seed=0, device=dev)
    ids = dag.make_inputs(seed=1, device=dev)
    log(f"  built {graph.name}: {len(graph)} tasks ({n_attn} attention), "
        f"{graph.total_param_gb():.3f} GB params, weights from numpy seed 0 "
        f"({time.perf_counter() - t0:.1f} s)")

    launches = {}
    t0 = time.perf_counter()
    cm, launches["calibrate"] = counted(
        "calibrate", n_attn, 1 + 3,
        lambda: P.calibrate(graph, params, ids, device=dev, repeats=3),
    )
    applied = cm.apply(graph)
    log(f"  calibrated {applied} tasks on {cm.platform}: per-task sum "
        f"{sum(cm.task_seconds.values()) * 1e3:.3f} ms, critical path "
        f"{graph.critical_path_time() * 1e3:.3f} ms "
        f"({time.perf_counter() - t0:.1f} s)")

    reports = {}
    for label, cluster, policy in (
        ("greedy x1", P.Cluster.from_torch_devices(), "greedy"),
        ("heft x8", P.Cluster.from_torch_devices([dev] * 8), "heft"),
    ):
        sched = P.get_scheduler(policy).schedule(graph, cluster)
        if sched.failed or len(sched.completed) != len(graph):
            raise AssertionError(f"{label}: {len(sched.failed)} tasks failed")
        order = P.DeviceBackend.dispatch_order(graph, sched)
        for nid, lst in sched.per_node.items():
            members = set(lst)
            if [t for t in order if t in members] != lst:
                raise AssertionError(f"{label}: dispatch ignores {nid}'s order")
        backend = P.DeviceBackend(cluster)
        rep, launches[label] = counted(
            label, n_attn, 1 + REPS, lambda: backend.execute(
                graph, sched, params, ids, warmup=True, reps=REPS
            ),
        )
        used = sum(1 for lst in sched.per_node.values() if lst)
        peak = sum(rep.peak_hbm_bytes.values()) / 1024**3
        log(f"  {label}: {used} node(s) used, makespan "
            f"{rep.makespan_s * 1e3:.3f} ms (mean of {REPS}), "
            f"{rep.n_dispatches} dispatches, {rep.transfer_edges} transfer "
            f"edges ({rep.transfer_bytes / 1024**2:.1f} MiB), dispatch loop "
            f"{rep.dispatch_overhead_s * 1e3:.3f} ms, peak {peak:.3f} GiB, "
            f"warmup {rep.compile_s:.2f} s")
        device_time_breakdown(torch, label, rep.makespan_s, lambda: backend.execute(
            graph, sched, params, ids, warmup=False, reps=1
        ))
        reports[label] = rep

    fused = dag.reference_forward(params, ids)
    for label, rep in reports.items():
        ok, viol, allowed, rel = oracle_close(fused, rep.output)
        finite = bool(torch.isfinite(rep.output).all())
        log(f"  {label} vs fused forward: {viol} elements outside the "
            f"{BAND:g} band (allowed {allowed}), rel Frobenius {rel:.3e} "
            f"(max {MAX_REL_FRO:g}), finite={finite} -> "
            f"{'ok' if ok and finite else 'FAIL'}")
        if not (ok and finite):
            raise AssertionError(f"{label}: output fails the oracle")
    return launches


def run_f32_leg(torch, P, dev) -> None:
    """Phase 5: placed on the card vs fused on the CPU, in float32."""
    cfg = P.GPT2Config.small(n_layer=2)
    dag = P.build_gpt2_dag(cfg, batch=2, seq_len=128, microbatches=2,
                           vocab_shards=8)
    graph = P.fuse_linear_chains(dag.graph)
    cluster = P.Cluster.from_torch_devices([dev] * 8)
    sched = P.get_scheduler("heft").schedule(graph, cluster)
    rep = P.DeviceBackend(cluster).execute(
        graph, sched, dag.init_params(seed=2, device=dev),
        dag.make_inputs(seed=3, device=dev), reps=1,
    )
    cpu = torch.device("cpu")
    want = dag.reference_forward(
        dag.init_params(seed=2, device=cpu), dag.make_inputs(seed=3, device=cpu)
    )
    got = rep.output.cpu()
    err = (got - want).abs().max().item()
    ok = bool(torch.allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL))
    log(f"  {graph.name}: {len(graph)} tasks on 8 nodes, heft; max_abs_err "
        f"{err:.3e} vs CPU fused forward (rtol=atol={F32_RTOL:g}) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("f32 placed output diverges from CPU forward")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import distributed_llm_scheduler_tpu_torch as P
    from distributed_llm_scheduler_tpu_torch.ops import attention as A
    from distributed_llm_scheduler_tpu_torch.ops import kernels

    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    log(f"[1/5] device: {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("  TF32 off for matmul and cuDNN")

    secs = kernels.build(A.KERNEL)
    log(f"[2/5] built {A.KERNEL}.cu with {kernels.nvcc_path()} for sm_90a "
        f"in {secs:.1f} s")

    log("[3/5] kernel check against the plain versions")
    attn = check_attention_kernel(torch, A, dev)

    log("[4/5] main path: flagship GPT-2 small bf16 DAG on the card")
    launches = run_main_path(torch, P, dev)

    log("[5/5] f32 leg: placed on the card vs fused on the CPU")
    run_f32_leg(torch, P, dev)

    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    line = {"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "distributed_llm_scheduler_tpu_torch/csrc/flash_attention.cu",
        "replaces": "distributed_llm_scheduler_tpu/ops/attention.py:152",
        "launches": launches["greedy x1"],
        "launches_by_path": launches,
        **attn,
    }]}
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
