#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):

1. device: a CUDA device must be present; TF32 is turned off for matmuls
   and cuDNN, so float32 means float32;
2. build: the three CUDA sources under ``distributed_llm_scheduler_tpu_
   torch/csrc/`` (flash attention; single-token and ragged paged
   attention; LayerNorm and RMSNorm) are compiled with nvcc for sm_90a,
   one process each, started together; ptxas's registers and spills of
   the flash kernels, of the single-token paged split kernels and of the
   ragged tensor-core kernels are printed, and for norms.cu one line over all its kernels (registers,
   spill bytes) with its largest register-path instance and any that
   spills;
3. flash kernel check: the kernel against its plain PyTorch version on
   the card, at the GPT-2 main path's shape (also as strided head views
   of a fused qkv product, the layout the model hands it, bit for bit
   equal to contiguous copies), at the Llama path's shape through
   ``gqa_mha`` (32 query heads reading 8 KV heads in place, hd 128) and
   at edge shapes (each head dim, T of 1, 77 and 300, full attention,
   fewer KV heads given to ``flash_attention`` itself), with its time as
   CUDA-graph replays and issued back to back, the plain version's, one
   PyTorch library call's as a yardstick, and the least time the card
   could take (its bound);
4. paged kernel check: both paged kernels against their plain versions
   on the card, on the JAX decode bench's 7 single-token and 5 ragged
   fixtures (f32, trash page poisoned, 1e-5; each ragged fixture on the
   variant ``ragged_plan`` names) and at the GPT-2 small serving shape in
   bf16 (the 32-token ragged chunk on the tensor-core variant), with
   times and bounds (each kernel as CUDA-graph replays over distinct
   serving cases that total 2x the L2, with one case repeated and issued
   back to back beside it); then the ragged op path
   (``paged_decode_attention(..., q_lens=...)``, as the decode bench's
   kernel leg drives it) with its launches counted in all and by
   variant;
5. norm kernel check: both norm kernels against their plain versions at
   the main paths' shapes and at edge cases (f32, 77 rows, D = 100 and
   128, strided rows, a long-row tail, rows offset by 1e4, the register
   instances' width edges, aligned and unaligned strided rows, more rows
   than the grid holds), each asserting which kernel variant
   (``norm_plan``: register or streaming) ran; then LayerNorm at the
   GPT-2 task's (1, 512, 768) and decode step's (8, 1, 768) shapes and
   RMSNorm at the Llama task's (1, 512, 4096), bf16, timed as CUDA-graph
   replays over distinct inputs that total 2x the L2 (and one input
   repeated), beside their bounds, an empty kernel's time on the same
   grid in the same kind of graph (the per-launch floor), the plain
   versions and the library calls;
6. flagship forward path: the GPT-2 small DAG (bf16, batch 8, seq 512,
   8 microbatches, 8 vocab shards, linear chains fused: 537 tasks) is
   calibrated on the card, placed by ``greedy`` on the card and by
   ``heft`` on 8 virtual nodes sharing it, and executed through
   ``DeviceBackend``; each of these three runs has its launch counts set
   to 0 just before it and read just after, and must launch the flash
   kernel once per attention task and the LayerNorm kernel once per
   layer norm per forward (96 and 200, every LayerNorm on the register
   kernel); the output must meet the fused forward; traces give device
   time per forward, the norm kernels' included;
7. execution ladder: the same flagship under ``greedy`` x1 per task,
   planned, coalesced, segmented and compiled, and under ``heft`` x8 (8
   nodes of the card, each on its own stream) per task, planned,
   segmented and compiled; each run has its counts set to 0 just before
   it: an eager rung must launch the kernels once per attention and layer
   norm of each forward, a captured rung (segments, each one CUDA graph;
   compiled, the whole run one CUDA graph) counts in its warm-up and
   capture only (twice the kernels in its graphs), and its launches are
   those its graphs' replays made, counted at each replay, which must be
   the kernels in its graphs times the runs (the segmented rung's
   re-batched segment: at most the per-task 96 flash launches per
   forward); each output must meet the
   fused forward, and the planned, coalesced and compiled ones must equal
   the per-task output bit for bit; makespan, host dispatch wall, host
   calls, idle share (a trace of one more run), peak memory allocated and
   reserved are printed per run, and the table as ``LADDER_TABLE``;
8. north-star bench: ``eval/bench.run("small")`` on the card: calibration,
   greedy x1 per task (planned) and the fused forward (3 windows of 6
   runs each), the segmented and compiled legs (the same, their
   launches counted as phase 7 counts them), the pre-flight memory pass,
   the link measured on the card, and every ported policy placed on 8
   nodes and replayed; its JSON line is printed (``BENCH_LINE``), and
   each leg must launch the flash and LayerNorm kernels once per
   attention and layer norm of each forward it runs (the pre-flight once
   per distinct task), the oracle must hold, every policy but round-robin
   must complete and the MFUs and the compiled leg's host wall must be
   measured;
9. serve path: GPT-2 small bf16 at full width through the paged decode
   DAG (8 slots, page size 16, 257 pages, capacity 512), placed by
   ``greedy`` and served by ``DeviceBackend.paged_decode_engine`` in
   8-step segments: 16 requests, one warm-up run, then 3 timed runs, each
   with the paged kernel's launches counted (12 layers x 8 steps per
   segment) and the LayerNorm kernel's (25 per decode step and per
   prefill forward, all on the register kernel), no leaked pages, every
   request's token count, and a teacher-forced oracle against the fused
   forward; a traced segment gives device busy time and the paged and
   norm kernels' own device time;
10. Llama path: Llama-3 8B bf16 at full width and depth (batch 8, seq
    512, 8 microbatches, 8 vocab shards, linear chains fused: 1,945
    tasks), weights drawn on the card from a seeded generator,
    calibrated, placed by ``pipeline`` on 8 virtual nodes sharing the card
    and by ``greedy`` on one, executed with 256 flash and 520 RMSNorm
    launches (all on the register kernel) per forward in every counted
    run, the pipeline placement also compiled (one CUDA graph, a stream
    per stage node), and held against the fused forward;
11. f32 leg: a 2-layer GPT-2 small-width DAG placed on the card, planned
    and compiled, must be allclose to the port's fused forward run on the
    CPU with the plain versions;
12. f32 serve leg: a 2-layer GPT-2 small-width f32 engine serves 4
    requests on the card (kernels) and on the CPU (plain versions) from
    the same weights, and every request's tokens must be equal;
13. f32 Llama leg: Llama-3 8B widths at 2 layers, placed by ``pipeline``
    on 8 virtual nodes on the card, planned and compiled, allclose to the
    fused forward on the CPU;
14. parameter streaming: ``eval/stream_bench.measure_streaming()`` at its
    defaults (GPT-2 medium bf16, batch 8, seq 512, greedy on one node
    capped at 0.3 of its params: per task, segmented, int8), its JSON
    printed (``STREAM_LINE``), each leg's flash and LayerNorm launches
    exactly one per attention and layer norm of each forward, every oracle
    true, the budget respected, evictions made, and the streamed run's
    allocator peak below the uncapped one's by at least half of (params
    − budget); then the flagship placed by ``mru`` on one node capped at
    0.35 of its params and by ``heft`` on 8 nodes of the card each capped
    at half its own union (``STREAM_HEFT``), streamed against the same
    placement unstreamed: bit-equal per task (and segmented without
    re-batching), within the fused forward's band, launches counted; and
    ``compiled=True, stream_params=True`` runs compiled at 4x the params
    (bit-equal to the unstreamed compiled run) and is refused with a
    STR002 or STR003 diagnosis at 0.3x.

The last lines are one JSON object of per-kernel numbers (``launches`` is
the count of the kernel's main path, ``launches_by_path`` each counted
run's own; for a captured run, the launches its graphs' replays made,
counted at each replay), the card's name and power limit as nvidia-smi reports them,
and ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --paged-timing [ROOT]

times only the single-token paged kernel of the package under ROOT
(another checkout, e.g. a parent commit unpacked with ``git archive``)
the way phase 4 does, and prints one JSON line; see :func:`paged_timing`.

    python3 chip_smoke.py --ragged-timing [ROOT]

does the same for the ragged paged kernel at the 32-token serving chunk;
see :func:`ragged_timing`.

    python3 chip_smoke.py --ragged-sweep ROOT GEOMETRIES [short]

times the tensor-core ragged kernel of ROOT at launch geometries given by
hand, with no check; see :func:`ragged_sweep`.

    python3 chip_smoke.py --norm-timing [ROOT]

does the same for the norm kernels of the package under ROOT at phase
5's three timed shapes; see :func:`norm_timing`.
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
# serve phase: GPT-2 small at full width, paged (capacity 512)
SERVE_GEOM = dict(slots=8, page_size=16, n_pages=257, pages_per_seq=32)
SERVE_SEG_STEPS = 8
SERVE_REPS = 3
# teacher-forced oracle: the emitted token's fused logit must lie within
# this of the row's fused maximum (a wrong token lies ~2 below it: the
# logits of N(0, 0.02) weights spread ~0.02 * sqrt(768) ~ 0.55)
ORACLE_GAP = 0.1
# paged kernels vs plain on the JAX bench's fixtures: the bench's own
# tolerance (eval/decode_bench.py allclose at atol = rtol = 1e-5)
PAGED_TOL = 1e-5
# Llama path: Llama-3 8B at full width and depth, the JAX package's
# flagship build (eval/ici_probe.py:192-196), linear chains fused
LLAMA_FLAGSHIP = dict(batch=8, seq_len=512, microbatches=8, vocab_shards=8)
LLAMA_TASKS = 1945
# the card's L2 cache: kernels that move a few MB are timed over distinct
# inputs totalling twice this, so no launch finds its input in L2
L2_BYTES = 50e6
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


def log_ptxas(build_log: str, only=("",)) -> None:
    """Registers, shared memory and spills of each kernel whose mangled
    name contains one of ``only``, as ptxas reported them while building
    (``-Xptxas=-v``)."""
    import re

    shown = False
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            shown = any(o in m.group(1) for o in only)
            if shown:
                log(f"  ptxas {m.group(1)}:")
        elif shown and ("spill" in line or "Used" in line):
            log(f"    {line.strip()}")


def ptxas_table(build_log: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) of every
    kernel in a build's ptxas report (``-Xptxas=-v``)."""
    import re

    rows, name, spills = [], None, (0, 0)
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    return rows


def log_norm_ptxas(build_log: str) -> dict:
    """One line for all of norms.cu's kernels (registers, spills), one for
    the register path's largest instance and one for each that spills."""
    rows = ptxas_table(build_log)
    if not rows:
        log("  ptxas norms.cu: no report (the library was built before)")
        return {}
    reg = [r for r in rows if "norm_reg_kernel" in r[0]]
    spilled = [r for r in rows if r[2] or r[3]]
    log(f"  ptxas norms.cu: {len(rows)} kernels ({len(reg)} register-path "
        f"instances), registers {min(r[1] for r in rows)}-"
        f"{max(r[1] for r in rows)}, spill stores "
        f"{sum(r[2] for r in rows)} bytes, spill loads "
        f"{sum(r[3] for r in rows)} bytes in {len(spilled)} kernels")
    for name, regs, st, ld in [max(reg, key=lambda r: r[1])] + spilled:
        log(f"    {regs} registers, spills {st}/{ld} bytes: {name}")
    return dict(kernels=len(rows), register_instances=len(reg),
                max_registers=max(r[1] for r in rows),
                spill_store_bytes=sum(r[2] for r in rows),
                spill_load_bytes=sum(r[3] for r in rows))


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


def attention_bound_ms(shape, dtype_name: str, causal: bool,
                       kv_heads=None) -> tuple:
    """Least time for one attention call: q, k, v read once and o written
    once over the memory rate (k and v at ``kv_heads`` heads under GQA),
    against the QK^T and PV products over the type's peak (causal: only
    the (T+1)/2 keys each query sees on average)."""
    B, H, T, hd = shape
    itemsize = 2 if dtype_name == "bfloat16" else 4
    nbytes = 2 * B * (H + (kv_heads or H)) * T * hd * itemsize
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    flops = 2 * 2 * hd * pairs
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_inputs(torch, rng, dev, shape, dname, layout, kv_heads):
    """q, k and v for one kernel case: contiguous (B, H, T, hd) tensors;
    with ``layout="qkv"`` the strided head views of one (B, T, 3*H*hd)
    product that ``models/gpt2.causal_attention`` hands the kernel; with
    ``layout="gqa"`` or ``"kv"`` k and v at ``kv_heads`` heads, as
    ``models/llama.gqa_attention`` hands them to ``gqa_mha``."""
    import numpy as np

    dt = getattr(torch, dname)
    B, H, T, hd = shape
    if layout in ("gqa", "kv"):
        kv = (B, kv_heads, T, hd)
        return tuple(
            torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
            .to(dev, dt) for sh in (shape, kv, kv)
        )
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


def time_attention(torch, fn, args, n: int) -> tuple:
    """(device ms, back-to-back ms) per call of ``fn(*args)``: ``n`` calls
    captured into a CUDA graph and replayed, so the host's cost per call
    is not timed; and ``n`` calls issued from the host between CUDA
    events, which is what a caller that launches one call at a time sees
    once the kernel is shorter than the host's work per call.  The inputs
    are the same each call, so they sit in the L2, as the output of the
    op just before would."""
    return graph_ms(torch, fn, [args] * n), cuda_ms(lambda: fn(*args), n)


def check_attention_kernel(torch, A, dev, llama) -> dict:
    """The flash kernel against its plain version; returns the numbers of
    the kernel line at the GPT-2 main path's shape, with the Llama path's
    (through ``gqa_mha``, at the shape config ``llama`` gives each
    attention task of the Llama flagship) under ``at_llama_shape``."""
    import numpy as np
    import torch.nn.functional as F

    llama_shape = (
        LLAMA_FLAGSHIP["batch"] // LLAMA_FLAGSHIP["microbatches"],
        llama.n_heads, LLAMA_FLAGSHIP["seq_len"], llama.head_dim,
    )
    cases = [  # (shape, dtype, causal, layout, KV heads)
        ((1, 12, 512, 64), "bfloat16", True, "heads", None),  # main path, per task
        ((1, 12, 512, 64), "bfloat16", True, "qkv", None),    # ... as the model's views
        # the segmented rung's re-batched microbatch siblings: one call at batch 8
        ((8, 12, 512, 64), "bfloat16", True, "heads", None),
        ((8, 12, 512, 64), "bfloat16", True, "qkv", None),
        # the stream phase's GPT-2 medium bench: one call a layer at batch 8
        ((8, 16, 512, 64), "bfloat16", True, "heads", None),
        ((8, 16, 512, 64), "bfloat16", True, "qkv", None),
        (llama_shape, "bfloat16", True, "gqa", llama.n_kv_heads),  # Llama-3 8B, per task
        ((1, 12, 512, 64), "float32", True, "heads", None),
        ((2, 3, 100, 64), "float32", False, "heads", None),   # ragged T, full attention
        ((1, 4, 256, 32), "bfloat16", True, "heads", None),
        ((1, 4, 300, 128), "float32", True, "heads", None),
        ((1, 4, 300, 128), "bfloat16", False, "heads", None),
        # the tensor-core kernel's edges: each head dim, T of one row and
        # ending inside a tile, full attention, KV heads read in place by
        # flash_attention itself, strided views against contiguous copies
        ((2, 3, 1, 64), "bfloat16", True, "heads", None),
        ((2, 3, 77, 32), "bfloat16", True, "heads", None),
        ((2, 3, 77, 128), "bfloat16", False, "heads", None),
        ((1, 4, 300, 32), "bfloat16", False, "heads", None),
        ((1, 4, 300, 128), "bfloat16", True, "heads", None),
        ((1, 8, 300, 128), "bfloat16", True, "kv", 2),
        ((2, 8, 77, 64), "bfloat16", False, "kv", 4),
        ((1, 4, 300, 128), "bfloat16", True, "qkv", None),
        ((2, 2, 77, 32), "bfloat16", False, "qkv", None),
        ((1, 8, 200, 128), "float32", True, "kv", 2),
    ]
    rng = np.random.default_rng(0)
    main = None
    for shape, dname, causal, layout, kv_heads in cases:
        q, k, v = attention_inputs(torch, rng, dev, shape, dname, layout, kv_heads)
        group = q.shape[1] // k.shape[1]
        kr, vr = k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)
        got = (A.gqa_mha(q, k, v, causal=causal) if layout == "gqa"
               else A.flash_attention(q, k, v, causal=causal))
        torch.cuda.synchronize()
        want = A.reference_mha(q, kr, vr, causal=causal)
        err = (got.float() - want.float()).abs().max().item()
        # the same function in f32 from the same inputs: isolates the
        # kernel's own output rounding from the plain version's bf16 steps
        want32 = A.reference_mha(q.float(), kr.float(), vr.float(), causal=causal)
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
        same = ""
        if layout == "qkv":  # strided views read in place, bit for bit
            dense = A.flash_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=causal)
            equal = bool(torch.equal(got, dense))
            same = f", equal to contiguous copies: {equal}"
            ok = ok and equal
        log(f"  flash_attention {shape} {dname} causal={causal} {layout}"
            f"{f' {kv_heads} KV heads' if kv_heads else ''}: max_abs_err "
            f"{err:.3e} vs plain (tol {KERNEL_TOL[dname]:g}), {err32:.3e} vs "
            f"plain in f32 ({rule32}){same} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(
                f"flash kernel disagrees at {shape} {dname} {layout}")
        if main is None:
            ms, ms_b2b = time_attention(
                torch, lambda *a: A.flash_attention(*a, causal=True), (q, k, v), 200)
            plain_ms = graph_ms(torch, lambda *a: A.reference_mha(*a, causal=True),
                                [(q, k, v)] * 20)
            lib_ms, lib_b2b = time_attention(
                torch, lambda *a: F.scaled_dot_product_attention(*a, is_causal=True),
                (q, k, v), 200)
            bound_ms, bound_by = attention_bound_ms(shape, dname, True)
            main = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=lib_ms, ms_back_to_back=ms_b2b,
                        library_ms_back_to_back=lib_b2b)
            log(f"  at the main path's shape {shape} {dname} (CUDA-graph "
                f"replays; issued back to back from the host in brackets): "
                f"kernel {ms:.5f} ms ({ms_b2b:.5f}), plain {plain_ms:.5f} ms, "
                f"SDPA {lib_ms:.5f} ms ({lib_b2b:.5f}), bound "
                f"{bound_ms * 1e3:.3f} us ({bound_by})")
        if layout == "gqa":
            # the Llama path's call: gqa_mha, one launch on the un-repeated K/V
            ms, ms_b2b = time_attention(torch, A.gqa_mha, (q, k, v), 100)
            plain_ms = graph_ms(torch, A.reference_mha, [(q, kr, vr)] * 10)
            lib_ms, lib_b2b = time_attention(
                torch, lambda *a: F.scaled_dot_product_attention(
                    *a, is_causal=True, enable_gqa=True), (q, k, v), 100)
            bound_ms, bound_by = attention_bound_ms(shape, dname, True, k.shape[1])
            main["at_llama_shape"] = dict(
                shape=list(shape), kv_heads=k.shape[1], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms, ms_back_to_back=ms_b2b,
                library_ms_back_to_back=lib_b2b)
            log(f"  at the Llama path's shape {shape} {dname}, {k.shape[1]} KV "
                f"heads (gqa_mha: one launch, K/V read in place; CUDA-graph "
                f"replays, back to back in brackets): {ms:.5f} ms "
                f"({ms_b2b:.5f}), plain (K/V repeated) {plain_ms:.5f} ms, SDPA "
                f"(enable_gqa) {lib_ms:.5f} ms ({lib_b2b:.5f}), bound "
                f"{bound_ms * 1e3:.3f} us ({bound_by})")
    return main


def norm_inputs(torch, rng, dev, shape, dname, offset=False, pad=0):
    """x, g and b for one norm case from numpy ``rng``.  ``offset`` rows
    sit at 1e4 + k/8 with each row's integer k summing to a multiple of D,
    so the mean and every partial sum are exact in f32; ``pad`` makes x a
    view of a wider buffer (strided rows, unaligned base)."""
    import numpy as np

    dt = getattr(torch, dname)
    D = shape[-1]
    if offset:
        k = np.round(8.0 * rng.standard_normal(shape)).reshape(-1, D)
        for row in k:
            row[: int(row.sum()) % D] -= 1
        x = 1e4 + k.reshape(shape) / 8.0
    else:
        x = rng.standard_normal(shape)
    x = torch.from_numpy(x.astype(np.float32)).to(dev, dt)
    if pad:
        wide = torch.zeros(shape[:-1] + (D + 2 * pad,), dtype=dt, device=dev)
        wide[..., pad:pad + D] = x
        x = wide[..., pad:pad + D]
    g, b = (torch.from_numpy(rng.standard_normal(D).astype(np.float32)).to(dev, dt)
            for _ in range(2))
    return x, g, b


def norm_work(x, kind: str) -> tuple:
    """(bytes, flops) one norm call needs: x read once, g (and b) read
    once, the output written once; per element 8 f32 operations for
    LayerNorm (sum; centre, square, sum; centre, scale, gain, bias), 4 for
    RMSNorm (square, sum; scale, gain)."""
    n, D, esz = x.numel(), x.shape[-1], x.element_size()
    weights = 2 if kind == "ln" else 1
    return 2 * n * esz + weights * D * esz, (8 if kind == "ln" else 4) * n


def graph_ms(torch, fn, inputs, reps: int = 5) -> float:
    """Mean ms per call of ``fn(*args)`` over ``inputs``: the calls are
    captured once into a CUDA graph (so the host's launch cost is not
    timed) and the graph is replayed ``reps`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        for args in inputs[:3]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in inputs:
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (reps * len(inputs))


# norm kernel cases: (kernel, shape, dtype, offset rows, pad), each with
# the variant ``norm_plan`` must pick for it; the main paths' shapes first
NORM_CASES = [
    ("ln", (1, 512, 768), "bfloat16", False, 0, "register"),   # GPT-2 flagship task
    ("ln", (8, 512, 768), "bfloat16", False, 0, "register"),   # ... re-batched segment
    ("ln", (8, 512, 1024), "bfloat16", False, 0, "register"),  # GPT-2 medium stream bench
    ("ln", (8, 1, 768), "bfloat16", False, 0, "register"),     # GPT-2 decode step
    ("rms", (1, 512, 4096), "bfloat16", False, 0, "register"),  # Llama-3 8B task
    ("ln", (1, 512, 768), "float32", False, 0, "register"),
    ("rms", (1, 512, 4096), "float32", False, 0, "register"),
    ("ln", (77, 100), "float32", False, 0, "register"),
    ("rms", (77, 100), "float32", False, 0, "register"),
    ("ln", (77, 128), "bfloat16", False, 0, "register"),
    ("rms", (77, 128), "bfloat16", False, 0, "register"),
    ("ln", (3, 40, 100), "bfloat16", False, 3, "streaming"),
    ("rms", (3, 40, 128), "float32", False, 1, "streaming"),
    ("ln", (5, 1500), "float32", False, 0, "register"),
    ("rms", (5, 1500), "bfloat16", False, 5, "streaming"),
    ("ln", (4, 128), "float32", True, 0, "register"),
    ("ln", (4, 100), "float32", True, 0, "register"),
    ("rms", (4, 100), "float32", True, 0, "register"),
    # the register instances' edges (bf16: 8 elements a vector; a warp
    # holds up to 1,024 a row, a block up to 8,192) and what streams
    ("ln", (33, 8), "bfloat16", False, 0, "register"),
    ("rms", (33, 256), "bfloat16", False, 0, "register"),
    ("ln", (33, 257), "bfloat16", False, 0, "streaming"),
    ("rms", (33, 1024), "bfloat16", False, 0, "register"),
    ("ln", (33, 1025), "bfloat16", False, 0, "streaming"),
    ("ln", (33, 1032), "bfloat16", False, 0, "register"),
    ("ln", (9, 4096), "bfloat16", False, 0, "register"),
    ("ln", (9, 8192), "bfloat16", False, 0, "register"),
    ("rms", (9, 8192), "bfloat16", False, 0, "register"),
    ("ln", (9, 8200), "bfloat16", False, 0, "streaming"),
    ("rms", (9, 4100), "float32", False, 0, "streaming"),
    ("ln", (3, 40, 768), "bfloat16", False, 8, "register"),   # strided, aligned
    ("ln", (3, 40, 768), "bfloat16", False, 4, "streaming"),  # 8 bytes off
    # more rows than the card holds blocks: the grid-stride loop
    ("ln", (20000, 768), "bfloat16", False, 0, "register"),
    ("rms", (3000, 4096), "bfloat16", False, 0, "register"),
]
# (kernel, shape) timed, bf16: the GPT-2 flagship task's LayerNorm, a
# GPT-2 decode step's (10,400 of a serve run's 10,475 LayerNorm launches),
# the Llama-3 8B task's RMSNorm
NORM_TIMED = (("ln", (1, 512, 768)), ("ln", (8, 1, 768)),
              ("rms", (1, 512, 4096)))
# the plain version, a chain of ~10 launches, is timed over at most this
# many of the distinct inputs (a decode step's shape needs ~8,100)
NORM_PLAIN_INPUTS = 1024


def norm_fns(torch, N):
    """Kernel, plain version and one-call library yardstick of each norm."""
    import torch.nn.functional as F

    return (
        {"ln": N.layer_norm_kernel, "rms": N.rms_norm_kernel},
        {"ln": N.reference_layer_norm, "rms": N.reference_rms_norm},
        {"ln": lambda x, g, b: F.layer_norm(x, (x.shape[-1],), g, b, 1e-5),
         "rms": lambda x, g: F.rms_norm(x, (x.shape[-1],), g, 1e-5)},
    )


def norm_plan_of(N, args):
    """``N.norm_plan`` for a norm call on ``args`` (x, g[, b]), or None for
    a package that predates it; the output, a fresh allocation, counts as
    16-byte aligned, as the caching allocator's blocks are."""
    if not hasattr(N, "norm_plan"):
        return None
    x2 = args[0].reshape(-1, args[0].shape[-1])
    return N.norm_plan(x2.shape[0], x2.shape[1], x2.stride(0), x2.dtype,
                       x2.data_ptr(), 0, [w.data_ptr() for w in args[1:]])


def time_norm(torch, N, kind, args, rng, dev, yardsticks=True) -> dict:
    """One norm kernel at ``args``' shape, as CUDA-graph replays over
    distinct inputs totalling 2x the L2 (and one input repeated, L2-
    resident), with its bytes bound, the per-launch floor of an empty
    kernel on the same grid in the same kind of graph (when the package
    has one), and, with ``yardsticks``, the plain version's and the
    library call's times."""
    kernel, plain, library = (f[kind] for f in norm_fns(torch, N))
    x = args[0]
    shape, dname = tuple(x.shape), str(x.dtype).split(".")[-1]
    n = max(8, math.ceil(2 * L2_BYTES / (x.numel() * x.element_size())))
    inputs = [args] + [
        norm_inputs(torch, rng, dev, shape, dname)[:len(args)]
        for _ in range(n - 1)]
    nbytes, flops = norm_work(x, kind)
    bound_ms, bound_by = bound_of(nbytes, flops, "float32")
    out = dict(shape=list(shape), distinct_inputs=n,
               ms=graph_ms(torch, kernel, inputs),
               ms_l2_resident=graph_ms(torch, kernel, [args] * n),
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
               flops=flops)
    plan = norm_plan_of(N, args)
    if plan is not None:
        out["variant"] = plan.variant
        out["instance"] = [plan.threads_per_row, plan.vecs_per_thread]
    if plan is not None and hasattr(N, "empty_kernel"):
        out["floor_ms"] = graph_ms(
            torch, lambda: N.empty_kernel(plan.blocks, dev), [()] * n)
        out["floor_blocks"] = plan.blocks
    if yardsticks:
        out["plain_ms"] = graph_ms(torch, plain, inputs[:NORM_PLAIN_INPUTS])
        out["plain_inputs"] = min(n, NORM_PLAIN_INPUTS)
        out["library_ms"] = graph_ms(torch, library, inputs)
    return out


def log_norm_time(name: str, t: dict) -> None:
    lib = "F.layer_norm" if name == "layer_norm" else "F.rms_norm"
    floor = (f", empty-kernel floor {t['floor_ms']:.5f} ms on "
             f"{t['floor_blocks']} blocks" if "floor_ms" in t else "")
    yard = (f", plain {t['plain_ms']:.5f} ms (over {t['plain_inputs']} of "
            f"them), library {lib} {t['library_ms']:.5f} ms"
            if "plain_ms" in t else "")
    log(f"  {name} {tuple(t['shape'])} bf16 ({t.get('variant', 'one kernel')}"
        f"{' ' + str(tuple(t['instance'])) if 'instance' in t else ''}), over "
        f"{t['distinct_inputs']} distinct inputs (2x the L2): kernel "
        f"{t['ms']:.5f} ms (one input repeated, L2-resident: "
        f"{t['ms_l2_resident']:.5f} ms){floor}{yard}, bound "
        f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}: "
        f"{t['bytes'] / 1e6:.4f} MB, {t['flops'] / 1e6:.3f} MFLOP)")


def check_norm_kernels(torch, N, dev) -> dict:
    """Both norm kernels against their plain versions on NORM_CASES: the
    main paths' shapes, then f32, 77 rows, D = 100 and 128, strided rows,
    the block-per-row path with a tail, rows offset by 1e4, the register
    instances' edges and rows past the grid; each case must also take the
    variant it names.  Then NORM_TIMED are timed.  Returns each kernel's
    numbers at its main path's shape (LayerNorm's decode-step shape under
    ``at_serve_shape``)."""
    import numpy as np

    from distributed_llm_scheduler_tpu_torch.ops import kernels

    kernel, plain, _ = norm_fns(torch, N)
    cpu = torch.device("cpu")
    rng = np.random.default_rng(3)
    timed_args = {}
    for kind, shape, dname, offset, pad, variant in NORM_CASES:
        x, g, b = norm_inputs(torch, rng, dev, shape, dname, offset, pad)
        args = (x, g, b) if kind == "ln" else (x, g)
        name = N.LN_KERNEL if kind == "ln" else N.RMS_KERNEL
        before = {v: kernels.launches[f"{name}.{v}"]
                  for v in (N.REGISTER, N.STREAMING)}
        got = kernel[kind](*args)
        torch.cuda.synchronize()
        ran = [v for v, n in before.items()
               if kernels.launches[f"{name}.{v}"] == n + 1]
        plan = norm_plan_of(N, args)
        # offset rows: the plain version on the card takes the mean as
        # sum * (1/D), one rounding off these rows' exact mean (an ulp of
        # 1e4 is ~1e-3); on the CPU it divides, exactly, as the kernel does
        where = cpu if offset else dev
        want = plain[kind](*(t.to(where) for t in args)).to(dev)
        want32 = plain[kind](*(t.to(where).float() for t in args)).to(dev)
        err = (got.float() - want.float()).abs().max().item()
        diff32 = (got.float() - want32).abs()
        if dname == "bfloat16":
            out32 = int((diff32 > BF16_ROUNDOFF * want32.abs() + F32_SLACK).sum())
            rule32 = f"{out32} elements beyond 2^-8*|x|+{F32_SLACK:g}"
        else:
            out32 = 0 if diff32.max().item() < KERNEL_TOL[dname] else 1
            rule32 = f"tol {KERNEL_TOL[dname]:g}"
        finite = bool(torch.isfinite(got).all())
        ok = (finite and err < KERNEL_TOL[dname] and out32 == 0
              and got.shape == x.shape and got.dtype == x.dtype
              and ran == [variant])
        shape_ = (f" {plan.threads_per_row}x{plan.vecs_per_thread}"
                  if plan.vecs_per_thread else "")
        log(f"  {name} {shape} {dname}{' offset 1e4' if offset else ''}"
            f"{f' strided (pad {pad})' if pad else ''}: {'/'.join(ran)}"
            f"{shape_} (expected {variant}), max_abs_err {err:.3e} "
            f"vs plain{' (CPU)' if offset else ''} (tol {KERNEL_TOL[dname]:g}), "
            f"{diff32.max().item():.3e} vs plain in f32 ({rule32}) -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees at {shape} {dname}")
        if (kind, shape) in NORM_TIMED and dname == "bfloat16":
            timed_args[(kind, shape)] = args, err
    out = {}
    for kind, shape in NORM_TIMED:
        name = N.LN_KERNEL if kind == "ln" else N.RMS_KERNEL
        args, err = timed_args[(kind, shape)]
        t = dict(max_abs_err=err, **time_norm(torch, N, kind, args, rng, dev))
        log_norm_time(name, t)
        if name in out:
            out[name]["at_serve_shape"] = t
        else:
            out[name] = t
    return out


def busy_union_ms(torch, prof):
    """(busy ms, window ms): the milliseconds in which at least one kernel
    ran, the union of the trace's device intervals (kernels on concurrent
    streams overlap, so their summed times can exceed the wall), and the
    traced device window from the first kernel's start to the last one's
    end.  None when the trace carries no device intervals."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
        and e.time_range.end > e.time_range.start
    )
    if not spans:
        return None
    total, (lo, hi) = 0.0, spans[0]
    end = max(b for _, b in spans)
    for a, b in spans[1:]:
        if a > hi:
            total, lo, hi = total + hi - lo, a, b
        else:
            hi = max(hi, b)
    return (total + hi - lo) / 1e3, (end - spans[0][0]) / 1e3


def device_time_breakdown(torch, label: str, makespan_s: float, run):
    """Trace one more placed forward with torch.profiler: kernel time per
    forward (summed over kernels), device busy time (the union of their
    intervals), the device's idle share of the untraced makespan (1 - busy
    / makespan) and of the traced device window (tracing stretches kernels
    that share the card, so busy can exceed the untraced makespan), and
    the kernels that take most of it.  Returns (busy ms, idle share, idle
    share of the traced window), or None when the trace shows no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    rows = [
        (getattr(e, "self_device_time_total", 0.0), e.count, e.key)
        for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ]
    kernel_ms = sum(r[0] for r in rows) / 1e3
    if kernel_ms <= 0:
        log(f"  {label} trace: no device time in the trace (not measured)")
        return None
    union = busy_union_ms(torch, prof)
    if union is None:
        log(f"  {label} trace: kernel time {kernel_ms:.3f} ms per forward; "
            "no device intervals, so busy time and idle share not measured")
        return None
    busy_ms, window_ms = union
    share = 1.0 - busy_ms / (makespan_s * 1e3)
    traced = 1.0 - busy_ms / window_ms
    log(f"  {label} trace: kernel time {kernel_ms:.3f} ms per forward, "
        f"device busy {busy_ms:.3f} ms (union), idle share {share:.3f} of the "
        f"{makespan_s * 1e3:.3f} ms makespan ({traced:.3f} of the "
        f"{window_ms:.3f} ms traced window); {sum(r[1] for r in rows)} "
        f"device ops")
    for us, n, key in sorted(rows, reverse=True)[:6]:
        log(f"    {us / 1e3:8.3f} ms  {n:5d}x  {key[:90]}")
    log_norm_device_time(f"{label} trace", "per forward", rows)
    return busy_ms, share, traced


def log_norm_device_time(label: str, per: str, rows) -> float:
    """The norm kernels' device time in a trace's (us, count, name) rows,
    by kernel (csrc/norms.cu: norm_reg_kernel, norm_fwd_kernel)."""
    total = 0.0
    for kernel in ("norm_reg_kernel", "norm_fwd_kernel"):
        hit = [(us, n) for us, n, key in rows if kernel in key]
        if hit:
            us, n = sum(h[0] for h in hit), sum(h[1] for h in hit)
            total += us / 1e3
            log(f"  {label}, {kernel}: {us / 1e3:.3f} ms {per} over {n} "
                f"launches ({us / n:.2f} us each)")
    return total


def counted(label: str, expected: dict, run):
    """Run ``run()`` with every launch count set to 0 just before and the
    counts of the kernels in ``expected`` read just after; each must equal
    its expected number.  Returns (run's result, {kernel: count})."""
    from distributed_llm_scheduler_tpu_torch.ops import kernels

    kernels.reset_launches()
    out = run()
    got = {k: kernels.launches[k] for k in expected}
    log(f"  {label}: " + ", ".join(
        f"{k} launched {got[k]} times (expected {n})" for k, n in expected.items()))
    bad = {k: got[k] for k, n in expected.items() if got[k] != n}
    if bad:
        raise AssertionError(f"{label}: launch counts {bad} != {expected}")
    return out, got


def paged_work(torch, case) -> tuple:
    """(bytes, flops) the paged call on ``case`` needs: each slot's live
    K and V rows read once (up to the last position a real row sees; the
    pool's row at the insert position is not read), q, the inserted
    rows, the page table and lengths read once, the output written once;
    4 * hd flops per (query row, visible key)."""
    q = case["q"]
    S, Hq, Tn, hd = q.shape
    _, _, Hkv, _ = case["k_pool"].shape
    cap = case["page_table"].shape[1] * case["k_pool"].shape[1]
    esz = q.element_size()
    lengths = case["lengths"].tolist()
    q_lens = case["q_lens"].tolist() if "q_lens" in case else [1] * S
    inserted = case.get("k_new") is not None
    rows = pairs = 0
    for L, QL in zip(lengths, q_lens):
        if QL > 0:
            # the inserted row replaces the pool's row at min(L, cap-1)
            rows += min(L + QL - 1, cap - 1) + (0 if inserted else 1)
            pairs += sum(min(L + t, cap - 1) + 1 for t in range(QL))
    nbytes = 2 * rows * Hkv * hd * esz + 2 * q.numel() * esz
    nbytes += sum(case[k].numel() * case[k].element_size()
                  for k in ("page_table", "lengths", "q_lens", "k_new", "v_new")
                  if case.get(k) is not None)
    return nbytes, 4 * hd * Hq * pairs


def bound_of(nbytes: int, flops: int, dtype_name: str) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paged_serving_cases(torch, DB, dev) -> list:
    """Single-token serving cases of ``DB.serving_case`` at seeds 0, 1,
    ... (distinct pools), until the bytes their calls must move total
    twice the L2, as ``paged_decode_attention`` keyword arguments."""
    cases, total = [], 0
    while total < 2 * L2_BYTES:
        case = DB.serving_case(torch.bfloat16, dev, seed=len(cases))
        total += paged_work(torch, case)[0]
        cases.append({k: v for k, v in case.items() if k not in ("name", "real")})
    return cases


def time_paged_kernel(torch, A, cases) -> dict:
    """The single-token paged kernel at the serving shape: device ms per
    call as CUDA-graph replays over the distinct ``cases`` (no call finds
    its K/V in the L2), over case 0 repeated (L2-resident), and issued
    back to back from the host; with the bound of the cases' mean work."""
    def run(args):
        return A.paged_decode_attention(**args, impl="kernel")

    args = [(c,) for c in cases]
    ms = graph_ms(torch, run, args, reps=20)
    ms_l2 = graph_ms(torch, run, [args[0]] * len(args), reps=20)
    ms_b2b = cuda_ms(lambda: run(cases[0]), 200)
    work = [paged_work(torch, c) for c in cases]
    nbytes = sum(w[0] for w in work) / len(work)
    flops = sum(w[1] for w in work) / len(work)
    bound_ms, bound_by = bound_of(nbytes, flops, "bfloat16")
    return dict(ms=ms, ms_l2_resident=ms_l2, ms_back_to_back=ms_b2b,
                bound_ms=bound_ms, bound_by=bound_by, distinct_inputs=len(cases),
                distinct_bytes=nbytes * len(cases))


def ragged_serving_cases(torch, DB, dev) -> list:
    """Ragged serving chunks (32 query tokens) of ``DB.serving_case`` at
    seeds 0, 1, ... (distinct pools), until the bytes their calls must
    move total twice the L2, as ``paged_decode_attention`` keyword
    arguments; ``real`` stays beside them for the checks."""
    cases, total = [], 0
    while total < 2 * L2_BYTES:
        case = DB.serving_case(torch.bfloat16, dev, seed=len(cases), q_tokens=32)
        total += paged_work(torch, case)[0]
        cases.append({k: v for k, v in case.items() if k != "name"})
    return cases


def ragged_variant(A, case) -> str:
    """The variant ``A.ragged_plan`` picks for a ragged case, or "walk"
    for a package that predates the plan (one kernel)."""
    if not hasattr(A, "ragged_plan"):
        return "walk"
    import torch

    S, Hq, Tn, hd = case["q"].shape
    _, ps, Hkv, _ = case["k_pool"].shape
    sms = torch.cuda.get_device_properties(case["q"].device).multi_processor_count
    return A.ragged_plan(case["q"].dtype, S, Hq, Hkv, Tn, hd, ps,
                         case["page_table"].shape[1], sms).variant


def time_ragged_kernel(torch, A, cases) -> dict:
    """The ragged kernel at the serving chunk, timed as
    :func:`time_paged_kernel` times the single-token one: CUDA-graph
    replays over the distinct ``cases``, case 0 repeated (L2-resident),
    back to back, and the bound of the cases' mean work; with the
    variant that ran."""
    args = [{k: v for k, v in c.items() if k != "real"} for c in cases]
    return dict(time_paged_kernel(torch, A, args),
                variant=ragged_variant(A, args[0]))


def ragged_beyond_rule(torch, A, case) -> tuple:
    """(elements beyond 2^-8 |x| + 1e-4 of the f32 plain version on the
    case's real rows, finite) of the ragged kernel's output on ``case``."""
    args = {k: v for k, v in case.items() if k not in ("name", "real")}
    got = A.paged_decode_attention(**args, impl="kernel").float()
    want32 = A.paged_decode_attention(**{
        k: (v.float() if torch.is_tensor(v) and v.is_floating_point() else v)
        for k, v in args.items()}, impl="plain")
    beyond = ((got - want32).abs() > BF16_ROUNDOFF * want32.abs() + F32_SLACK)
    return (int((beyond & case["real"].expand_as(got).bool()).sum()),
            bool(torch.isfinite(got).all()))


def check_paged_kernels(torch, A, DB, dev) -> dict:
    """Both paged kernels against their plain versions; returns each
    kernel's numbers at the serving shape."""
    import torch.nn.functional as F

    from distributed_llm_scheduler_tpu_torch.models.kv_pages import gather_kv

    from distributed_llm_scheduler_tpu_torch.ops import kernels

    for label, cases in (("single-token", DB.paged_parity_cases(device=dev)),
                         ("ragged", DB.ragged_parity_cases(device=dev))):
        ran = {}
        for c in cases:  # each ragged fixture on the variant its plan names
            kernels.reset_launches()
            res = DB.op_parity([c], kernel_impl="kernel")
            torch.cuda.synchronize()
            r = res["fixtures"][c["name"]]
            ok = r["allclose"] and r["finite"]
            variant = ""
            if label == "ragged":
                want = ragged_variant(A, c)
                ran = [v for v in (A.RAGGED_TC, A.RAGGED_WALK) if kernels.launches[
                    f"{A.PAGED_RAGGED_KERNEL}.{v}"] == 1]
                ok = ok and ran == [want]
                variant = f", variant {'/'.join(ran)} (plan: {want})"
            log(f"  {label} fixture {c['name']}: max_abs_err {r['max_abs_err']:.3e} "
                f"(f32, tol {PAGED_TOL:g}), finite={r['finite']}{variant} -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(
                    f"paged {label} kernel fails the bench fixture {c['name']}")

    out = {}
    for kname, q_tokens in ((A.PAGED_KERNEL, 1), (A.PAGED_RAGGED_KERNEL, 32)):
        case = DB.serving_case(torch.bfloat16, dev, seed=0, q_tokens=q_tokens)
        args = {k: v for k, v in case.items() if k not in ("name", "real")}
        kernels.reset_launches()
        got = A.paged_decode_attention(**args, impl="kernel")
        torch.cuda.synchronize()
        variant = ""
        if q_tokens > 1:  # the serving chunk runs on the tensor cores
            variant = A.RAGGED_TC
            if kernels.launches[f"{A.PAGED_RAGGED_KERNEL}.{A.RAGGED_TC}"] != 1:
                raise AssertionError(f"{kname}: the serving chunk did not run "
                                     f"on the {A.RAGGED_TC} variant")
        want = A.paged_decode_attention(**args, impl="plain")
        args32 = {k: (v.float() if torch.is_tensor(v) and v.is_floating_point()
                      else v) for k, v in args.items()}
        want32 = A.paged_decode_attention(**args32, impl="plain")
        m = (case["real"].expand_as(got) if "real" in case
             else torch.ones_like(got, dtype=torch.float32))
        err = ((got.float() - want.float()).abs() * m).max().item()
        diff32 = (got.float() - want32).abs()
        out32 = int(((diff32 > BF16_ROUNDOFF * want32.abs() + F32_SLACK)
                     * m.bool()).sum())
        finite = bool(torch.isfinite(got).all())
        ok = finite and err < KERNEL_TOL["bfloat16"] and out32 == 0
        log(f"  {kname} serving shape {tuple(case['q'].shape)} bf16, lengths "
            f"{case['lengths'].tolist()}"
            + (f", q_lens {case['q_lens'].tolist()}" if "q_lens" in case else "")
            + f": max_abs_err {err:.3e} vs plain (tol {KERNEL_TOL['bfloat16']:g}), "
            f"{(diff32 * m).max().item():.3e} vs plain in f32 ({out32} elements "
            f"beyond 2^-8*|x|+{F32_SLACK:g}), finite={finite}"
            + (f", variant {variant}" if variant else "") + " -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{kname} disagrees at the serving shape")
        if q_tokens == 1:
            timed = time_paged_kernel(torch, A, paged_serving_cases(torch, DB, dev))
        else:
            timed = time_ragged_kernel(torch, A, ragged_serving_cases(torch, DB, dev))
        ms = timed.pop("ms")
        plain_ms = cuda_ms(lambda: A.paged_decode_attention(**args, impl="plain"), 50)
        S, H, Tn, hd = case["q"].shape
        cap = case["page_table"].shape[1] * case["k_pool"].shape[1]
        top = case["lengths"].long() + (case["q_lens"].long().clamp(min=1) - 1
                                        if "q_lens" in case else 0)
        mask = (torch.arange(cap, device=dev)[None, :] <= top[:, None])
        mask = mask[:, None, None, :]
        if Tn > 1:
            t = torch.arange(Tn, device=dev)[None, :, None]
            mask = (torch.arange(cap, device=dev)[None, None, :]
                    <= (case["lengths"].long()[:, None, None] + t))[:, None]

        def yardstick():
            k = gather_kv(case["k_pool"], case["page_table"])
            v = gather_kv(case["v_pool"], case["page_table"])
            return F.scaled_dot_product_attention(case["q"], k, v, attn_mask=mask)

        yard_ms = cuda_ms(yardstick, 100)
        nbytes, flops = paged_work(torch, case)
        bound_ms, bound_by = bound_of(nbytes, flops, "bfloat16")
        log(f"  {kname} at the serving shape, CUDA-graph replays over "
            f"{timed['distinct_inputs']} distinct cases "
            f"({timed['distinct_bytes'] / 1e6:.1f} MB to move, 2x the L2): "
            f"kernel {ms:.5f} ms (case 0 repeated, L2-resident: "
            f"{timed['ms_l2_resident']:.5f} ms; issued back to back: "
            f"{timed['ms_back_to_back']:.5f} ms), bound of the cases' mean "
            f"work {timed['bound_ms'] * 1e3:.3f} us ({timed['bound_by']})"
            + (f", variant {timed['variant']}" if "variant" in timed else ""))
        bound_ms, bound_by = timed.pop("bound_ms"), timed.pop("bound_by")
        log(f"  {kname} at the serving shape: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms * 1e3:.3f} us ({bound_by}: "
            f"{nbytes / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP for case 0); "
            f"library_ms null (no single PyTorch call computes paged "
            f"attention); yardstick of two calls, gather_kv of K and V + "
            f"scaled_dot_product_attention: {yard_ms:.4f} ms")
        out[kname] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                          yardstick_two_calls_ms=yard_ms, **timed)
    return out


def run_ragged_op_path(torch, A, DB, dev) -> dict:
    """The ragged kernel's path: ``paged_decode_attention(..., q_lens=...)``
    with the device's own dispatch, over the decode bench's ragged sweep
    (f32) and two serving-shape chunks (bf16), counted in all and by the
    variant each call's plan names.  Returns the counts."""
    cases = DB.ragged_parity_cases(device=dev) + [
        DB.serving_case(torch.bfloat16, dev, seed=s, q_tokens=32) for s in (4, 5)]
    expected = {A.PAGED_RAGGED_KERNEL: len(cases)}
    for v in (A.RAGGED_TC, A.RAGGED_WALK):
        expected[f"{A.PAGED_RAGGED_KERNEL}.{v}"] = sum(
            ragged_variant(A, c) == v for c in cases)

    def run():
        outs = []
        for c in cases:
            args = {k: v for k, v in c.items() if k not in ("name", "real")}
            outs.append(A.paged_decode_attention(**args))
        torch.cuda.synchronize()
        return outs

    outs, n = counted("ragged op path", expected, run)
    if not all(bool(torch.isfinite(o).all()) for o in outs):
        raise AssertionError("ragged op path: non-finite output")
    return n


def times(per_forward: dict, n: int) -> dict:
    return {k: v * n for k, v in per_forward.items()}


def run_main_path(torch, P, dev) -> dict:
    """The GPT-2 flagship DAG, calibrated, placed twice, executed.
    Returns each run's own launch counts."""
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

    # layer norms per forward: ln1 and ln2 per layer, final_ln, per microbatch
    n_ln = sum(1 for t in dag.graph
               if t.task_id.endswith(("_ln1", "_ln2", "final_ln")))
    # ... every one of them on the register kernel
    per_forward = {"flash_attention": n_attn, "layer_norm": n_ln,
                   "layer_norm.register": n_ln}
    log(f"  per forward: {n_attn} flash and {n_ln} layer_norm launches")

    launches = {}
    t0 = time.perf_counter()
    cm, launches["calibrate"] = counted(
        "calibrate", times(per_forward, 1 + 3),
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
            label, times(per_forward, 1 + REPS), lambda: backend.execute(
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


# the execution ladder on the flagship: (label, nodes, policy, rungs); each
# rung is (name, execute() flags, output promised bit-equal to per task)
LADDER = (
    ("greedy x1", 1, "greedy", (
        ("per task", dict(planned=False), True),
        ("planned", {}, True),
        ("coalesced", dict(coalesce=True), True),
        ("segmented", dict(segments=True), False),
        ("compiled", dict(compiled=True), True),
    )),
    ("heft x8", 8, "heft", (
        ("per task", dict(planned=False), True),
        ("planned", {}, True),
        ("segmented", dict(segments=True), False),
        ("compiled", dict(compiled=True), True),
    )),
)


def run_ladder_path(torch, P, dev) -> dict:
    """The GPT-2 flagship through every rung of the execution ladder:
    per task, planned, coalesced, segmented (captured segments, siblings
    re-batched) and compiled (the whole run one CUDA graph, a stream per
    node), under greedy x1 and heft x8.  Each rung's run has its counts set
    to 0 just before and read just after: an eager rung must launch the
    flash and LayerNorm kernels once per attention and layer norm of each
    forward it runs; a captured rung's wrappers count in its warm-up and
    its capture only (2x the kernels in its graphs), and its launches are
    those its graphs' replays made (``kernels.replayed``, counted at each
    replay), which must be the kernels in its graphs times the runs.  Each
    output meets the fused forward, and the planned, coalesced and
    compiled outputs equal the per-task output bit for bit.  Returns each
    run's launches."""
    from distributed_llm_scheduler_tpu_torch.ops import attention as A
    from distributed_llm_scheduler_tpu_torch.ops import kernels
    from distributed_llm_scheduler_tpu_torch.ops import norms as N

    cfg = P.GPT2Config.small(dtype=torch.bfloat16)
    dag = P.build_gpt2_dag(cfg, **FLAGSHIP)
    graph = P.fuse_linear_chains(dag.graph)
    params = dag.init_params(seed=0, device=dev)
    ids = dag.make_inputs(seed=1, device=dev)
    mb = FLAGSHIP["microbatches"]
    n_ln = 2 * cfg.n_layer + 1
    per_forward = {A.KERNEL: mb * cfg.n_layer, N.LN_KERNEL: mb * n_ln}
    # references on the host, so the card's peak is the rung's own
    fused = dag.reference_forward(params, ids).cpu()
    launches, table = {}, []
    for label, n, policy, rungs in LADDER:
        cluster = P.Cluster.from_torch_devices([dev] * n)
        sched = P.get_scheduler(policy).schedule(graph, cluster)
        backend = P.DeviceBackend(cluster)
        base = None
        for rung, kw, bit_equal in rungs:
            name = f"{label} {rung}"
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated(dev) / 1024**3
            kernels.reset_launches()
            rep = backend.execute(graph, sched, params, ids, reps=REPS, **kw)
            torch.cuda.synchronize()
            eager = {k: kernels.launches[k] for k in per_forward}
            replayed = {k: kernels.replayed.get(k, 0) for k in per_forward}
            out = rep.output.cpu()  # read before the program runs again
            captured = {k: rep.captured_launches.get(k, 0) for k in per_forward}
            if rep.captured_launches:
                if eager != {k: 2 * v for k, v in captured.items()}:
                    raise AssertionError(f"{name}: eager {eager} != 2 x "
                                         f"captured {captured}")
                if captured[A.KERNEL] > per_forward[A.KERNEL] or (
                        kw.get("compiled") and captured != per_forward):
                    raise AssertionError(f"{name}: captured {captured}")
                # every run replayed every graph: the warm-up and REPS runs
                if replayed != times(captured, 1 + REPS):
                    raise AssertionError(f"{name}: replays launched "
                                         f"{replayed}, captured {captured}")
                launches[name] = replayed
            else:
                if eager != times(per_forward, 1 + REPS):
                    raise AssertionError(f"{name}: launches {eager}")
                launches[name] = eager
            ok, viol, allowed, rel = oracle_close(fused, out)
            finite = bool(torch.isfinite(out).all())
            if base is None:
                base = out
            same = torch.equal(out, base)
            if not (ok and finite) or (bit_equal and not same):
                raise AssertionError(
                    f"{name}: oracle {ok} ({viol} outside the band, rel "
                    f"{rel:.3e}), finite {finite}, bit-equal to per task "
                    f"{same}")
            peak = sum(rep.peak_hbm_bytes.values()) / 1024**3
            reserved = torch.cuda.memory_reserved(dev) / 1024**3
            tr = device_time_breakdown(
                torch, name, rep.makespan_s, lambda: backend.execute(
                    graph, sched, params, ids, warmup=False, reps=1, **kw))
            row = dict(
                run=name, makespan_ms=rep.makespan_s * 1e3,
                dispatch_ms=rep.dispatch_overhead_s * 1e3,
                host_calls=rep.n_dispatches,
                flash=launches[name][A.KERNEL] // (1 + REPS),
                layer_norm=launches[name][N.LN_KERNEL] // (1 + REPS),
                busy_ms=tr[0] if tr else None, idle=tr[1] if tr else None,
                idle_traced=tr[2] if tr else None,
                peak_gib=peak, held_gib=held, reserved_gib=reserved,
                transfer_edges=rep.transfer_edges, bit_equal=same,
                warmup_s=rep.compile_s)
            table.append(row)
            log(f"  {name}: makespan {row['makespan_ms']:.3f} ms (mean of "
                f"{REPS}), host dispatch {row['dispatch_ms']:.3f} ms in "
                f"{rep.n_dispatches} host calls, per run {row['flash']} flash "
                f"and {row['layer_norm']} layer_norm launches"
                f"{' (captured)' if rep.captured_launches else ''}, idle "
                f"{row['idle']}, peak {peak:.3f} GiB allocated ({held:.3f} held "
                f"before the run, {reserved:.3f} reserved), "
                f"{rep.transfer_edges} transfer edges, rel "
                f"Frobenius {rel:.3e} vs fused, bit-equal to per task {same}, "
                f"warmup {rep.compile_s:.2f} s")
            del rep, out
        del backend
        torch.cuda.empty_cache()
    print("LADDER_TABLE " + json.dumps(table), flush=True)
    return launches


def run_bench_path(torch, P, dev) -> dict:
    """The port's north-star bench (``eval/bench.run("small")``) on the card:
    calibration, the per-task and fused legs, the pre-flight, the replay of
    every ported policy.  Prints its JSON line and each leg's launches;
    fails unless the oracle holds, every policy but round-robin completes,
    the MFU was measured and each leg launched the kernels as many times as
    its forwards need.  Returns each leg's launch counts."""
    from distributed_llm_scheduler_tpu_torch.eval import bench
    from distributed_llm_scheduler_tpu_torch.ops import attention as A
    from distributed_llm_scheduler_tpu_torch.ops import kernels
    from distributed_llm_scheduler_tpu_torch.ops import norms as N

    cfg = P.GPT2Config.small()
    mb = bench.CONFIGS["small"][2]["microbatches"]
    n_ln = 2 * cfg.n_layer + 1
    ln_reg = N.LN_KERNEL + ".register"
    # the DAG runs each microbatch's layers as tasks; the fused forward
    # runs the whole batch through each layer once
    per_dag = {A.KERNEL: mb * cfg.n_layer, N.LN_KERNEL: mb * n_ln,
               ln_reg: mb * n_ln}
    per_fused = {A.KERNEL: cfg.n_layer, N.LN_KERNEL: n_ln, ln_reg: n_ln}
    reps = bench.REPS
    # the segmented leg's one captured segment re-batches the microbatch
    # siblings: one launch per layer's op, as the fused forward
    replays = 2 + bench.WINDOWS * reps
    expected = {
        # each calibration window warms up once, then profiles
        "calibrate": times(per_dag, bench.CAL_WINDOWS * (1 + bench.CAL_REPEATS)),
        "per_task": times(per_dag, 2 + bench.WINDOWS * reps),
        "fused": times(per_fused, 2 + 2 * bench.WINDOWS * reps),
        # a captured leg's wrappers count in its warm-up and its capture;
        # its launches are those its graph's replays made, counted at each
        # replay: the kernels in its graph times the replays
        "segmented_eager": times(per_fused, 2),
        "segmented": times(per_fused, replays),
        "compiled_eager": times(per_dag, 2),
        "compiled": times(per_dag, replays + bench.WINDOWS),
    }
    kernels.reset_launches()
    t0 = time.perf_counter()
    result = bench.run("small", dev, reps=reps)
    total = {k: kernels.launches.get(k, 0) for k in per_dag}
    line = result.to_json()
    print("BENCH_LINE " + json.dumps(line), flush=True)
    legs = result.launches
    log(f"  bench in {time.perf_counter() - t0:.1f} s; launches per leg: "
        + json.dumps(legs))
    for leg, want in expected.items():
        got = {k: legs.get(leg, {}).get(k, 0) for k in want}
        log(f"  bench {leg}: " + ", ".join(
            f"{k} {got[k]} (expected {n})" for k, n in want.items()))
        if got != want:
            raise AssertionError(f"bench {leg}: launches {got} != {want}")
    # the pre-flight runs each distinct (task fn, input shapes) once: at
    # least one launch of each kernel, at most one forward's
    pre = {k: legs.get("preflight", {}).get(k, 0) for k in per_dag}
    log(f"  bench preflight: {pre} (1 to {per_dag} each)")
    if any(not 1 <= pre[k] <= per_dag[k] for k in per_dag):
        raise AssertionError(f"bench preflight launches {pre}")
    summed = {k: sum(n.get(k, 0) for leg, n in legs.items()
                     if leg not in ("segmented", "compiled"))
              for k in per_dag}
    if summed != total:
        raise AssertionError(f"bench legs {summed} != launches in all {total}")
    log(f"  bench: best {result.best_policy} {line['value']} ms vs "
        f"round-robin -> {line['vs_baseline']}x; per-task "
        f"{line['spread']['pt_makespan']['median_ms']} ms, fused "
        f"{line['fused_forward_ms']} ms; single-card replay "
        f"{line['singlechip_replay_ms']} ms; value over the calibration "
        f"windows {line['spread']['value']}; MFU {line.get('mfu_single_chip')} "
        f"(fused {line.get('mfu_fused')}); oracle {result.oracle_ok}")
    incomplete = {n: c for n, (_, c) in result.policies.items()
                  if n != "roundrobin" and c < 1.0}
    if not result.oracle_ok:
        raise AssertionError("bench: placed output fails the oracle")
    if incomplete:
        raise AssertionError(f"bench: policies did not complete: {incomplete}")
    if result.mfu_single_chip is None:
        raise AssertionError("bench: no MFU for this card")
    ladder = {k: line.get(k) for k in (
        "segmented_makespan_ms", "mfu_segmented", "compiled_makespan_ms",
        "mfu_compiled", "compiled_dispatch_overhead_ms")}
    log(f"  bench ladder legs: {ladder}; spread segmented "
        f"{line['spread']['segmented']}, compiled {line['spread']['compiled']}")
    if None in ladder.values():
        raise AssertionError(f"bench: a ladder leg is missing: {ladder}")
    return legs


# parameter-streaming phase: GPT-2 small under mru on one node capped at
# this fraction of its params (batch 1, so that no task's own logits
# exceed the budget mru places under; the flagship's 8 vocab shards, so its
# params are the flagship's), and the flagship under heft on 8 nodes each
# capped at this fraction of its own node's param union
STREAM_MRU_FRAC = 0.35
STREAM_MRU_BUILD = dict(batch=1, seq_len=512, vocab_shards=8)
STREAM_NODE_FRAC = 0.5


def run_stream_path(torch, P, dev) -> dict:
    """Parameter streaming on the card: the stream bench at its defaults
    (GPT-2 medium bf16, batch 8, seq 512, greedy on one node capped at 0.3
    of the params: per task, segmented and int8), then the flagship placed
    by ``mru`` on one node capped at 0.35 of its params (at batch 1), by
    ``heft`` on 8 nodes each capped at half its own union, and the
    stream-safety pass deciding the compiled rung.  Every streamed output
    meets the fused forward, equals the same placement's unstreamed output
    bit for bit (per task, and segmented without re-batching), and every
    streamed run launches the flash and LayerNorm kernels once per
    attention and layer norm of each of its forwards (warm-up and timed
    run).  Returns each streamed run's launches."""
    from distributed_llm_scheduler_tpu_torch.analysis import AnalysisError
    from distributed_llm_scheduler_tpu_torch.backends.device import pin_params
    from distributed_llm_scheduler_tpu_torch.eval import stream_bench
    from distributed_llm_scheduler_tpu_torch.ops import attention as A
    from distributed_llm_scheduler_tpu_torch.ops import norms as N

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"stream phase: {what}")

    # 1. the bench, each leg's launches counted
    t0 = time.perf_counter()
    res = stream_bench.measure_streaming(device=dev, log=log)
    print("STREAM_LINE " + json.dumps(res), flush=True)
    med = P.GPT2Config.medium()
    per_med = {A.KERNEL: med.n_layer, N.LN_KERNEL: 2 * med.n_layer + 1}
    legs = res["launches"]
    want = {leg: times(per_med, n) for leg, n in (
        ("uncapped", 2), ("fused", 1), ("capped", 2), ("segmented", 2),
        ("quantized", 2), ("quantized_fused", 1))}
    want.update({leg: times(per_med, 2) for leg in legs
                 if leg.startswith("uncapped_rerun")})
    for leg, n in want.items():
        got = {k: legs.get(leg, {}).get(k, 0) for k in n}
        log(f"  stream bench {leg}: {got} (expected {n})")
        check(got == n, f"bench {leg} launched {got}, expected {n}")
    drop = res["uncapped_peak_hbm_gb"] - res["capped_peak_hbm_gb"]
    need = 0.5 * (res["total_param_gb"] - res["budget_gb"])
    log(f"  stream bench in {time.perf_counter() - t0:.1f} s: uncapped "
        f"{res['uncapped_makespan_ms']} ms, capped {res['capped_makespan_ms']}"
        f" ms, segmented {res['segmented_capped_makespan_ms']} ms, int8 "
        f"{res['quantized_capped_makespan_ms']} ms; link burst "
        f"{res['host_link_gbps']} GB/s, sustained {res['sustained_gbps']} "
        f"GB/s, achieved {res['achieved_gbps']} GB/s, bound utilization "
        f"{res['bound_utilization']} ({res['floor_source']}); allocator peak "
        f"{res['uncapped_peak_hbm_gb']:.4f} uncapped, "
        f"{res['capped_peak_hbm_gb']:.4f} capped GiB (drop {drop:.4f}, "
        f"needed {need:.4f})")
    for key in ("oracle_ok", "segmented_oracle_ok", "quantized_oracle_ok",
                "budget_respected", "quantized_budget_respected"):
        check(res[key] is True, f"bench {key} is {res[key]}")
    check(res["param_evictions"] > 0, "the bench evicted nothing")
    check(res["sustained_gbps"] is not None, "no sustained link rate")
    check(drop >= need, f"allocator peak dropped {drop:.4f} GiB, needed "
                        f"{need:.4f}: the weights co-reside")
    launches = {f"bench {leg}": n for leg, n in legs.items()
                if leg in ("capped", "segmented", "quantized")}

    # 2. GPT-2 small, its params on the host and pinned once
    cfg = P.GPT2Config.small(dtype=torch.bfloat16)
    per_layer = {A.KERNEL: cfg.n_layer, N.LN_KERNEL: 2 * cfg.n_layer + 1}

    def build(**shape):
        dag = P.build_gpt2_dag(cfg, **shape)
        return dag, P.fuse_linear_chains(dag.graph), dag.make_inputs(
            seed=1, device=dev)

    dag, graph, ids = build(**FLAGSHIP)
    params = pin_params(dag.init_params(seed=0, device="cpu"))
    total = graph.total_param_gb()
    on_dev = {k: v.to(dev) for k, v in params.items()}

    def pair(label, backend, graph, ids, sched, **kw):
        """The placement unstreamed, then streamed (counted): outputs on
        the host, bit-equal, the streamed one within the fused forward's
        band."""
        mb = sum(1 for t in dag_of[graph].graph
                 if t.task_id.endswith("final_ln"))  # one per microbatch
        with torch.no_grad():
            fused = dag_of[graph].reference_forward(on_dev, ids).cpu()
        base = backend.execute(graph, sched, params, ids, **kw)
        base_out = base.output.cpu()
        rep, launches[label] = counted(
            label, times(per_layer, 2 * mb), lambda: backend.execute(
                graph, sched, params, ids, stream_params=True, **kw))
        out = rep.output.cpu()
        ok, viol, allowed, rel = oracle_close(fused, out)
        same = torch.equal(out, base_out)
        peak = {n: b / 1024**3 for n, b in rep.peak_param_bytes.items() if b}
        budgets = {d.node_id: d.total_memory for d in backend.cluster
                   if d.node_id in peak}
        log(f"  {label}: unstreamed {base.makespan_s * 1e3:.3f} ms, streamed "
            f"{rep.makespan_s * 1e3:.3f} ms; {rep.param_loads} loads in "
            f"{rep.param_load_calls} calls ({rep.param_load_bytes / 1024**2:.1f}"
            f" MiB), {rep.param_evictions} evictions, {rep.n_dispatches} host "
            f"calls; ledger peak GiB {json.dumps(peak)} on budgets "
            f"{json.dumps(budgets)}; allocator peak "
            f"{stream_bench.run_peak_gb(base):.4f} unstreamed, "
            f"{stream_bench.run_peak_gb(rep):.4f} streamed GiB; {viol} "
            f"outside the band, rel {rel:.3e}; bit-equal {same}")
        check(ok and bool(torch.isfinite(out).all()), f"{label}: oracle")
        check(same, f"{label}: streamed output differs from unstreamed")
        check(rep.param_evictions > 0, f"{label}: nothing evicted")
        device_time_breakdown(
            torch, f"{label} streamed", rep.makespan_s, lambda: backend.execute(
                graph, sched, params, ids, stream_params=True, warmup=False,
                **kw))
        return base, rep

    # the paper's headline: mru places under a budget below the model
    hdag, hgraph, hids = build(**STREAM_MRU_BUILD)
    dag_of = {graph: dag, hgraph: hdag}
    cluster = P.Cluster.from_torch_devices(
        [dev], hbm_cap_gb=STREAM_MRU_FRAC * hgraph.total_param_gb())
    sched = P.get_scheduler("mru").schedule(hgraph, cluster)
    check(not sched.failed, f"mru failed {len(sched.failed)} tasks")
    backend = P.DeviceBackend(cluster)
    pair("mru x1 per task", backend, hgraph, hids, sched, planned=False)
    pair("mru x1 segmented", backend, hgraph, hids, sched, segments=True,
         rebatch=False)

    # several nodes of the card, each capped at half its own union
    cluster = P.Cluster.from_torch_devices([dev] * 8)
    sched = P.get_scheduler("heft").schedule(graph, cluster)
    check(not sched.failed, f"heft failed {len(sched.failed)} tasks")
    for d in cluster:
        union = {g for t in sched.per_node.get(d.node_id, ())
                 for _, g in graph[t].param_items()}
        if union:
            d.total_memory = STREAM_NODE_FRAC * sum(
                graph.param_size_gb(g) for g in union)
    base, rep = pair("heft x8 per task", P.DeviceBackend(cluster), graph, ids,
                     sched, planned=False)
    print("STREAM_HEFT " + json.dumps(dict(
        nodes=sum(1 for lst in sched.per_node.values() if lst),
        budgets_gb={d.node_id: d.total_memory for d in cluster},
        unstreamed_ms=base.makespan_s * 1e3, streamed_ms=rep.makespan_s * 1e3,
        param_loads=rep.param_loads, param_load_calls=rep.param_load_calls,
        param_load_gb=rep.param_load_bytes / 1024**3,
        param_evictions=rep.param_evictions,
        peak_param_gb={n: b / 1024**3 for n, b in rep.peak_param_bytes.items()},
        peak_hbm_gb={"unstreamed": stream_bench.run_peak_gb(base),
                     "streamed": stream_bench.run_peak_gb(rep)},
        transfer_edges=rep.transfer_edges)), flush=True)

    # the stream-safety pass decides the compiled rung
    roomy = P.Cluster.from_torch_devices([dev], hbm_cap_gb=4 * total)
    sched = P.get_scheduler("greedy").schedule(graph, roomy)
    backend = P.DeviceBackend(roomy)
    unstreamed = backend.execute(graph, sched, params, ids, compiled=True)
    base_out = unstreamed.output.cpu()
    rep = backend.execute(graph, sched, params, ids, compiled=True,
                          stream_params=True)
    same = torch.equal(rep.output.cpu(), base_out)
    log(f"  compiled at 4x the params: compiled {rep.compiled}, streamed "
        f"{rep.streamed}, {rep.makespan_s * 1e3:.3f} ms, bit-equal to the "
        f"unstreamed compiled run {same}")
    check(rep.compiled and not rep.streamed and same, "compiled at 4x")
    roomy.devices[0].total_memory = 0.3 * total
    try:
        backend.execute(graph, sched, params, ids, compiled=True,
                        stream_params=True)
    except AnalysisError as e:
        codes = sorted({d.code for d in e.report.diagnostics})
        log(f"  compiled at 0.3x the params: refused with {codes}")
        check(bool(set(codes) & {"STR002", "STR003"}), f"refusal {codes}")
    else:
        raise AssertionError("stream phase: compiled at 0.3x was not refused")
    return launches


def run_f32_leg(torch, P, dev) -> None:
    """GPT-2: placed on the card vs fused on the CPU, in float32."""
    cfg = P.GPT2Config.small(n_layer=2)
    dag = P.build_gpt2_dag(cfg, batch=2, seq_len=128, microbatches=2,
                           vocab_shards=8)
    graph = P.fuse_linear_chains(dag.graph)
    cluster = P.Cluster.from_torch_devices([dev] * 8)
    sched = P.get_scheduler("heft").schedule(graph, cluster)
    backend = P.DeviceBackend(cluster)
    params = dag.init_params(seed=2, device=dev)
    ids = dag.make_inputs(seed=3, device=dev)
    cpu = torch.device("cpu")
    want = dag.reference_forward(
        dag.init_params(seed=2, device=cpu), dag.make_inputs(seed=3, device=cpu)
    )
    for rung, kw in (("planned", {}), ("compiled", dict(compiled=True))):
        got = backend.execute(graph, sched, params, ids, reps=1, **kw).output.cpu()
        err = (got - want).abs().max().item()
        ok = bool(torch.allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL))
        log(f"  {graph.name}: {len(graph)} tasks on 8 nodes, heft, {rung}; "
            f"max_abs_err {err:.3e} vs CPU fused forward (rtol=atol="
            f"{F32_RTOL:g}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(
                f"f32 placed output ({rung}) diverges from CPU forward")


def run_llama_path(torch, P, dev) -> dict:
    """The Llama-3 8B flagship DAG at full width and depth: weights drawn
    on the card, calibrated, placed by ``pipeline`` on 8 virtual nodes and
    by ``greedy`` on one, executed, and held against the fused forward.
    Returns each run's own launch counts."""
    from distributed_llm_scheduler_tpu_torch.models import llama
    from distributed_llm_scheduler_tpu_torch.ops import kernels

    cfg = P.LlamaConfig.llama3_8b(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    dag = P.build_llama_dag(cfg, **LLAMA_FLAGSHIP)
    graph = P.fuse_linear_chains(dag.graph)
    if len(graph) != LLAMA_TASKS:
        raise AssertionError(f"Llama flagship has {len(graph)} tasks")
    # per microbatch: one attention per layer; attn_norm and ffn_norm per
    # layer, and final_norm, every one of them on the register kernel
    n_rms = sum(1 for t in dag.graph if t.task_id.endswith("_norm"))
    per_forward = {
        "flash_attention": sum(1 for t in dag.graph
                               if t.task_id.endswith("_attention")),
        "rms_norm": n_rms, "rms_norm.register": n_rms,
    }
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = dag.derive_params(llama.init_params_torch(cfg, seed=0, device=dev))
    ids = dag.make_inputs(seed=1, device=dev)
    torch.cuda.synchronize()
    log(f"  built {graph.name}: {len(dag.graph)} tasks, {len(graph)} after "
        f"fusing chains, {graph.total_param_gb():.3f} GiB params "
        f"({llama.num_params(cfg) / 1e9:.3f} B), largest task output "
        f"{graph.max_task_memory():.3f} GiB ({t_build:.1f} s); weights drawn "
        f"on the card from torch seed 0 ({time.perf_counter() - t0:.1f} s), "
        f"{torch.cuda.memory_allocated(dev) / 1024**3:.3f} GiB allocated; per "
        f"forward {per_forward}")

    launches = {}
    t0 = time.perf_counter()
    cm, launches["calibrate"] = counted(
        "calibrate", times(per_forward, 1 + 3),
        lambda: P.calibrate(graph, params, ids, device=dev, repeats=3),
    )
    cm.apply(graph)
    log(f"  calibrated {len(cm.task_seconds)} tasks: per-task sum "
        f"{sum(cm.task_seconds.values()) * 1e3:.3f} ms, critical path "
        f"{graph.critical_path_time() * 1e3:.3f} ms "
        f"({time.perf_counter() - t0:.1f} s)")

    reports = {}
    for label, devices, policy in (
        ("pipeline x8", [dev] * 8, "pipeline"),
        ("greedy x1", [dev], "greedy"),
    ):
        cluster = P.Cluster.from_torch_devices(devices)
        t0 = time.perf_counter()
        sched = P.get_scheduler(policy).schedule(graph, cluster)
        t_sched = time.perf_counter() - t0
        if sched.failed or len(sched.completed) != len(graph):
            raise AssertionError(f"{label}: {len(sched.failed)} tasks failed")
        order = P.DeviceBackend.dispatch_order(graph, sched)
        for nid, lst in sched.per_node.items():
            members = set(lst)
            if [t for t in order if t in members] != lst:
                raise AssertionError(f"{label}: dispatch ignores {nid}'s order")
        backend = P.DeviceBackend(cluster)
        rep, launches[label] = counted(
            label, times(per_forward, 1 + REPS), lambda: backend.execute(
                graph, sched, params, ids, warmup=True, reps=REPS
            ),
        )
        per_node = [len(lst) for lst in sched.per_node.values()]
        peak = sum(rep.peak_hbm_bytes.values()) / 1024**3
        log(f"  {label}: {len(sched.completed)}/{len(graph)} tasks on "
            f"{sum(1 for n in per_node if n)} node(s) of "
            f"{cluster.devices[0].total_memory:.2f} GB ({per_node} tasks), "
            f"placed in {t_sched:.2f} s; makespan {rep.makespan_s * 1e3:.3f} "
            f"ms (mean of {REPS}), {rep.n_dispatches} dispatches, "
            f"{rep.transfer_edges} transfer edges "
            f"({rep.transfer_bytes / 1024**2:.1f} MiB), dispatch loop "
            f"{rep.dispatch_overhead_s * 1e3:.3f} ms, peak {peak:.3f} GiB, "
            f"warmup {rep.compile_s:.2f} s")
        device_time_breakdown(torch, label, rep.makespan_s, lambda: backend.execute(
            graph, sched, params, ids, warmup=False, reps=1
        ))
        reports[label] = rep
        if label == "pipeline x8":
            pipeline = (backend, sched)

    # the pipeline placement as one CUDA graph, a stream per stage node: its
    # wrappers count in the warm-up and the capture; its replays (the
    # warm-up run and REPS runs) launch the kernels in the graph
    backend, sched = pipeline
    label = "pipeline x8 compiled"
    rep, eager = counted(label, times(per_forward, 2), lambda: backend.execute(
        graph, sched, params, ids, compiled=True, reps=REPS))
    if {k: rep.captured_launches.get(k, 0) for k in per_forward} != per_forward:
        raise AssertionError(f"{label}: captured {rep.captured_launches}")
    launches[label] = {k: kernels.replayed.get(k, 0) for k in per_forward}
    if launches[label] != times(per_forward, 1 + REPS):
        raise AssertionError(f"{label}: replays launched {launches[label]}")
    peak = sum(rep.peak_hbm_bytes.values()) / 1024**3
    log(f"  {label}: makespan {rep.makespan_s * 1e3:.3f} ms (mean of {REPS}), "
        f"host dispatch {rep.dispatch_overhead_s * 1e3:.4f} ms in "
        f"{rep.n_dispatches} host calls, {rep.transfer_edges} exchanges, peak "
        f"{peak:.3f} GiB allocated ({torch.cuda.memory_reserved(dev) / 1024**3:.3f} "
        f"reserved), warmup and capture {rep.compile_s:.2f} s")
    device_time_breakdown(torch, label, rep.makespan_s, lambda: backend.execute(
        graph, sched, params, ids, compiled=True, warmup=False, reps=1))
    reports[label] = backend.execute(graph, sched, params, ids, compiled=True,
                                     warmup=False)
    del pipeline

    t0 = time.perf_counter()
    fused = dag.reference_forward(params, ids)
    rms = fused.float().pow(2).mean().sqrt().item()
    log(f"  fused forward {tuple(fused.shape)} {fused.dtype} "
        f"({fused.numel() * fused.element_size() / 1e9:.3f} GB of logits, "
        f"rms {rms:.4f}, {time.perf_counter() - t0:.2f} s)")
    if not (math.isfinite(rms) and rms > 0.1):  # N(0, 0.02) head: ~1.28
        raise AssertionError(f"Llama fused logits degenerate (rms {rms})")
    for label, rep in reports.items():
        ok, viol, allowed, rel = oracle_close(fused, rep.output)
        finite = bool(torch.isfinite(rep.output).all())
        log(f"  {label} vs fused forward: {viol} elements outside the "
            f"{BAND:g} band (allowed {allowed}), rel Frobenius {rel:.3e} "
            f"(max {MAX_REL_FRO:g}), finite={finite} -> "
            f"{'ok' if ok and finite else 'FAIL'}")
        if not (ok and finite):
            raise AssertionError(f"Llama {label}: output fails the oracle")
    return launches


def run_llama_f32_leg(torch, P, dev) -> None:
    """Llama-3 8B widths at 2 layers in float32: placed by ``pipeline`` on
    8 virtual nodes on the card vs the fused forward on the CPU with the
    plain versions, from the same numpy-seeded weights (the vocab shards
    exist only on the card)."""
    from distributed_llm_scheduler_tpu_torch.models import llama

    cfg = P.LlamaConfig.llama3_8b(n_layers=2)
    dag = P.build_llama_dag(cfg, batch=2, seq_len=128, microbatches=2,
                            vocab_shards=8)
    graph = P.fuse_linear_chains(dag.graph)
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    np_params = llama.init_params_numpy(cfg, seed=2)
    card = dag.derive_params(llama.params_from_numpy(np_params, dev, torch.float32))
    host = llama.params_from_numpy(np_params, cpu, torch.float32)
    del np_params
    ids = dag.make_inputs(seed=3, device=cpu)
    t_init = time.perf_counter() - t0
    cluster = P.Cluster.from_torch_devices([dev] * 8)
    sched = P.get_scheduler("pipeline").schedule(graph, cluster)
    if sched.failed:
        raise AssertionError(f"{graph.name}: {len(sched.failed)} tasks failed")
    backend = P.DeviceBackend(cluster)
    t0 = time.perf_counter()
    want = dag.reference_forward(host, ids)
    t_cpu = time.perf_counter() - t0
    for rung, kw in (("planned", {}), ("compiled", dict(compiled=True))):
        got = backend.execute(graph, sched, card, ids.to(dev), reps=1,
                              **kw).output.cpu()
        err = (got - want).abs().max().item()
        ok = bool(torch.allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL))
        log(f"  {graph.name}: {len(graph)} tasks on "
            f"{sum(1 for lst in sched.per_node.values() if lst)} nodes, "
            f"pipeline, {rung}; max_abs_err {err:.3e} vs CPU fused forward "
            f"(rtol=atol={F32_RTOL:g}) -> {'ok' if ok else 'FAIL'} (weights "
            f"{t_init:.1f} s, CPU forward {t_cpu:.1f} s)")
        if not ok:
            raise AssertionError(
                f"f32 Llama placed output ({rung}) diverges from CPU forward")



def serve_workload(vocab: int) -> list:
    """16 requests from numpy seed 7: prompts of 64 tokens (r0-r7) and 128
    (r8-r15); max_new follows ``[384, 32, 32, 32][i % 4]``, the skew of
    the JAX decode bench's ``measure_paged_decode`` (1,920 useful
    tokens)."""
    import numpy as np

    rng = np.random.default_rng(7)
    reqs = []
    for i in range(16):
        plen = 64 if i < 8 else 128
        ids = rng.integers(0, vocab, size=(1, plen), dtype=np.int32)
        reqs.append((f"r{i}", ids, [384, 32, 32, 32][i % 4]))
    return reqs


def build_engine(P, cfg, dev, geom, seg_steps, seed):
    """A paged decode engine for ``cfg`` on ``dev``: the paged decode DAG,
    placed by ``greedy`` on one node, weights from numpy ``seed``."""
    dag = P.build_paged_decode_dag(cfg, **geom)
    cluster = P.Cluster.from_torch_devices([dev])
    sched = P.get_scheduler("greedy").schedule(dag.graph, cluster)
    if sched.failed:
        raise AssertionError(f"{dag.graph.name}: {len(sched.failed)} tasks failed")
    from distributed_llm_scheduler_tpu_torch.models import gpt2

    weights = P.params_from_numpy(gpt2.init_params_numpy(cfg, seed), dev, cfg.dtype)
    pool = P.PagePool(n_pages=geom["n_pages"], page_size=geom["page_size"])
    eng = P.DeviceBackend(cluster).paged_decode_engine(
        dag.graph, sched, cfg, weights, pool, slots=geom["slots"],
        pages_per_seq=geom["pages_per_seq"], seg_steps=seg_steps)
    return dag, eng, weights


def serve(eng, reqs) -> dict:
    for rid, ids, gen in reqs:
        eng.submit(rid, ids, gen)
    return eng.run()


def serve_trace(torch, eng, reqs, seg_wall_s: float) -> None:
    """Trace one steady-state segment (the third, before any slot frees
    up) with torch.profiler: device busy time, idle share of the mean
    untraced segment wall, and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    eng.reset()
    for rid, ids, gen in reqs:
        eng.submit(rid, ids, gen)
    eng.step_segment()
    eng.step_segment()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step_segment()
        traced_s = time.perf_counter() - t0
    eng.run()
    rows = [
        (getattr(e, "self_device_time_total", 0.0), e.count, e.key)
        for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ]
    busy_ms = sum(r[0] for r in rows) / 1e3
    if busy_ms <= 0:
        log("  serve trace: no device time in the trace (not measured)")
        return {}
    n_ops = sum(r[1] for r in rows)
    log(f"  serve trace, one segment of {SERVE_SEG_STEPS} steps: device busy "
        f"{busy_ms:.3f} ms, idle share {1.0 - busy_ms / (seg_wall_s * 1e3):.3f} "
        f"of the {seg_wall_s * 1e3:.3f} ms mean untraced segment wall (traced "
        f"wall {traced_s * 1e3:.3f} ms); {n_ops} device ops")
    for us, n, key in sorted(rows, reverse=True)[:8]:
        log(f"    {us / 1e3:8.3f} ms  {n:5d}x  {key[:90]}")
    # the single-token paged kernel's device ops (every kernel of
    # csrc/paged_attention.cu is in the anonymous namespace with "paged"
    # in its name)
    paged = [(us, n, key) for us, n, key in rows if "paged" in key]
    for us, n, key in paged:
        log(f"  serve trace, paged: {us / 1e3:.3f} ms over {n} launches "
            f"({us / n:.2f} us each): {key[:80]}")
    norm_ms = log_norm_device_time("serve trace", "per segment", rows)
    return dict(segment_device_busy_ms=busy_ms, segment_device_ops=n_ops,
                segment_paged_ms=sum(r[0] for r in paged) / 1e3,
                segment_paged_ops=sum(r[1] for r in paged),
                segment_norm_ms=norm_ms)


def serve_oracle(torch, P, cfg, weights, reqs, results) -> None:
    """Teacher-forced check against the fused dense forward on the card:
    prompt + generated tokens but the last go through ``forward``; at
    every generated position the emitted token's fused logit must lie
    within ORACLE_GAP of that row's fused maximum."""
    import numpy as np

    from distributed_llm_scheduler_tpu_torch.models.gpt2 import forward as fwd

    n = exact = 0
    worst = 0.0
    for rid, ids, gen in reqs:
        toks = np.asarray(results[rid])
        seq = np.concatenate([ids[0], toks[:-1]])[None]
        logits = fwd(weights, torch.from_numpy(seq).to(weights["wte"].device),
                     cfg)[0].float()
        rows = logits[ids.shape[1] - 1:]
        picked = rows.gather(1, torch.from_numpy(toks.astype(np.int64))
                             .to(rows.device)[:, None])[:, 0]
        gap = (rows.max(dim=1).values - picked)
        worst = max(worst, gap.max().item())
        exact += int((rows.argmax(dim=1).cpu().numpy() == toks).sum())
        n += len(toks)
    ok = worst <= ORACLE_GAP
    log(f"  teacher-forced oracle over {n} generated positions: exact argmax "
        f"matches {exact}/{n} ({exact / n:.4f}), largest gap to the fused row "
        f"max {worst:.4f} (limit {ORACLE_GAP:g}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("serve path fails the teacher-forced oracle")


def run_serve_path(torch, P, A, dev) -> tuple:
    """GPT-2 small bf16 served through the paged engine; returns each
    timed run's launch counts of the single-token and the ragged paged
    kernel and of the LayerNorm kernel."""
    import numpy as np

    cfg = P.GPT2Config.small(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    dag, eng, weights = build_engine(P, cfg, dev, SERVE_GEOM, SERVE_SEG_STEPS, 0)
    reqs = serve_workload(cfg.vocab_size)
    useful = sum(g for _, _, g in reqs)
    pool_mb = sum(t.numel() * t.element_size() for t in eng.pools.values()) / 1e6
    log(f"  built {dag.graph.name}: {len(dag.graph)} tasks, KV pools "
        f"{pool_mb:.1f} MB on the card, capacity {eng.capacity}; {len(reqs)} "
        f"requests, {useful} useful tokens ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    serve(eng, reqs)  # warm-up
    torch.cuda.synchronize()
    log(f"  warm-up run: {time.perf_counter() - t0:.2f} s, "
        f"{eng.segments_run} segments")

    from distributed_llm_scheduler_tpu_torch.ops import kernels

    walls, prefill_s, segs, snaps = [], [], [], []
    paged_n, ragged_n, ln_n = {}, {}, {}
    for rep in range(SERVE_REPS):
        eng.reset(fresh_metrics=True)  # this run's own histograms
        label = f"serve run {rep + 1}"
        kernels.reset_launches()
        t = time.perf_counter()
        results = serve(eng, reqs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        n_paged = kernels.launches[A.PAGED_KERNEL]
        n_ragged = kernels.launches[A.PAGED_RAGGED_KERNEL]
        n_ln = kernels.launches["layer_norm"]
        n_ln_reg = kernels.launches["layer_norm.register"]
        snap = eng.metrics.snapshot()
        steps = SERVE_SEG_STEPS * eng.segments_run
        waves = snap["counters"]["decode.admission_waves"]["value"]
        expected = cfg.n_layer * steps
        ln_expected = (2 * cfg.n_layer + 1) * (steps + waves)
        log(f"  {label}: {A.PAGED_KERNEL} launched {n_paged} times (expected "
            f"{cfg.n_layer} x {SERVE_SEG_STEPS} x {eng.segments_run} segments = "
            f"{expected}), {A.PAGED_RAGGED_KERNEL} {n_ragged} times (expected "
            f"0), layer_norm {n_ln} times (expected {2 * cfg.n_layer + 1} x "
            f"({steps} decode steps + {waves} prefill forwards) = {ln_expected}),"
            f" {n_ln_reg} of them on the register kernel (expected all)")
        if (n_paged != expected or n_ragged != 0 or n_ln != ln_expected
                or n_ln_reg != n_ln):
            raise AssertionError(f"{label}: kernel launches off")
        paged_n[label], ragged_n[label], ln_n[label] = n_paged, n_ragged, n_ln
        bad = [rid for rid, _, g in reqs if len(results[rid]) != g]
        leaked = snap["gauges"]["decode.pages_leaked"]["value"]
        if bad or leaked != 0:
            raise AssertionError(f"{label}: wrong token counts {bad} or "
                                 f"{leaked} leaked pages")
        # admission waves: prefill + its first-token readback
        prefill_s.append(snap["histograms"]["decode.prefill_s"]["sum"])
        segs.append(eng.segments_run)
        snaps.append(snap)
    med = sorted(range(SERVE_REPS), key=walls.__getitem__)[SERVE_REPS // 2]
    h = snaps[med]["histograms"]
    log(f"  timed runs: walls {', '.join(f'{w:.4f}' for w in walls)} s; median "
        f"{walls[med]:.4f} s -> {useful / walls[med]:.1f} useful tok/s; "
        f"{segs[med]} segments; prefill share of the wall "
        f"{prefill_s[med] / walls[med]:.3f}; 0 leaked pages")
    log(f"  median run (wall clock; TTFT from submit, all 16 submitted at "
        f"once): TTFT p50 {h['decode.ttft_s']['p50'] * 1e3:.2f} "
        f"ms, p99 {h['decode.ttft_s']['p99'] * 1e3:.2f} ms; TPOT p50 "
        f"{h['decode.tpot_s']['p50'] * 1e3:.3f} ms, p99 "
        f"{h['decode.tpot_s']['p99'] * 1e3:.3f} ms")
    serve_oracle(torch, P, cfg, weights, reqs, results)
    seg_wall = (walls[med] - prefill_s[med]) / segs[med]
    trace = serve_trace(torch, eng, reqs, seg_wall)
    return paged_n, ragged_n, ln_n, trace


def run_f32_serve_leg(torch, P, dev) -> None:
    """A 2-layer GPT-2 small-width f32 engine on the card (kernels) and on
    the CPU (plain versions), same weights, equal tokens."""
    import numpy as np

    cfg = P.GPT2Config.small(n_layer=2)
    geom = dict(slots=4, page_size=16, n_pages=33, pages_per_seq=8)
    rng = np.random.default_rng(9)
    reqs = [(f"f{i}", rng.integers(0, cfg.vocab_size, size=(1, plen),
                                   dtype=np.int32), 24)
            for i, plen in enumerate((16, 16, 24, 24))]
    card, host = (serve(build_engine(P, cfg, where, geom, 8, 3)[1], reqs)
                  for where in (dev, torch.device("cpu")))
    equal = all(np.array_equal(card[r], host[r]) for r, _, _ in reqs)
    log(f"  f32 serve: {len(reqs)} requests x 24 tokens, card (kernel) vs CPU "
        f"(plain): tokens equal={equal} -> {'ok' if equal else 'FAIL'}")
    if not equal:
        raise AssertionError("f32 serve tokens differ between card and CPU")


def paged_timing(root: Path) -> int:
    """``python3 chip_smoke.py --paged-timing [ROOT]``: the single-token
    paged kernel of the package under ROOT (default: this checkout) alone,
    built from ROOT's source, held once against its plain version in f32
    at the serving shape and timed as the full run times it; prints one
    JSON line.  Two trees run in turns (A, B, B, A) in one call on one
    card give a before and after."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    root = root.resolve()
    sys.path.insert(0, str(root))
    from distributed_llm_scheduler_tpu_torch.eval import decode_bench as DB
    from distributed_llm_scheduler_tpu_torch.ops import attention as A
    from distributed_llm_scheduler_tpu_torch.ops import kernels

    if not Path(A.__file__).resolve().is_relative_to(root):
        raise AssertionError(f"imported {A.__file__}, not the package under {root}")
    dev = torch.device("cuda", 0)
    secs = kernels.build(A.PAGED_SOURCE)
    cases = paged_serving_cases(torch, DB, dev)
    got = A.paged_decode_attention(**cases[0], impl="kernel").float()
    want32 = A.paged_decode_attention(**{
        k: (v.float() if torch.is_tensor(v) and v.is_floating_point() else v)
        for k, v in cases[0].items()}, impl="plain")
    beyond = int(((got - want32).abs()
                  > BF16_ROUNDOFF * want32.abs() + F32_SLACK).sum())
    if beyond or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{root}: paged kernel off its plain version")
    timed = time_paged_kernel(torch, A, cases)
    print(json.dumps({"tree": str(root), "build_s": secs,
                      "beyond_bf16_rule": beyond, **timed,
                      "device": nvidia_smi_line()}), flush=True)
    return 0


def ragged_timing(root: Path) -> int:
    """``python3 chip_smoke.py --ragged-timing [ROOT]``: the ragged paged
    kernel of the package under ROOT (default: this checkout) alone,
    built from ROOT's source, held once against its plain version in f32
    under the bf16 rule on case 0's real rows, and timed as phase 4 times
    it (CUDA-graph replays over distinct 32-token serving chunks totalling
    2x the L2, case 0 repeated, back to back, the bound); prints one JSON
    line.  Two trees run in turns (A, B, B, A) in one call on one card
    give a before and after."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    root = root.resolve()
    sys.path.insert(0, str(root))
    from distributed_llm_scheduler_tpu_torch.eval import decode_bench as DB
    from distributed_llm_scheduler_tpu_torch.ops import attention as A
    from distributed_llm_scheduler_tpu_torch.ops import kernels

    if not Path(A.__file__).resolve().is_relative_to(root):
        raise AssertionError(f"imported {A.__file__}, not the package under {root}")
    dev = torch.device("cuda", 0)
    secs = kernels.build(A.PAGED_SOURCE)
    cases = ragged_serving_cases(torch, DB, dev)
    beyond, finite = ragged_beyond_rule(torch, A, cases[0])
    if beyond or not finite:
        raise AssertionError(f"{root}: ragged kernel off its plain version "
                             f"({beyond} elements beyond the bf16 rule)")
    timed = time_ragged_kernel(torch, A, cases)
    print(json.dumps({"tree": str(root), "build_s": secs,
                      "beyond_bf16_rule": beyond, **timed,
                      "device": nvidia_smi_line()}), flush=True)
    return 0


def ragged_sweep(root: Path, geometries: list, short: bool) -> int:
    """``python3 chip_smoke.py --ragged-sweep ROOT GEOMETRIES [short]``:
    the tensor-core ragged kernel of the package under ROOT, launched
    through its C entry at launch geometries given by hand (GEOMETRIES, a
    JSON list of the integer arguments that follow ``pages_per_seq``, e.g.
    ``[[4, 8, 4], [4, 16, 2]]`` for warps, pages_per_split, n_split), over
    the distinct 32-token serving chunks and over each chunk's longest
    slot alone, as CUDA-graph replays; with ``short`` every slot's length
    is cut below 24 and its chunk to 8 tokens, so only split 0 sees a key.
    No output is checked; prints one JSON line of ms per call."""
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    root = root.resolve()
    sys.path.insert(0, str(root))
    from distributed_llm_scheduler_tpu_torch.eval import decode_bench as DB
    from distributed_llm_scheduler_tpu_torch.ops import attention as A
    from distributed_llm_scheduler_tpu_torch.ops import kernels

    if not Path(A.__file__).resolve().is_relative_to(root):
        raise AssertionError(f"imported {A.__file__}, not the package under {root}")
    dev = torch.device("cuda", 0)
    kernels.build(A.PAGED_SOURCE)
    entry = A._paged_library().dls_paged_attention_ragged_tc_fwd
    cases = ragged_serving_cases(torch, DB, dev)
    if short:
        for c in cases:
            c["lengths"] = c["lengths"] % 24
            c["q_lens"] = c["q_lens"].clamp(max=8)

    def prep(c, slots):
        q = c["q"][slots].contiguous()
        pt, ln, ql = (A._int32(c[k][slots]) for k in ("page_table", "lengths", "q_lens"))
        qs = (ctypes.c_int64 * 3)(*q.stride()[:3])
        return (q, c["k_pool"], c["v_pool"], pt, ln, ql, torch.empty_like(q), qs)

    def launch(geo):
        vp, i = ctypes.c_void_p, ctypes.c_int
        entry.argtypes = [vp] * 8 + [i] * (7 + len(geo)) + [ctypes.c_float, vp]

        def run(q, kp, vp_, pt, ln, ql, out, qs):
            S, Hq, Tn, hd = q.shape
            _, ps, Hkv, _ = kp.shape
            err = entry(q.data_ptr(), kp.data_ptr(), vp_.data_ptr(), pt.data_ptr(),
                        ln.data_ptr(), ql.data_ptr(), out.data_ptr(),
                        ctypes.addressof(qs), S, Hq, Hkv, Tn, hd, ps,
                        pt.shape[1], *geo, float(hd ** -0.5),
                        torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"geometry {geo}: cudaError {err}")
        return run

    full = [prep(c, slice(None)) for c in cases]
    longest = [prep(c, [int(torch.argmax(c["lengths"]))]) for c in cases]
    out = {"tree": str(root), "short": short}
    for geo in geometries:
        key = "_".join(map(str, geo))
        out[key] = graph_ms(torch, launch(geo), full, reps=20)
        out[key + "_longest_slot"] = graph_ms(torch, launch(geo), longest, reps=20)
    print(json.dumps(dict(out, device=nvidia_smi_line())), flush=True)
    return 0


def norm_timing(root: Path) -> int:
    """``python3 chip_smoke.py --norm-timing [ROOT]``: the norm kernels of
    the package under ROOT (default: this checkout) alone, built from
    ROOT's source, each held once against its plain version in f32 under
    the bf16 rule and timed at NORM_TIMED as phase 5 times them (kernel,
    L2-resident repeat and, where the package has one, the empty-kernel
    floor); prints one JSON line.  Two trees run in turns (A, B, B, A) in
    one call on one card give a before and after."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    root = root.resolve()
    sys.path.insert(0, str(root))
    from distributed_llm_scheduler_tpu_torch.ops import kernels
    from distributed_llm_scheduler_tpu_torch.ops import norms as N

    if not Path(N.__file__).resolve().is_relative_to(root):
        raise AssertionError(f"imported {N.__file__}, not the package under {root}")
    dev = torch.device("cuda", 0)
    secs = kernels.build(N.SOURCE)
    kernel, plain, _ = norm_fns(torch, N)
    rng = np.random.default_rng(3)
    timed = []
    for kind, shape in NORM_TIMED:
        x, g, b = norm_inputs(torch, rng, dev, shape, "bfloat16")
        args = (x, g, b) if kind == "ln" else (x, g)
        got = kernel[kind](*args).float()
        want32 = plain[kind](*(t.float() for t in args))
        beyond = int(((got - want32).abs()
                      > BF16_ROUNDOFF * want32.abs() + F32_SLACK).sum())
        if beyond or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{root}: {kind} kernel off its plain version")
        t = time_norm(torch, N, kind, args, rng, dev, yardsticks=False)
        timed.append(dict(kernel=kind, beyond_bf16_rule=beyond, **t))
    print(json.dumps({"tree": str(root), "build_s": secs, "timed": timed,
                      "device": nvidia_smi_line()}), flush=True)
    return 0


def main() -> int:
    import gc

    import torch

    if sys.argv[1:2] == ["--paged-timing"]:
        return paged_timing(Path(sys.argv[2]) if len(sys.argv) > 2 else ROOT)
    if sys.argv[1:2] == ["--ragged-timing"]:
        return ragged_timing(Path(sys.argv[2]) if len(sys.argv) > 2 else ROOT)
    if sys.argv[1:2] == ["--ragged-sweep"]:
        return ragged_sweep(Path(sys.argv[2]), json.loads(sys.argv[3]),
                            sys.argv[4:5] == ["short"])
    if sys.argv[1:2] == ["--norm-timing"]:
        return norm_timing(Path(sys.argv[2]) if len(sys.argv) > 2 else ROOT)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import distributed_llm_scheduler_tpu_torch as P
    from distributed_llm_scheduler_tpu_torch.eval import decode_bench as DB
    from distributed_llm_scheduler_tpu_torch.ops import attention as A
    from distributed_llm_scheduler_tpu_torch.ops import kernels
    from distributed_llm_scheduler_tpu_torch.ops import norms as N

    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    log(f"[1/14] device: {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("  TF32 off for matmul and cuDNN")

    sources = (A.KERNEL, A.PAGED_SOURCE, N.SOURCE)
    secs = kernels.build(*sources)
    log(f"[2/14] built {', '.join(f'{n}.cu' for n in sources)} with "
        f"{kernels.nvcc_path()} for sm_90a in {secs:.1f} s (in parallel)")
    log_ptxas(kernels.build_logs.get(A.KERNEL, ""))
    log_ptxas(kernels.build_logs.get(A.PAGED_SOURCE, ""),
              only=("paged_split", "paged_ragged_tc"))
    ragged_ptxas = [dict(kernel=k, registers=r, spill_store_bytes=st,
                         spill_load_bytes=ld)
                    for k, r, st, ld in ptxas_table(
                        kernels.build_logs.get(A.PAGED_SOURCE, ""))
                    if "paged_ragged_tc" in k]
    norm_ptxas = log_norm_ptxas(kernels.build_logs.get(N.SOURCE, ""))

    log("[3/14] flash kernel check against its plain version")
    attn = check_attention_kernel(
        torch, A, dev, P.LlamaConfig.llama3_8b(dtype=torch.bfloat16))

    log("[4/14] paged kernel check against the plain versions")
    paged = check_paged_kernels(torch, A, DB, dev)
    ragged_n = run_ragged_op_path(torch, A, DB, dev)

    log("[5/14] LayerNorm and RMSNorm kernel check against the plain versions")
    norms = check_norm_kernels(torch, N, dev)

    def phase_done():  # free the phase's tensors before the next one
        gc.collect()
        torch.cuda.empty_cache()

    log("[6/14] flagship forward path: GPT-2 small bf16 DAG on the card")
    gpt2_n = run_main_path(torch, P, dev)
    phase_done()

    log("[7/14] execution ladder: the flagship per task, planned, coalesced, "
        "segmented and compiled")
    ladder_n = run_ladder_path(torch, P, dev)
    phase_done()

    log("[8/14] north-star bench: GPT-2 small bf16, 8 policies replayed")
    bench_n = run_bench_path(torch, P, dev)
    phase_done()

    log("[9/14] serve path: GPT-2 small bf16 through the paged decode engine")
    serve_launches, serve_ragged, serve_ln, serve_tr = run_serve_path(
        torch, P, A, dev)
    phase_done()

    log("[10/14] Llama path: Llama-3 8B bf16 DAG, pipeline stages, on the card")
    llama_n = run_llama_path(torch, P, dev)
    phase_done()

    log("[11/14] f32 leg: GPT-2 placed on the card vs fused on the CPU")
    run_f32_leg(torch, P, dev)

    log("[12/14] f32 serve leg: the engine on the card vs on the CPU")
    run_f32_serve_leg(torch, P, dev)
    phase_done()

    log("[13/14] f32 Llama leg: placed on the card vs fused on the CPU")
    run_llama_f32_leg(torch, P, dev)
    phase_done()

    log("[14/14] parameter streaming: GPT-2 medium and the flagship under "
        "budgets below their params")
    stream_n = run_stream_path(torch, P, dev)
    phase_done()

    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")

    def by_path(kernel, runs):
        return {f"{path} {label}": n[kernel]
                for path, counts in runs for label, n in counts.items()
                if kernel in n}

    csrc = "distributed_llm_scheduler_tpu_torch/csrc/"
    tpu = "distributed_llm_scheduler_tpu/ops/attention.py:"
    tpu_norms = "distributed_llm_scheduler_tpu/ops/norms.py:"
    runs = (("gpt2", gpt2_n), ("ladder", ladder_n), ("bench", bench_n),
            ("llama", llama_n), ("stream", stream_n))
    line = {"kernels": [
        {"name": A.KERNEL, "route": "cuda", "source": csrc + "flash_attention.cu",
         "replaces": tpu + "152",
         "launches": gpt2_n["greedy x1"][A.KERNEL],
         "launches_by_path": by_path(A.KERNEL, runs), **attn},
        {"name": A.PAGED_KERNEL, "route": "cuda",
         "source": csrc + "paged_attention.cu", "replaces": tpu + "411",
         "launches": serve_launches["serve run 1"],
         "launches_by_path": serve_launches, **paged[A.PAGED_KERNEL],
         "serve_trace": serve_tr},
        {"name": A.PAGED_RAGGED_KERNEL, "route": "cuda",
         "source": csrc + "paged_attention.cu", "replaces": tpu + "547",
         "launches": ragged_n[A.PAGED_RAGGED_KERNEL],
         "launches_by_path": {"ragged op path": ragged_n[A.PAGED_RAGGED_KERNEL],
                              **serve_ragged},
         "launches_by_variant": {k.split(".")[1]: v for k, v in ragged_n.items()
                                 if "." in k},
         "ptxas": ragged_ptxas, **paged[A.PAGED_RAGGED_KERNEL]},
        {"name": N.LN_KERNEL, "route": "cuda", "source": csrc + "norms.cu",
         "replaces": tpu_norms + "58",
         "launches": gpt2_n["greedy x1"][N.LN_KERNEL],
         "launches_by_path": {**by_path(N.LN_KERNEL, runs),
                              **{f"gpt2 {k}": v for k, v in serve_ln.items()}},
         **norms[N.LN_KERNEL]},
        {"name": N.RMS_KERNEL, "route": "cuda", "source": csrc + "norms.cu",
         "replaces": tpu_norms + "76",
         "launches": llama_n["pipeline x8"][N.RMS_KERNEL],
         "launches_by_path": by_path(N.RMS_KERNEL, runs),
         **norms[N.RMS_KERNEL], "ptxas": norm_ptxas},
    ]}
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
