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
   at edge shapes (each head dim, 16 included, T of 1, 77 and 300, full
   attention, fewer KV heads given to ``flash_attention`` itself,
   float16, head dims between the instances through ``mha``/``gqa_mha``
   on padded copies), with its time as CUDA-graph replays and issued back
   to back, the plain version's, one PyTorch library call's as a
   yardstick, and the least time the card could take (its bound), at the
   main path's shape and at ``EDGE_TIMED``'s (head dim 16, float16, head
   dim 80 padded); then ``mha``/``gqa_mha``'s routes: a head dim without
   an instance runs the kernel on padded copies, float16 as given, a
   misaligned bf16 view on contiguous copies, the copies counted, and
   head dim 192 raises; every main path below requires no such route;
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
   the link measured on the card, and all 10 policies (``search`` at
   budget 120, as the JAX bench) placed on 8 nodes and replayed, each
   policy's replayed makespan and scheduling wall printed, refine's and
   search's static pre-filter reading ``on`` in both runs; its JSON line
   (``BENCH_LINE``, metric ``..._best_of_10_policies_cuda``) is printed, and
   each leg must launch the flash and LayerNorm kernels once per
   attention and layer norm of each forward it runs (the pre-flight once
   per distinct task), the oracle must hold, every policy but round-robin
   must complete and the MFUs and the compiled leg's host wall must be
   measured; the first run measures the calibration afresh and saves it,
   and a second run (one rep a measured leg, the same link) replays the
   saved file: ``cache_hit`` true, and the best policy, ``value``,
   ``vs_baseline`` and every policy's ``placement_digest`` equal to the
   first run's (``BENCH_REPLAY_LINE``);
9. serve path: GPT-2 small bf16 at full width through the paged decode
   DAG (8 slots, page size 16, 257 pages, capacity 512), placed by
   ``greedy`` and served by ``DeviceBackend.paged_decode_engine`` in
   8-step segments, each one replay of a CUDA graph the engine captures
   at its first segment: 16 requests, one warm-up run, then 3 timed runs,
   each with the paged kernel's launches that ran counted (12 layers x 8
   steps per segment, all by replays) and the LayerNorm kernel's (25 per
   decode step and per prefill forward, all on the register kernel), no
   leaked pages, every request's token count, and a teacher-forced oracle
   against the fused forward; an engine with ``capture=False`` serves the
   same workload: tokens bit-equal, its tok/s, TPOT and segment wall
   beside the captured engine's; 5 steady captured segments' device
   windows from CUDA events; a traced segment gives device busy time (so
   the idle share of the window and of the wall) and the paged and norm
   kernels' own device time;
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
    STR002 or STR003 diagnosis at 0.3x;
15. online serving: a. the serve bench (``eval/serve_bench.
    measure_serving``: GPT-2 tiny f32 on a virtual clock, fifo against
    slo with preemption, the prefix and chunked legs) on the card and on
    the CPU: every gate passes, every ``serve.*`` metric equals the CPU
    run's and ``SERVE_r18.json``'s, and each leg's digest the CPU's; then
    the ``ServingFrontend`` over phase 9's GPT-2 small bf16 engine on a
    real clock: b. 64 Poisson arrivals from seed 7 at twice the capacity
    phase 9 measured, fifo admit-all against slo admission with
    preemption (TTFT target 4x phase 9's mean segment wall), and the slo
    leg on the first 16 arrivals run untraced (wall, idle sleeps) and
    traced (device busy) for the device's idle share;
    c. a mix with a 448-token prompt every 6th arrival, whole against
    chunked prefill (64-token chunks), with the share of tokens that
    agree; d. two-turn sessions on a 256-token system prompt, prefix
    sharing on against off, the ownership log through the page-lifetime
    prover.  Every leg must leak no page, pass the lifecycle lint and
    launch the paged kernel 12 times per decode step and LayerNorm 25
    times per decode step and per prefill call, and every delivered token
    must pass phase 9's teacher-forced oracle (``ONLINE_LINE``);
16. run doctor: a. the flagship under ``greedy`` x1 (planned, segmented)
    and ``heft`` x8 (planned, compiled) with a ``Tracer`` and a
    ``MemoryProfiler``, launches counted as phase 7 counts them, then run
    untraced: outputs bit-equal, both makespans printed; the Perfetto
    export validates with every node's track, flows across nodes (heft
    x8 planned) and the memory counter tracks; the attribution is
    non-null and tiles its makespan; the memory timeline verifies, its
    peak printed beside the allocator's.  b. phase 9's engine and
    workload bare, traced (tracer, flight recorder, request waterfalls,
    memory profiler) and bare again: tokens bit-equal, launches counted
    as phase 9 counts them, one waterfall per request, the export and
    the flight ring valid, 0 leaked pages, and the traced wall split into
    the engine's segment spans, admission waves (their prefill spans) and
    the rest.  c. the soak of ``SOAK_r17.json``'s config (GPT-2 tiny f32,
    virtual clock) on the card: its seven ``soak.*`` values equal the
    banked file's and a CPU run's; an injected page leak trips HLT001 and
    dumps a flight trace that validates; injected compile-class churn
    trips HLT003; then phase 9's engine soaks 8 s (2 s warm-up) on the
    real clock at half the rate it serves the soak's request shapes
    arriving one per segment: healthy, no leaked page.  d. ``measure_fleet(seed=7)`` over three GPT-2 tiny f32
    replicas on the card: the eight ``fleet.*`` values and the fleet
    health history equal ``FLEET_r20.json``'s, the gates pass, and the
    card's allocated memory is back at its level after the restarts.
    Each leg's launches are counted; the numbers as ``DOCTOR_LINE``;
17. searched placements: a. phase 8's ``refine`` and ``search`` (budget
    120, seed 0) placements of the flagship, made from the card's saved
    calibration (their static pre-filter must read ``on``), beside its
    ``heft`` x8: each one's eventsim makespan and
    replay under that calibration and link (the replay equal to the
    bench's), then executed on 8 nodes of the card planned and compiled
    (one CUDA graph, a stream per node), launches counted as phase 7
    counts them (96 flash and 200 LayerNorm per forward), outputs within
    the fused forward's band and compiled bit-equal to planned.  b. the
    pre-execution gate: a schedule with a task on two nodes and a graph
    with a cycle are each refused with ``AnalysisError`` by ``execute``
    (planned and compiled), ``CompiledSchedule.build`` and
    ``paged_decode_engine``, every launch count still 0; with
    ``DLS_SKIP_ANALYSIS=1`` a schedule the gate refuses (an unknown,
    empty node list) runs, bit-equal to the clean one; the gate's host
    time on the flagship.  c. ``analyze()`` over heft x8's schedule with
    the bf16 params and the input as meta tensors: equal, diagnostic for
    diagnostic, to the same call on 8 CPU nodes of the same budgets, every
    task's output typechecked, no kernel launched.  The numbers as
    ``SEARCH_LINE``.

18. BASELINE.json configs #5 and #4.  a. the GPT-2 small f32 training
    step (43 tasks): ``eval/train_bench.measure_train_dag`` on the card,
    run as the train leg of ``eval/capture_artifacts`` (its TRAIN record:
    oracle true, 10 policies replayed, every launch of the leg counted;
    phase 25 b reads this run), then the step on one node and placed by
    ``mru`` and ``heft`` on 4 nodes of the card at 0.55x the step's
    footprint, planned and
    compiled, each within ``tests/test_train_dag.py``'s tolerances of the
    single-node step (which outputs are bit-equal is printed), 24 flash
    and 49 LayerNorm launches per step; the step's profile (the norm
    backward's share of its device time), the allocator's peak beside the
    pre-flight's, and both kernels timed at the step's shapes
    (``TRAIN_LINE``).  b. Mixtral-8x7B at full width, depth cut to 4
    layers, bf16, batch 2, seq 512 (63 tasks): dense and routed (capacity
    factor 2.0), placed by ``mru``, ``greedy`` and ``heft`` on 8 nodes at
    0.3x the params each (experts on at least 2 nodes), planned and
    compiled, each against the fused forward under phase 10's rule, the
    tokens whose top-2 experts differ from the fused path's counted (0),
    4 flash and 9 RMSNorm launches per forward (``MOE_LINE``).
19. decoding.  a. Llama-3 8B bf16 at full width and depth, weights drawn
    on the card: the decode bench's ``measure_decode`` at the JAX bench's
    defaults (batch 8, prompt 512, 64 new tokens), its decode steps
    replays of one captured CUDA graph, with 65 RMSNorm launches that ran
    per forward_cached call (all on the register kernel, none on copies,
    no flash launch), tok/s, ms per step and the roofline's
    ``bound_utilization``, and an eager generation (``capture=False``,
    16 new tokens, one timed repetition) beside them, with tokens equal
    to the captured generation's; then a generation whose step logits at 8 of
    the generated positions are held against the fused forward over the
    sequence so far (the JAX package's ``oracle_close``): in f32 on the
    same weights, which must hold, and in bf16, reported (a randomly drawn
    Llama-3 8B carries a rounding difference between the two orders of
    the math to percents over its 32 layers).  b. The same with the
    int8 KV cache: its bytes at most 0.75 of the bf16 cache's, tok/s and
    token agreement with a.  c. ``measure_decode_dag`` under ``heft`` on
    one node (34-task step: per task, segmented, host-driven and looped
    legs, the K-step loop (16 steps) captured and eager with equal tokens,
    ``oracle_ok``, two graph classes); one step under ``heft`` on
    8 nodes of the card, bit-equal to one node's; the segmented and
    compiled rungs captured at step 1 and replayed at step 3, after the
    cache slabs were updated in place, bit-equal to the per-task step.
    d. Mixtral-8x7B widths at 4 layers, bf16, batch 2: ``generate`` and
    the decode DAG give equal greedy tokens.  e. GPT-2 small bf16 through
    the bench's other legs at their defaults: ``measure_decode`` with its
    int8-weight and int8-cache legs, ``decode_attribution``,
    ``measure_paged_decode`` and ``measure_paged_kernel`` (GPT-2 tiny f32:
    tokens exact, parity, 0 pages leaked).  Then both norm kernels at the
    decode paths' shapes, checked and timed as phase 5 times them
    (``DECODE_LINE``).
20. the command line on the card: the port's ``__main__.main(argv)``
    called in this process, stdout captured, every launch count set to 0
    just before each command and read just after.  a. ``execute --model
    gpt2`` (GPT-2 small f32 at full width, the README's quickstart, on
    the cards a prefix of ``--num-nodes 8`` binds) with its defaults,
    with ``--segments`` and with ``--profile --trace``: every task
    completed, ``n_devices`` the cards bound, the flash and LayerNorm
    launches the DAG's attention and layer-norm tasks times the forwards
    the command ran (a captured run: twice its graphs' kernels eagerly,
    and its graphs' kernels at each replay), the output within the fused
    forward's band, the Chrome trace valid under
    ``obs/export.validate_trace``.  b. ``trace --model gpt2`` and
    ``metrics --model gpt2``: the execute leg's flash launches as in a,
    the paged decode leg's single-token paged kernel launched, the
    Perfetto trace and the metrics snapshot valid.  c. ``generate --model
    gpt2 --max-new-tokens 32 --weights`` a synthetic checkpoint drawn
    from a seed, whole-model and ``--task-graph``: equal tokens, at
    least 8 of them distinct.  d. ``schedule --model llama-8b`` with ``native:heft`` (the
    C++ engine built here with ``g++``) and ``heft``: equal placement
    digests and reports.  f. the serving commands: ``serve --model gpt2``
    (a virtual clock, no breach, no leaked page, every request completed),
    ``slo --model gpt2 --ttft 10`` (a live leg), ``soak --duration 2
    --warmup 0.5`` (healthy; every value but its clock-stamped series
    equal to the same command's on the CPU), ``doctor --model gpt2`` and
    ``doctor --memory --model gpt2``, ``metrics diff`` over the soak's
    series and ``regress`` of a committed artifact against itself: each
    exits 0, and each that serves replays the paged kernel.  e. ``python
    -m distributed_llm_scheduler_tpu_torch execute --model gpt2`` in a
    subprocess exits 0.  Each command's wall time and makespan
    (``CLI_LINE``).
21. the pre-flight lint and the sim-against-card rank check, through the
    port's ``__main__.main(argv)`` in this process, every launch count set
    to 0 just before each command and read just after.  a. ``lint --model
    gpt2 --json``, ``lint --model llama-8b --json`` (the sharding pass over
    Llama-3 8B's meta specs under ``factorize_mesh(8)``) and ``lint
    --model gpt2 --quantize int8 --json``: each exits as, and prints the
    JSON of, the same command under ``DLS_PLATFORM=cpu``, and no kernel
    runs.  b. ``lint --model gpt2 --preflight`` on the card (each distinct
    task once: the flash and LayerNorm kernels run), its CST diagnostics
    printed; ``lint --serving`` (the serve bench's scenario on the card,
    the paged kernel replayed) exits 0 with no PGL, LCY or DET diagnostic,
    so the port's tree is clean under the determinism pass; ``--inject-leak
    4`` exits 1 naming PGL001 and ``--prefix --inject-underflow`` exits 1
    naming PGL006.  c. ``rankcheck --model gpt2`` at its defaults (GPT-2
    small f32, batch 1, seq 512, 99 tasks, on the cards ``--num-nodes 8``
    binds) exits 0 or 1.  d. ``run_rank_check`` over the same DAG on 8
    nodes sharing the card, ``roundrobin,critical,pipeline,pack``, 3
    measured repeats, uncalibrated and with ``anchor_calibrate``: every
    policy completes and every measured run's output equals one node's
    under the f32 rule (``benchlib.oracle_close``); predicted and measured
    ms per policy, Kendall's tau and the agreement printed.  e. ``rankcheck
    --stress``: with fewer than 4 cards it exits 2 with one line; with 4 or
    more it runs.  f. ``trace_to_chain`` over the GPT-2 small forward on
    meta tensors: every weight charged (``total_param_gb`` the params'
    bytes), its task count printed (``LINT_RANK_LINE``).
22. the parallel layer on ``torch.distributed``: ``parallel.launch.spawn``
    starts one process per visible card (NCCL) and each runs
    :func:`parallel_rank`; the world and the card count are printed.
    a. GPT-2 small f32 (config #5), batch 8, seq 512, ``make_train_step``
    over ``factorize_mesh(n)``: 3 steps, the flash and LayerNorm launches
    counted from 0 over them; the losses within rtol = atol = 1e-4 of the
    unsharded step's on rank 0 from the same weights; then 8 more steps,
    each timed between CUDA events (median and range).  b. the state saved after step 2 (``utils/checkpoint``,
    a ``torch.distributed.checkpoint`` directory), loaded into a fresh
    state, step 3 taken: its loss equal to the uninterrupted run's (atol
    0).  c. Llama-3 8B bf16, batch 8, prompt 512 (phase 19's input), 32
    greedy tokens, tp = n: ``measure_decode_sharded`` (ms per token, tok/s;
    the RMSNorm launches that ran counted from 0); an f32 leg at 2 layers
    of its widths, 8 greedy tokens: the tensor-parallel logits of the
    prefill and of each decode step fed the same tokens at rtol = atol =
    2e-4 against the unsharded ``forward_cached``, and the greedy tokens
    equal to the unsharded ``generate``'s but at a near tie (the two
    tokens' logits within twice that tolerance where a row first parts).  d. ring and Ulysses attention at Llama width
    (B 1, H 32, T 8,192, hd 128), bf16 and f32, sp = n: each against the
    other and against ``mha`` (the flash kernel) at the flash check's
    tolerance (``KERNEL_TOL``), Ulysses launching flash once per rank; each
    call timed between CUDA events after an untimed first one, which opens
    the NCCL communicators (``PARALLEL_LINE``).
23. the compiled rung over the cards (``execute(compiled=True)`` in a
    world of one process per card, each capturing its share with the
    IR's cross-card exchanges as NCCL sends and receives).  a. the
    flagship DAG of phase 6 (bf16, 537 tasks, weights on the host) placed
    by ``heft`` on 8 nodes bound to the visible cards in turn (two per
    card on four cards; on one card, all eight on it in a world of one,
    ``DeviceBackend(world=True)``): the world's output bit-equal to the
    planned rung's on the same placement in this process (and on one
    card to the in-process compiled rung's), within the bf16 oracle rule
    of the fused forward, its host calls per run at most the input's
    tensors plus one; the flash and LayerNorm kernels that ran in each
    rank (the ranks' ``kernels.ran``, counted over one run) above 0 and
    summing to one forward's; the makespan of both rungs (median and
    range of ``COMPILED_SAMPLES`` runs), the exchanges in all and across
    cards with their bytes, and the world's start seconds.  b. the
    ladder's two benches (``eval/dispatch_bench``, ``eval/compiled_bench``)
    at the reference's defaults on the visible cards: their JSON printed,
    bit-identity and the compiled launch bound required, the re-batched
    segmented leg (the one the makespan gate reads) required allclose to
    planned, the timing gates' verdicts and legs recorded
    (``COMPILED_CARDS_LINE``).
24. expert and pipeline parallelism: one ``parallel.launch.World`` of a
    process per visible card (NCCL) runs :func:`expert_pipeline_rank`;
    each rank's numbers come back.  a. the dp x ep Mixtral training step
    (``parallel/expert.make_moe_train_step``; ep = the cards, dp the
    rest) at Mixtral-8x7B widths, batch 2, seq 512, dense and routed
    (capacity 2.0): bf16 at ``MOE_LAYERS`` layers, weights drawn on the
    card tensor by tensor with each rank keeping its experts, 3 steps
    with finite losses and each rank's flash and RMSNorm launches (one
    forward's per step: the attention and norms run on every ep rank)
    counted from 0, then ``PAR_TIMED_STEPS`` steps timed between CUDA
    events; f32 at 1 layer, the 3 losses within rtol = atol = 1e-4 of the
    unsharded per-expert step's (``models/mixtral.loss_fn``, the same
    AdamW) on rank 0, and the routed forward's dropped slots at capacity
    2.0 and at 0.5 (which must drop some) equal to the unsharded routed
    forward's.  b. the GPipe training step of GPT-2
    small f32 (``parallel/pipeline_pp.make_pp_train_step``: batch 8, seq
    512, pp = the cards, 8 microbatches): 3 steps within 1e-4 of the
    unsharded step's on rank 0, each stage rank launching flash ``L/S x
    M`` and LayerNorm ``2 L/S x M + 1`` times a step (no fill or drain
    step runs a layer; the head's norm on every rank), then timed as in
    a.  c. the pipeline forward of Llama-3 8B widths at 8 layers, bf16,
    batch 4, seq 512, 4 microbatches, against the plain forward on rank
    0 under the bf16 oracle rule, timed between CUDA events.  Each leg's
    peak GiB per rank.  d. ``train --model mixtral-tiny --routed --steps
    2`` and ``train --model gpt2 --pp n --steps 2`` through the port's
    ``__main__``: exit 0 and two ``step N: loss X`` lines
    (``EXPERT_PIPELINE_LINE``).
25. the record tools.  a. ``lint --parallel`` and ``lint --parallel
    --json`` through the port's ``__main__`` on the cards' count: exit 0,
    no diagnostic, no kernel launched; then the collective sweep
    (``analysis/parallel_sweep``) on a simulated world of 8 ranks (a
    thread a rank, on the CPU): clean, each probe's recorded collectives
    printed.  b. ``eval/capture_artifacts.main([23, "train"])`` at full
    size into a temporary directory (phase 18 a's run): exit 0, the TRAIN
    record's fields (``tests/test_artifacts_schema.py``'s), ``platform``
    ``cuda`` and ``card``, flash and LayerNorm launches counted.  c.
    ``eval/rankcheck_artifact.main``: below four cards its one-line
    refusal (exit 2, nothing written); on four, both legs, each leg's
    Kendall's tau and winner agreement printed (``ARTIFACTS_LINE``).

The last lines are one JSON object of per-kernel numbers (``launches`` is
the count of the kernel's main path, ``launches_by_path`` each counted
run's own; for a captured run, the launches its graphs' replays made,
counted at each replay; for a run that captures the decode loops, the
launches that ran, eager and by replays), the card's name and power limit as nvidia-smi reports them,
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

    python3 chip_smoke.py --parallel

runs phase 22 alone over every visible card (one card, or the four of
the four-card machine) and prints its ``PARALLEL_LINE``.

    python3 chip_smoke.py --compiled-cards

runs phase 23 alone over every visible card and prints its
``COMPILED_CARDS_LINE``.

    python3 chip_smoke.py --expert-pipeline

runs phase 24 alone over every visible card and prints its
``EXPERT_PIPELINE_LINE``.

    python3 chip_smoke.py --record-tools

runs phase 25 alone (b runs the train capture leg itself) and prints its
``ARTIFACTS_LINE``.

    python3 chip_smoke.py --artifacts [OUT]

runs every leg of ``eval/capture_artifacts`` at full size and, on four
cards, both legs of ``eval/rankcheck_artifact``, writing their
``*_TORCH_r23.json`` records under OUT (default: this checkout's root),
and prints each record's headline values (``ARTIFACTS_RECORDS_LINE``);
see :func:`artifacts_only`.

    python3 chip_smoke.py --preflight-passes [ROOT]

measures ``lint --preflight``'s task footprints (GPT-2 small f32) twice
in a fresh process with the package under ROOT and prints where the two
passes differ; see :func:`preflight_passes`.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): device memory rate and the
# compute rate for each input type (bf16 and f16 on the tensor cores;
# float32 outside them)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}

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
# flash edge cases timed at the flagship's batch and length, by the key
# of their numbers in the kernel line: head dim 16 (Mixtral tiny's d_model
# 64 as 4 heads of 16), float16 at GPT-2 small's heads, and head dim 80
# (padded to the 128 instance) at 32 heads
HD16_TIMED = (8, 4, 512, 16)
EDGE_TIMED = {(HD16_TIMED, "bfloat16"): "at_head_dim_16",
              ((8, 12, 512, 64), "float16"): "at_float16",
              ((8, 32, 512, 80), "bfloat16"): "at_head_dim_80_padded"}
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
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 5e-2, "float16": 5e-2}
# kernel vs the plain version in f32 on the same (bf16-valued) inputs: the
# kernel computes in f32 and rounds once on output, so every element must
# lie within bf16's unit roundoff 2^-8 of the exact value, plus 1e-4 for
# f32 summation order; in f32 the limit is KERNEL_TOL's (the flash kernel's
# f16 instance: f16's 2^-11)
BF16_ROUNDOFF, F32_SLACK = 2.0 ** -8, 1e-4
ROUNDOFF = {"bfloat16": BF16_ROUNDOFF, "float16": 2.0 ** -11}


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
    itemsize = 4 if dtype_name == "float32" else 2
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
        # head dim 16 (Mixtral tiny's), f32 and bf16, plain, GQA and views
        ((2, 4, 77, 16), "float32", True, "heads", None),
        ((2, 4, 77, 16), "bfloat16", True, "heads", None),
        ((2, 4, 300, 16), "bfloat16", False, "heads", None),
        ((1, 8, 300, 16), "bfloat16", True, "kv", 2),
        ((1, 8, 200, 16), "float32", True, "kv", 4),
        ((2, 4, 128, 16), "bfloat16", True, "qkv", None),
        # float16 on its tensor-core instance; head dims between the
        # instances, through mha/gqa_mha on copies padded to the next one
        ((2, 3, 77, 64), "float16", True, "heads", None),
        ((1, 8, 300, 128), "float16", True, "kv", 2),
        ((2, 4, 128, 32), "float16", False, "qkv", None),
        ((2, 4, 77, 48), "float32", True, "heads", None),
        ((2, 4, 300, 80), "bfloat16", True, "heads", None),
        ((1, 8, 200, 96), "float16", False, "kv", 2),
        ((2, 4, 77, 8), "bfloat16", True, "qkv", None),
        *((shape, dname, True, "heads", None) for shape, dname in EDGE_TIMED),
    ]
    rng = np.random.default_rng(0)
    main = None
    for shape, dname, causal, layout, kv_heads in cases:
        q, k, v = attention_inputs(torch, rng, dev, shape, dname, layout, kv_heads)
        group = q.shape[1] // k.shape[1]
        kr, vr = k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)
        # flash_attention itself, but for the Llama path's call and the
        # head dims only mha/gqa_mha take (padded)
        fn = (A.gqa_mha if layout == "gqa" or shape[-1] not in A._HEAD_DIMS
              else A.flash_attention)
        got = fn(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = A.reference_mha(q, kr, vr, causal=causal)
        err = (got.float() - want.float()).abs().max().item()
        # the same function in f32 from the same inputs: isolates the
        # kernel's own output rounding from the plain version's bf16 steps
        want32 = A.reference_mha(q.float(), kr.float(), vr.float(), causal=causal)
        diff32 = (got.float() - want32).abs()
        err32 = diff32.max().item()
        if dname in ROUNDOFF:
            out32 = int((diff32 > ROUNDOFF[dname] * want32.abs() + F32_SLACK).sum())
            rule32 = (f"{out32} elements beyond 2^{math.log2(ROUNDOFF[dname]):.0f}"
                      f"*|x|+{F32_SLACK:g}")
        else:
            out32 = 0 if err32 < KERNEL_TOL[dname] else 1
            rule32 = f"tol {KERNEL_TOL[dname]:g}"
        ok = (math.isfinite(err) and err < KERNEL_TOL[dname]
              and math.isfinite(err32) and out32 == 0)
        same = ""
        if layout == "qkv":  # strided views read in place, bit for bit
            dense = fn(q.contiguous(), k.contiguous(), v.contiguous(),
                       causal=causal)
            equal = bool(torch.equal(got, dense))
            same = f", equal to contiguous copies: {equal}"
            ok = ok and equal
        log(f"  {fn.__name__} {shape} {dname} causal={causal} {layout}"
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
        edge = EDGE_TIMED.get((shape, dname))
        if edge:
            ms, ms_b2b = time_attention(
                torch, lambda *a: A.mha(*a, causal=True), (q, k, v), 200)
            plain_ms = graph_ms(torch, lambda *a: A.reference_mha(*a, causal=True),
                                [(q, k, v)] * 20)
            lib_ms, lib_b2b = time_attention(
                torch, lambda *a: F.scaled_dot_product_attention(*a, is_causal=True),
                (q, k, v), 200)
            bound_ms, bound_by = attention_bound_ms(shape, dname, True)
            main[edge] = dict(
                shape=list(shape), dtype=dname, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms, ms_back_to_back=ms_b2b,
                library_ms_back_to_back=lib_b2b)
            log(f"  {edge} {shape} {dname} (mha; CUDA-graph replays, back to "
                f"back in brackets): kernel {ms:.5f} ms ({ms_b2b:.5f}), "
                f"plain {plain_ms:.5f} ms, SDPA {lib_ms:.5f} ms ({lib_b2b:.5f}), "
                f"bound {bound_ms * 1e3:.3f} us ({bound_by})")
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
    main["routes"] = check_flash_routes(torch, A, dev, rng)
    return main


def check_flash_routes(torch, A, dev, rng) -> dict:
    """``mha``/``gqa_mha`` on the card take every call to the kernel, by
    the path ``resolve_flash_path`` names: a head dim without an instance
    (48) on copies padded to the next one (counted), float16 GQA as given,
    a bf16 view the kernel's 16-byte copies cannot read on contiguous
    copies (counted, equal to the kernel on copies made by hand); a head
    dim above 128 raises."""
    import numpy as np

    from distributed_llm_scheduler_tpu_torch.ops import kernels

    def draw(shape, dt):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dt)

    kernels.reset_launches()
    x = draw((2, 4, 77, 48), torch.float32)
    out48 = A.mha(x, x, x)
    h = draw((2, 8, 77, 64), torch.float16)
    kv = draw((2, 2, 77, 64), torch.float16)
    out16 = A.gqa_mha(h, kv, kv)
    wide = draw((2, 4, 77, 33), torch.bfloat16)
    view, q = wide[..., 1:33], wide[..., 1:33].contiguous()
    got = A.mha(q, view, view)
    torch.cuda.synchronize()
    routes = {k: v for k, v in kernels.routes.items() if v}
    launched = kernels.launches[A.KERNEL]
    ok48 = (out48 - A.reference_mha(x, x, x)).abs().max().item() < KERNEL_TOL["float32"]
    kr = kv.repeat_interleave(4, dim=1)
    ok16 = ((out16.float() - A.reference_mha(h, kr, kr).float()).abs().max().item()
            < KERNEL_TOL["float16"])
    same = bool(torch.equal(got, A.flash_attention(q, q, q)))
    big = draw((1, 2, 8, 192), torch.float32)
    try:
        A.mha(big, big, big)
        refused = False
    except ValueError:
        refused = True
    ok = (routes == {f"{A.KERNEL}.kernel:padded": 1,
                     f"{A.KERNEL}.kernel:contiguous": 1}
          and launched == 3 and ok48 and ok16 and same and refused)
    log(f"  flash routes on the card: {routes}, kernel launches {launched} "
        f"(expected 3); hd 48 f32 (padded) equal to the plain version within "
        f"{KERNEL_TOL['float32']:g}: {ok48}; fp16 GQA within "
        f"{KERNEL_TOL['float16']:g}: {ok16}; misaligned bf16 view equal to "
        f"the kernel on copies: {same}; hd 192 refused: {refused} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash routes on the card are off")
    return routes


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


def check_norm_case(torch, N, dev, rng, kind, shape, dname, offset, pad,
                    variant) -> tuple:
    """One norm kernel against its plain version on one case (see
    ``NORM_CASES``); the case must also take ``variant``.  Returns (the
    kernel's args, max_abs_err against the plain version)."""
    from distributed_llm_scheduler_tpu_torch.ops import kernels

    kernel, plain, _ = norm_fns(torch, N)
    cpu = torch.device("cpu")
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
    return args, err


def check_norm_kernels(torch, N, dev) -> dict:
    """Both norm kernels against their plain versions on NORM_CASES: the
    main paths' shapes, then f32, 77 rows, D = 100 and 128, strided rows,
    the block-per-row path with a tail, rows offset by 1e4, the register
    instances' edges and rows past the grid; each case must also take the
    variant it names.  Then NORM_TIMED are timed.  Returns each kernel's
    numbers at its main path's shape (LayerNorm's decode-step shape under
    ``at_serve_shape``)."""
    import numpy as np

    rng = np.random.default_rng(3)
    timed_args = {}
    for kind, shape, dname, offset, pad, variant in NORM_CASES:
        args, err = check_norm_case(torch, N, dev, rng, kind, shape, dname,
                                    offset, pad, variant)
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


def no_routes(label: str) -> None:
    """Raise if, since the counts were last set to 0, a wrapper handed its
    kernel a call on copies (``kernels.routes``: a misaligned view or a
    padded head dim), which a main path never needs."""
    from distributed_llm_scheduler_tpu_torch.ops import kernels

    taken = {k: v for k, v in kernels.routes.items() if v}
    if taken:
        raise AssertionError(f"{label}: kernels took calls on copies: {taken}")


def counted(label: str, expected: dict, run):
    """Run ``run()`` with every launch count set to 0 just before and the
    counts of the kernels in ``expected`` read just after; each must equal
    its expected number, and no call may have gone to a kernel on copies
    (:func:`no_routes`).  Returns (run's result, {kernel: count})."""
    from distributed_llm_scheduler_tpu_torch.ops import kernels

    kernels.reset_launches()
    out = run()
    no_routes(label)
    got = {k: kernels.launches[k] for k in expected}
    log(f"  {label}: " + ", ".join(
        f"{k} launched {got[k]} times (expected {n})" for k, n in expected.items()))
    bad = {k: got[k] for k, n in expected.items() if got[k] != n}
    if bad:
        raise AssertionError(f"{label}: launch counts {bad} != {expected}")
    return out, got


def ran_counts(names) -> dict:
    """{kernel: launches that ran on the card since the counts were last
    set to 0}: the eager ones and the replays', not the captures' records
    (``kernels.ran``)."""
    from distributed_llm_scheduler_tpu_torch.ops import kernels

    return {k: kernels.ran(k) for k in names}


def counted_ran(label: str, expected: dict, run):
    """:func:`counted` for a path that captures CUDA graphs (greedy
    ``generate``'s step): each kernel's launches that ran on the card,
    eager and replayed, must equal its expected number.  Returns (run's
    result, {kernel: count that ran}, {kernel: of them by replays})."""
    from distributed_llm_scheduler_tpu_torch.ops import kernels

    kernels.reset_launches()
    out = run()
    no_routes(label)
    got = ran_counts(expected)
    by_replay = {k: kernels.replayed.get(k, 0) for k in expected}
    log(f"  {label}: " + ", ".join(
        f"{k} ran {got[k]} times (expected {n}; {by_replay[k]} by replays)"
        for k, n in expected.items()))
    bad = {k: got[k] for k, n in expected.items() if got[k] != n}
    if bad:
        raise AssertionError(f"{label}: launch counts {bad} != {expected}")
    return out, got, by_replay


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
            no_routes(name)
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


def static_filters_on(label: str, result) -> dict:
    """refine's and search's ``stats["static_filter"]`` from a bench
    result: both must read ``on`` (an analyzer that raised turns the
    pre-filter off and changes the walk and the placements)."""
    got = {n: (result.policy_stats or {}).get(n, {}).get("static_filter")
           for n in ("refine", "search")}
    log(f"  {label}: static pre-filter " + ", ".join(
        f"{n} {v}" for n, v in got.items()))
    if any(v != "on" for v in got.values()):
        raise AssertionError(f"{label}: static pre-filter {got}")
    return got


def run_bench_path(torch, P, dev) -> tuple:
    """The port's north-star bench (``eval/bench.run("small")``) on the card:
    calibration, the per-task and fused legs, the pre-flight, the replay of
    all 10 policies (``search`` at budget 120).  Prints its JSON line, each
    policy's replayed makespan and scheduling wall, and each leg's
    launches; fails unless the oracle holds, every policy but round-robin
    completes, the MFU was measured, each leg launched the kernels as many
    times as its forwards need, refine's and search's static pre-filter
    ran in both runs, and a second run from the saved
    calibration gives the first run's best policy, ``value``,
    ``vs_baseline`` and every policy's placement digest.  Returns each
    leg's launch counts and the second run's result."""
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
    # measured afresh and saved: the second run below replays the file
    result = bench.run("small", dev, reps=reps, refresh=True)
    no_routes("bench")
    total = {k: kernels.launches.get(k, 0) for k in per_dag}
    line = result.to_json()
    print("BENCH_LINE " + json.dumps(line), flush=True)
    if result.n_policies != 10 or "best_of_10" not in line["metric"]:
        raise AssertionError(f"bench ranked {result.n_policies} policies: "
                             f"{line['metric']}")
    static_filters_on("bench", result)
    for name, (makespan, completion) in sorted(result.policies.items()):
        log(f"  bench policy {name:10s}: replayed {makespan * 1e3:.4f} ms, "
            f"completion {completion:.3f}, scheduled in "
            f"{result.policy_sched_s[name]:.3f} s, digest "
            f"{result.placement_digests[name][:12]}")
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
    # the saved calibration replayed (one rep a measured leg; the same link,
    # so the replay sees the same inputs): the headline must not move
    t0 = time.perf_counter()
    again = bench.run("small", dev, reps=1, link=result.link_model)
    line2 = again.to_json()
    print("BENCH_REPLAY_LINE " + json.dumps(line2), flush=True)
    static_filters_on("bench from the saved calibration", again)
    same = (again.cache_hit is True and result.cache_hit is False
            and line2["value"] == line["value"]
            and line2["vs_baseline"] == line["vs_baseline"]
            and again.best_makespan_s == result.best_makespan_s
            and again.best_policy == result.best_policy
            and again.placement_digests == result.placement_digests)
    log(f"  bench from the saved calibration in {time.perf_counter() - t0:.1f} "
        f"s: cache_hit {again.cache_hit} (first run {result.cache_hit}), age "
        f"{again.calibration_age_days} days, value {line2['value']} ms (first "
        f"run {line['value']}), vs_baseline {line2['vs_baseline']} (first run "
        f"{line['vs_baseline']}), best {again.best_policy} (first run "
        f"{result.best_policy}), placement digests of all "
        f"{len(again.placement_digests)} policies equal "
        f"{again.placement_digests == result.placement_digests}; per-task "
        f"{line2['spread']['pt_makespan']['median_ms']} ms measured live "
        f"-> {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("bench: the saved calibration did not replay "
                             "the first run's headline")
    return legs, again


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


def build_engine(P, cfg, dev, geom, seg_steps, seed, capture=True):
    """A paged decode engine for ``cfg`` on ``dev``: the paged decode DAG,
    placed by ``greedy`` on one node, weights from numpy ``seed``; its
    segments captured as one CUDA graph unless ``capture`` is False."""
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
        pages_per_seq=geom["pages_per_seq"], seg_steps=seg_steps,
        capture=capture)
    return dag, eng, weights


def serve(eng, reqs) -> dict:
    for rid, ids, gen in reqs:
        eng.submit(rid, ids, gen)
    return eng.run()


def segment_windows(torch, P, eng, reqs, n: int = 5) -> dict:
    """The device window of ``n`` steady-state captured segments (the
    third on, before any slot frees up), each from a CUDA event recorded
    on the current stream before the segment to one after it
    (``DeviceClock.mark``): a replay's host span bounds only its launch,
    so the host wall of ``step_segment`` is read beside it."""
    from distributed_llm_scheduler_tpu_torch.backends.device import DeviceClock

    eng.reset()
    for rid, ids, gen in reqs:
        eng.submit(rid, ids, gen)
    eng.step_segment()
    eng.step_segment()
    torch.cuda.synchronize()
    dev_ms, host_ms = [], []
    for _ in range(n):
        stream = torch.cuda.current_stream()
        a = DeviceClock.mark(stream)
        t0 = time.perf_counter()
        eng.step_segment()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        b = DeviceClock.mark(stream)
        torch.cuda.synchronize()
        dev_ms.append(a.elapsed_time(b))
    eng.run()
    return dict(segment_device_window_ms=statistics.median(dev_ms),
                segment_device_windows_ms=dev_ms,
                segment_host_ms=statistics.median(host_ms))


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
    """GPT-2 small bf16 served through the paged engine, its segments one
    captured CUDA graph (the warm-up run captures it; the timed runs only
    replay); returns each timed run's launch counts that ran of the
    single-token and the ragged paged kernel and of the LayerNorm kernel,
    the trace's numbers, and what the online serving phase reuses: the
    warmed engine, its weights and config, the median run's useful tok/s
    and its mean segment wall.  An engine with ``capture=False`` serves
    the same workload once: its tokens must equal the captured engine's
    bit for bit."""
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
        no_routes(label)
        n_paged = kernels.ran(A.PAGED_KERNEL)
        n_ragged = kernels.ran(A.PAGED_RAGGED_KERNEL)
        n_ln = kernels.ran("layer_norm")
        n_ln_reg = kernels.ran("layer_norm.register")
        eager_paged = kernels.launches[A.PAGED_KERNEL]
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
            f" {n_ln_reg} of them on the register kernel (expected all); "
            f"{kernels.replayed[A.PAGED_KERNEL]} paged and "
            f"{kernels.replayed['layer_norm']} layer_norm launches by "
            f"replays of the captured segment, {eager_paged} paged eagerly "
            f"(expected 0)")
        if (n_paged != expected or n_ragged != 0 or n_ln != ln_expected
                or n_ln_reg != n_ln or eager_paged):
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
    captured = dict(tok_s=useful / walls[med], wall_s=walls[med],
                    tpot_p50_ms=h["decode.tpot_s"]["p50"] * 1e3,
                    tpot_p99_ms=h["decode.tpot_s"]["p99"] * 1e3,
                    ttft_p50_ms=h["decode.ttft_s"]["p50"] * 1e3,
                    ttft_p99_ms=h["decode.ttft_s"]["p99"] * 1e3,
                    segment_wall_ms=seg_wall * 1e3)

    # the same workload through an eager engine of the same weights
    _, eager_eng, _ = build_engine(P, cfg, dev, SERVE_GEOM, SERVE_SEG_STEPS,
                                   0, capture=False)
    serve(eager_eng, reqs)  # warm-up
    eager_eng.reset(fresh_metrics=True)
    t = time.perf_counter()
    eager_res = serve(eager_eng, reqs)
    torch.cuda.synchronize()
    e_wall = time.perf_counter() - t
    eh = eager_eng.metrics.snapshot()["histograms"]
    e_pf = eh["decode.prefill_s"]["sum"]
    eager = dict(tok_s=useful / e_wall, wall_s=e_wall,
                 tpot_p50_ms=eh["decode.tpot_s"]["p50"] * 1e3,
                 tpot_p99_ms=eh["decode.tpot_s"]["p99"] * 1e3,
                 segment_wall_ms=(e_wall - e_pf) / eager_eng.segments_run * 1e3)
    same = [rid for rid, _, _ in reqs
            if np.array_equal(eager_res[rid], results[rid])]
    log(f"  eager engine (capture=False), same workload: {e_wall:.4f} s -> "
        f"{eager['tok_s']:.1f} useful tok/s, TPOT p50 "
        f"{eager['tpot_p50_ms']:.3f} ms, p99 {eager['tpot_p99_ms']:.3f} ms, "
        f"segment wall {eager['segment_wall_ms']:.3f} ms; captured "
        f"{captured['tok_s']:.1f} tok/s, TPOT p50 {captured['tpot_p50_ms']:.3f}"
        f" ms, p99 {captured['tpot_p99_ms']:.3f} ms, segment wall "
        f"{captured['segment_wall_ms']:.3f} ms ({eager['segment_wall_ms'] / captured['segment_wall_ms']:.2f}x); "
        f"tokens equal in {len(same)} of {len(reqs)} requests")
    if len(same) != len(reqs):
        raise AssertionError("captured segments' tokens differ from the "
                             "eager engine's")
    del eager_eng
    win = segment_windows(torch, P, eng, reqs)
    log(f"  captured segment device window (CUDA events): median "
        f"{win['segment_device_window_ms']:.3f} ms over "
        f"{len(win['segment_device_windows_ms'])} segments, host wall "
        f"{win['segment_host_ms']:.3f} ms")
    trace = serve_trace(torch, eng, reqs, seg_wall)
    busy = trace.get("segment_device_busy_ms")
    if busy:
        win["idle_share_of_window"] = 1.0 - busy / win["segment_device_window_ms"]
        win["idle_share_of_wall"] = 1.0 - busy / (seg_wall * 1e3)
        log(f"  captured segment: device busy {busy:.3f} ms of a "
            f"{win['segment_device_window_ms']:.3f} ms device window (idle "
            f"share {win['idle_share_of_window']:.3f}) and of a "
            f"{seg_wall * 1e3:.3f} ms mean segment wall (idle share "
            f"{win['idle_share_of_wall']:.3f})")
    trace.update(win, captured=captured, eager=eager)
    served = dict(engine=eng, weights=weights, cfg=cfg,
                  tok_s=useful / walls[med], seg_wall_s=seg_wall)
    return paged_n, ragged_n, ln_n, trace, served


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


# online serving phase (15), parts b-d: the frontend over phase 9's GPT-2
# small bf16 engine on a real clock.  b: one Poisson schedule from seed 7
# at LOAD x the capacity phase 9 measured (its useful tok/s over the
# schedule's mean new tokens per request), fifo admit-all against slo
# admission with preemption, the TTFT target TTFT_SEGMENTS x phase 9's
# mean segment wall; c: the long-prompt mix, chunked against whole
# prefill; d: sessions sharing a 256-token system prompt, sharing on and
# off.  Every prompt plus its output fits the 512-token capacity.
ONLINE = dict(n_requests=64, prompt_lens=(64, 128, 192, 256),
              max_new_tokens=(64, 96, 128), priorities=(0, 1),
              priority_weights=(0.3, 0.7), seed=7)
ONLINE_LOAD = 2.0
TTFT_SEGMENTS = 4
SLO_WINDOW_SEGMENTS = 16
ONLINE_TRACED = 16  # arrivals of the traced slo leg
CHUNKED_ONLINE = dict(n_requests=24, short_lens=(32, 48, 64), long_len=448,
                      long_every=6, max_new_tokens=(32, 64),
                      long_max_new_tokens=8)
CHUNK_TOKENS = 64
PREFIX_ONLINE = dict(n_sessions=16, system_len=256, user_len=64, turns=2,
                     max_new_tokens=(64,), priorities=(0, 1),
                     priority_weights=(0.3, 0.7), think_time_s=0.05)


def run_serve_bench_on_card(torch, dev) -> dict:
    """Part a: the serve bench (``eval/serve_bench.measure_serving``, GPT-2
    tiny f32 on a virtual clock, its prefix and chunked legs included) on
    the card and on the CPU.  Every gate must pass on the card, and every
    ``serve.*`` metric must equal the CPU run's and ``SERVE_r18.json``'s;
    each leg's digest (its request rows and every generated token) must
    equal the CPU's.  Returns the card's numbers and its launches."""
    from distributed_llm_scheduler_tpu_torch.eval import serve_bench as SB
    from distributed_llm_scheduler_tpu_torch.ops import kernels

    banked = json.loads((ROOT / "SERVE_r18.json").read_text())
    keys = sorted(k for k in banked if k.startswith("serve."))
    t0 = time.perf_counter()
    host = SB.measure_serving(seed=7, device="cpu")
    t_host = time.perf_counter() - t0
    kernels.reset_launches()
    t0 = time.perf_counter()
    card = SB.measure_serving(seed=7, device=dev)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    no_routes("serve bench on the card")
    launches = {k: v for k, v in sorted(kernels.launches.items()) if v}
    fails = SB.gate_failures(card) + [
        f"artifact: {e}" for e in SB.validate_serve_artifact(card)]
    off = {k: dict(card=card.get(k), cpu=host.get(k), banked=banked[k])
           for k in keys if not card.get(k) == host.get(k) == banked[k]}
    legs = {"fifo_admit_all": ("legs",), "slo_preempt": ("legs",),
            "shared": ("prefix", "legs"), "unshared": ("prefix", "legs"),
            "whole": ("chunked", "legs"), "chunked": ("chunked", "legs")}

    def leg(art, name):
        for k in legs[name]:
            art = art[k]
        return art[name]

    digests = {n: leg(card, n)["digest"] == leg(host, n)["digest"] for n in legs}
    rows = {n: leg(card, n)["requests"] == leg(host, n)["requests"] for n in legs}
    residual = card["serve.attribution.max_residual_s"]
    log(f"  serve bench on the card in {t_card:.1f} s (CPU {t_host:.1f} s): "
        f"{len(keys)} serve.* metrics, {len(keys) - len(off)} equal to the CPU "
        f"run's and SERVE_r18.json's; gates {'pass' if not fails else fails}; "
        f"attribution residual {residual}; digests equal to the CPU's "
        f"{digests}; request rows equal {rows}; launches {launches}")
    for k in keys:
        log(f"    {k} = {card[k]!r}")
    if off or fails or residual != 0.0 or not all(digests.values()):
        if not all(digests.values()):
            log_divergent_tokens(dev)
        raise AssertionError(
            f"serve bench on the card: metrics off {off}, gates {fails}, "
            f"residual {residual}, digests {digests}")
    return dict(metrics={k: card[k] for k in keys}, seconds=t_card,
                launches=launches)


def log_divergent_tokens(dev) -> None:
    """On a digest mismatch: the fifo leg's tokens on the card and on the
    CPU, request by request, where they differ."""
    from distributed_llm_scheduler_tpu_torch.eval import serve_bench as SB
    from distributed_llm_scheduler_tpu_torch.obs import SLOPolicy
    from distributed_llm_scheduler_tpu_torch.serve import (
        ServiceTimeModel, ServingFrontend, VirtualClock, poisson_arrivals)

    sc = SB.SCENARIO
    arrivals = poisson_arrivals(
        sc["rate_rps"], sc["n_requests"], 7, prompt_lens=sc["prompt_lens"],
        max_new_tokens=sc["max_new_tokens"], priorities=sc["priorities"],
        priority_weights=sc["priority_weights"])
    out = {}
    for where in (dev, "cpu"):
        eng, _ = SB.build_serve_engine(
            slots=sc["slots"], page_size=sc["page_size"], n_pages=sc["n_pages"],
            pages_per_seq=sc["pages_per_seq"], seg_steps=sc["seg_steps"],
            clock=VirtualClock(), device=where)
        fe = ServingFrontend(
            eng, arrivals, SLOPolicy(ttft_s=sc["ttft_s"], window_s=sc["window_s"]),
            admission="fifo", preemption=False, time_model=ServiceTimeModel(
                wave_s=sc["wave_s"], segment_s=sc["segment_s"],
                idle_s=sc["idle_s"]))
        fe.run()
        out[str(where)] = fe.results
    card, host = out[str(dev)], out["cpu"]
    for rid in sorted(host):
        if not (rid in card and (card[rid] == host[rid]).all()):
            log(f"    fifo {rid}: card {card.get(rid, []).tolist()} vs CPU "
                f"{host[rid].tolist()}")


def online_oracle(torch, P, served, fe, label: str) -> int:
    """Every token the frontend delivered, through phase 9's teacher-forced
    oracle (prompts rebuilt by the frontend's own materializer).  Returns
    the number of requests checked."""
    reqs = [(rid, fe.prompt_fn(rid, fe._reqs[rid].a.prompt_len, fe.vocab_size,
                               fe.prompt_seed), len(toks))
            for rid, toks in sorted(fe.results.items())]
    log(f"  {label}: oracle over {len(reqs)} completed requests")
    serve_oracle(torch, P, served["cfg"], served["weights"], reqs, fe.results)
    return len(reqs)


def online_leg(torch, A, eng, arrivals, policy, label: str, *, admission="slo",
               preemption=True, prompt_fn=None, ownlog=None, sleep=None) -> tuple:
    """One frontend run over the engine on the real clock: rebound first
    (fresh metrics and request log, a pristine pool that keeps the sharing
    mode), its launch counts set to 0 just before and read just after.
    The paged kernel must launch 12 times per decode step and LayerNorm 25
    times per decode step and per prefill call (admission waves and
    prefill chunks), the ragged kernel never; no page may leak and the
    lifecycle lint must find nothing.  ``sleep`` replaces the frontend's
    idle sleep.  Returns (frontend, report, launch counts, wall seconds)."""
    from distributed_llm_scheduler_tpu_torch.obs.reqlog import _percentiles
    from distributed_llm_scheduler_tpu_torch.ops import kernels
    from distributed_llm_scheduler_tpu_torch.serve import ServingFrontend

    eng.rebind_obs(ownlog=ownlog)
    fe = ServingFrontend(eng, arrivals, policy, admission=admission,
                         preemption=preemption, prompt_fn=prompt_fn, sleep=sleep)
    kernels.reset_launches()
    t0 = time.perf_counter()
    rep = fe.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    no_routes(label)
    counts = ran_counts((A.PAGED_KERNEL, A.PAGED_RAGGED_KERNEL, A.KERNEL,
                         "layer_norm", "layer_norm.register"))
    c = eng.metrics.counter
    steps = eng.seg_steps * eng.segments_run
    prefills = int(c("decode.admission_waves").value + c("decode.chunk_waves").value)
    n_layer = eng.n_layers
    want = {A.PAGED_KERNEL: n_layer * steps, A.PAGED_RAGGED_KERNEL: 0,
            "layer_norm": (2 * n_layer + 1) * (steps + prefills)}
    qwait = _percentiles([r["queue_wait_s"] for r in rep["requests"]
                          if r["state"] == "retired"])
    lint = fe.lint()
    findings = [d.code for d in lint.diagnostics]
    log(f"  {label}: {rep['completed']} of {rep['n_requests']} completed, "
        f"{rep['shed']} shed, {rep['preemptions']} preemptions "
        f"({rep['preempted_requests']} requests), in {wall:.2f} s wall; "
        f"goodput {rep['goodput_tok_s']:.1f} tok/s (throughput "
        f"{rep['throughput_tok_s']:.1f}); TTFT p50/p95/p99 "
        f"{rep['ttft_p50_ms']}/{rep['ttft_p95_ms']}/{rep['ttft_p99_ms']} ms; "
        f"TPOT p50/p95/p99 {rep['tpot_p50_ms']}/{rep['tpot_p95_ms']}/"
        f"{rep['tpot_p99_ms']} ms; queue wait p50/p95/p99 "
        f"{rep['queue_wait_p50_ms']}/{rep['queue_wait_p95_ms']}/"
        f"{None if qwait['p99'] is None else qwait['p99'] * 1e3} ms; "
        f"{rep['pages_leaked']} pages leaked; lint {findings or 'clean'}")
    log(f"  {label}: {A.PAGED_KERNEL} {counts[A.PAGED_KERNEL]} (expected "
        f"{n_layer} x {steps} decode steps = {want[A.PAGED_KERNEL]}), "
        f"{A.PAGED_RAGGED_KERNEL} {counts[A.PAGED_RAGGED_KERNEL]} (expected 0), "
        f"layer_norm {counts['layer_norm']} (expected {2 * n_layer + 1} x "
        f"({steps} steps + {prefills} prefill calls) = {want['layer_norm']}), "
        f"{counts['layer_norm.register']} on the register kernel, "
        f"{A.KERNEL} {counts[A.KERNEL]}")
    bad = {k: counts[k] for k, n in want.items() if counts[k] != n}
    if (bad or counts["layer_norm.register"] != counts["layer_norm"]
            or not counts[A.PAGED_KERNEL] or rep["pages_leaked"] or findings):
        raise AssertionError(
            f"{label}: launches {bad}, leaked {rep['pages_leaked']}, lint "
            f"{findings}")
    rep["queue_wait_p99_ms"] = None if qwait["p99"] is None else qwait["p99"] * 1e3
    rep["wall_s"] = wall
    rep["launches"] = counts
    return fe, rep, counts, wall


def leg_numbers(rep) -> dict:
    keys = ("n_requests", "completed", "shed", "preemptions",
            "preempted_requests", "goodput_tok_s", "throughput_tok_s",
            "ttft_p50_ms", "ttft_p95_ms", "ttft_p99_ms", "tpot_p50_ms",
            "tpot_p95_ms", "tpot_p99_ms", "queue_wait_p50_ms",
            "queue_wait_p95_ms", "queue_wait_p99_ms", "pages_leaked",
            "makespan_s", "wall_s", "launches")
    return {k: rep[k] for k in keys}


def run_online_path(torch, P, A, dev, served) -> dict:
    """Parts b-d on phase 9's warmed GPT-2 small bf16 engine; returns each
    leg's numbers (``ONLINE_LINE``) and launch counts."""
    import functools

    from distributed_llm_scheduler_tpu_torch.eval.serve_bench import _page_peaks
    from distributed_llm_scheduler_tpu_torch.analysis import analyze_pages
    from distributed_llm_scheduler_tpu_torch.models.kv_pages import PageOwnershipLog
    from distributed_llm_scheduler_tpu_torch.obs import SLOPolicy
    from distributed_llm_scheduler_tpu_torch.serve import (
        mixed_long_prompt_arrivals, poisson_arrivals, session_arrivals,
        session_prompt_token_ids)

    eng = served["engine"]
    out, launches = {}, {}
    ttft = TTFT_SEGMENTS * served["seg_wall_s"]
    policy = SLOPolicy(ttft_s=ttft, window_s=SLO_WINDOW_SEGMENTS * served["seg_wall_s"],
                       percentile="p95")
    kw = {k: v for k, v in ONLINE.items() if k not in ("n_requests", "seed")}
    probe = poisson_arrivals(1.0, ONLINE["n_requests"], ONLINE["seed"], **kw)
    mean_new = sum(a.max_new_tokens for a in probe) / len(probe)
    capacity = served["tok_s"] / mean_new
    rate = ONLINE_LOAD * capacity
    arrivals = poisson_arrivals(rate, ONLINE["n_requests"], ONLINE["seed"], **kw)
    log(f"  b. {len(arrivals)} Poisson arrivals (seed {ONLINE['seed']}) at "
        f"{rate:.3f} req/s = {ONLINE_LOAD:g} x the {capacity:.3f} req/s capacity "
        f"phase 9 measured ({served['tok_s']:.1f} useful tok/s over "
        f"{mean_new:.2f} new tokens a request), over {arrivals[-1].t:.2f} s; "
        f"TTFT target {ttft * 1e3:.2f} ms = {TTFT_SEGMENTS} x the "
        f"{served['seg_wall_s'] * 1e3:.3f} ms mean segment wall, window "
        f"{policy.window_s * 1e3:.1f} ms, p95")
    for name, adm, pre in (("fifo", "fifo", False), ("slo", "slo", True)):
        label = f"online {name}"
        fe, rep, counts, _ = online_leg(torch, A, eng, arrivals, policy, label,
                                        admission=adm, preemption=pre)
        online_oracle(torch, P, served, fe, label)
        out[name], launches[label] = leg_numbers(rep), counts
    out["offered"] = dict(rate_rps=rate, capacity_rps=capacity,
                          ttft_target_ms=ttft * 1e3, n_requests=len(arrivals),
                          arrival_span_s=arrivals[-1].t)
    # the device's idle share in one slo leg over the first arrivals: run
    # once untraced (its wall, and the time the frontend slept with nothing
    # to run while it waited for arrivals) and once traced with the
    # device's activity only (the busy time); idle is 1 - busy over the
    # untraced wall, and over that wall less the sleeps
    from torch.profiler import ProfilerActivity, profile

    head = arrivals[:ONLINE_TRACED]
    slept = []

    def sleep(dt):
        t = time.perf_counter()
        time.sleep(dt)
        slept.append(time.perf_counter() - t)

    _, _, _, wall = online_leg(torch, A, eng, head, policy,
                               f"online slo untraced ({ONLINE_TRACED} arrivals)",
                               sleep=sleep)
    segments = eng.segments_run
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, _, wall_traced = online_leg(
            torch, A, eng, head, policy,
            f"online slo traced ({ONLINE_TRACED} arrivals)")
    union = busy_union_ms(torch, prof)
    if union is None:
        log("  traced leg: no device intervals (idle share not measured)")
        out["traced"] = None
    else:
        busy_ms = union[0]
        working_s = wall - sum(slept)
        out["traced"] = dict(
            wall_s=wall, slept_s=sum(slept), busy_ms=busy_ms,
            idle_share=1.0 - busy_ms / (wall * 1e3),
            idle_share_working=1.0 - busy_ms / (working_s * 1e3),
            segments=segments, wall_traced_s=wall_traced,
            segments_traced=eng.segments_run)
        log(f"  idle share: device busy {busy_ms:.3f} ms (union, traced leg "
            f"of {eng.segments_run} segments, {wall_traced * 1e3:.3f} ms wall) "
            f"over the untraced leg's {wall * 1e3:.3f} ms wall ({segments} "
            f"segments): {out['traced']['idle_share']:.4f}; over its "
            f"{working_s * 1e3:.3f} ms with work (the wall less "
            f"{sum(slept) * 1e3:.3f} ms slept waiting for arrivals): "
            f"{out['traced']['idle_share_working']:.4f}")

    # c. chunked against whole prefill
    mix = mixed_long_prompt_arrivals(rate, CHUNKED_ONLINE["n_requests"], 7, **{
        k: v for k, v in CHUNKED_ONLINE.items() if k != "n_requests"})
    n_long = sum(1 for a in mix if a.prompt_len == CHUNKED_ONLINE["long_len"])
    log(f"  c. {len(mix)} mixed arrivals at {rate:.3f} req/s, {n_long} of "
        f"{CHUNKED_ONLINE['long_len']} tokens, chunk_tokens {CHUNK_TOKENS}")
    loose = SLOPolicy(ttft_s=10.0, window_s=policy.window_s, percentile="p95")
    toks = {}
    try:
        for name, ct in (("whole", None), ("chunked", CHUNK_TOKENS)):
            eng.chunk_tokens = ct
            label = f"online {name} prefill"
            fe, rep, counts, _ = online_leg(torch, A, eng, mix, loose, label,
                                            preemption=False)
            online_oracle(torch, P, served, fe, label)
            toks[name] = fe.results
            out[f"{name}_prefill"] = dict(
                leg_numbers(rep),
                chunk_admitted=eng.metrics.counter("decode.chunk_admitted").value)
            launches[label] = counts
    finally:
        eng.chunk_tokens = None
    both = sorted(set(toks["whole"]) & set(toks["chunked"]))
    n_tok = sum(len(toks["whole"][r]) for r in both)
    agree = sum(int((toks["whole"][r] == toks["chunked"][r]).sum()) for r in both)
    out["chunked_token_agreement"] = dict(tokens=n_tok, equal=agree,
                                          share=agree / n_tok if n_tok else None)
    log(f"  chunked vs whole: {agree} of {n_tok} tokens equal "
        f"({out['chunked_token_agreement']['share']}); TPOT p99 "
        f"{out['chunked_prefill']['tpot_p99_ms']} vs "
        f"{out['whole_prefill']['tpot_p99_ms']} ms, TTFT p99 "
        f"{out['chunked_prefill']['ttft_p99_ms']} vs "
        f"{out['whole_prefill']['ttft_p99_ms']} ms")
    if not out["chunked_prefill"]["chunk_admitted"]:
        raise AssertionError("online chunked leg chunked no prompt")

    # d. prefix sharing, shared against unshared
    sess = session_arrivals(rate, PREFIX_ONLINE["n_sessions"], 7, **{
        k: v for k, v in PREFIX_ONLINE.items() if k != "n_sessions"})
    prompt_fn = functools.partial(
        session_prompt_token_ids, system_len=PREFIX_ONLINE["system_len"],
        user_len=PREFIX_ONLINE["user_len"])
    log(f"  d. {len(sess)} session arrivals ({PREFIX_ONLINE['n_sessions']} "
        f"sessions x {PREFIX_ONLINE['turns']} turns) at {rate:.3f} sessions/s, "
        f"a {PREFIX_ONLINE['system_len']}-token system prompt")
    try:
        for name, mode in (("unshared", False), ("shared", True)):
            eng.pool.sharing = mode
            own = PageOwnershipLog()
            label = f"online {name} prefix"
            fe, rep, counts, _ = online_leg(torch, A, eng, sess, policy, label,
                                            prompt_fn=prompt_fn, ownlog=own)
            online_oracle(torch, P, served, fe, label)
            findings = [d.code for d in analyze_pages(own).diagnostics]
            acct = _page_peaks(own.events)
            out[name] = dict(leg_numbers(rep), page_pass=findings, **acct)
            launches[label] = counts
            log(f"  {label}: {acct['shared_page_hits']} shared-page hits, "
                f"physical peak {acct['physical_pages_peak']}, logical peak "
                f"{acct['logical_pages_peak']}; page pass "
                f"{findings or 'clean'} over {len(own)} events")
            if findings or acct["physical_pages_end"] or acct["logical_pages_end"]:
                raise AssertionError(f"{label}: page pass {findings}, books {acct}")
    finally:
        eng.pool.sharing = False
        eng.rebind_obs()
    if not out["shared"]["shared_page_hits"]:
        raise AssertionError("online shared leg aliased no page")
    return out, launches


# the run doctor's phase (16): a, the flagship traced and memory-profiled
# on four rungs; b, phase 9's engine traced with a flight recorder and
# request waterfalls; c, the soak doctor (virtual clock on the banked
# config, the leak and churn injections, a real-clock soak of phase 9's
# engine at SOAK_LOAD x its measured capacity for the soak's requests); d,
# the health-routed fleet
DOCTOR_LEGS = (
    ("greedy x1", 1, "greedy", (("planned", {}),
                                ("segmented", dict(segments=True)))),
    ("heft x8", 8, "heft", (("planned", {}),
                            ("compiled", dict(compiled=True)))),
)
SOAK_LOAD = 0.5
SOAK_REAL = dict(duration_s=8.0, warmup_s=2.0)
SOAK_PROBE = 64  # requests of the soak's shapes that measure its capacity
FLIGHT_DIR = ROOT / "chip_smoke_out" / "flight"


def traced_checks(tr, nodes, flows: bool, counters: int) -> dict:
    """The Perfetto export of ``tr``: it validates, every node has its
    track, flows where promised and at least ``counters`` counter tracks.
    Returns the trace summary."""
    from distributed_llm_scheduler_tpu_torch.obs.export import (
        chrome_events, trace_summary, validate_trace)

    obj = {"traceEvents": chrome_events(tr), "displayTimeUnit": "ms"}
    errs = validate_trace(obj)
    summ = trace_summary(obj)
    missing = set(nodes) - set(summ["rows"])
    if (errs or missing or (flows and not summ["flows"])
            or len(summ["counter_tracks"]) < counters):
        raise AssertionError(
            f"trace: errors {errs[:3]}, node tracks missing {missing}, flows "
            f"{summ['flows']}, counter tracks {summ['counter_tracks']}")
    return summ


def run_traced_forward(torch, P, dev) -> tuple:
    """Part a: the flagship under greedy x1 (planned, segmented) and heft
    x8 (planned, compiled), each run with a tracer and a memory profiler,
    its launches counted as phase 7 counts them, then once untraced: the
    outputs bit-equal, the makespans side by side.  The export validates
    with the node tracks, flows across nodes and the memory counter
    tracks; the attribution is non-null and tiles its makespan; the
    memory timeline verifies, its model peak beside the allocator's."""
    from distributed_llm_scheduler_tpu_torch.obs import MemoryProfiler, Tracer
    from distributed_llm_scheduler_tpu_torch.ops import attention as A
    from distributed_llm_scheduler_tpu_torch.ops import kernels
    from distributed_llm_scheduler_tpu_torch.ops import norms as N

    cfg = P.GPT2Config.small(dtype=torch.bfloat16)
    dag = P.build_gpt2_dag(cfg, **FLAGSHIP)
    graph = P.fuse_linear_chains(dag.graph)
    params = dag.init_params(seed=0, device=dev)
    ids = dag.make_inputs(seed=1, device=dev)
    mb = FLAGSHIP["microbatches"]
    per_forward = {A.KERNEL: mb * cfg.n_layer,
                   N.LN_KERNEL: mb * (2 * cfg.n_layer + 1)}
    out, launches = {}, {}
    for label, n, policy, rungs in DOCTOR_LEGS:
        cluster = P.Cluster.from_torch_devices([dev] * n)
        sched = P.get_scheduler(policy).schedule(graph, cluster)
        backend = P.DeviceBackend(cluster)
        nodes = sorted(set(sched.placement.values()))
        for rung, kw in rungs:
            name = f"{label} {rung}"
            tr = Tracer()
            mem = MemoryProfiler(tracer=tr)
            kernels.reset_launches()
            rep = backend.execute(graph, sched, params, ids, reps=REPS,
                                  trace=tr, memprof=mem, **kw)
            torch.cuda.synchronize()
            no_routes(name)
            eager = {k: kernels.launches[k] for k in per_forward}
            replayed = {k: kernels.replayed.get(k, 0) for k in per_forward}
            captured = {k: rep.captured_launches.get(k, 0) for k in per_forward}
            if rep.captured_launches:
                if (eager != times(captured, 2)
                        or replayed != times(captured, 1 + REPS)):
                    raise AssertionError(f"{name}: eager {eager}, replayed "
                                         f"{replayed}, captured {captured}")
                launches[f"doctor {name}"] = replayed
            else:
                if eager != times(per_forward, 1 + REPS):
                    raise AssertionError(f"{name}: launches {eager}")
                launches[f"doctor {name}"] = eager
            on = rep.output.clone()
            summ = traced_checks(tr, nodes, flows="planned" in rung and n > 1,
                                 counters=min(n, 2))
            att = rep.attribution
            if att is None or not att["critical_path"]:
                raise AssertionError(f"{name}: no attribution")
            residual = sum(att["breakdown_s"].values()) - att["makespan_s"]
            if abs(residual) > 1e-9:
                raise AssertionError(f"{name}: attribution residual {residual}")
            errs = mem.verify()
            if errs:
                raise AssertionError(f"{name}: memory timeline {errs[:3]}")
            devs = rep.memory["devices"]
            model_peak = max(d["peak_bytes"] for d in devs.values())
            plat = {d.get("platform_peak_bytes") for d in devs.values()}
            if len(plat) != 1 or None in plat:
                raise AssertionError(f"{name}: allocator peaks {plat}")
            off = backend.execute(graph, sched, params, ids, reps=REPS, **kw)
            torch.cuda.synchronize()
            same = torch.equal(off.output, on)
            if not same:
                raise AssertionError(f"{name}: traced output differs")
            frac = {k: v for k, v in att["fractions"].items()}
            row = dict(
                makespan_ms_traced=rep.makespan_s * 1e3,
                makespan_ms_untraced=off.makespan_s * 1e3,
                dispatch_ms_traced=rep.dispatch_overhead_s * 1e3,
                dispatch_ms_untraced=off.dispatch_overhead_s * 1e3,
                events=len(tr.events), spans=summ["spans"],
                flows=summ["flows"], counter_tracks=len(summ["counter_tracks"]),
                attribution_makespan_ms=att["makespan_s"] * 1e3,
                breakdown_ms={k: v * 1e3 for k, v in att["breakdown_s"].items()},
                fractions=frac, critical_path=len(att["critical_path"]),
                stragglers=att["stragglers"],
                model_peak_bytes=model_peak,
                allocator_peak_bytes=plat.pop(), memory_events=len(mem),
                bit_equal=same)
            out[name] = row
            log(f"  {name}: makespan {row['makespan_ms_traced']:.3f} ms traced "
                f"vs {row['makespan_ms_untraced']:.3f} untraced (host dispatch "
                f"{row['dispatch_ms_traced']:.3f} vs "
                f"{row['dispatch_ms_untraced']:.3f} ms); outputs bit-equal; "
                f"{row['events']} events ({row['spans']} spans, {row['flows']} "
                f"flows, {row['counter_tracks']} counter tracks), export valid; "
                f"attribution of {row['attribution_makespan_ms']:.3f} ms: "
                + ", ".join(f"{k} {v:.3f}" for k, v in row["breakdown_ms"].items())
                + f" ms (residual {residual:.1e}), critical path "
                f"{row['critical_path']} spans; memory model peak "
                f"{model_peak / 1024**2:.1f} MiB beside the allocator's "
                f"{row['allocator_peak_bytes'] / 1024**2:.1f} MiB, "
                f"{len(mem)} events, verified")
            del rep, off, on
        del backend
        torch.cuda.empty_cache()
    return out, launches


def span_sum(tr, name: str, track: str = "decode") -> tuple:
    """(count, seconds) of the spans called ``name`` on ``track`` (the
    request waterfalls carry spans of the same names on their own
    tracks)."""
    spans = [e for e in tr.events if e["type"] == "span"
             and e["name"] == name and e["track"] == track]
    return len(spans), sum(e["t1"] - e["t0"] for e in spans)


def run_traced_serving(torch, P, A, dev, served) -> tuple:
    """Part b: phase 9's engine and workload bare, then with a tracer, a
    flight recorder and request waterfalls (and a memory profiler): the
    tokens equal, the launches counted as phase 9 counts them, the
    export valid with one waterfall per request, 0 leaked pages, and the
    run's wall split into the engine's segment spans, its admission waves
    (the prefill spans inside them) and the rest."""
    from distributed_llm_scheduler_tpu_torch.obs import (
        FlightRecorder, MemoryProfiler, Tracer, request_track)
    from distributed_llm_scheduler_tpu_torch.ops import kernels

    eng, cfg = served["engine"], served["cfg"]
    reqs = serve_workload(cfg.vocab_size)

    def bare_run():
        eng.rebind_obs()
        t0 = time.perf_counter()
        got = {k: v.copy() for k, v in serve(eng, reqs).items()}
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0

    # bare, traced, bare: the tracer's cost against both neighbours
    bare, bare_wall = bare_run()
    tr, fl, mem = Tracer(), FlightRecorder(), MemoryProfiler()
    eng.rebind_obs(tracer=tr, flight=fl, memprof=mem)
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = serve(eng, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    no_routes("doctor serve")
    snap = eng.metrics.snapshot()
    steps = eng.seg_steps * eng.segments_run
    waves = snap["counters"]["decode.admission_waves"]["value"]
    want = {A.PAGED_KERNEL: cfg.n_layer * steps, A.PAGED_RAGGED_KERNEL: 0,
            "layer_norm": (2 * cfg.n_layer + 1) * (steps + waves)}
    counts = ran_counts(want)
    if counts != want or kernels.ran("layer_norm.register") != counts[
            "layer_norm"]:
        raise AssertionError(f"doctor serve: launches {counts} != {want}")
    got = {k: v.copy() for k, v in got.items()}
    leaked = snap["gauges"]["decode.pages_leaked"]["value"]
    summ = traced_checks(tr, [], flows=False, counters=3)
    tracks = set(tr.tracks())
    missing = [rid for rid, _, _ in reqs if request_track(rid) not in tracks]
    flight = traced_checks(fl.tracer, [], flows=False, counters=1)
    mem_errs = mem.verify()
    n_events, kv_peak = len(tr.events), mem.peak(mem.devices()[0])[0]
    bare_again, bare_wall_after = bare_run()
    diff = [rid for rid in bare if not (got[rid] == bare[rid]).all()
            or not (bare_again[rid] == bare[rid]).all()]
    if diff or leaked or missing or mem_errs:
        raise AssertionError(
            f"doctor serve: tokens differ {diff}, {leaked} leaked, waterfalls "
            f"missing {missing}, memory {mem_errs[:2]}")
    n_seg, seg_s = span_sum(tr, "segment")
    n_wave, wave_s = span_sum(tr, "admission_wave")
    n_pf, pf_s = span_sum(tr, "prefill")
    rest_s = wall - seg_s - wave_s
    split = dict(
        wall_s=wall, bare_wall_s=bare_wall,
        bare_wall_after_s=bare_wall_after, segments=n_seg,
        segment_span_s=seg_s, segment_mean_ms=seg_s / n_seg * 1e3,
        admission_waves=n_wave, wave_span_s=wave_s, prefill_span_s=pf_s,
        rest_s=rest_s, rest_per_segment_ms=rest_s / n_seg * 1e3,
        events=n_events, spans=summ["spans"],
        waterfalls=len(reqs), flight_ring_events=len(fl.tracer.events),
        flight_spans=flight["spans"], kv_peak_bytes=kv_peak,
        launches=counts)
    log(f"  doctor serve: {len(reqs)} requests in {wall:.4f} s traced "
        f"({bare_wall:.4f} s bare before, {bare_wall_after:.4f} s after), "
        f"tokens bit-equal; of the traced wall: "
        f"{n_seg} segment spans {seg_s:.4f} s (mean "
        f"{split['segment_mean_ms']:.3f} ms: the captured segment's replay "
        f"and its token readback), {n_wave} admission waves {wave_s:.4f} s "
        f"(their prefill spans {pf_s:.4f} s), the rest {rest_s:.4f} s "
        f"({split['rest_per_segment_ms']:.3f} ms a segment: slot bookkeeping "
        f"and the engine loop); {n_events} events, {len(reqs)} "
        f"waterfalls, export valid; flight ring {len(fl.tracer.events)} "
        f"events, valid; kv peak {split['kv_peak_bytes'] / 1024**2:.1f} MiB; "
        f"0 leaked pages; launches {counts}")
    eng.rebind_obs()
    return split, {"doctor serve": counts}


def soak_launches(A, eng) -> dict:
    """What one soak's engine must have run: the paged kernel per layer
    and decode step, LayerNorm per decode step and prefill call."""
    c = eng.metrics.counter
    steps = eng.seg_steps * eng.segments_run
    prefills = int(c("decode.admission_waves").value
                   + c("decode.chunk_waves").value)
    return {A.PAGED_KERNEL: eng.n_layers * steps, A.PAGED_RAGGED_KERNEL: 0,
            "layer_norm": (2 * eng.n_layers + 1) * (steps + prefills)}


def counted_soak(torch, A, label, eng, run):
    """One soak, its launches that ran counted: :func:`soak_launches`, plus
    once more the kernels of the segment graph when the engine captured it
    in this run (the capture's eager warm-up segment, rerun by the first
    replay)."""
    from distributed_llm_scheduler_tpu_torch.ops import kernels

    kernels.reset_launches()
    art = run()
    torch.cuda.synchronize()
    no_routes(label)
    want = soak_launches(A, eng)
    want = {k: n + kernels.captured.get(k, 0) for k, n in want.items()}
    got = ran_counts(want)
    if got != want or not got[A.PAGED_KERNEL]:
        raise AssertionError(f"{label}: launches {got} != {want}")
    return art, got


def soak_capacity(torch, eng, arrivals) -> float:
    """Requests per second phase 9's warmed engine serves on the host's
    clock when the soak's request shapes arrive one per segment (each
    admission a wave of one, as sparse Poisson arrivals are): the rate at
    which it saturates.  With its segments captured, a short request's
    eager prefill and admission, not the decode, bound it, so phase 9's
    decode tok/s over the mean new tokens overstates it."""
    from distributed_llm_scheduler_tpu_torch.serve import prompt_token_ids

    eng.rebind_obs()
    vocab = int(eng.config.vocab_size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in arrivals:
        eng.submit(a.rid, prompt_token_ids(a.rid, a.prompt_len, vocab, 0),
                   a.max_new_tokens)
        eng.step_segment()
    eng.run()
    torch.cuda.synchronize()
    return len(arrivals) / (time.perf_counter() - t0)


def run_soak_path(torch, P, A, dev, served) -> tuple:
    """Part c: the soak of ``SOAK_r17.json``'s config (GPT-2 tiny f32,
    virtual clock) on the card: its seven ``soak.*`` values equal the
    banked file's and a CPU run's; an injected page leak trips HLT001 and
    dumps a flight trace that validates; injected compile-class churn
    trips HLT003; then phase 9's GPT-2 small bf16 engine soaks on the real
    clock at SOAK_LOAD x its capacity for the soak's requests
    (:func:`soak_capacity`): healthy, no leak."""
    from distributed_llm_scheduler_tpu_torch.eval import serve_bench as SB
    from distributed_llm_scheduler_tpu_torch.obs.export import validate_trace
    from distributed_llm_scheduler_tpu_torch.serve import (
        VirtualClock, poisson_arrivals)
    from distributed_llm_scheduler_tpu_torch.serve.soak import (
        SLOPE_METRICS, SoakConfig, run_soak, validate_soak_artifact)

    banked = json.loads((ROOT / "SOAK_r17.json").read_text())
    keys = sorted(k for k in banked if k.startswith("soak."))
    cfg = SoakConfig(**banked["config"])
    t0 = time.perf_counter()
    host = run_soak(cfg, device="cpu")
    t_host = time.perf_counter() - t0
    tiny, _ = SB.build_serve_engine(clock=VirtualClock(), device=dev)

    def factory(eng):
        def make(*, clock=None, flight=None, attention_impl=None):
            eng.rebind_obs(clock=clock, flight=flight)
            return eng
        return make

    out, launches = {}, {}
    t0 = time.perf_counter()
    card, launches["soak virtual"] = counted_soak(
        torch, A, "soak virtual", tiny,
        lambda: run_soak(cfg, engine_factory=factory(tiny)))
    t_card = time.perf_counter() - t0
    off = {k: (card[k], host[k], banked[k]) for k in keys
           if not card[k] == host[k] == banked[k]}
    log(f"  soak (banked config, virtual clock) on the card in {t_card:.1f} s "
        f"(CPU {t_host:.1f} s): {len(keys) - len(off)} of {len(keys)} soak.* "
        f"values equal the CPU's and SOAK_r17.json's, verdict "
        f"{card['verdict']}, digest equal to the CPU's "
        f"{card['digest'] == host['digest']}")
    for k in keys:
        log(f"    {k} = {card[k]!r}")
    if (off or card["digest"] != host["digest"] or card["verdict"] != "healthy"
            or validate_soak_artifact(card)):
        raise AssertionError(f"soak virtual: off {off}")
    out["virtual"] = dict({k: card[k] for k in keys}, seconds=t_card)

    FLIGHT_DIR.mkdir(parents=True, exist_ok=True)
    for name, kw, code in (
        ("leak", dict(flight_dir=str(FLIGHT_DIR), inject_leak_every=2),
         "HLT001"),
        ("churn", dict(inject_churn=True), "HLT003"),
    ):
        art, launches[f"soak {name}"] = counted_soak(
            torch, A, f"soak {name}", tiny,
            lambda: run_soak(SoakConfig(), engine_factory=factory(tiny), **kw))
        errors = [f for f in art["health"]["findings"]
                  if f["severity"] == "error"]
        dumps = art["flight_dumps"]
        dump_ok = all(validate_trace(d["trace"]) == [] for d in dumps)
        log(f"  soak {name}: verdict {art['verdict']}, breaches "
            + "; ".join(f["message"] for f in errors)
            + f"; {len(dumps)} flight dump(s), valid {dump_ok}"
            + (f", reasons {dumps[0]['reasons']}" if dumps else ""))
        if (art["verdict"] != "breach" or code not in {f["code"] for f in errors}
                or not dump_ok or (name == "leak" and not dumps)):
            raise AssertionError(f"soak {name} did not trip {code}")
        out[name] = dict(verdict=art["verdict"],
                         breaches=[f["code"] for f in errors],
                         dumps=len(dumps),
                         **{m: art[m] for m in SLOPE_METRICS.values()})

    eng = served["engine"]
    probe = poisson_arrivals(1.0, 256, cfg.seed,
                             prompt_lens=SB.SCENARIO["prompt_lens"],
                             max_new_tokens=SB.SCENARIO["max_new_tokens"])
    mean_new = sum(a.max_new_tokens for a in probe) / len(probe)
    capacity = soak_capacity(torch, eng, probe[:SOAK_PROBE])
    rate = SOAK_LOAD * capacity
    real = SoakConfig(rate_rps=rate, real_clock=True,
                      ttft_s=TTFT_SEGMENTS * served["seg_wall_s"],
                      window_s=SLO_WINDOW_SEGMENTS * served["seg_wall_s"],
                      **SOAK_REAL)
    t0 = time.perf_counter()
    art, launches["soak real"] = counted_soak(
        torch, A, "soak real", eng,
        lambda: run_soak(real, engine_factory=factory(eng)))
    t_real = time.perf_counter() - t0
    sv = art["serving"]
    slopes = {m: art[m] for m in SLOPE_METRICS.values()}
    log(f"  soak real clock, GPT-2 small bf16: {SOAK_REAL['duration_s']:g} s "
        f"({SOAK_REAL['warmup_s']:g} s warm-up) at {rate:.3f} req/s = "
        f"{SOAK_LOAD:g} x the {capacity:.3f} req/s its requests ran at one "
        f"arrival a segment (phase 9's {served['tok_s']:.1f} tok/s over "
        f"{mean_new:.2f} new tokens would say "
        f"{served['tok_s'] / mean_new:.3f}), TTFT "
        f"target {real.ttft_s * 1e3:.1f} ms; {t_real:.1f} s wall; verdict "
        f"{art['verdict']}; goodput {art['soak.goodput_tok_s']:.1f} tok/s; "
        f"{sv['completed']} of {sv['n_requests']} completed, {sv['shed']} shed, "
        f"{sv['pages_leaked']} pages leaked; slopes {slopes}")
    if art["verdict"] != "healthy" or sv["pages_leaked"] or validate_soak_artifact(art):
        raise AssertionError(f"soak real: verdict {art['verdict']}, health "
                             f"{art['health']['findings']}")
    out["real"] = dict(rate_rps=rate, capacity_rps=capacity, wall_s=t_real,
                       verdict=art["verdict"],
                       goodput_tok_s=art["soak.goodput_tok_s"],
                       completed=sv["completed"], shed=sv["shed"],
                       n_requests=sv["n_requests"], **slopes)
    eng.rebind_obs()
    return out, launches


def run_fleet_path(torch, A, dev) -> tuple:
    """Part d: ``measure_fleet(seed=7)`` over three GPT-2 tiny f32 replicas
    sharing the card: all eight ``fleet.*`` values and the ``fleet_health``
    history equal ``FLEET_r20.json``'s, every gate passes, and the card's
    allocated memory is back at its level once the legs' restarts are
    done."""
    import numpy as np

    from distributed_llm_scheduler_tpu_torch.eval import serve_bench as SB
    from distributed_llm_scheduler_tpu_torch.ops import kernels
    from distributed_llm_scheduler_tpu_torch.serve import VirtualClock

    banked = json.loads((ROOT / "FLEET_r20.json").read_text())
    keys = sorted(k for k in banked if k.startswith("fleet."))
    engines = {rid: SB.build_serve_engine(clock=VirtualClock(), device=dev)[0]
               for rid in ("n0", "n1", "n2")}
    # each engine captures its segment graph once (its static buffers stay
    # allocated with the engine) before the memory baseline
    for eng in engines.values():
        eng.submit("warm", np.ones((1, 8), np.int32), 4)
        eng.run()
        eng.reset()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    art = SB.measure_fleet(seed=7, engines=engines, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    no_routes("fleet")
    counts = ran_counts((A.PAGED_KERNEL, A.PAGED_RAGGED_KERNEL, "layer_norm"))
    for eng in engines.values():
        eng.rebind_obs()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated(dev)
    off = {k: (art[k], banked[k]) for k in keys if art[k] != banked[k]}
    fails = SB.fleet_gate_failures(art) + SB.validate_fleet_artifact(art)
    same_health = art["fleet_health"] == banked["fleet_health"]
    log(f"  fleet (3 GPT-2 tiny f32 replicas on the card, one leaking) in "
        f"{secs:.1f} s: {len(keys) - len(off)} of {len(keys)} fleet.* values "
        f"equal FLEET_r20.json's, fleet_health equal {same_health}, gates "
        f"{'pass' if not fails else fails}; allocated {held} bytes before and "
        f"{after} after the restarts; launches {counts}")
    for k in keys:
        log(f"    {k} = {art[k]!r}")
    if (off or fails or not same_health or after != held
            or not counts[A.PAGED_KERNEL] or counts[A.PAGED_RAGGED_KERNEL]):
        raise AssertionError(f"fleet: off {off}, gates {fails}, health "
                             f"{same_health}, memory {held} -> {after}")
    return dict({k: art[k] for k in keys}, seconds=secs), {"fleet": counts}


def run_doctor_path(torch, P, A, dev, served) -> tuple:
    """Phase 16, parts a-d; returns (``DOCTOR_LINE``'s object, each leg's
    launch counts)."""
    out, launches = {}, {}
    log("  a. the flagship traced and memory-profiled")
    out["forward"], n = run_traced_forward(torch, P, dev)
    launches.update(n)
    torch.cuda.empty_cache()
    log("  b. phase 9's engine traced, with a flight recorder and waterfalls")
    out["serve"], n = run_traced_serving(torch, P, A, dev, served)
    launches.update(n)
    log("  c. the soak doctor")
    out["soak"], n = run_soak_path(torch, P, A, dev, served)
    launches.update(n)
    log("  d. the health-routed fleet")
    out["fleet"], n = run_fleet_path(torch, A, dev)
    launches.update(n)
    return out, launches


# searched placements on the card (phase 17): the bench's refine and search
# placements of the flagship beside its heft x8, each executed planned and
# compiled; then the pre-execution gate and analyze() on the card
SEARCHED = ("refine", "search", "heft")
GATE_TIMED = 20


def with_cycle(P, graph):
    """Copies of ``graph``'s tasks with its first task waiting on its last:
    a dependency cycle, left unfrozen (freezing it raises)."""
    import dataclasses

    order = graph.topo_order
    tasks = [dataclasses.replace(t, dependencies=list(t.dependencies))
             for t in graph.tasks()]
    next(t for t in tasks if t.task_id == order[0]).dependencies.append(
        order[-1])
    return P.TaskGraph(tasks, name=graph.name)


def edited(P, sched, **per_node):
    """``sched`` with node lists replaced or added (a corrupted copy)."""
    lists = {n: list(ts) for n, ts in sched.per_node.items()}
    lists.update(per_node)
    return P.Schedule(policy=sched.policy + "-edited", per_node=lists,
                      assignment_order=list(sched.assignment_order),
                      completed=set(sched.completed))


def run_searched_path(torch, P, A, N, dev, bench_result) -> tuple:
    """Part a: the bench's refine and search (budget 120, seed 0)
    placements of the flagship on 8 nodes, made from the card's saved
    calibration, beside its heft x8.  Each placement's eventsim makespan
    and replay (which must equal the bench's) under that calibration and
    the bench's link, then its measured makespan planned and compiled (one
    CUDA graph, a stream per node), launches counted as phase 7 counts
    them: the outputs meet the fused forward and compiled equals planned
    bit for bit.  Returns (SEARCH_LINE's object, launches per run, the
    state parts b and c reuse)."""
    from distributed_llm_scheduler_tpu_torch.eval import bench
    from distributed_llm_scheduler_tpu_torch.ops import kernels
    from distributed_llm_scheduler_tpu_torch.utils.costmodel import (
        calibration_path,
        load_cached,
    )
    from distributed_llm_scheduler_tpu_torch.utils.hbm import (
        preflight_task_memory,
    )

    cfg = P.GPT2Config.small(dtype=torch.bfloat16)
    dag = P.build_gpt2_dag(cfg, **FLAGSHIP)
    graph = P.fuse_linear_chains(dag.graph)
    params = dag.init_params(seed=0, device=dev)
    ids = dag.make_inputs(seed=1, device=dev)
    cm = load_cached(calibration_path(bench.CACHE_DIR, graph.name, "cuda"),
                     graph)
    if cm is None:
        raise AssertionError("searched: the bench saved no calibration")
    cm.apply(graph)
    # the replay charges a transfer by its producer's output size, which
    # the bench's pre-flight sets (a fused chain's activation footprint is
    # its widest member's); shapes alone give it: with the input on the
    # CPU the pre-flight propagates meta tensors and launches nothing
    preflight_task_memory(graph, params, ids.cpu())
    link = bench_result.link_model
    model = P.Cluster([P.DeviceState(f"core_{i}", bench_result.node_hbm_gb)
                       for i in range(bench.REPLAY_NODES)])
    speeds = {d.node_id: d.compute_speed for d in model}
    sim = P.SimulatedBackend(fidelity="full", link=link,
                             dispatch_s=cm.dispatch_s)
    cluster = P.Cluster.from_torch_devices([dev] * bench.REPLAY_NODES)
    backend = P.DeviceBackend(cluster)
    mb = FLAGSHIP["microbatches"]
    per_forward = {A.KERNEL: mb * cfg.n_layer,
                   N.LN_KERNEL: mb * (2 * cfg.n_layer + 1)}
    fused = dag.reference_forward(params, ids).cpu()
    filters = static_filters_on("searched placements", bench_result)
    out, launches = {}, {}
    for name in SEARCHED:
        sched = bench_result.schedules[name]
        digest = P.placement_digest(sched.placement)
        if digest != bench_result.placement_digests[name]:
            raise AssertionError(f"searched {name}: digest {digest}")
        _order, ev, _nf = P.simulate_placement(
            graph, sched.placement, speeds, link, model.slice_ids())
        replay = sim.execute(graph, model, sched, dag_type="gpt2_small")
        if replay.makespan != bench_result.policies[name][0]:
            raise AssertionError(
                f"searched {name}: replay {replay.makespan} != the bench's "
                f"{bench_result.policies[name][0]}")
        row = dict(eventsim_ms=ev * 1e3, replay_ms=replay.makespan * 1e3,
                   nodes_used=sum(1 for ts in sched.per_node.values() if ts),
                   sched_s=bench_result.policy_sched_s[name],
                   digest=digest, static_filter=filters.get(name))
        outs = {}
        for rung, kw in (("planned", {}), ("compiled", dict(compiled=True))):
            label = f"{name} x8 {rung}"
            # an earlier policy whose placement lowers to the same program
            # (refine and search can converge) left it captured: the run
            # replays it, with no warm-up or capture launch of its own
            n_progs = len(backend._prog_cache.get(graph, {}))
            kernels.reset_launches()
            rep = backend.execute(graph, sched, params, ids, reps=REPS, **kw)
            torch.cuda.synchronize()
            no_routes(label)
            eager = {k: kernels.launches[k] for k in per_forward}
            replayed = {k: kernels.replayed.get(k, 0) for k in per_forward}
            outs[rung] = rep.output.cpu()
            if kw:
                captured = {k: rep.captured_launches.get(k, 0)
                            for k in per_forward}
                reused = len(backend._prog_cache.get(graph, {})) == n_progs
                row["program_reused"] = reused
                if (captured != per_forward
                        or eager != times(captured, 0 if reused else 2)
                        or replayed != times(captured, 1 + REPS)):
                    raise AssertionError(
                        f"{label}: captured {captured}, eager {eager}, "
                        f"replayed {replayed}, program reused {reused}")
                launches[label] = replayed
            else:
                if eager != times(per_forward, 1 + REPS):
                    raise AssertionError(f"{label}: launches {eager}")
                launches[label] = eager
            ok, viol, allowed, rel = oracle_close(fused, outs[rung])
            finite = bool(torch.isfinite(outs[rung]).all())
            if not (ok and finite):
                raise AssertionError(f"{label}: oracle {ok} ({viol} outside "
                                     f"the band), finite {finite}")
            row[f"{rung}_ms"] = rep.makespan_s * 1e3
            row[f"{rung}_rel_fro"] = rel
            del rep
        row["bit_equal"] = torch.equal(outs["planned"], outs["compiled"])
        if not row["bit_equal"]:
            raise AssertionError(f"searched {name}: compiled != planned")
        out[name] = row
        log(f"  {name} x8 ({row['nodes_used']} nodes used, scheduled in "
            f"{row['sched_s']:.3f} s): eventsim {row['eventsim_ms']:.4f} ms, "
            f"replayed {row['replay_ms']:.4f} ms, measured planned "
            f"{row['planned_ms']:.3f} ms and compiled {row['compiled_ms']:.3f} "
            f"ms (mean of {REPS}), per forward {per_forward[A.KERNEL]} flash "
            f"and {per_forward[N.LN_KERNEL]} layer_norm launches, compiled "
            f"bit-equal to planned, rel Frobenius {row['planned_rel_fro']:.3e} "
            f"vs fused")
    for name in ("refine", "search"):
        gain = {k: out["heft"][k] / out[name][k] for k in (
            "eventsim_ms", "replay_ms", "planned_ms", "compiled_ms")}
        out[name]["vs_heft"] = gain
        log(f"  {name} vs heft x8 (heft / {name}): " + ", ".join(
            f"{k[:-3]} {v:.4f}" for k, v in gain.items()))
    state = dict(graph=graph, dag=dag, cluster=cluster, backend=backend,
                 params=params, ids=ids, model=model,
                 schedules=bench_result.schedules, planned=outs["planned"])
    return out, launches, state


def refused(label: str, run) -> str:
    """``run()`` must raise ``AnalysisError``; returns its codes."""
    from distributed_llm_scheduler_tpu_torch.analysis import AnalysisError

    try:
        run()
    except AnalysisError as e:
        return ",".join(sorted({d.code for d in e.report.errors}))
    raise AssertionError(f"gate: {label} was not refused")


def run_gate_path(torch, P, dev, st) -> dict:
    """Part b: a schedule with a task placed on two nodes and a graph with
    a cycle, each refused with ``AnalysisError`` by ``execute`` (planned
    and compiled), ``CompiledSchedule.build`` and ``paged_decode_engine``
    with every launch count still 0; ``DLS_SKIP_ANALYSIS=1`` turns the gate
    off (an unknown, empty node list, refused with the gate on, then runs
    bit-equal to the clean placement); the gate's host time on the
    flagship."""
    import os

    from distributed_llm_scheduler_tpu_torch import analysis as PA
    from distributed_llm_scheduler_tpu_torch.backends.compiled_schedule import (
        CompiledSchedule,
    )
    from distributed_llm_scheduler_tpu_torch.models.kv_pages import PagePool
    from distributed_llm_scheduler_tpu_torch.ops import kernels

    graph, cluster, backend = st["graph"], st["cluster"], st["backend"]
    params, ids = st["params"], st["ids"]
    sched = st["schedules"]["refine"]
    first = sched.assignment_order[0]
    home = sched.placement[first]
    other = next(n for n in sched.per_node if n != home)
    twice = edited(P, sched, **{other: [first] + sched.per_node[other]})
    cyclic = with_cycle(P, graph)
    cfg = P.GPT2Config.small(dtype=torch.bfloat16)
    paged = P.build_paged_decode_dag(cfg, **SERVE_GEOM)
    two = P.Cluster.from_torch_devices([dev] * 2)
    p_sched = P.get_scheduler("greedy").schedule(paged.graph, two)
    p_home = next(n for n, ts in p_sched.per_node.items() if ts)
    p_other = next(n for n in ("core_0", "core_1") if n != p_home)
    p_twice = edited(P, p_sched, **{p_other: [p_sched.per_node[p_home][0]]})
    pool = PagePool(SERVE_GEOM["n_pages"])
    engine = dict(slots=SERVE_GEOM["slots"],
                  pages_per_seq=SERVE_GEOM["pages_per_seq"])
    cases = {}
    kernels.reset_launches()
    for defect, (g, s, pg, ps) in {
        "task on two nodes": (graph, twice, paged.graph, p_twice),
        "graph with a cycle": (cyclic, sched, with_cycle(P, paged.graph),
                               p_sched),
    }.items():
        cases[defect] = {
            "execute planned": refused(defect, lambda: backend.execute(
                g, s, params, ids)),
            "execute compiled": refused(defect, lambda: backend.execute(
                g, s, params, ids, compiled=True)),
            "CompiledSchedule.build": refused(
                defect, lambda: CompiledSchedule.build(backend, g, s, {}, ids)),
            "paged_decode_engine": refused(
                defect, lambda: P.DeviceBackend(two).paged_decode_engine(
                    pg, ps, cfg, {}, pool, **engine)),
        }
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launches.items() if v}
    counts.update({f"replayed {k}": v for k, v in kernels.replayed.items() if v})
    log(f"  refused, with every launch count 0 after ({counts or 'none'}): "
        + "; ".join(f"{d}: " + ", ".join(f"{e} {c}" for e, c in r.items())
                    for d, r in cases.items()))
    if counts:
        raise AssertionError(f"gate: refused runs launched {counts}")
    bogus = edited(P, sched, bogus=[])
    cases["unknown node, gate on"] = refused("unknown node", lambda:
                                             backend.execute(graph, bogus,
                                                             params, ids))
    os.environ[PA.SKIP_ENV] = "1"
    try:
        off = backend.execute(graph, bogus, params, ids).output.cpu()
    finally:
        del os.environ[PA.SKIP_ENV]
    skip_ok = torch.equal(off, st["planned"])
    log(f"  {PA.SKIP_ENV}=1: the unknown-node schedule the gate refuses "
        f"({cases['unknown node, gate on']}) runs, bit-equal to the clean "
        f"placement {skip_ok}")
    if not skip_ok:
        raise AssertionError("gate: the skipped run's output differs")
    gate_ms, analyze_ms = [], []
    for _ in range(GATE_TIMED):
        t0 = time.perf_counter()
        PA.pre_execution_gate(graph, cluster, sched, backend="device")
        gate_ms.append((time.perf_counter() - t0) * 1e3)
    for _ in range(3):
        t0 = time.perf_counter()
        PA.analyze(graph, cluster, sched)
        analyze_ms.append((time.perf_counter() - t0) * 1e3)
    host = dict(gate_ms=statistics.median(gate_ms),
                gate_min_ms=min(gate_ms),
                analyze_ms=statistics.median(analyze_ms))
    log(f"  gate host time on the {len(graph)}-task flagship: median "
        f"{host['gate_ms']:.3f} ms (min {host['gate_min_ms']:.3f}) over "
        f"{GATE_TIMED} calls; analyze() {host['analyze_ms']:.3f} ms")
    return dict(refusals=cases, skip_bit_equal=skip_ok, **host)


def run_analyze_path(torch, P, st) -> dict:
    """Part c: ``analyze()`` over heft x8's flagship schedule on the card's
    8 nodes, the bf16 params and the input as meta tensors: diagnostic for
    diagnostic the call over the same schedule on 8 CPU nodes of the same
    budgets, every task's output typechecked, and no kernel launched."""
    from distributed_llm_scheduler_tpu_torch import analysis as PA
    from distributed_llm_scheduler_tpu_torch.analysis import typecheck_pass
    from distributed_llm_scheduler_tpu_torch.ops import kernels

    graph, dag, cluster = st["graph"], st["dag"], st["cluster"]
    sched = st["schedules"]["heft"]
    cpu = torch.device("cpu")
    on_cpu = P.Cluster([P.DeviceState(d.node_id, d.total_memory,
                                      torch_device=cpu) for d in cluster])
    kw = dict(params=dag.param_specs, graph_input=dag.input_spec)
    kernels.reset_launches()
    t0 = time.perf_counter()
    card = PA.analyze(graph, cluster, sched, **kw)
    secs = time.perf_counter() - t0
    host = PA.analyze(graph, on_cpu, sched, **kw)
    avals, _ = typecheck_pass.propagate_schedule_avals(graph, **kw)
    torch.cuda.synchronize()
    launched = {k: v for k, v in kernels.launches.items() if v}

    def fields(rep):
        return [(d.code, int(d.severity), d.task, d.node, d.param, d.message)
                for d in rep.diagnostics]

    same = fields(card) == fields(host)
    typed = sum(1 for v in avals.values() if v is not None)
    codes = {}
    for d in card.diagnostics:
        codes[d.code] = codes.get(d.code, 0) + 1
    log(f"  analyze() over heft x8 with meta bf16 params in {secs:.2f} s: "
        f"{len(card.diagnostics)} diagnostics {codes}, exit code "
        f"{card.exit_code}; equal to the CPU call {same}; {typed} of "
        f"{len(graph)} task outputs typechecked; launches {launched or 0}")
    if not same or typed != len(graph) or launched or card.has("TYP001"):
        raise AssertionError(f"analyze: equal {same}, typed {typed}, "
                             f"launched {launched}")
    return dict(seconds=secs, diagnostics=codes, exit_code=card.exit_code,
                equal_to_cpu=same, typed=typed)


def run_search_phase(torch, P, A, N, dev, bench_result) -> tuple:
    """Phase 17, parts a-c; returns (``SEARCH_LINE``'s object, each run's
    launch counts)."""
    log("  a. the bench's refine and search placements executed beside heft")
    placed, launches, st = run_searched_path(torch, P, A, N, dev, bench_result)
    log("  b. the pre-execution gate on the card")
    gate = run_gate_path(torch, P, dev, st)
    log("  c. analyze() over heft x8 with meta params")
    analyzed = run_analyze_path(torch, P, st)
    return dict(placements=placed, gate=gate, analyze=analyzed), launches


# the two BASELINE.json configurations of phase 18.  a: config #5, the
# GPT-2 small f32 training step (43 tasks) through the train bench, then
# placed on TRAIN_NODES nodes of the card at TRAIN_PRESSURE x the step's
# footprint on one node (the bench's budget), planned and compiled.  b:
# config #4, Mixtral-8x7B at full width, its depth cut from 32 to
# MOE_LAYERS layers (11.3 GiB of bf16 params: 8 nodes at 0.3x them each,
# plus the activations and the fused oracle's, fit one card's 80 GB), on
# MOE_NODES nodes at MOE_NODE_FRAC x the params each, dense and routed
TRAIN_BUILD = dict(batch=8, seq_len=512)
TRAIN_TASKS = 43
TRAIN_NODES = 4
TRAIN_PRESSURE = 0.55
TRAIN_POLICIES = ("mru", "heft")
# a placed step against the single-node step: tests/test_train_dag.py's
STEP_LOSS_RTOL, STEP_RTOL, STEP_ATOL = 1e-5, 2e-4, 2e-5
MOE_LAYERS = 4
MOE_BUILD = dict(batch=2, seq_len=512)
MOE_TASKS = 63
MOE_NODES = 8
MOE_NODE_FRAC = 0.3
MOE_CAPACITY = 2.0
MOE_POLICIES = ("mru", "greedy", "heft")


def counted_compiled(label: str, per_run: dict, run) -> tuple:
    """A compiled run (``execute(compiled=True, reps=REPS)``) counted: its
    wrappers count in the warm-up and the capture (2x ``per_run``), its
    graph must hold ``per_run``, and its replays (the first run and REPS
    more) launch ``per_run`` each, counted at each replay.  Returns (the
    report, the replays' launches)."""
    from distributed_llm_scheduler_tpu_torch.ops import kernels

    rep, _ = counted(label, times(per_run, 2), run)
    if {k: rep.captured_launches.get(k, 0) for k in per_run} != per_run:
        raise AssertionError(f"{label}: captured {rep.captured_launches}")
    replayed = {k: kernels.replayed.get(k, 0) for k in per_run}
    if replayed != times(per_run, 1 + REPS):
        raise AssertionError(f"{label}: replays launched {replayed}")
    return rep, replayed


def train_launches(L: int) -> tuple:
    """(per step, per fused oracle step) launches of the training step of
    an L-layer GPT-2: each ``layer_{i}_fwd`` runs one flash and two
    LayerNorms, each rematerializing ``layer_{i}_bwd`` the same again,
    ``head_bwd`` the final LayerNorm (the backwards recompute through the
    plain versions and launch nothing); the fused oracle's forward runs
    each once."""
    per_step = {"flash_attention": 2 * L, "layer_norm": 4 * L + 1,
                "layer_norm.register": 4 * L + 1}
    per_ref = {"flash_attention": L, "layer_norm": 2 * L + 1,
               "layer_norm.register": 2 * L + 1}
    return per_step, per_ref


def step_numbers(got, want) -> dict:
    """A placed step against the single-node one: within the tolerances
    or not, and what is bit-equal (the loss, and how many params)."""
    import torch

    from distributed_llm_scheduler_tpu_torch.eval.train_bench import step_matches

    equal = sum(bool(torch.equal(got["params"][k], w))
                for k, w in want["params"].items())
    worst = max(float((got["params"][k] - w).abs().max())
                for k, w in want["params"].items())
    return dict(ok=step_matches(got, want, STEP_LOSS_RTOL, STEP_RTOL, STEP_ATOL),
                loss_bit_equal=bool(torch.equal(got["loss"], want["loss"])),
                params_bit_equal=equal, params=len(want["params"]),
                max_abs_param_diff=worst)


def cloned(out):
    """A step output copied out of a captured program's own tensors."""
    return {"loss": out["loss"].clone(),
            "params": {k: v.clone() for k, v in out["params"].items()}}


def device_time_of(prof, names) -> float:
    """Device ms under the autograd nodes whose key contains one of
    ``names`` (their evaluate_function events, each node's kernels
    counted once)."""
    total = 0.0
    for e in prof.key_averages():
        if e.key.startswith("autograd::engine::evaluate_function: ") and any(
                n in e.key for n in names):
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0.0)
            total += us
    return total / 1e3


def step_trace(torch, run) -> dict:
    """One step under torch.profiler: the kernels' device ms in all, the
    norm backward's (the ``_NormFunction`` nodes' recompute) and the flash
    backward's, each with its share; None where the trace shows no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernel_ms = sum(
        getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ) / 1e3
    if kernel_ms <= 0:
        log("  step trace: no device time in the trace (not measured)")
        return dict(kernel_ms=None, norm_backward_ms=None,
                    norm_backward_share=None)
    norm_ms = device_time_of(prof, ("_NormFunctionBackward",))
    flash_ms = device_time_of(prof, ("_FlashAttentionBackward",))
    out = dict(kernel_ms=kernel_ms, norm_backward_ms=norm_ms,
               norm_backward_share=norm_ms / kernel_ms,
               flash_backward_ms=flash_ms,
               flash_backward_share=flash_ms / kernel_ms)
    log(f"  step trace: kernels {kernel_ms:.3f} ms of device time per step; "
        f"the norm backward's recompute {norm_ms:.3f} ms "
        f"({out['norm_backward_share']:.4f}), the flash backward's "
        f"{flash_ms:.3f} ms ({out['flash_backward_share']:.4f})")
    return out


def time_train_kernels(torch, A, N, dev) -> dict:
    """The two kernels at the training step's shapes (f32): flash at
    (8, 12, 512, 64) and LayerNorm at (8, 512, 768), each against its plain
    version with its time, bound and library call; and the norm
    backward (recompute through the plain version) against autograd of
    ``F.layer_norm``, issued back to back between CUDA events."""
    import numpy as np
    import torch.nn.functional as F

    rng = np.random.default_rng(18)
    B, T = TRAIN_BUILD["batch"], TRAIN_BUILD["seq_len"]
    shape = (B, 12, T, 64)
    q, k, v = attention_inputs(torch, rng, dev, shape, "float32", "heads", None)
    got = A.flash_attention(q, k, v, causal=True)
    err = (got - A.reference_mha(q, k, v, causal=True)).abs().max().item()
    if not err < KERNEL_TOL["float32"]:
        raise AssertionError(f"flash at the training shape: {err}")
    ms, ms_b2b = time_attention(
        torch, lambda *a: A.flash_attention(*a, causal=True), (q, k, v), 50)
    bound_ms, bound_by = attention_bound_ms(shape, "float32", True)
    flash = dict(
        shape=list(shape), dtype="float32", max_abs_err=err, ms=ms,
        ms_back_to_back=ms_b2b,
        plain_ms=graph_ms(torch, lambda *a: A.reference_mha(*a, causal=True),
                          [(q, k, v)] * 5),
        library_ms=time_attention(torch, lambda *a: F.scaled_dot_product_attention(
            *a, is_causal=True), (q, k, v), 50)[0],
        bound_ms=bound_ms, bound_by=bound_by)
    x, g, b = norm_inputs(torch, rng, dev, (B, T, 768), "float32")
    err = (N.layer_norm_kernel(x, g, b) - N.reference_layer_norm(x, g, b)
           ).abs().max().item()
    if not err < KERNEL_TOL["float32"]:
        raise AssertionError(f"LayerNorm at the training shape: {err}")
    ln = dict(time_norm(torch, N, "ln", (x, g, b), rng, dev), dtype="float32",
              max_abs_err=err)
    dy = torch.randn_like(x)

    def library_backward():
        xs = [t.detach().requires_grad_() for t in (x, g, b)]
        out = F.layer_norm(xs[0], (768,), xs[1], xs[2], 1e-5)
        return torch.autograd.grad(out, xs, dy)

    ln["backward_ms"] = cuda_ms(
        lambda: N.norm_backward(N.LN_KERNEL, x, (g, b), dy), 20)
    ln["backward_library_ms"] = cuda_ms(library_backward, 20)
    log(f"  flash {shape} f32: kernel {flash['ms']:.5f} ms, plain "
        f"{flash['plain_ms']:.5f}, SDPA {flash['library_ms']:.5f}, bound "
        f"{bound_ms:.5f} ms ({bound_by}); LayerNorm {(B, T, 768)} f32: "
        f"kernel {ln['ms']:.5f} ms, plain {ln['plain_ms']:.5f}, F.layer_norm "
        f"{ln['library_ms']:.5f}, bound {ln['bound_ms']:.5f} ms; its backward "
        f"by recompute {ln['backward_ms']:.5f} ms against autograd of "
        f"F.layer_norm {ln['backward_library_ms']:.5f} ms (back to back)")
    return dict(flash=flash, layer_norm=ln)


def run_train_path(torch, P, A, N, dev, cfg=None) -> tuple:
    """Phase 18 a: the training step through ``measure_train_dag``, run as
    the train leg of ``eval/capture_artifacts`` (its record, launches
    counted over the whole leg; phase 25 b reads the same run), then on
    one node and placed by ``mru`` and ``heft`` on TRAIN_NODES nodes of
    the card, planned
    (per step, counted) and compiled (warm-up and capture counted, the
    replays' launches counted at each replay), each against the
    single-node step.  Returns (TRAIN_LINE's dict, counted launches)."""
    from distributed_llm_scheduler_tpu_torch.utils.hbm import preflight_task_memory

    cfg = cfg or P.GPT2Config.small()
    per_step, _ = train_launches(cfg.n_layer)
    launches = {}
    t0 = time.perf_counter()
    bench, launches["train bench"] = capture_train_leg(torch, P)
    bench_s = time.perf_counter() - t0
    print("TRAIN_BENCH_LINE " + json.dumps(bench), flush=True)
    log(f"  train bench in {bench_s:.1f} s: executed step "
        f"{bench['executed_step_ms']} ms, best {bench['best_policy']} "
        f"{bench['best_makespan_ms']} ms, vs_roundrobin {bench['vs_roundrobin']}")

    dag = P.build_gpt2_train_dag(cfg, **TRAIN_BUILD)
    graph = dag.graph
    if cfg == P.GPT2Config.small() and len(graph) != TRAIN_TASKS:
        raise AssertionError(f"train DAG has {len(graph)} tasks")
    params = dag.init_params(seed=0, device=dev)
    inputs = dag.make_inputs(device=dev)
    one = P.Cluster.from_torch_devices([dev])
    sched_one = P.get_scheduler("greedy").schedule(graph, one)
    be1 = P.DeviceBackend(one)
    step_ms = {}
    rep1, launches["greedy x1"] = counted(
        "greedy x1", times(per_step, 1 + REPS),
        lambda: be1.execute(graph, sched_one, params, inputs, reps=REPS))
    want = rep1.output
    step_ms["greedy x1 planned"] = rep1.makespan_s * 1e3
    held = rep1.held_hbm_bytes.get(str(dev), 0)
    alloc_peak_gb = (rep1.peak_hbm_bytes.get(str(dev), 0) - held) / 1024**3
    trace = step_trace(torch, lambda: be1.execute(
        graph, sched_one, params, inputs, warmup=False))
    v1 = P.validate_schedule(graph, one, sched_one)
    budget = max(v1.peak_no_evict_gb.values()) * TRAIN_PRESSURE
    cluster = P.Cluster.from_torch_devices([dev] * TRAIN_NODES, hbm_cap_gb=budget)
    log(f"  single-node step {step_ms['greedy x1 planned']:.3f} ms; "
        f"{TRAIN_NODES} nodes of {budget:.4f} GB ({TRAIN_PRESSURE} x the "
        f"step's {max(v1.peak_no_evict_gb.values()):.4f} GB on one node)")
    placed = {}
    for pol in TRAIN_POLICIES:
        s = P.get_scheduler(pol).schedule(graph, cluster)
        used = sum(1 for lst in s.per_node.values() if lst)
        if s.failed or used < 2:
            raise AssertionError(f"train {pol}: failed {sorted(s.failed)[:3]}, "
                                 f"{used} node(s)")
        be = P.DeviceBackend(cluster)
        label = f"{pol} x{TRAIN_NODES}"
        rep, launches[label] = counted(
            label, times(per_step, 1 + REPS),
            lambda: be.execute(graph, s, params, inputs, reps=REPS))
        if rep.transfer_edges <= 0:
            raise AssertionError(f"{label}: the step did not spread")
        nums = step_numbers(rep.output, want)
        step_ms[f"{label} planned"] = rep.makespan_s * 1e3
        label_c = f"{label} compiled"
        rep_c, launches[label_c] = counted_compiled(
            label_c, per_step, lambda: be.execute(
                graph, s, params, inputs, compiled=True, reps=REPS))
        nums_c = step_numbers(cloned(rep_c.output), want)
        step_ms[label_c] = rep_c.makespan_s * 1e3
        placed[pol] = dict(nodes=used, transfer_edges=rep.transfer_edges,
                           planned=nums, compiled=nums_c,
                           compiled_exchanges=rep_c.transfer_edges)
        log(f"  {label}: {used} nodes, {rep.transfer_edges} transfer edges; "
            f"planned {step_ms[label + ' planned']:.3f} ms, compiled "
            f"{step_ms[label_c]:.3f} ms; vs the single-node step: planned "
            f"{nums}, compiled {nums_c}")
        if not (nums["ok"] and nums_c["ok"]):
            raise AssertionError(f"{label}: step off the single-node step")
        del be, rep, rep_c
    fp = preflight_task_memory(graph, params, inputs)
    vpf = P.validate_schedule(graph, one, sched_one)
    # the card's footprints (the CPU has no allocator peak: none)
    pre = dict(max_task_gb=max(fp.values(), default=None),
               modeled_peak_gb=max(vpf.peak_no_evict_gb.values()))
    log(f"  allocator peak of the single-node step {alloc_peak_gb:.4f} GiB "
        f"beyond what was held; pre-flight: largest task {pre['max_task_gb']} "
        f"GiB, modeled no-evict peak {pre['modeled_peak_gb']:.4f} GiB")
    line = dict(bench=bench, bench_seconds=bench_s, step_ms=step_ms,
                launches_per_step=per_step, placed=placed,
                allocator_peak_gb=alloc_peak_gb, preflight=pre, trace=trace,
                kernels=time_train_kernels(torch, A, N, dev))
    return line, launches


def fused_routing(torch, mixtral, params, ids, cfg, routed: bool) -> list:
    """The fused forward's top-k expert set of every token in every layer
    (sorted ids, (N, top_k) per layer), from its own ffn_norm outputs."""
    from distributed_llm_scheduler_tpu_torch.models import llama

    keys = mixtral._layer_keys(cfg)
    sets = []
    with torch.no_grad():
        x = llama.embedding(ids, params["tok_emb"])
        for i in range(cfg.n_layers):
            bp = {k: params[f"l{i}_{k}"] for k in keys}
            h = mixtral.rms_norm(x, bp["attn_norm_g"], cfg.rms_eps)
            x = x + mixtral.gqa_attention(
                h, bp["wq"], bp["wk"], bp["wv"], bp["wo"], cfg.n_heads,
                cfg.n_kv_heads, cfg.rope_theta)
            h = mixtral.rms_norm(x, bp["ffn_norm_g"], cfg.rms_eps)
            logits = (h.reshape(-1, cfg.d_model) @ bp["router"]).float()
            sets.append(mixtral.topk_stable(logits, cfg.top_k)[1].sort(-1).values)
            x = x + (mixtral.moe_routed(bp, h, cfg, MOE_CAPACITY) if routed
                     else mixtral._moe(bp, h, cfg))
    return sets


def dag_routing(torch, outputs, cfg, routed: bool) -> tuple:
    """(per-layer sorted top-k expert sets, dropped slots) from the router
    tasks' outputs of one DAG run."""
    sets, dropped = [], 0
    for i in range(cfg.n_layers):
        r = outputs[f"layer_{i}_router"]
        if routed:
            sets.append(r["flat_e"].long().reshape(-1, cfg.top_k).sort(-1).values)
            dropped += int((~r["keep"]).sum())
        else:
            w = r.reshape(-1, cfg.n_experts).float()
            sets.append(w.topk(cfg.top_k, dim=-1).indices.sort(-1).values)
    return sets, dropped


def time_moe_kernels(torch, A, N, dev, cfg) -> dict:
    """Flash through ``gqa_mha`` and RMSNorm at the Mixtral tasks' shapes
    (bf16), against their plain versions, with times, bounds and library
    calls."""
    import numpy as np
    import torch.nn.functional as F

    rng = np.random.default_rng(19)
    B, T = MOE_BUILD["batch"], MOE_BUILD["seq_len"]
    shape = (B, cfg.n_heads, T, cfg.head_dim)
    q, k, v = attention_inputs(torch, rng, dev, shape, "bfloat16", "gqa",
                               cfg.n_kv_heads)
    group = cfg.n_heads // cfg.n_kv_heads
    kr, vr = k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)
    got = A.gqa_mha(q, k, v, causal=True)
    err = (got.float() - A.reference_mha(q, kr, vr, causal=True).float()
           ).abs().max().item()
    if not err < KERNEL_TOL["bfloat16"]:
        raise AssertionError(f"flash at the Mixtral shape: {err}")
    ms, ms_b2b = time_attention(torch, A.gqa_mha, (q, k, v), 100)
    bound_ms, bound_by = attention_bound_ms(shape, "bfloat16", True,
                                            cfg.n_kv_heads)
    flash = dict(
        shape=list(shape), kv_heads=cfg.n_kv_heads, dtype="bfloat16",
        max_abs_err=err, ms=ms, ms_back_to_back=ms_b2b,
        plain_ms=graph_ms(torch, A.reference_mha, [(q, kr, vr)] * 10),
        library_ms=time_attention(torch, lambda *a: F.scaled_dot_product_attention(
            *a, is_causal=True, enable_gqa=True), (q, k, v), 100)[0],
        bound_ms=bound_ms, bound_by=bound_by)
    x, g, _ = norm_inputs(torch, rng, dev, (B, T, cfg.d_model), "bfloat16")
    err = (N.rms_norm_kernel(x, g).float() - N.reference_rms_norm(x, g).float()
           ).abs().max().item()
    if not err < KERNEL_TOL["bfloat16"]:
        raise AssertionError(f"RMSNorm at the Mixtral shape: {err}")
    rms = dict(time_norm(torch, N, "rms", (x, g), rng, dev), dtype="bfloat16",
               max_abs_err=err)
    log(f"  gqa_mha {shape} bf16, {cfg.n_kv_heads} KV heads: kernel "
        f"{ms:.5f} ms, plain {flash['plain_ms']:.5f}, SDPA "
        f"{flash['library_ms']:.5f}, bound {bound_ms:.5f} ms ({bound_by}); "
        f"RMSNorm {(B, T, cfg.d_model)} bf16: kernel {rms['ms']:.5f} ms, plain "
        f"{rms['plain_ms']:.5f}, F.rms_norm {rms['library_ms']:.5f}, bound "
        f"{rms['bound_ms']:.5f} ms")
    return dict(flash=flash, rms_norm=rms)


def run_moe_path(torch, P, A, N, dev, cfg=None) -> tuple:
    """Phase 18 b: the Mixtral DAG, dense and routed, placed by mru, greedy
    and heft on MOE_NODES nodes of the card at MOE_NODE_FRAC x the params
    each, planned (with every task's output kept: the routing) and
    compiled, against the fused forward; the tokens whose top-k sets
    differ from the fused path's are counted and must be 0.  Returns
    (MOE_LINE's dict, counted launches)."""
    from distributed_llm_scheduler_tpu_torch.models import mixtral

    cfg = cfg or P.MixtralConfig.mixtral_8x7b(n_layers=MOE_LAYERS,
                                              dtype=torch.bfloat16)
    L = cfg.n_layers
    per_forward = {"flash_attention": L, "rms_norm": 2 * L + 1,
                   "rms_norm.register": 2 * L + 1}
    t0 = time.perf_counter()
    params = mixtral.init_params_torch(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"  Mixtral-8x7B widths at {L} layers: {mixtral.num_params(cfg) / 1e9:.3f} "
        f"B params drawn on the card from torch seed 0 in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated(dev) / 1024**3:.3f} GiB allocated")
    launches, line = {}, dict(makespan_ms={}, peak_gib={}, dropped_slots={},
                              routing_differs={}, oracle={}, homes={})
    for routed in (False, True):
        mode = "routed" if routed else "dense"
        dag = P.build_moe_dag(cfg, routed=routed, capacity_factor=MOE_CAPACITY,
                              **MOE_BUILD)
        graph = dag.graph
        if cfg.d_model == 4096 and (len(graph) != MOE_TASKS or not graph.name
                                    .startswith(f"mixtral_{L}l_d4096_e8")):
            raise AssertionError(f"{graph.name}: {len(graph)} tasks")
        ids = dag.make_inputs(seed=1, device=dev)
        fused, launches[f"{mode} fused"] = counted(
            f"{mode} fused", per_forward,
            lambda: dag.reference_forward(params, ids))
        want_sets = fused_routing(torch, mixtral, params, ids, cfg, routed)
        cap = MOE_NODE_FRAC * graph.total_param_gb()
        cluster = P.Cluster.from_torch_devices([dev] * MOE_NODES, hbm_cap_gb=cap)
        for pol in MOE_POLICIES:
            s = P.get_scheduler(pol).schedule(graph, cluster)
            homes = {n for n, lst in s.per_node.items()
                     if any("_expert_" in t for t in lst)}
            if s.failed or len(homes) < 2:
                raise AssertionError(f"{mode} {pol}: failed "
                                     f"{sorted(s.failed)[:3]}, experts on {homes}")
            be = P.DeviceBackend(cluster)
            label = f"{mode} {pol} x{MOE_NODES}"
            rep, launches[label] = counted(
                label, times(per_forward, 2), lambda: be.execute(
                    graph, s, params, ids, keep_outputs=True))
            got_sets, dropped = dag_routing(torch, rep.task_outputs, cfg, routed)
            differ = sum(int((a != b).any(-1).sum())
                         for a, b in zip(got_sets, want_sets))
            results = {"planned": (rep, rep.output)}
            label_c = f"{label} compiled"
            rep_c, launches[label_c] = counted_compiled(
                label_c, per_forward, lambda: be.execute(
                    graph, s, params, ids, compiled=True, reps=REPS))
            results["compiled"] = (rep_c, rep_c.output)
            for rung, (r, out) in results.items():
                ok, viol, allowed, rel = oracle_close(fused, out)
                finite = bool(torch.isfinite(out).all())
                key = f"{label} {rung}"
                line["makespan_ms"][key] = r.makespan_s * 1e3
                line["peak_gib"][key] = (sum(r.peak_hbm_bytes.values())
                                         - sum(r.held_hbm_bytes.values())) / 1024**3
                line["oracle"][key] = dict(ok=ok and finite, violations=viol,
                                           rel_fro=rel)
                log(f"  {key}: makespan {r.makespan_s * 1e3:.3f} ms, "
                    f"{r.transfer_edges} transfer edges, peak "
                    f"{line['peak_gib'][key]:.3f} GiB beyond what was held; vs "
                    f"fused: {viol} outside the {BAND:g} band (allowed "
                    f"{allowed}), rel Frobenius {rel:.3e}, finite={finite}")
                if not (ok and finite):
                    raise AssertionError(f"{key}: output fails the oracle")
            line["dropped_slots"][label] = dropped
            line["routing_differs"][label] = differ
            line["homes"][label] = len(homes)
            log(f"  {label}: experts on {len(homes)} nodes, {differ} token "
                f"routings differ from the fused path's, {dropped} slots dropped")
            if differ:
                raise AssertionError(f"{label}: {differ} token routings differ")
            del be, rep, rep_c, results
        del fused, dag, graph
    line["launches_per_forward"] = per_forward
    line["kernels"] = time_moe_kernels(torch, A, N, dev, cfg)
    del params
    return line, launches


def run_baseline_configs(torch, P, A, N, dev) -> tuple:
    """Phase 18: a, then b; prints TRAIN_LINE and MOE_LINE."""
    t0 = time.perf_counter()
    log("  a. config #5: the GPT-2 small f32 training step")
    train, train_n = run_train_path(torch, P, A, N, dev)
    train["seconds"] = time.perf_counter() - t0
    print("TRAIN_LINE " + json.dumps(dict(train, bench=None)), flush=True)
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    log("  b. config #4: Mixtral-8x7B at full width, 4 layers, bf16")
    moe, moe_n = run_moe_path(torch, P, A, N, dev)
    moe["seconds"] = time.perf_counter() - t1
    print("MOE_LINE " + json.dumps(moe), flush=True)
    return train, train_n, moe, moe_n


# decoding (phase 19).  a: Llama-3 8B at full width and depth, bf16,
# through the decode bench's measure_decode at the JAX bench's defaults
# (batch 8, prompt 512, 64 new tokens), its step logits held against the
# fused forward at DECODE_CHECKS of the generated positions; b: the same
# with the int8 KV cache; c: the decode-step DAG through the scheduler
# (measure_decode_dag under heft on one node), one step under heft on 8
# nodes of the card, and the captured rungs at the cache state of step 3;
# d: Mixtral-8x7B widths at phase 18 b's 4-layer cut, generate against the
# decode DAG; e: GPT-2 small bf16 through the bench's other legs at their
# defaults (the paged legs' default is GPT-2 tiny f32)
DECODE = dict(batch=8, prompt_len=512, new_tokens=64)
DECODE_REPS = 3
DECODE_CHECKS = 8
# the bf16 step oracle's limit: the cached step's distance to the f32
# fused forward over at most this many times the bf16 fused forward's.
# On an H100 the 8 positions read 1.009-1.282 (1.282 the first step after
# the prefill, whose attention rounds its scores to bf16 as the
# reference's does); an f32 attention read 0.986-1.011
DECODE_BF16_K = 1.5
DECODE_RUNG_STEPS = 3
# leg c's K-step loop windows: 16 steps, where the JAX bench's 64 took
# ~40 s of the phase in the eager and int8-weight windows (81 and 78 ms a
# Llama-3 8B token; PR 23)
DECODE_LOOP_STEPS = 16
MOE_DECODE = dict(batch=2, prompt_len=512, new_tokens=16)
# the shapes the decode paths give the norm kernels that phase 5 does not
# time: a Llama-3 8B decode step's and prefill's RMSNorm, the GPT-2 small
# prefill's LayerNorm (its decode step's (8, 1, 768) is phase 5's)
DECODE_NORMS = (("rms", (8, 1, 4096)), ("rms", (8, 512, 4096)),
                ("ln", (8, 512, 768)))


def decode_calls(reps: int, new_tokens: int, lossy: bool = False,
                 eager_leg: bool = False) -> int:
    """forward_cached calls that run on the card in one measure_decode:
    generate(1) and generate(new_tokens), each warmed up once and run
    ``reps`` times (one call per generated token, a captured step's replay
    included), plus, for a lossy leg, the agreement's two generations, and
    with ``eager_leg`` the same eagerly at the bench's EAGER_REPS and
    EAGER_TOKENS and the two generations that compare the paths' tokens."""
    from distributed_llm_scheduler_tpu_torch.eval.decode_bench import (
        EAGER_REPS, EAGER_TOKENS,
    )

    one = (reps + 1) * (1 + new_tokens)
    et = min(EAGER_TOKENS, new_tokens)
    return (one + (2 * new_tokens if lossy else 0)
            + ((EAGER_REPS + 1) * (1 + et) + 2 * et if eager_leg else 0))


def decode_oracle(torch, llama, cfg, params, ids, new_tokens: int,
                  f32=None) -> dict:
    """Greedy generation through ``forward_cached``; at DECODE_CHECKS
    evenly spaced generated positions, the cached step's last-position
    logits against the fused ``forward`` over the sequence so far.  The
    fused forward is causal, so the sequence-so-far logits are the rows of
    one forward over every token the generation fed.

    Without ``f32`` (an f32 run) each check is the JAX package's
    ``oracle_close`` rule at the config's dtype.  With ``f32`` = (config,
    params), the same weights in f32, each check of this bf16 run is
    relative: the cached step's relative Frobenius distance to the f32
    fused forward over the same sequence may be at most DECODE_BF16_K
    times that of the bf16 fused forward.  A miss raises."""
    from distributed_llm_scheduler_tpu_torch.eval.benchlib import (
        oracle_close as bench_close,
    )

    dname = str(cfg.dtype).removeprefix("torch.")
    B, T = ids.shape
    at = sorted({round(i * (new_tokens - 1) / (DECODE_CHECKS - 1))
                 for i in range(DECODE_CHECKS)})
    cache = llama.init_cache(cfg, B, T + new_tokens, device=ids.device)
    seq, got = [ids], {}
    tok = None
    for step in range(new_tokens):
        pos = 0 if step == 0 else T + step - 1
        x = ids if step == 0 else tok[:, None]
        logits, cache = llama.forward_cached(params, x, cache, pos, cfg)
        if step in at:
            got[step] = logits[:, -1].clone()
        tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        if step < new_tokens - 1:
            seq.append(tok[:, None])
    del cache, logits
    rows = [T - 1 + step for step in got]
    seq = torch.cat(seq, dim=1)
    fused = llama.forward(params, seq, cfg)[:, rows].clone()
    ref = (None if f32 is None
           else llama.forward(f32[1], seq, f32[0])[:, rows].clone())
    checks = []
    for j, (step, g) in enumerate(got.items()):
        want = fused[:, j]
        _, viol, allowed, rel = oracle_close(want, g)
        c = dict(position=T + step,
                 max_abs=(want.float() - g.float()).abs().max().item(),
                 bf16_rule_violations=viol, allowed=allowed, rel_fro=rel)
        if ref is None:
            c["ok"] = bench_close(want, g, dname)
        else:
            c["rel_fro_cached_vs_f32"] = oracle_close(ref[:, j], g)[3]
            c["rel_fro_fused_vs_f32"] = oracle_close(ref[:, j], want)[3]
            c["ratio"] = c["rel_fro_cached_vs_f32"] / c["rel_fro_fused_vs_f32"]
            c["ok"] = c["ratio"] <= DECODE_BF16_K
        checks.append(c)
    del fused, ref
    out = dict(dtype=dname, positions=[c["position"] for c in checks],
               ok=all(c["ok"] for c in checks),
               worst_rel_fro=max(c["rel_fro"] for c in checks),
               worst_max_abs=max(c["max_abs"] for c in checks),
               checks=checks)
    if f32 is None:
        log(f"  {dname} oracle: {len(checks)} generated positions "
            f"{out['positions']} against the fused forward over the sequence "
            f"so far: {sum(c['ok'] for c in checks)} within the {dname} rule, "
            f"worst rel_fro {out['worst_rel_fro']:.3e}, worst max abs "
            f"{out['worst_max_abs']:.3e}")
    else:
        out["k"] = DECODE_BF16_K
        out["worst_ratio"] = max(c["ratio"] for c in checks)
        log(f"  {dname} oracle: {len(checks)} generated positions "
            f"{out['positions']}, each against the f32 fused forward over the "
            f"same sequence: the cached step at rel_fro "
            f"{[round(c['rel_fro_cached_vs_f32'], 5) for c in checks]}, the "
            f"{dname} fused forward at "
            f"{[round(c['rel_fro_fused_vs_f32'], 5) for c in checks]}; "
            f"ratios {[round(c['ratio'], 4) for c in checks]} (limit "
            f"{DECODE_BF16_K}); cached against the {dname} fused forward: "
            f"worst rel_fro {out['worst_rel_fro']:.3e}, worst max abs "
            f"{out['worst_max_abs']:.3e}")
    if not out["ok"]:
        raise AssertionError(f"{dname} decode steps miss the fused forward: "
                             f"{[c for c in checks if not c['ok']]}")
    return out


def log_decode(label: str, r: dict) -> None:
    roof = (f", bound {r['step_bound_ms']:.3f} ms/step "
            f"({r['bytes_per_step'] / 1e9:.3f} GB: params "
            f"{r['param_bytes'] / 1e9:.3f}, cache {r['kv_cache_bytes'] / 1e9:.3f}"
            f" at {r['hbm_gbps_assumed']:.0f} GB/s), bound_utilization "
            f"{r['bound_utilization']:.4f}" if "step_bound_ms" in r else "")
    log(f"  {label}: {r['decode_tok_s']:.1f} tok/s, "
        f"{r['ms_per_token_step']:.4f} ms per token step, wall "
        f"{r['wall_s']:.4f} s, prefill + one {r['prefill_plus_one_s']:.4f} s"
        f"{roof}")


def decode_step_rungs(torch, P, N, cfg, params, dev) -> dict:
    """The Llama-3 8B decode-step DAG at the bench's batch and prompt: a
    prefill on one node, then DECODE_RUNG_STEPS single-token steps per task
    under ``heft`` on one node, each folded into the cache slabs in place.
    At step 1 the same step runs per task under ``heft`` on 8 nodes of the
    card (logits bit-equal to one node's) and on the segmented and compiled
    rungs (each captured there); at step 3 those two replay, reading the
    slabs where they were captured, and their logits must equal the per-
    task step's: an update that made new tensors would leave them reading
    the state of step 1."""
    from distributed_llm_scheduler_tpu_torch.eval import decode_bench as DB
    from distributed_llm_scheduler_tpu_torch.ops import kernels

    B, T = DECODE["batch"], DECODE["prompt_len"]
    max_len = T + DECODE_RUNG_STEPS + 1
    per_fwd = 2 * cfg.n_layers + 1
    one = P.Cluster.from_torch_devices([dev])
    eight = P.Cluster.from_torch_devices([dev] * 8)
    be1, be8 = P.DeviceBackend(one), P.DeviceBackend(eight)
    pdag = P.build_decode_dag_any(cfg, batch=B, step_len=T, max_len=max_len)
    ddag = P.build_decode_dag_any(cfg, batch=B, step_len=1, max_len=max_len)
    heft = P.get_scheduler("heft")
    s1, s8 = heft.schedule(ddag.graph, one), heft.schedule(ddag.graph, eight)
    nodes8 = len(set(s8.placement.values()))
    params_c = pdag.derive_params(params)
    rep = be1.execute(pdag.graph, heft.schedule(pdag.graph, one), params_c,
                      P.decode_inputs(DB.prompt_ids(cfg, B, T, dev), 0),
                      keep_outputs=True, planned=False)
    P.apply_cache_updates(params_c, rep.task_outputs, cfg, 0)
    tok = torch.argmax(rep.output[:, -1, :], dim=-1).to(torch.int32)[:, None]
    del rep
    out = dict(nodes_heft_x8=nodes8)
    rms = {N.RMS_KERNEL: per_fwd, f"{N.RMS_KERNEL}.register": per_fwd}
    launches = {}

    def programs():  # captured programs the backend holds for the step
        return (sum(map(len, be1._seg_cache.values()))
                + sum(map(len, be1._prog_cache.values())))

    for step in range(1, DECODE_RUNG_STEPS + 1):
        pos = T + step - 1
        inp = P.decode_inputs(tok, pos, max_len=max_len)
        pt, _ = counted(f"decode step {step} per task (heft x1)", rms,
                        lambda: be1.execute(ddag.graph, s1, params_c, inp,
                                            keep_outputs=True, planned=False,
                                            warmup=False))
        if step == 1:
            x8, launches["decode step heft x8"] = counted(
                "decode step per task (heft x8)", rms,
                lambda: be8.execute(ddag.graph, s8, params_c, inp,
                                    planned=False, warmup=False))
            out["heft_x8_bit_equal"] = bool(torch.equal(x8.output, pt.output))
            out["heft_x8_ms"] = x8.makespan_s * 1e3
            if not out["heft_x8_bit_equal"]:
                d = (x8.output.float() - pt.output.float()).abs().max().item()
                raise AssertionError(
                    f"decode step on {nodes8} nodes differs from one node's "
                    f"(max abs {d:.3e})")
            del x8
        if step in (1, DECODE_RUNG_STEPS):
            for rung in ("segments", "compiled"):
                kernels.reset_launches()
                # captured at step 1 (its warm-up), replayed once after
                got = be1.execute(ddag.graph, s1, params_c, inp,
                                  warmup=step == 1,
                                  **{rung: True}).output.clone()
                no_routes(f"decode step {step} {rung}")
                replayed = kernels.replayed.get(N.RMS_KERNEL, 0)
                if step == 1:
                    captured = programs()
                else:
                    eager = kernels.launches.get(N.RMS_KERNEL, 0)
                    launches[f"decode step {rung} replay"] = {
                        N.RMS_KERNEL: replayed}
                    # a replay of the step-1 capture: nothing launched
                    # eagerly and no new program, which a params dict
                    # holding new slab tensors would have made
                    if replayed != per_fwd or eager or programs() != captured:
                        raise AssertionError(
                            f"{rung} at step {step}: replayed {replayed} "
                            f"RMSNorm (want {per_fwd}), launched {eager} "
                            f"eagerly (want 0), holds {programs()} captured "
                            f"programs (want {captured})")
                    equal = bool(torch.equal(got, pt.output))
                    d = (got.float() - pt.output.float()).abs().max().item()
                    out[f"{rung}_bit_equal_at_step_{step}"] = equal
                    log(f"  decode step {step}, {rung} rung (captured at step "
                        f"1, slabs updated in place since): replay launched "
                        f"{replayed} RMSNorm, 0 eagerly, {captured} captured "
                        f"programs before and after; logits "
                        f"{'bit-equal to' if equal else 'DIFFER from'} the per-"
                        f"task step's (max abs {d:.3e})")
                    if not equal:
                        raise AssertionError(
                            f"{rung} rung read stale cache slabs at step {step}")
        P.apply_cache_updates(params_c, pt.task_outputs, cfg, pos)
        tok = torch.argmax(pt.output[:, -1, :], dim=-1).to(torch.int32)[:, None]
        del pt
    log(f"  heft x8: the step on {nodes8} nodes of the card, logits bit-equal "
        f"to one node's ({out['heft_x8_ms']:.3f} ms)")
    # what the layer tasks' out-of-place slab copies (the step's rows
    # written into a copy of each K and V slab) cost per step
    from distributed_llm_scheduler_tpu_torch.frontend.decode_dag import (
        _with_step_rows,
    )

    H, hd = cfg.n_kv_heads, cfg.head_dim
    new = torch.zeros((B, H, 1, hd), dtype=cfg.dtype, device=dev)
    pos_t = torch.full((), T + DECODE_RUNG_STEPS, dtype=torch.int32, device=dev)
    slabs = [(params_c[f"cache_{kind}_{i}"], new, pos_t)
             for i in range(cfg.n_layers) for kind in ("k", "v")]
    out["slab_copy_ms"] = graph_ms(torch, _with_step_rows, slabs) * len(slabs)
    out["slab_copy_bound_ms"] = (2 * sum(s.nbytes for s, _, _ in slabs)
                                 / PEAK_BYTES_PER_S * 1e3)
    log(f"  the layer tasks' slab copies: {len(slabs)} per step, "
        f"{out['slab_copy_ms']:.4f} ms (bound {out['slab_copy_bound_ms']:.4f} "
        f"ms: each slab read and its copy written once)")
    del params_c, slabs
    return out, launches


def moe_decode(torch, P, N, dev) -> tuple:
    """Mixtral-8x7B widths at phase 18 b's depth cut, bf16: ``generate``
    against the backbone decode DAG (prefill, then single-token steps under
    ``heft`` on one node, folded in place); greedy tokens must be equal."""
    from distributed_llm_scheduler_tpu_torch.eval import decode_bench as DB
    from distributed_llm_scheduler_tpu_torch.models import mixtral

    cfg = P.MixtralConfig.mixtral_8x7b(n_layers=MOE_LAYERS, dtype=torch.bfloat16)
    B, T, new = (MOE_DECODE[k] for k in ("batch", "prompt_len", "new_tokens"))
    params = mixtral.init_params_torch(cfg, seed=0, device=dev)
    ids = DB.prompt_ids(cfg, B, T, dev)
    per_fwd = 2 * cfg.n_layers + 1
    rms = {N.RMS_KERNEL: per_fwd * new, f"{N.RMS_KERNEL}.register": per_fwd * new}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, n_gen, _ = counted_ran("mixtral generate", rms,
                                 lambda: mixtral.generate(
                                     params, ids, cfg, max_new_tokens=new))
    want = want[:, T:].cpu()
    gen_s = time.perf_counter() - t0
    one = P.Cluster.from_torch_devices([dev])
    be = P.DeviceBackend(one)
    heft = P.get_scheduler("heft")
    max_len = T + new
    pdag = P.build_decode_dag_any(cfg, batch=B, step_len=T, max_len=max_len)
    ddag = P.build_decode_dag_any(cfg, batch=B, step_len=1, max_len=max_len)
    ps, ds = heft.schedule(pdag.graph, one), heft.schedule(ddag.graph, one)
    params_c = pdag.derive_params(params)

    def dag_generate():
        rep = be.execute(pdag.graph, ps, params_c, P.decode_inputs(ids, 0),
                         keep_outputs=True, warmup=False)
        P.apply_cache_updates(params_c, rep.task_outputs, cfg, 0)
        tok = torch.argmax(rep.output[:, -1, :], dim=-1).to(torch.int32)
        toks = [tok]
        for s in range(1, new):
            pos = T + s - 1
            rep = be.execute(ddag.graph, ds, params_c,
                             P.decode_inputs(tok[:, None], pos, max_len=max_len),
                             keep_outputs=True, warmup=False)
            P.apply_cache_updates(params_c, rep.task_outputs, cfg, pos)
            tok = torch.argmax(rep.output[:, -1, :], dim=-1).to(torch.int32)
            toks.append(tok)
        return torch.stack(toks, dim=1).cpu()

    t0 = time.perf_counter()
    got, n_dag = counted("mixtral decode DAG", rms, dag_generate)
    dag_s = time.perf_counter() - t0
    equal = bool(torch.equal(got, want))
    log(f"  Mixtral {cfg.n_layers} layers bf16, batch {B}, prompt {T}, {new} "
        f"new tokens: generate {gen_s:.3f} s, decode DAG ({len(ddag.graph)} "
        f"tasks per step, heft x1) {dag_s:.3f} s; greedy tokens "
        f"{'equal' if equal else 'DIFFER'}")
    if not equal:
        raise AssertionError(f"Mixtral decode DAG tokens {got.tolist()} != "
                             f"generate's {want.tolist()}")
    del params, params_c
    return (dict(n_layers=cfg.n_layers, batch=B, prompt_len=T, new_tokens=new,
                 generate_s=gen_s, dag_s=dag_s, n_tasks_step=len(ddag.graph),
                 tokens_equal=equal),
            {"mixtral generate": n_gen, "mixtral decode DAG": n_dag})


def gpt2_decode_legs(torch, P, A, N, dev) -> tuple:
    """Phase 19 e: the decode bench's GPT-2 legs at their defaults."""
    from distributed_llm_scheduler_tpu_torch.eval import decode_bench as DB
    from distributed_llm_scheduler_tpu_torch.ops import kernels

    cfg = P.GPT2Config.small(dtype=torch.bfloat16)
    per_fwd = 2 * cfg.n_layer + 1  # ln1 and ln2 per layer, ln_f
    calls = decode_calls(DECODE_REPS, DECODE["new_tokens"])
    ln = {N.LN_KERNEL: per_fwd * calls, f"{N.LN_KERNEL}.register": per_fwd * calls}
    out, launches = {}, {}
    out["decode"], launches["gpt2 decode"], _ = counted_ran(
        "gpt2 decode", ln, lambda: DB.measure_decode(cfg, reps=DECODE_REPS,
                                                     device=dev, **DECODE))
    log_decode("GPT-2 small bf16 generate", out["decode"])
    for label, kw in (("int8", dict(quantize=True, kv_int8=True)),
                      ("kv_int8", dict(kv_int8=True))):
        calls_q = decode_calls(DECODE_REPS, DECODE["new_tokens"], lossy=True)
        # the int8-weight leg also runs two fused forwards (its flip rate)
        n_ln = per_fwd * (calls_q + (2 if label == "int8" else 0))
        r, launches[f"gpt2 decode {label}"], _ = counted_ran(
            f"gpt2 decode {label}",
            {N.LN_KERNEL: n_ln, f"{N.LN_KERNEL}.register": n_ln},
            lambda: DB.measure_decode(cfg, reps=DECODE_REPS, device=dev,
                                      **DECODE, **kw))
        out[label] = r
        log_decode(f"GPT-2 small {label}", r)
        log(f"    token agreement {r['token_agreement']}, first token "
            f"{r['first_token_agreement']}"
            + (f", argmax flip rate {r['argmax_flip_rate']}, logit rmse "
               f"{r['logit_rmse']}" if "argmax_flip_rate" in r else ""))
    out["attribution"] = DB.decode_attribution(cfg, device=dev)
    a = out["attribution"]
    log(f"  attribution: step {a['step_ms']} ms (bound "
        f"{a.get('step_bound_ms')}), forward in place "
        f"{a['forward_donated_ms']} ms, on a cloned cache "
        f"{a['forward_undonated_ms']} ms, head {a['head_ms']} ms (bound "
        f"{a['head_bound_ms']}), attention {a['attn_ms']} ms (bound "
        f"{a['attn_bound_ms']}), argmax {a['sample_ms']} ms, loop overhead "
        f"{a['loop_overhead_ms']} ms")
    kernels.reset_launches()
    p = DB.measure_paged_decode(device=dev)
    n_paged = kernels.ran(A.PAGED_KERNEL)
    launches["paged decode"] = {A.PAGED_KERNEL: n_paged}
    log(f"  paged decode (GPT-2 tiny f32): paged {p['paged_tok_s']:.1f} tok/s "
        f"against dense {p['dense_tok_s']:.1f} ({p['speedup']}x), tokens "
        f"exact {p['tokens_exact']}, {p['pages_leaked']} pages leaked, "
        f"{n_paged} paged-kernel launches")
    if not p["tokens_exact"] or p["pages_leaked"] or not n_paged:
        raise AssertionError("paged decode leg failed")
    out["paged"] = {k: v for k, v in p.items()
                    if k not in ("metrics", "requests", "slo")}
    kernels.reset_launches()
    k = DB.measure_paged_kernel(device=dev)
    leg = ran_counts((A.PAGED_KERNEL, A.PAGED_RAGGED_KERNEL))
    launches["paged kernel leg"] = leg
    failures = DB.kernel_gate_failures(k)
    log(f"  paged kernel leg (GPT-2 tiny f32): kernel {k['kernel_tok_s']:.1f} "
        f"tok/s against the plain gather {k['gather_tok_s']:.1f} "
        f"({k.get('kernel_vs_gather_speedup')}x), tokens exact "
        f"{k['tokens_exact']}, parity {k['parity_ok']}, ragged parity "
        f"{k['ragged_parity_ok']}, leaked {k['pages_leaked_gather']} / "
        f"{k['pages_leaked_kernel']}; {leg[A.PAGED_KERNEL]} paged and "
        f"{leg[A.PAGED_RAGGED_KERNEL]} ragged launches")
    if failures or not leg[A.PAGED_KERNEL]:
        raise AssertionError(f"paged kernel leg failed: {failures}")
    out["paged_kernel"] = k
    return out, launches


def run_decode_path(torch, P, A, N, dev) -> tuple:
    """Phase 19: a-e, then the norm kernels at the decode paths' shapes.
    Returns (DECODE_LINE's dict, {run: launches}, the norm timings)."""
    import numpy as np

    from distributed_llm_scheduler_tpu_torch.eval import decode_bench as DB
    from distributed_llm_scheduler_tpu_torch.models import decode, llama

    line, launches = {"card": nvidia_smi_line()}, {}
    cfg = P.LlamaConfig.llama3_8b(dtype=torch.bfloat16)
    per_fwd = 2 * cfg.n_layers + 1
    t0 = time.perf_counter()
    params = llama.init_params_torch(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"  a. Llama-3 8B bf16, weights drawn on the card from torch seed 0 "
        f"({time.perf_counter() - t0:.1f} s); batch {DECODE['batch']}, prompt "
        f"{DECODE['prompt_len']}, {DECODE['new_tokens']} new tokens, "
        f"{per_fwd} RMSNorm per forward")

    def rms(n):
        return {N.RMS_KERNEL: per_fwd * n, f"{N.RMS_KERNEL}.register": per_fwd * n,
                A.KERNEL: 0}

    calls = decode_calls(DECODE_REPS, DECODE["new_tokens"], eager_leg=True)
    a, launches["llama decode"], replays = counted_ran(
        "llama decode", rms(calls), lambda: DB.measure_decode(
            cfg, reps=DECODE_REPS, device=dev, params=params, eager_leg=True,
            **DECODE))
    a["rms_norm_replayed"] = replays[N.RMS_KERNEL]
    log_decode("Llama-3 8B generate, captured steps", a)
    e = a["eager"]
    log(f"  Llama-3 8B generate, eager steps (capture=False, "
        f"{e['new_tokens']:.0f} tokens, {DB.EAGER_REPS} "
        f"timed rep): {e['decode_tok_s']:.1f} tok/s, "
        f"{e['ms_per_token_step']:.4f} ms per token step, bound_utilization "
        f"{e.get('bound_utilization', 0):.4f}; captured "
        f"{a['ms_per_token_step']:.4f} ms "
        f"({e['ms_per_token_step'] / a['ms_per_token_step']:.2f}x); tokens "
        f"equal {e['tokens_equal']} ({time.perf_counter() - t0:.1f} s so far)")
    if not e["tokens_equal"]:
        raise AssertionError("captured generate's tokens differ from the "
                             "eager path's")
    log(f"    {per_fwd} RMSNorm per step, all on the register kernel; no "
        f"call on copies")
    ids = DB.prompt_ids(cfg, DECODE["batch"], DECODE["prompt_len"], dev)
    # in bf16 a randomly drawn Llama-3 8B carries any rounding difference
    # between two orders of the same math (the cached step against the
    # flash forward) to percents over its 32 layers, so the bf16 steps are
    # held against the same weights in f32: no further from the f32 fused
    # forward than DECODE_BF16_K times the bf16 fused forward; the f32
    # steps meet the f32 fused forward under the JAX package's rule
    cfg32 = P.LlamaConfig.llama3_8b(dtype=torch.float32)
    params32 = llama.init_params_torch(cfg32, seed=0, device=dev)
    a["oracle_bf16"] = decode_oracle(torch, llama, cfg, params, ids,
                                     DECODE["new_tokens"], f32=(cfg32, params32))
    a["oracle"] = decode_oracle(torch, llama, cfg32, params32, ids,
                                DECODE["new_tokens"])
    del params32
    gc_cuda(torch)
    line["llama"] = a
    log(f"  a. in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    log("  b. Llama-3 8B with the int8 KV cache")
    calls_b = decode_calls(DECODE_REPS, DECODE["new_tokens"], lossy=True)
    b, launches["llama decode kv_int8"], _ = counted_ran(
        "llama decode kv_int8", rms(calls_b), lambda: DB.measure_decode(
            cfg, reps=DECODE_REPS, device=dev, params=params, kv_int8=True,
            **DECODE))
    M = DECODE["prompt_len"] + DECODE["new_tokens"]
    dense = llama.init_cache(cfg, DECODE["batch"], M, device=dev)
    q8 = decode.quantize_cache(dense)
    b["cache_bytes"] = sum(v.nbytes for v in q8.values())
    b["cache_bytes_ratio"] = b["cache_bytes"] / sum(v.nbytes for v in dense.values())
    del dense, q8
    log_decode("Llama-3 8B generate, int8 KV cache", b)
    log(f"    cache {b['cache_bytes'] / 1e9:.4f} GB, {b['cache_bytes_ratio']:.4f}"
        f" of the bf16 cache's; token agreement with leg a "
        f"{b['token_agreement']}, first token {b['first_token_agreement']}")
    if b["cache_bytes_ratio"] > 0.75:
        raise AssertionError("the int8 cache is not under 0.75 of the bf16 one")
    line["llama_kv_int8"] = b
    log(f"  b. in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    log("  c. the Llama-3 8B decode-step DAG through the scheduler")
    from distributed_llm_scheduler_tpu_torch.ops import kernels

    kernels.reset_launches()
    c = DB.measure_decode_dag(cfg, policy="heft", device=dev, params=params,
                              loop_steps=DECODE_LOOP_STEPS)
    no_routes("llama decode DAG bench")
    n_rms = kernels.ran(N.RMS_KERNEL)
    launches["llama decode DAG bench"] = {N.RMS_KERNEL: n_rms}
    if kernels.ran(f"{N.RMS_KERNEL}.register") != n_rms or not n_rms:
        raise AssertionError("decode DAG bench: RMSNorm off the register kernel")
    lp = c["looped"]
    el = lp["eager"]
    log(f"  decode DAG K-step loop x{lp['steps_per_dispatch']}: captured "
        f"{lp['ms_per_token']} ms/token ({lp['tok_s']} tok/s), eager "
        f"{el['ms_per_token']} ms/token ({el['tok_s']} tok/s); tokens equal "
        f"{el['tokens_equal_captured']}")
    if not el["tokens_equal_captured"]:
        raise AssertionError("captured K-step loop's tokens differ from the "
                             "eager loop's")
    log(f"  decode DAG ({c['n_tasks_decode_step']} tasks, heft x1): per task "
        f"{c['step_ms_per_task']} ms/step, segmented {c['step_ms_segmented']} "
        f"ms/step (bound utilization {c.get('segmented_bound_utilization')}), "
        f"host-driven {c['tok_s_end_to_end']} tok/s (host round trip "
        f"{c['host_rtt_ms']} ms), looped x{lp['steps_per_dispatch']} "
        f"{lp['ms_per_token']} ms/token ({lp['tok_s']} tok/s, agreement with "
        f"generate {lp['token_agreement_vs_whole_program']}), int8 weights "
        f"{lp['int8_weights']['ms_per_token']} ms/token; oracle "
        f"{c['oracle_ok']}, token agreement {c['token_agreement']}, "
        f"{c['graph_classes_compiled']} graph classes; {n_rms} RMSNorm "
        f"launches")
    if not (c["oracle_ok"] and c["graph_classes_compiled"] == 2
            and c["n_tasks_decode_step"] == cfg.n_layers + 2):
        raise AssertionError(f"decode DAG bench failed: {c}")
    c["rungs"], rung_n = decode_step_rungs(torch, P, N, cfg, params, dev)
    launches.update(rung_n)
    line["llama_dag"] = c
    del params
    gc_cuda(torch)
    log(f"  c. in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    log("  d. Mixtral-8x7B widths, 4 layers: generate against the decode DAG")
    line["mixtral"], moe_n = moe_decode(torch, P, N, dev)
    launches.update(moe_n)
    gc_cuda(torch)
    log(f"  d. in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    log("  e. GPT-2 small bf16 through the bench's other legs")
    line["gpt2"], gpt2_n = gpt2_decode_legs(torch, P, A, N, dev)
    launches.update(gpt2_n)
    gc_cuda(torch)
    log(f"  e. in {time.perf_counter() - t0:.1f} s")

    log("  norm kernels at the decode paths' shapes")
    rng = np.random.default_rng(5)
    norms = {}
    for kind, shape in DECODE_NORMS:
        name = N.LN_KERNEL if kind == "ln" else N.RMS_KERNEL
        args, err = check_norm_case(torch, N, dev, rng, kind, shape,
                                    "bfloat16", False, 0, N.REGISTER)
        t = dict(max_abs_err=err, **time_norm(torch, N, kind, args, rng, dev))
        log_norm_time(name, t)
        norms.setdefault(name, []).append(t)
    line["norms"] = norms
    return line, launches, norms


CLI_TOKENS = 32
CLI_DIR = ROOT / "chip_smoke_out" / "cli"
# generate's checkpoint: N(0, scale) weights, LayerNorm gains 1 + N(0, 0.1),
# from this seed.  GPT-2's own init (std 0.02) leaves the tied LM head
# repeating the last token, which would hide a misplaced cache write
CLI_WEIGHTS_SEED, CLI_WEIGHTS_SCALE = 7, 0.2
# the least number of distinct ids the CLI_TOKENS generated must hold
CLI_MIN_DISTINCT = 8


def save_gpt2_checkpoint(torch, config, path: Path) -> Path:
    """A synthetic HF-layout GPT-2 state dict for ``config``, drawn on the
    card from ``CLI_WEIGHTS_SEED`` and written with ``torch.save``, as
    ``generate --weights`` reads it."""
    from distributed_llm_scheduler_tpu_torch.frontend import pretrained
    from distributed_llm_scheduler_tpu_torch.models import gpt2

    top = {v: k for k, v in pretrained._TOP_LEVEL.items()}
    per_layer = {v: k for k, v in pretrained._PER_LAYER.items()}
    gen = torch.Generator(device="cuda").manual_seed(CLI_WEIGHTS_SEED)
    sd = {}
    for name, (shape, _dt) in gpt2.param_shapes(config).items():
        if name in top:
            hf = "transformer." + top[name]
        else:
            idx, per = name[1:].split("_", 1)
            hf = f"transformer.h.{idx}.{per_layer[per]}"
        w = torch.randn(shape, generator=gen, device="cuda")
        w = 1.0 + 0.1 * w if name.endswith("_g") else CLI_WEIGHTS_SCALE * w
        sd[hf] = w.cpu()
    torch.save(sd, str(path))
    return path


@contextlib.contextmanager
def spied(owner, name: str):
    """Record every call of ``owner.name`` while open: a list of
    (args, kwargs, result), the method still doing its work."""
    orig = getattr(owner, name)
    calls = []

    def spy(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(owner, name, spy)
    try:
        yield calls
    finally:
        setattr(owner, name, orig)


def cli_run(torch, main, label: str, argv: list) -> tuple:
    """One command of the port's CLI in this process: stdout captured,
    every launch count set to 0 just before and read just after.  Fails
    unless it exits 0 with no call on copies.  Returns (stdout, {kernel:
    eager launches}, {kernel: replayed launches}, wall seconds)."""
    from distributed_llm_scheduler_tpu_torch.ops import kernels

    kernels.reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{label}: `{' '.join(argv)}` exited {rc}")
    no_routes(label)
    return (out.getvalue(), dict(kernels.launches), dict(kernels.replayed),
            wall)


def per_forward_of(graph, A, N) -> dict:
    """The flash and LayerNorm launches one forward of a GPT-2 DAG makes:
    one per attention task, one per layer-norm task."""
    return {A.KERNEL: sum(1 for t in graph if t.task_id.endswith("_attention")),
            N.LN_KERNEL: sum(1 for t in graph if t.task_id.endswith(
                ("_ln1", "_ln2", "final_ln")))}


def cli_execute_checks(torch, P, A, N, label, calls, out, eager, replayed
                       ) -> dict:
    """``execute``'s checks on the run the command made (spied): every
    task completed, ``n_devices`` the cards bound, the launches the DAG's
    tasks times the forwards run (warm-up and one timed run), the output
    finite and within the fused forward's band.  Returns the counts."""
    (backend, graph, sched, params, ids), _kw, rep = calls[-1]
    summary = json.loads(out[out.index("{"):out.rindex("}") + 1])
    cards = min(8, torch.cuda.device_count())
    if len(sched.completed) != len(graph) or sched.failed:
        raise AssertionError(f"{label}: {len(sched.completed)} of "
                             f"{len(graph)} tasks completed")
    if summary["n_devices"] != cards or len(backend.cluster) != cards:
        raise AssertionError(f"{label}: n_devices {summary['n_devices']}, "
                             f"{cards} card(s) bound")
    per_forward = per_forward_of(graph, A, N)
    got = {k: eager.get(k, 0) for k in per_forward}
    if rep.captured_launches:
        captured = {k: rep.captured_launches.get(k, 0) for k in per_forward}
        rp = {k: replayed.get(k, 0) for k in per_forward}
        if captured != per_forward or got != times(captured, 2) or \
                rp != times(captured, 2):
            raise AssertionError(f"{label}: captured {captured}, eager {got}, "
                                 f"replayed {rp}; per forward {per_forward}")
        counts = rp
    else:
        if got != times(per_forward, 2):
            raise AssertionError(f"{label}: launches {got}, per forward "
                                 f"{per_forward}")
        counts = got
    from distributed_llm_scheduler_tpu_torch.models import gpt2

    fused = gpt2.forward(params, ids, P.GPT2Config.small())
    ok, viol, allowed, rel = oracle_close(fused, rep.output)
    if not (ok and bool(torch.isfinite(rep.output).all())):
        raise AssertionError(f"{label}: output off the fused forward ({viol} "
                             f"outside the band, rel {rel:.3e})")
    return dict(counts=counts, per_forward=per_forward, rel_fro=rel,
                tasks=len(graph), makespan_ms=summary["makespan_ms"])


def run_cli_path(torch, P, A, N) -> tuple:
    """Phase 20: the port's command line on the card (see the module
    docstring).  Returns (CLI_LINE dict, {command: launch counts})."""
    from distributed_llm_scheduler_tpu_torch.__main__ import main
    from distributed_llm_scheduler_tpu_torch.obs.export import validate_trace
    from distributed_llm_scheduler_tpu_torch.ops import kernels
    from distributed_llm_scheduler_tpu_torch.obs.metrics import (
        validate_snapshot,
    )
    from distributed_llm_scheduler_tpu_torch.sched.search import (
        placement_digest,
    )

    CLI_DIR.mkdir(parents=True, exist_ok=True)
    line, counts = {"commands": {}}, {}

    def record(label, wall, makespan_ms, **extra):
        line["commands"][label] = dict(wall_s=wall, makespan_ms=makespan_ms,
                                       **extra)
        log(f"  {label}: {wall:.2f} s wall, makespan "
            f"{makespan_ms if makespan_ms is None else f'{makespan_ms:.3f}'} ms"
            + "".join(f", {k} {v}" for k, v in extra.items()))

    # a. execute, the README's quickstart
    trace_path = CLI_DIR / "execute_trace.json"
    for label, extra in (("execute", []), ("execute --segments", ["--segments"]),
                         ("execute --profile --trace",
                          ["--profile", "--trace", str(trace_path)])):
        with spied(P.DeviceBackend, "execute") as calls:
            out, eager, replayed, wall = cli_run(
                torch, main, label, ["execute", "--model", "gpt2", *extra])
        got = cli_execute_checks(torch, P, A, N, label, calls, out, eager,
                                 replayed)
        counts[label] = got["counts"]
        if "--trace" in extra:
            errs = validate_trace(str(trace_path))
            if errs:
                raise AssertionError(f"{label}: trace invalid: {errs[:3]}")
        record(label, wall, got["makespan_ms"], tasks=got["tasks"],
               launches=got["counts"], rel_fro=got["rel_fro"])
        del calls

    # b. trace and metrics: the execute leg, then the paged decode leg
    for label, argv in (
        ("trace", ["trace", "--model", "gpt2", "--out",
                   str(CLI_DIR / "trace.json")]),
        ("metrics", ["metrics", "--model", "gpt2"]),
    ):
        with spied(P.DeviceBackend, "execute") as calls:
            out, eager, _, wall = cli_run(torch, main, label, argv)
        graph, rep = calls[0][0][1], calls[0][2]
        per_forward = per_forward_of(graph, A, N)
        if eager.get(A.KERNEL, 0) != 2 * per_forward[A.KERNEL]:
            raise AssertionError(f"{label}: {eager.get(A.KERNEL)} flash "
                                 f"launches, per forward {per_forward}")
        if not kernels.replayed.get(A.PAGED_KERNEL, 0):
            raise AssertionError(f"{label}: the decode leg replayed no "
                                 "paged kernel")
        if label == "trace":
            errs = validate_trace(str(CLI_DIR / "trace.json"))
            extra = dict(spans=json.loads(out)["spans"])
        else:
            snap = json.loads(out)
            errs = validate_snapshot(snap)
            extra = dict(counters=len(snap["counters"]))
        if errs:
            raise AssertionError(f"{label}: invalid output: {errs[:3]}")
        counts[label] = ran_counts((A.KERNEL, A.PAGED_KERNEL, N.LN_KERNEL))
        record(label, wall, rep.makespan_s * 1e3, launches=counts[label],
               **extra)
        del calls

    # c. generate, whole-model and through the scheduling layer, from one
    # synthetic checkpoint whose greedy stream does not collapse
    tokens = {}
    ckpt = save_gpt2_checkpoint(torch, P.GPT2Config.small(),
                                CLI_DIR / "gpt2_synthetic.pt")
    for label, extra in (("generate", []), ("generate --task-graph",
                                            ["--task-graph"])):
        out, eager, _, wall = cli_run(
            torch, main, label, ["generate", "--model", "gpt2", "--weights",
                                 str(ckpt), "--max-new-tokens",
                                 str(CLI_TOKENS), *extra])
        tokens[label] = json.loads(out)["generated_ids"]
        counts[label] = ran_counts((A.KERNEL, N.LN_KERNEL))
        record(label, wall, None, launches=counts[label],
               tokens=len(tokens[label]))
        # 2 n_layer + 1 layer norms per forward that ran: whole-model, the
        # prefill and 31 steps (30 of them replays of the captured step);
        # the task graph also warms up its two graph classes
        forwards = CLI_TOKENS + (2 if extra else 0)
        n_ln = 2 * P.GPT2Config.small().n_layer + 1
        if len(tokens[label]) != CLI_TOKENS or \
                counts[label][N.LN_KERNEL] != n_ln * forwards:
            raise AssertionError(f"{label}: {len(tokens[label])} tokens, "
                                 f"launches {counts[label]}, expected "
                                 f"{n_ln * forwards} layer_norm")
    ckpt.unlink()
    if len(set(tokens["generate"])) < CLI_MIN_DISTINCT:
        raise AssertionError(f"generate: {tokens['generate']} holds fewer "
                             f"than {CLI_MIN_DISTINCT} distinct ids")
    if tokens["generate"] != tokens["generate --task-graph"]:
        raise AssertionError(f"generate: whole-model {tokens['generate']} != "
                             f"task graph {tokens['generate --task-graph']}")
    line["generated_ids"] = tokens["generate"]

    # d. schedule llama-8b: the native engine (built here) against heft
    digests, reports = {}, {}
    for policy in ("native:heft", "heft"):
        label = f"schedule {policy}"
        with spied(P.SimulatedBackend, "execute") as calls:
            out, _, _, wall = cli_run(torch, main, label, [
                "schedule", "--model", "llama-8b", "--scheduler", policy])
        rep = json.loads(out)
        digests[policy] = placement_digest(calls[0][0][3].placement)
        reports[policy] = rep
        record(label, wall, rep["makespan_s"] * 1e3, digest=digests[policy],
               tasks=rep["graph"]["num_tasks"],
               scheduling_wall_s=rep["schedule"].pop("scheduling_wall_s"))
    if digests["native:heft"] != digests["heft"] or \
            reports["native:heft"] != reports["heft"]:
        raise AssertionError(f"schedule: native:heft {digests['native:heft']}"
                             f" != heft {digests['heft']}")

    # f. the serving commands
    serving_commands(torch, A, N, main, record, counts)

    # e. the module entry point, in a process of its own
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "distributed_llm_scheduler_tpu_torch",
         "execute", "--model", "gpt2"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"python -m distributed_llm_scheduler_tpu_torch "
                             f"execute exited {r.returncode}: {r.stderr[-2000:]}")
    summary = json.loads(r.stdout)
    record("python -m ... execute", wall, summary["makespan_ms"],
           n_devices=summary["n_devices"])
    return line, counts


def serving_commands(torch, A, N, main, record, counts) -> None:
    """Phase 20 f: ``serve --model gpt2`` (GPT-2 small f32 on a virtual
    clock, its segments captured), ``slo`` (a live leg on the card's wall
    clock), a short ``soak`` (GPT-2 tiny f32, virtual clock; every value
    but the clock-stamped series equal to the same command's on the CPU),
    ``doctor`` (the live profiled run, ``--memory``), ``metrics diff``
    over the soak's series and ``regress`` on a committed artifact: each
    exits 0, and each that serves replays the paged kernel."""
    import os

    from distributed_llm_scheduler_tpu_torch.ops import kernels

    def replayed_paged(label):
        n = kernels.replayed.get(A.PAGED_KERNEL, 0)
        if not n:
            raise AssertionError(f"{label}: no replayed paged kernel launch")
        return n

    out, _, _, wall = cli_run(torch, main, "serve", [
        "serve", "--model", "gpt2", "--out", str(CLI_DIR / "serve.json")])
    rep = json.loads(out)
    counts["serve"] = ran_counts((A.PAGED_KERNEL, N.LN_KERNEL))
    if rep["breached"] or rep["pages_leaked"] or rep["completed"] != rep[
            "n_requests"]:
        raise AssertionError(f"serve: {rep}")
    record("serve --model gpt2", wall, None, launches=counts["serve"],
           replayed_paged=replayed_paged("serve"), completed=rep["completed"],
           goodput_tok_s=rep["goodput_tok_s"], ttft_p99_ms=rep["ttft_p99_ms"])

    out, _, _, wall = cli_run(torch, main, "slo", [
        "slo", "--model", "gpt2", "--ttft", "10"])
    rep = json.loads(out)
    counts["slo"] = ran_counts((A.PAGED_KERNEL, N.LN_KERNEL))
    record("slo --model gpt2", wall, None, launches=counts["slo"],
           replayed_paged=replayed_paged("slo"),
           requests=rep["requests"]["n_requests"]
           if "n_requests" in rep["requests"] else len(rep["requests"]))

    soak_argv = ["soak", "--duration", "2", "--warmup", "0.5"]
    card_art, host_art = CLI_DIR / "soak.json", CLI_DIR / "soak_cpu.json"
    out, _, _, wall = cli_run(torch, main, "soak",
                              soak_argv + ["--out", str(card_art)])
    counts["soak"] = ran_counts((A.PAGED_KERNEL, N.LN_KERNEL))
    n_replayed = replayed_paged("soak")
    prev = os.environ.get("DLS_PLATFORM")
    os.environ["DLS_PLATFORM"] = "cpu"
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = main(soak_argv + ["--out", str(host_art)])
    finally:
        if prev is None:
            del os.environ["DLS_PLATFORM"]
        else:
            os.environ["DLS_PLATFORM"] = prev
    card, host = (json.loads(p.read_text()) for p in (card_art, host_art))
    off = [k for k in card if k not in ("timeseries", "flight_dumps")
           and card[k] != host[k]]
    if rc != 0 or off or card["verdict"] != "healthy":
        raise AssertionError(f"soak: CPU exit {rc}, values off the CPU's "
                             f"{off}, verdict {card['verdict']}")
    record("soak (2 s)", wall, None, launches=counts["soak"],
           replayed_paged=n_replayed, verdict=card["verdict"],
           goodput_tok_s=card["soak.goodput_tok_s"], equal_to_cpu=True)

    for label, argv in (("doctor", ["doctor", "--model", "gpt2"]),
                        ("doctor --memory",
                         ["doctor", "--memory", "--model", "gpt2"])):
        out, _, _, wall = cli_run(torch, main, label, argv)
        rep = json.loads(out)
        counts[label] = ran_counts((A.KERNEL, N.LN_KERNEL))
        if label == "doctor":
            extra = dict(critical_path=len(rep["attribution"]["critical_path"]),
                         drift_tasks=rep["drift"]["n_tasks"],
                         drift_median_ratio=rep["drift"]["median_ratio"])
        else:
            extra = dict(devices=len(rep["memory"]["devices"]),
                         mem_drift_worst_ratio=rep["mem_drift"]["worst_ratio"])
        if not counts[label][A.KERNEL]:
            raise AssertionError(f"{label}: no flash launch")
        record(label, wall, None, launches=counts[label], **extra)

    out, _, _, wall = cli_run(torch, main, "metrics diff", [
        "metrics", "diff", str(card_art), "--at", "0", "--vs", "-1"])
    record("metrics diff", wall, None,
           gauges=len(json.loads(out).get("gauges", {})))
    out, _, _, wall = cli_run(torch, main, "regress", [
        "regress", "--fresh", str(ROOT / "BENCH_MEDIUM_r05.json"),
        "--baseline", str(ROOT / "BENCH_MEDIUM_r05.json"), "--json"])
    verdict = json.loads(out)
    if not verdict["ok"]:
        raise AssertionError(f"regress: {verdict}")
    record("regress", wall, None, checks=verdict["n_checks"],
           regressed=verdict["n_regressed"])


# phase 21: the pre-flight lint and the sim-against-card rank check
LINT_HOST = (["lint", "--model", "gpt2", "--json"],
             ["lint", "--model", "llama-8b", "--json"],
             ["lint", "--model", "gpt2", "--quantize", "int8", "--json"])
LINT_SERVING = (
    # (argv, exit code, a code the report must name)
    (["lint", "--serving", "--json"], 0, None),
    (["lint", "--serving", "--inject-leak", "4", "--json"], 1, "PGL001"),
    (["lint", "--serving", "--prefix", "--inject-underflow", "--json"], 1,
     "PGL006"),
)
RANK_POLICIES = ("roundrobin", "critical", "pipeline", "pack")
RANK_REPEATS = 3


def cli_call(torch, main, argv: list, platform=None) -> tuple:
    """One command of the port's CLI in this process, with
    ``DLS_PLATFORM`` set to ``platform`` (None: unset, the card) while it
    runs, stdout and stderr captured, every launch count set to 0 just
    before and read just after.  Returns (exit code, stdout, stderr, wall
    seconds, {kernel: launches that ran})."""
    import os

    from distributed_llm_scheduler_tpu_torch.ops import kernels

    prev = os.environ.pop("DLS_PLATFORM", None)
    if platform is not None:
        os.environ["DLS_PLATFORM"] = platform
    kernels.reset_launches()
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
        torch.cuda.synchronize()
    finally:
        os.environ.pop("DLS_PLATFORM", None)
        if prev is not None:
            os.environ["DLS_PLATFORM"] = prev
    wall = time.perf_counter() - t0
    ran = {k: kernels.ran(k) for k in sorted(set(kernels.launches)
                                             | set(kernels.replayed))}
    return rc, out.getvalue(), err.getvalue(), wall, ran


def lint_codes(out: str, severity=None) -> list:
    """(code, task) of each diagnostic of a ``lint --json`` report, of one
    severity when given."""
    return [(d["code"], d.get("task")) for d in json.loads(out)["diagnostics"]
            if severity is None or d["severity"] == severity]


def rank_summary(rep: dict) -> dict:
    """The rank check's figures, per policy in ms."""
    return dict(
        policies={p: dict(predicted_ms=r["predicted_s"] * 1e3,
                          measured_ms=r["measured_s"] * 1e3,
                          ratio=r["ratio"])
                  for p, r in rep["policies"].items()},
        predicted_order=rep["predicted_order"],
        measured_order=rep["measured_order"], kendall_tau=rep["kendall_tau"],
        winner_agreement=rep["winner_agreement"],
        prediction_is_tie=rep["prediction_is_tie"],
        prediction_spread=rep["prediction_spread"],
        cross_group_agreement=rep["cross_group_agreement"],
        n_devices=rep["n_devices"], link_provenance=rep["link_provenance"],
        anchor_calibration=rep["anchor_calibration"], wall_s=rep["wall_s"])


def run_lint_rank_path(torch, P, A, N, dev) -> tuple:
    """Phase 21: ``lint`` and ``rankcheck`` on the card (see the module
    docstring).  Returns (LINT_RANK_LINE dict, {run: {kernel: launches
    that ran}})."""
    from distributed_llm_scheduler_tpu_torch.__main__ import main
    from distributed_llm_scheduler_tpu_torch.eval.benchlib import (
        oracle_close as f32_close,
    )
    from distributed_llm_scheduler_tpu_torch.eval.rankcheck import (
        run_rank_check,
    )
    from distributed_llm_scheduler_tpu_torch.frontend.tracer import (
        trace_to_chain,
    )
    from distributed_llm_scheduler_tpu_torch.models import gpt2
    from distributed_llm_scheduler_tpu_torch.ops import kernels
    from distributed_llm_scheduler_tpu_torch.utils.config import RunConfig

    line, counts = {}, {}
    main_kernels = (A.KERNEL, N.LN_KERNEL)

    # a. host-only lints: on the card's platform and on the CPU, equal
    line["host_lints"] = {}
    for argv in LINT_HOST:
        label = " ".join(argv[1:])
        rc, out, err, wall, ran = cli_call(torch, main, argv)
        rc_cpu, out_cpu, _, _, _ = cli_call(torch, main, argv, "cpu")
        if (rc, out) != (rc_cpu, out_cpu):
            raise AssertionError(f"lint {label}: exit {rc} and its JSON differ "
                                 f"from DLS_PLATFORM=cpu's (exit {rc_cpu})")
        if any(ran.values()):
            raise AssertionError(f"lint {label}: kernels ran {ran}")
        codes = sorted({c for c, _ in lint_codes(out)})
        line["host_lints"][label] = dict(exit=rc, codes=codes, wall_s=wall)
        log(f"  a. lint {label}: exit {rc}, codes {codes}, equal to "
            f"DLS_PLATFORM=cpu's, no kernel ran, {wall:.2f} s")

    # b. the preflight on the card, then the serving lint
    argv = ["lint", "--model", "gpt2", "--preflight", "--json"]
    rc, out, err, wall, ran = cli_call(torch, main, argv)
    if rc != 0:
        raise AssertionError(f"lint --preflight exited {rc}: {err[-2000:]}")
    cst = [(d["code"], d["task"], d["data"]["analytic_gb"] * 1024,
            d["data"]["compiled_gb"] * 1024 if "compiled_gb" in d["data"]
            else None)
           for d in json.loads(out)["diagnostics"]
           if d["code"].startswith("CST")]
    pre = {k: ran.get(k, 0) for k in main_kernels}
    if min(pre.values()) < 1:
        raise AssertionError(f"lint --preflight: launches {pre}")
    counts["lint --preflight"] = pre
    line["preflight"] = dict(cst=cst, launches=pre, wall_s=wall)
    log(f"  b. lint --model gpt2 --preflight: exit 0, {len(cst)} CST "
        "diagnostics (code, task, analytic MB, measured MB) "
        f"{cst}; flash ran {pre[A.KERNEL]}, layer_norm ran "
        f"{pre[N.LN_KERNEL]} (each distinct task once), {wall:.2f} s")
    line["serving"] = {}
    for argv, want_rc, must in LINT_SERVING:
        label = " ".join(argv[1:-1])
        rc, out, err, wall, ran = cli_call(torch, main, argv)
        codes = lint_codes(out)
        errors = sorted({c for c, _ in lint_codes(out, "error")})
        n = {k: ran.get(k, 0) for k in (A.PAGED_KERNEL, N.LN_KERNEL)}
        if rc != want_rc or (must and must not in errors):
            raise AssertionError(f"lint {label}: exit {rc} (want {want_rc}), "
                                 f"errors {errors} (must name {must})")
        if not must and any(c.startswith(("PGL", "LCY", "DET"))
                            for c, _ in codes):
            raise AssertionError(f"lint {label}: {codes[:5]}")
        if n[A.PAGED_KERNEL] < 1:
            raise AssertionError(f"lint {label}: the paged kernel did not run")
        counts[f"lint {label}"] = n
        line["serving"][label] = dict(exit=rc, errors=errors, launches=n,
                                      wall_s=wall)
        log(f"  b. lint {label}: exit {rc}, errors {errors}; paged ran "
            f"{n[A.PAGED_KERNEL]}, layer_norm ran {n[N.LN_KERNEL]}, "
            f"{wall:.2f} s")

    # c. rankcheck through the CLI at its defaults: the cards --num-nodes
    # binds (one card: one node, so every policy places alike)
    rc, out, err, wall, ran = cli_call(torch, main, ["rankcheck", "--model",
                                                     "gpt2"])
    if rc not in (0, 1) or "Traceback" in err:
        raise AssertionError(f"rankcheck exited {rc}: {err[-2000:]}")
    rep = json.loads(out)
    counts["rankcheck"] = {k: ran.get(k, 0) for k in main_kernels}
    line["rankcheck_cli"] = dict(rank_summary(rep), exit=rc,
                                 launches=counts["rankcheck"], wall_s=wall)
    log(f"  c. rankcheck --model gpt2: exit {rc} on {rep['n_devices']} "
        f"node(s), winner_agreement {rep['winner_agreement']}, kendall_tau "
        f"{rep['kendall_tau']:.3f}, prediction_is_tie "
        f"{rep['prediction_is_tie']}; {wall:.2f} s")

    # d. run_rank_check on 8 nodes sharing the card, the same DAG
    cfg = RunConfig(model="gpt2")
    dag = cfg.build_graph()
    graph = dag.graph
    params, ids = dag.init_params(device=dev), dag.make_inputs(device=dev)
    one = P.Cluster.from_torch_devices([dev])
    single = P.DeviceBackend(one).execute(
        graph, P.get_scheduler("greedy").schedule(graph, one), params,
        ids).output.clone()
    cluster = P.Cluster.from_torch_devices([dev] * 8, hbm_cap_gb=cfg.hbm_gb)
    line["rank_on_8_nodes"] = {}
    for label, anchor in (("uncalibrated", False), ("anchor-calibrated", True)):
        kernels.reset_launches()
        t0 = time.perf_counter()
        with spied(P.DeviceBackend, "execute") as calls:
            rep = run_rank_check(graph, params, ids, policies=RANK_POLICIES,
                                 cluster=cluster,
                                 measure_repeats=RANK_REPEATS,
                                 anchor_calibrate=anchor, log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rep["n_policies"] != len(RANK_POLICIES):
            raise AssertionError(f"rank check ({label}): {rep['n_policies']} "
                                 f"of {len(RANK_POLICIES)} policies completed")
        placed = [c[2].output for c in calls if c[0][0].cluster is cluster]
        if len(placed) != len(RANK_POLICIES) * (1 + RANK_REPEATS):
            raise AssertionError(f"rank check ({label}): {len(placed)} runs")
        bad = [i for i, out in enumerate(placed)
               if not f32_close(single, out, "float32")]
        if bad:
            raise AssertionError(f"rank check ({label}): runs {bad} differ "
                                 "from the single node's output")
        del calls, placed
        n = ran_counts(main_kernels)
        counts[f"rank check 8 nodes {label}"] = n
        summary = rank_summary(rep)
        line["rank_on_8_nodes"][label] = dict(summary, launches=n,
                                              wall_s=wall)
        for p, r in summary["policies"].items():
            log(f"  d. {label} {p}: predicted {r['predicted_ms']:.3f} ms, "
                f"measured {r['measured_ms']:.3f} ms")
        log(f"  d. {label}: kendall_tau {rep['kendall_tau']:.3f}, "
            f"winner_agreement {rep['winner_agreement']}, tie "
            f"{rep['prediction_is_tie']}; every run equal to one node's "
            f"output (f32 rule); {n}; {wall:.1f} s")
    del params, ids, single

    # e. --stress: 4 cards or a one-line refusal
    rc, out, err, wall, _ = cli_call(torch, main, ["rankcheck", "--stress"])
    cards = torch.cuda.device_count()
    if cards < 4:
        if rc != 2 or out or len(err.strip().splitlines()) != 1:
            raise AssertionError(f"rankcheck --stress on {cards} card(s): "
                                 f"exit {rc}, stderr {err!r}")
        line["stress"] = dict(exit=rc, refusal=err.strip())
        log(f"  e. rankcheck --stress on {cards} card(s): exit 2, "
            f"{err.strip()!r}")
    else:
        if rc not in (0, 1):
            raise AssertionError(f"rankcheck --stress exited {rc}: "
                                 f"{err[-2000:]}")
        line["stress"] = dict(exit=rc, **rank_summary(json.loads(out)))
        log(f"  e. rankcheck --stress: exit {rc}, {line['stress']}")

    # f. the tracer at full width, on meta tensors
    small = P.GPT2Config.small()
    meta = {k: torch.empty(shape, dtype=dt, device="meta")
            for k, (shape, dt) in gpt2.param_shapes(small).items()}
    kernels.reset_launches()
    t0 = time.perf_counter()
    traced = trace_to_chain(lambda i: gpt2.forward(meta, i, small),
                            torch.zeros((1, 512), dtype=torch.int32,
                                        device="meta"), name="gpt2_small")
    wall = time.perf_counter() - t0
    want_gb = sum(t.numel() * t.element_size() for t in meta.values()) / 2**30
    if traced.total_param_gb() != want_gb or any(kernels.launches.values()):
        raise AssertionError(f"tracer: {traced.total_param_gb()} GB of params "
                             f"(want {want_gb}), launches {kernels.launches}")
    line["tracer"] = dict(tasks=len(traced), param_gb=want_gb, wall_s=wall)
    log(f"  f. trace_to_chain(GPT-2 small forward, meta): {len(traced)} "
        f"tasks, {want_gb:.4f} GB of params (every weight), {wall:.2f} s")
    return line, counts


# phase 22: the parallel layer on torch.distributed, one process per card
# (parallel/launch.spawn over every visible card).  a: GPT-2 small f32
# (config #5), batch 8, seq 512, make_train_step over factorize_mesh(n),
# 3 steps against the unsharded step on rank 0, then PAR_TIMED_STEPS steps
# timed one by one (the checked steps open cuBLAS and NCCL).  b: a
# checkpoint after step 2, resumed into a fresh state.  c: Llama-3 8B
# bf16, phase 19's input, tp = n, measure_decode_sharded; an f32 leg at 2
# layers holds the prefill logits and each decode step's (T = 1 over the
# rank's KV heads, logits gathered over tp) against the unsharded forward
# fed the same tokens, and the greedy tokens against the unsharded
# generate.  d: ring and Ulysses at Llama width, sp = n, bf16 and f32,
# against each other and mha (flash).
PAR_TRAIN = dict(batch=8, seq=512, steps=3)
PAR_TRAIN_TOL = 1e-4
PAR_TIMED_STEPS = 8
PAR_DECODE = dict(batch=8, prompt_len=512, new_tokens=32, reps=2)
PAR_F32_LAYERS = 2
PAR_F32_NEW = 8
PAR_ATTN = (1, 32, 8192, 128)


def _cuda_ms(torch, fn) -> tuple:
    """(result, ms) of one call of ``fn`` between CUDA events."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def _par_train(torch, dist, P, kernels, A, N, world) -> dict:
    """Part a and b on every rank; rank 0's numbers."""
    import tempfile

    from distributed_llm_scheduler_tpu_torch.models import gpt2
    from distributed_llm_scheduler_tpu_torch.parallel import train as T
    from distributed_llm_scheduler_tpu_torch.parallel.launch import device
    from distributed_llm_scheduler_tpu_torch.parallel.mesh import (
        factorize_mesh, make_mesh)
    from distributed_llm_scheduler_tpu_torch.utils.checkpoint import (
        load_state, save_state)

    rank, dev = dist.get_rank(), device()
    cfg = gpt2.GPT2Config.small()
    # tp at most 2, so four cards run dp2 x tp2: both axes at once
    axes = factorize_mesh(world, prefer_tp=2)
    mesh = make_mesh(**axes)
    whole = gpt2.init_params_numpy(cfg, 0)
    ids, tgt = (torch.from_numpy(a).to(dev) for a in T.train_batch(
        PAR_TRAIN["batch"], PAR_TRAIN["seq"], cfg.vocab_size))
    step, init = T.make_train_step(cfg, mesh)
    state = init(params=whole)
    with tempfile.TemporaryDirectory(prefix="dls_par_") as tmp:
        box = [tmp]
        dist.broadcast_object_list(box, src=0)
        ckpt = box[0] + "/ckpt"
        kernels.reset_launches()
        losses = []
        for i in range(PAR_TRAIN["steps"]):
            state, loss = step(state, ids, tgt)
            losses.append(float(loss))
            if i == 1:
                save_state(state, ckpt)
        launched = {k: kernels.launches.get(k, 0) for k in (A.KERNEL, N.LN_KERNEL)}
        resumed = load_state(ckpt, init(params=whole))
        if resumed.step != 2:
            raise AssertionError(f"resumed at step {resumed.step}, not 2")
        _, loss3 = step(resumed, ids, tgt)
        dist.barrier()
    ms = [_cuda_ms(torch, lambda: step(state, ids, tgt))[1]
          for _ in range(PAR_TIMED_STEPS)]
    out = {"mesh": axes, "losses": losses, "step_ms": ms,
           "step_ms_median": statistics.median(ms),
           "step_ms_min": min(ms), "step_ms_max": max(ms),
           "launches": launched,
           "launches_per_step": {k: v / PAR_TRAIN["steps"] for k, v in launched.items()},
           "resumed_loss": float(loss3)}
    if float(loss3) != losses[2]:
        raise AssertionError(f"resumed step 3 loss {float(loss3)!r} != "
                             f"uninterrupted {losses[2]!r}")
    if not all(launched.values()):
        raise AssertionError(f"the training step launched no kernel: {launched}")
    del state, resumed
    if rank == 0:  # the unsharded step on the same weights
        ref_step, ref_init = T.make_train_step(cfg, make_mesh())
        ref = ref_init(params=whole)
        ref_losses = [float(ref_step(ref, ids, tgt)[1])
                      for _ in range(PAR_TRAIN["steps"])]
        out["unsharded_losses"] = ref_losses
        for a, b in zip(losses, ref_losses):
            if abs(a - b) > PAR_TRAIN_TOL + PAR_TRAIN_TOL * abs(b):
                raise AssertionError(f"sharded losses {losses} off the "
                                     f"unsharded {ref_losses}")
        del ref
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def _par_decode(torch, dist, P, kernels, N, world) -> dict:
    """Part c on every rank; rank 0's numbers."""
    import functools

    from distributed_llm_scheduler_tpu_torch.eval.decode_bench import (
        measure_decode_sharded, prompt_ids)
    from distributed_llm_scheduler_tpu_torch.models import llama
    from distributed_llm_scheduler_tpu_torch.parallel.blocks import (
        FORWARD_CACHED, init_cache)
    from distributed_llm_scheduler_tpu_torch.parallel.decode import (
        generate_on_shards, shard_decode_params)
    from distributed_llm_scheduler_tpu_torch.parallel.launch import device
    from distributed_llm_scheduler_tpu_torch.parallel.mesh import make_mesh

    rank, dev = dist.get_rank(), device()
    mesh = make_mesh(tp=world)
    cfg = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16)
    kernels.reset_launches()
    res = measure_decode_sharded(cfg, tp=world, mesh=mesh, **PAR_DECODE)
    torch.cuda.synchronize()
    ran = kernels.ran(N.RMS_KERNEL)
    if not ran:
        raise AssertionError("TP decode ran no RMSNorm kernel")
    res["rms_norm_launches"] = ran
    torch.cuda.empty_cache()
    # f32 leg: the TP greedy tokens, and the logits of the TP prefill and
    # of each TP decode step fed those tokens, against the unsharded ones
    cfg32 = llama.LlamaConfig.llama3_8b(n_layers=PAR_F32_LAYERS)
    whole = llama.init_params_torch(cfg32, 0, device=dev)
    local = shard_decode_params(mesh, whole, cfg32)
    ids = prompt_ids(cfg32, PAR_DECODE["batch"], PAR_DECODE["prompt_len"], dev)
    with torch.no_grad():
        toks = generate_on_shards(local, ids, cfg32, mesh, PAR_F32_NEW)
        got = _cached_logits(
            functools.partial(FORWARD_CACHED["llama"], mesh=mesh), local,
            init_cache(cfg32, ids.shape[0], toks.shape[1], dev, mesh=mesh),
            toks, ids.shape[1], cfg32)
    if rank != 0:
        del whole
    else:
        with torch.no_grad():
            want = _cached_logits(
                llama.forward_cached, whole,
                llama.init_cache(cfg32, ids.shape[0], toks.shape[1], dev),
                toks, ids.shape[1], cfg32)
            ref = llama.generate(whole, ids, cfg32, PAR_F32_NEW)
        res["f32_leg"] = _hold_tp_decode(torch, got, want, toks, ref,
                                         ids.shape[1])
        del whole, want, ref
    del local, got
    torch.cuda.empty_cache()
    dist.barrier()
    return res


def _cached_logits(forward, params, cache, toks, T: int, config) -> list:
    """The logits of a prefill over ``toks[:, :T]``, then of a decode step
    (T = 1) over each next token of ``toks`` but the last: [(B, T, V),
    (B, 1, V), ...], the cache written in place as generation writes it."""
    logits, cache = forward(params, toks[:, :T], cache, 0, config)
    out = [logits]
    for pos in range(T, toks.shape[1] - 1):
        logits, cache = forward(params, toks[:, pos:pos + 1], cache, pos, config)
        out.append(logits)
    return out


def _hold_tp_decode(torch, got: list, want: list, toks, ref, T: int) -> dict:
    """Phase 22 c's f32 gates: every step's logits (the prefill's, then
    each decode step's) within F32_RTOL / F32_ATOL of the unsharded
    forward fed the same tokens, and the greedy tokens equal to the
    unsharded ``generate``'s.  A row may part only at a near tie: where
    it first parts, the two tokens' unsharded logits lie within twice
    the tolerance, so rounding inside it decides the argmax."""
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    close = [bool(torch.allclose(g, w, rtol=F32_RTOL, atol=F32_ATOL))
             for g, w in zip(got, want)]
    if len(got) != len(want) or not all(close):
        raise AssertionError(f"TP logits off the unsharded ones: max abs per "
                             f"step {errs} (prefill first)")
    if toks.shape != ref.shape or not torch.equal(toks[:, :T], ref[:, :T]):
        raise AssertionError("TP generate changed the prompt or its shape")
    ties = []
    for b in range(toks.shape[0]):
        parted = (toks[b, T:] != ref[b, T:]).nonzero()
        if not len(parted):
            continue
        j = int(parted[0])
        w = want[j][b, -1]
        a, c = w[ref[b, T + j]], w[toks[b, T + j]]
        gap = float((a - c).abs())
        if gap > 2 * (F32_ATOL + F32_RTOL * float(a.abs())):
            raise AssertionError(
                f"TP greedy tokens part from the unsharded generate's at row "
                f"{b}, token {j}, where their logits differ by {gap}: no tie")
        ties.append({"row": b, "token": j, "logit_gap": gap})
    return {"layers": PAR_F32_LAYERS, "steps": len(got),
            "max_abs_err": max(errs), "max_abs_err_per_step": errs,
            "token_agreement": float((toks == ref).float().mean()),
            "near_ties": ties}


def _par_attention(torch, dist, kernels, A, world) -> dict:
    """Part d on every rank; rank 0's numbers."""
    from distributed_llm_scheduler_tpu_torch.parallel.launch import device
    from distributed_llm_scheduler_tpu_torch.parallel.mesh import make_mesh
    from distributed_llm_scheduler_tpu_torch.parallel.ring_attention import (
        ring_attention_sharded)
    from distributed_llm_scheduler_tpu_torch.parallel.ulysses import (
        ulysses_attention_sharded)

    rank, dev = dist.get_rank(), device()
    mesh = make_mesh(sp=world)
    out = {}
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        q, k, v = (torch.randn(PAR_ATTN, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        # a first call of each, untimed: it opens the NCCL communicators
        ring = ring_attention_sharded(q, k, v, mesh)
        ring, ring_ms = _cuda_ms(torch, lambda: ring_attention_sharded(q, k, v, mesh))
        ulysses_attention_sharded(q, k, v, mesh)
        kernels.reset_launches()
        uly, uly_ms = _cuda_ms(torch, lambda: ulysses_attention_sharded(q, k, v, mesh))
        flash_n = kernels.launches.get(A.KERNEL, 0)
        if flash_n != 1:
            raise AssertionError(f"Ulysses launched flash {flash_n} times, not 1")
        bound, by = attention_bound_ms(PAR_ATTN, dname, True)
        row = {"ring_ms": ring_ms, "ulysses_ms": uly_ms, "flash_launches": flash_n,
               "flash_bound_ms": bound, "flash_bound_by": by}
        if rank == 0:
            A.mha(q, k, v, causal=True)
            ref, mha_ms = _cuda_ms(torch, lambda: A.mha(q, k, v, causal=True))
            tol = KERNEL_TOL[dname]
            errs = {"ring_vs_mha": float((ring.float() - ref.float()).abs().max()),
                    "ulysses_vs_mha": float((uly.float() - ref.float()).abs().max()),
                    "ring_vs_ulysses": float((ring.float() - uly.float()).abs().max())}
            row.update(errs, mha_ms=mha_ms, tol=tol)
            if max(errs.values()) > tol:
                raise AssertionError(f"sequence parallel {dname} off: {errs}")
            del ref
        out[dname] = row
        del q, k, v, ring, uly
        torch.cuda.empty_cache()
        dist.barrier()
    return out


def parallel_rank() -> dict:
    """Phase 22 on one rank of the world (every card); rank 0's numbers
    come back to :func:`run_parallel_path`."""
    import torch
    import torch.distributed as dist

    import distributed_llm_scheduler_tpu_torch as P
    from distributed_llm_scheduler_tpu_torch.ops import attention as A
    from distributed_llm_scheduler_tpu_torch.ops import kernels
    from distributed_llm_scheduler_tpu_torch.ops import norms as N

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = dist.get_world_size()
    out = {"world": world, "backend": dist.get_backend()}
    t = time.perf_counter()
    out["train"] = _par_train(torch, dist, P, kernels, A, N, world)
    out["train"]["seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    out["decode"] = _par_decode(torch, dist, P, kernels, N, world)
    out["decode"]["seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    out["attention"] = _par_attention(torch, dist, kernels, A, world)
    out["attention"]["seconds"] = time.perf_counter() - t
    return out


def run_parallel_path(torch, A, N) -> tuple:
    """Phase 22: :func:`parallel_rank` on every visible card through
    ``parallel.launch.spawn``.  Returns (PARALLEL_LINE dict, {run:
    {kernel: launches}})."""
    from distributed_llm_scheduler_tpu_torch.parallel import launch

    n = torch.cuda.device_count()
    log(f"  spawning a world of {n} (one process per card, NCCL)")
    t = time.perf_counter()
    line = launch.spawn(parallel_rank, n, timeout=900)
    line["seconds"] = time.perf_counter() - t
    tr, dec, att = line["train"], line["decode"], line["attention"]
    log(f"  world {line['world']} ({line['backend']}) of {n} cards; a. mesh "
        f"{tr['mesh']}: losses {tr['losses']} vs unsharded "
        f"{tr['unsharded_losses']}, ms per step (median of "
        f"{len(tr['step_ms'])} after the checked steps) {tr['step_ms_median']:.2f}, "
        f"range {tr['step_ms_min']:.2f}-{tr['step_ms_max']:.2f} ({tr['step_ms']}), launches "
        f"per step {tr['launches_per_step']}; b. resumed step 3 loss "
        f"{tr['resumed_loss']} (uninterrupted {tr['losses'][2]})")
    log(f"  c. Llama-3 8B bf16 tp {dec['tp']}: {dec['ms_per_token_step']:.3f} ms "
        f"per token, {dec['decode_tok_s']:.1f} tok/s, RMSNorm ran "
        f"{dec['rms_norm_launches']}; f32 leg {dec['f32_leg']}")
    for dname, row in att.items():
        if isinstance(row, dict):
            log(f"  d. {dname} {PAR_ATTN}: ring {row['ring_ms']:.2f} ms, Ulysses "
                f"{row['ulysses_ms']:.2f} ms, mha {row['mha_ms']:.2f} ms (bound "
                f"{row['flash_bound_ms']:.3f} ms, {row['flash_bound_by']}); max abs "
                f"ring-mha {row['ring_vs_mha']:.3g}, ulysses-mha "
                f"{row['ulysses_vs_mha']:.3g}, ring-ulysses "
                f"{row['ring_vs_ulysses']:.3g} (tol {row['tol']})")
    counts = {
        "train": dict(tr["launches"]),
        "decode": {N.RMS_KERNEL: dec["rms_norm_launches"]},
        "ulysses": {A.KERNEL: sum(
            row["flash_launches"] for row in att.values() if isinstance(row, dict))},
    }
    return line, counts


COMPILED_SAMPLES = 5
COMPILED_NODES = 8


def _ms_stats(reports) -> dict:
    ms = [r.makespan_s * 1e3 for r in reports]
    return {"median_ms": statistics.median(ms), "min_ms": min(ms),
            "max_ms": max(ms), "samples_ms": ms}


def run_compiled_cards_path(torch, P, A, N) -> tuple:
    """Phase 23: the flagship's compiled rung in a world of one process per
    visible card against the planned rung, then the ladder's two benches.
    Returns (COMPILED_CARDS_LINE dict, {run: {kernel: launches}})."""
    from distributed_llm_scheduler_tpu_torch.eval import compiled_bench as CB
    from distributed_llm_scheduler_tpu_torch.eval import dispatch_bench as DB

    n = torch.cuda.device_count()
    cfg = P.GPT2Config.small(dtype=torch.bfloat16)
    dag = P.build_gpt2_dag(cfg, **FLAGSHIP)
    graph = P.fuse_linear_chains(dag.graph)
    if len(graph) != FLAGSHIP_TASKS:
        raise AssertionError(f"flagship has {len(graph)} tasks")
    n_attn = sum(1 for t in graph if t.task_id.endswith("_attention"))
    n_ln = sum(1 for t in dag.graph
               if t.task_id.endswith(("_ln1", "_ln2", "final_ln")))
    params = dag.init_params(seed=0, device="cpu")
    ids = dag.make_inputs(seed=1, device="cpu")
    cards = [torch.device("cuda", i % n) for i in range(COMPILED_NODES)]
    cluster = P.Cluster.from_torch_devices(cards)
    sched = P.get_scheduler("heft").schedule(graph, cluster)
    if sched.failed or len(sched.completed) != len(graph):
        raise AssertionError(f"heft x8: {len(sched.failed)} tasks failed")
    backend = P.DeviceBackend(cluster, world=True)
    line = {"cards": n, "nodes": COMPILED_NODES, "tasks": len(graph)}
    try:
        planned = backend.execute(graph, sched, params, ids)
        want = planned.output
        line["planned"] = _ms_stats([
            backend.execute(graph, sched, params, ids, warmup=False)
            for _ in range(COMPILED_SAMPLES)])
        t0 = time.perf_counter()
        first = backend.execute(graph, sched, params, ids, compiled=True)
        build_s = time.perf_counter() - t0
        got = first.output
        if not torch.equal(got, want.to(got.device)):
            raise AssertionError("the world's output differs from the "
                                 "planned rung's")
        fused = dag.reference_forward(
            {k: v.to(got.device) for k, v in params.items()},
            ids.to(got.device))
        ok, viol, allowed, rel = oracle_close(fused, got)
        if not (ok and bool(torch.isfinite(got).all())):
            raise AssertionError(f"the world's output fails the oracle: "
                                 f"{viol} > {allowed} or rel {rel:.3e}")
        del fused
        runs = [backend.execute(graph, sched, params, ids, compiled=True,
                                warmup=False)
                for _ in range(COMPILED_SAMPLES)]
        rep = runs[-1]
        w = rep.world
        line["world"] = _ms_stats(runs)
        bound = 2  # the ids' copy and the replay
        if rep.n_dispatches > bound:
            raise AssertionError(f"{rep.n_dispatches} host calls per run > "
                                 f"{bound}")
        ran = w["ran_by_rank"]
        for r, counts in enumerate(ran):
            if counts.get(A.KERNEL, 0) <= 0 or counts.get(N.LN_KERNEL, 0) <= 0:
                raise AssertionError(f"rank {r} ran {counts}")
        total = {k: sum(c.get(k, 0) for c in ran)
                 for k in (A.KERNEL, N.LN_KERNEL)}
        if total != {A.KERNEL: n_attn, N.LN_KERNEL: n_ln}:
            raise AssertionError(f"the ranks ran {total} per run, one "
                                 f"forward is {n_attn} flash, {n_ln} LN")
        line.update(
            ranks=w["ranks"], start_s=w["start_s"], first_execute_s=build_s,
            n_dispatches=rep.n_dispatches,
            n_dispatches_sum=w["n_dispatches_sum"],
            makespan_spread_ms=w["makespan_spread_s"] * 1e3,
            makespan_ms_by_rank=[x * 1e3 for x in w["makespan_s_by_rank"]],
            dispatch_ms_by_rank=[
                x * 1e3 for x in w["dispatch_overhead_s_by_rank"]],
            exchanges=rep.transfer_edges, exchange_bytes=rep.transfer_bytes,
            build_s_by_rank=w["build_s_by_rank"],
            exchanges_across_cards=w["exchanges_across_ranks"],
            bytes_across_cards=w["bytes_across_ranks"],
            ran_by_rank=ran, captured_by_rank=w["captured_by_rank"],
            oracle={"violations": viol, "allowed": allowed, "rel_fro": rel},
            bit_equal_to_planned=True)
        log(f"  a. world of {w['ranks']} on {n} card(s), started in "
            f"{w['start_s']:.1f} s (first execute {build_s:.1f} s): makespan "
            f"median {line['world']['median_ms']:.3f} ms (range "
            f"{line['world']['min_ms']:.3f}-{line['world']['max_ms']:.3f}, "
            f"spread across ranks {line['makespan_spread_ms']:.3f}) vs "
            f"planned {line['planned']['median_ms']:.3f} ms (range "
            f"{line['planned']['min_ms']:.3f}-"
            f"{line['planned']['max_ms']:.3f}); {rep.transfer_edges} "
            f"exchanges ({rep.transfer_bytes / 1024**2:.1f} MiB), "
            f"{w['exchanges_across_ranks']} across cards "
            f"({w['bytes_across_ranks'] / 1024**2:.1f} MiB); "
            f"{rep.n_dispatches} host calls per rank per run "
            f"({w['n_dispatches_sum']} in all); ran per rank {ran}; "
            f"bit-equal to planned, oracle rel {rel:.3e}")
        if n == 1:  # the world of one against the in-process compiled rung
            # (its capture copies the input on the card, and reads the
            # params where they were placed: both go there once)
            one = P.DeviceBackend(cluster)
            on_card = {k: v.to(got.device) for k, v in params.items()}
            ids_dev = ids.to(got.device)
            inproc = one.execute(graph, sched, on_card, ids_dev, compiled=True)
            if not torch.equal(inproc.output, got):
                raise AssertionError("the world of one differs from the "
                                     "in-process compiled rung")
            line["in_process"] = _ms_stats([
                one.execute(graph, sched, on_card, ids_dev, compiled=True,
                            warmup=False)
                for _ in range(COMPILED_SAMPLES)])
            log(f"  a. world of one bit-equal to the in-process compiled "
                f"rung (median {line['in_process']['median_ms']:.3f} ms)")
            del one, inproc, on_card
        del planned, want, got, first, runs, rep  # the world's output too
    finally:
        backend.close()
    gc_cuda(torch)

    def sub(msg: str) -> None:
        log("    " + msg)

    benches = {}
    for name, run, gates in (
            ("dispatch", DB.run_dispatch_bench,
             lambda r: DB.evaluate_gates(r, *DB.GATES, sub)),
            ("compiled", CB.run_compiled_bench,
             lambda r: CB.evaluate_gates(r, *CB.GATES, sub))):
        t0 = time.perf_counter()
        log(f"  b. {name} bench at the reference's defaults")
        report = run(log=sub)
        gates(report)
        report["seconds"] = time.perf_counter() - t0
        print(f"{name.upper()}_BENCH_LINE " + json.dumps(report), flush=True)
        if not report["bit_identical"]:
            raise AssertionError(f"{name} bench: outputs not bit-identical")
        legs = report["legs"]
        benches[name] = {"gates": report["gates"],
                         "seconds": report["seconds"]}
        for key in ("makespan_ms", "dispatch_overhead_ms"):
            benches[name][key] = {k: v[key] for k, v in legs.items()
                                  if key in v}
    seg = report["stand_ins"]["segmented"]
    if not seg["rebatched_allclose"]:
        raise AssertionError(f"compiled bench: the re-batched segmented "
                             f"output is {seg['rebatched_max_abs_err']:.3e} "
                             f"from planned")
    benches["compiled"]["rebatched"] = {
        k: seg[k] for k in ("rebatched_bit_identical",
                            "rebatched_max_abs_err", "rebatched_allclose")}
    launches = report["legs"]["compiled"]["n_dispatches"]
    budget = report["n_devices"] + CB.GATES[2]
    if launches > budget:
        raise AssertionError(f"compiled bench: {launches} launches > "
                             f"{budget}")
    line["benches"] = benches
    counts = {"heft x8 world": total}
    return line, counts


# phase 24: expert and pipeline parallelism on torch.distributed, one world
# of one process per card (parallel/launch.World over every visible card)
# for legs a-c, each rank's launches, peak GiB and numbers gathered.  a:
# the dp x ep Mixtral step at Mixtral-8x7B widths (ep = the cards, dp the
# rest), batch 2, seq 512 (phase 18's), dense and routed (capacity 2.0):
# bf16 at MOE_LAYERS layers, EP_CHECKED steps checked then PAR_TIMED_STEPS
# timed; f32 at 1 layer, its losses held against the unsharded per-expert
# step on rank 0 at PAR_TRAIN_TOL and its routed dropped slots equal.  b:
# the GPipe training step of GPT-2 small f32 (config #5: batch 8, seq 512,
# pp = the cards, 8 microbatches) against the unsharded step on rank 0.
# c: the pipeline forward of Llama-3 8B widths at PP_LLAMA_LAYERS layers,
# bf16, against the plain forward under the bf16 oracle rule.  d: the
# CLI's train --model mixtral-tiny --routed and train --model gpt2 --pp n.
EP_CHECKED = 3
EP_BATCH = dict(batch=2, seq=512)
EP_CAPACITY = 2.0
EP_SQUEEZE = 0.5  # a capacity below the average load: the f32 leg's drops
PP_TRAIN = dict(batch=8, seq=512, microbatches=8, steps=3)
PP_LLAMA = dict(batch=4, seq=512, microbatches=4)
PP_LLAMA_LAYERS = 8


def _peak_gib(torch) -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def _expect(label: str, want: dict) -> dict:
    """The flash, LayerNorm and RMSNorm launches that ran since the counts
    were set to 0, which must equal ``want``."""
    got = ran_counts(want)
    if got != want:
        raise AssertionError(f"{label}: launches {got} != {want}")
    return got


def _ep_batch(torch, cfg, dev):
    from distributed_llm_scheduler_tpu_torch.parallel.train import train_batch

    return tuple(torch.from_numpy(a).to(dev) for a in train_batch(
        EP_BATCH["batch"], EP_BATCH["seq"], cfg.vocab_size))


def _routed_stats_ref(torch, mixtral, params, ids, cfg, capacity) -> int:
    """Dropped slots of the unsharded per-expert routed forward (the
    models' own ``moe_routed`` with stats) at ``capacity``, summed over
    the layers."""
    dropped = 0
    with torch.no_grad():
        x = mixtral.embedding(ids, params["tok_emb"])
        keys = mixtral._layer_keys(cfg)
        for i in range(cfg.n_layers):
            bp = {k: params[f"l{i}_{k}"] for k in keys}
            h = mixtral.rms_norm(x, bp["attn_norm_g"], cfg.rms_eps)
            x = x + mixtral.gqa_attention(h, bp["wq"], bp["wk"], bp["wv"],
                                          bp["wo"], cfg.n_heads, cfg.n_kv_heads,
                                          cfg.rope_theta)
            h = mixtral.rms_norm(x, bp["ffn_norm_g"], cfg.rms_eps)
            out, st = mixtral.moe_routed(bp, h, cfg, capacity, with_stats=True)
            x = x + out
            dropped += int(st["dropped_slots"])
    return dropped


def _ep_bf16(torch, dist, kernels, A, N, world) -> dict:
    """Part a's bf16 legs on this rank: dense and routed."""
    import functools

    from distributed_llm_scheduler_tpu_torch.models import mixtral
    from distributed_llm_scheduler_tpu_torch.parallel.expert import (
        expert_mesh_axes, make_moe_train_step)
    from distributed_llm_scheduler_tpu_torch.parallel.launch import device
    from distributed_llm_scheduler_tpu_torch.parallel.mesh import make_axes_mesh

    dev = device()
    cfg = mixtral.MixtralConfig.mixtral_8x7b(n_layers=MOE_LAYERS,
                                             dtype=torch.bfloat16)
    dp, ep = expert_mesh_axes(cfg.n_experts, world)
    mesh = make_axes_mesh(dp=dp, ep=ep)
    ids, tgt = _ep_batch(torch, cfg, dev)
    # the per-tensor update: foreach's list temporaries would not fit
    # beside 4 layers' params, gradients and moments on one card
    opt = functools.partial(torch.optim.AdamW, lr=3e-4, weight_decay=0.01,
                            foreach=False)
    out = {"mesh": {"dp": dp, "ep": ep}, "layers": MOE_LAYERS}
    L = cfg.n_layers
    for label, routed in (("dense", False), ("routed", True)):
        torch.cuda.reset_peak_memory_stats()
        step, init = make_moe_train_step(cfg, mesh, optimizer=opt, routed=routed,
                                         capacity_factor=EP_CAPACITY)
        state = init(params=mixtral.iter_params_torch(cfg, 0, dev))
        kernels.reset_launches()
        losses = [float(step(state, ids, tgt)[1]) for _ in range(EP_CHECKED)]
        launched = _expect(f"a. {label} bf16", {
            A.KERNEL: L * EP_CHECKED, N.LN_KERNEL: 0,
            N.RMS_KERNEL: (2 * L + 1) * EP_CHECKED})
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"a. {label} bf16 losses {losses}")
        ms = [_cuda_ms(torch, lambda: step(state, ids, tgt))[1]
              for _ in range(PAR_TIMED_STEPS)]
        out[label] = {"losses": losses, "launches": launched,
                      "step_ms": ms, "step_ms_median": statistics.median(ms),
                      "step_ms_min": min(ms), "step_ms_max": max(ms),
                      "peak_gib": _peak_gib(torch)}
        del state, step, init
        torch.cuda.empty_cache()
        dist.barrier()
    return out


def _ep_f32(torch, dist, kernels, A, N, world) -> dict:
    """Part a's f32 leg at 1 layer: dense and routed EP steps, each held
    against the unsharded per-expert step on rank 0; the routed forward's
    dropped slots against the unsharded routed forward's."""
    from distributed_llm_scheduler_tpu_torch.models import mixtral
    from distributed_llm_scheduler_tpu_torch.parallel.expert import (
        expert_mesh_axes, forward_ep_stats, make_moe_train_step)
    from distributed_llm_scheduler_tpu_torch.parallel.launch import device
    from distributed_llm_scheduler_tpu_torch.parallel.mesh import (
        make_axes_mesh, make_mesh)
    from distributed_llm_scheduler_tpu_torch.parallel.sharding import Sharding
    from distributed_llm_scheduler_tpu_torch.parallel.train import make_step_from_loss

    rank, dev = dist.get_rank(), device()
    cfg = mixtral.MixtralConfig.mixtral_8x7b(n_layers=1)
    dp, ep = expert_mesh_axes(cfg.n_experts, world)
    mesh = make_axes_mesh(dp=dp, ep=ep)
    ids, tgt = _ep_batch(torch, cfg, dev)
    out = {}
    for label, routed in (("dense", False), ("routed", True)):
        step, init = make_moe_train_step(cfg, mesh, routed=routed,
                                         capacity_factor=EP_CAPACITY)
        state = init(params=mixtral.iter_params_torch(cfg, 0, dev))
        row = {}
        if routed:  # the drops at the training capacity and at the squeeze
            row["dropped_slots"], row["total_slots"] = [], 0
            for cf in (EP_CAPACITY, EP_SQUEEZE):
                with torch.no_grad():
                    _, st = forward_ep_stats(
                        state.params, Sharding(mesh, ("dp", None)).shard(ids),
                        cfg, cf, mesh=mesh)
                row["dropped_slots"].append(int(st["dropped_slots"]))
                row["total_slots"] = int(st["total_slots"])
        row["losses"] = [float(step(state, ids, tgt)[1]) for _ in range(EP_CHECKED)]
        del state, step, init
        torch.cuda.empty_cache()
        if rank == 0:  # the per-expert model, one device, the same AdamW
            whole = mixtral.init_params_torch(cfg, 0, dev)

            def loss(p, i, t):
                return mixtral.loss_fn(p, i, t, cfg, routed=routed,
                                       capacity_factor=EP_CAPACITY)

            if routed:
                row["unsharded_dropped_slots"] = [
                    _routed_stats_ref(torch, mixtral, whole, ids, cfg, cf)
                    for cf in (EP_CAPACITY, EP_SQUEEZE)]
            ref_step, ref_init = make_step_from_loss(
                loss, lambda seed, p: {k: v for k, v in whole.items()})
            ref = ref_init()
            row["unsharded_losses"] = [float(ref_step(ref, ids, tgt)[1])
                                       for _ in range(EP_CHECKED)]
            del ref, whole, ref_step, ref_init
            torch.cuda.empty_cache()
            for a, b in zip(row["losses"], row["unsharded_losses"]):
                if abs(a - b) > PAR_TRAIN_TOL + PAR_TRAIN_TOL * abs(b):
                    raise AssertionError(f"a. f32 {label}: EP losses {row['losses']} "
                                         f"off the unsharded {row['unsharded_losses']}")
            if routed and (row["dropped_slots"] != row["unsharded_dropped_slots"]
                           or not row["dropped_slots"][1]):
                raise AssertionError(f"a. f32 routed: {row['dropped_slots']} slots "
                                     f"dropped at capacities {EP_CAPACITY} and "
                                     f"{EP_SQUEEZE}, unsharded "
                                     f"{row['unsharded_dropped_slots']}")
        out[label] = row
        dist.barrier()
    return out


def _pp_train(torch, dist, kernels, A, N, world) -> dict:
    """Part b on this rank."""
    from distributed_llm_scheduler_tpu_torch.models import gpt2
    from distributed_llm_scheduler_tpu_torch.parallel import train as T
    from distributed_llm_scheduler_tpu_torch.parallel.launch import device
    from distributed_llm_scheduler_tpu_torch.parallel.mesh import (
        make_axes_mesh, make_mesh)
    from distributed_llm_scheduler_tpu_torch.parallel.pipeline_pp import (
        make_pp_train_step)

    rank, dev = dist.get_rank(), device()
    cfg = gpt2.GPT2Config.small()
    S, M = world, PP_TRAIN["microbatches"]
    mesh = make_axes_mesh(pp=S)
    whole = gpt2.init_params_numpy(cfg, 0)
    ids, tgt = (torch.from_numpy(a).to(dev) for a in T.train_batch(
        PP_TRAIN["batch"], PP_TRAIN["seq"], cfg.vocab_size))
    torch.cuda.reset_peak_memory_stats()
    step, init = make_pp_train_step(cfg, mesh, M)
    state = init(params=whole)
    kernels.reset_launches()
    losses = [float(step(state, ids, tgt)[1]) for _ in range(PP_TRAIN["steps"])]
    per = cfg.n_layer // S
    launched = _expect("b. pipeline step", {
        A.KERNEL: per * M * PP_TRAIN["steps"], N.RMS_KERNEL: 0,
        N.LN_KERNEL: (2 * per * M + 1) * PP_TRAIN["steps"]})
    ms = [_cuda_ms(torch, lambda: step(state, ids, tgt))[1]
          for _ in range(PAR_TIMED_STEPS)]
    out = {"pp": S, "microbatches": M, "losses": losses, "launches": launched,
           "step_ms": ms, "step_ms_median": statistics.median(ms),
           "step_ms_min": min(ms), "step_ms_max": max(ms),
           "peak_gib": _peak_gib(torch)}
    del state, step, init
    torch.cuda.empty_cache()
    if rank == 0:  # the unsharded step on the same weights
        ref_step, ref_init = T.make_train_step(cfg, make_mesh())
        ref = ref_init(params=whole)
        out["unsharded_losses"] = [float(ref_step(ref, ids, tgt)[1])
                                   for _ in range(PP_TRAIN["steps"])]
        del ref
        torch.cuda.empty_cache()
        for a, b in zip(losses, out["unsharded_losses"]):
            if abs(a - b) > PAR_TRAIN_TOL + PAR_TRAIN_TOL * abs(b):
                raise AssertionError(f"b. pipeline losses {losses} off the "
                                     f"unsharded {out['unsharded_losses']}")
    dist.barrier()
    return out


def _pp_llama(torch, dist, kernels, A, N, world) -> dict:
    """Part c on this rank."""
    from distributed_llm_scheduler_tpu_torch.eval.decode_bench import prompt_ids
    from distributed_llm_scheduler_tpu_torch.models import llama
    from distributed_llm_scheduler_tpu_torch.parallel.launch import device
    from distributed_llm_scheduler_tpu_torch.parallel.mesh import make_axes_mesh
    from distributed_llm_scheduler_tpu_torch.parallel.pipeline_pp import (
        pipeline_forward, stage_param_names)

    rank, dev = dist.get_rank(), device()
    cfg = llama.LlamaConfig.llama3_8b(n_layers=PP_LLAMA_LAYERS,
                                      dtype=torch.bfloat16)
    S, M = world, PP_LLAMA["microbatches"]
    mesh = make_axes_mesh(pp=S)
    keep = set(stage_param_names(cfg, S, rank))
    params = {k: v for k, v in llama.iter_params_torch(cfg, 0, dev)
              if rank == 0 or k in keep}
    ids = prompt_ids(cfg, PP_LLAMA["batch"], PP_LLAMA["seq"], dev)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        pipeline_forward(params, ids, cfg, mesh, M)  # opens the hops' channels
        kernels.reset_launches()
        logits, ms = _cuda_ms(torch, lambda: pipeline_forward(params, ids, cfg,
                                                              mesh, M))
    per = cfg.n_layers // S
    launched = _expect("c. Llama pipeline forward", {
        A.KERNEL: per * M, N.LN_KERNEL: 0, N.RMS_KERNEL: 2 * per * M + 1})
    out = {"pp": S, "microbatches": M, "layers": PP_LLAMA_LAYERS, "ms": ms,
           "launches": launched, "peak_gib": _peak_gib(torch)}
    if rank == 0:
        with torch.no_grad():
            want, plain_ms = _cuda_ms(torch, lambda: llama.forward(params, ids, cfg))
        ok, viol, allowed, rel = oracle_close(want, logits)
        out.update(plain_ms=plain_ms, oracle_ok=ok, violations=viol,
                   allowed=allowed, rel_fro=rel)
        if not ok:
            raise AssertionError(f"c. Llama pipeline logits off the plain forward: "
                                 f"{viol} > {allowed} outside the band, rel {rel}")
        del want
    del params, logits
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def expert_pipeline_rank() -> dict:
    """Phase 24 a-c on one rank of the world (every card); each rank's
    numbers come back to :func:`run_expert_pipeline_path`."""
    import torch
    import torch.distributed as dist

    from distributed_llm_scheduler_tpu_torch.ops import attention as A
    from distributed_llm_scheduler_tpu_torch.ops import kernels
    from distributed_llm_scheduler_tpu_torch.ops import norms as N

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = dist.get_world_size()
    out = {"rank": dist.get_rank(), "world": world, "backend": dist.get_backend()}
    for key, leg in (("moe_bf16", _ep_bf16), ("moe_f32", _ep_f32),
                     ("pp_train", _pp_train), ("pp_llama", _pp_llama)):
        t = time.perf_counter()
        out[key] = leg(torch, dist, kernels, A, N, world)
        out[key]["seconds"] = time.perf_counter() - t
    return out


def run_expert_pipeline_path(torch, A, N) -> tuple:
    """Phase 24: :func:`expert_pipeline_rank` on every visible card in one
    ``parallel.launch.World``, then part d through the port's
    ``__main__``.  Returns (EXPERT_PIPELINE_LINE dict, {run: {kernel:
    launches per rank}})."""
    from distributed_llm_scheduler_tpu_torch.__main__ import main
    from distributed_llm_scheduler_tpu_torch.parallel import launch

    n = torch.cuda.device_count()
    log(f"  a world of {n} (one process per card, NCCL)")
    t = time.perf_counter()
    w = launch.World(n, timeout=900)
    try:
        ranks = w.call(expert_pipeline_rank)
    finally:
        w.close()
    r0 = ranks[0]
    line = {"world": r0["world"], "backend": r0["backend"],
            "start_s": w.start_s, "world_s": time.perf_counter() - t}
    for key in ("moe_bf16", "moe_f32", "pp_train", "pp_llama"):
        line[key] = r0[key]
    gib = line["peak_gib_per_rank"] = {
        "moe_bf16 dense": [r["moe_bf16"]["dense"]["peak_gib"] for r in ranks],
        "moe_bf16 routed": [r["moe_bf16"]["routed"]["peak_gib"] for r in ranks],
        "pp_train": [r["pp_train"]["peak_gib"] for r in ranks],
        "pp_llama": [r["pp_llama"]["peak_gib"] for r in ranks]}
    counts = {}
    for r in ranks:
        for key, sub in (("moe_bf16", "dense"), ("moe_bf16", "routed")):
            counts[f"moe {sub} bf16 rank {r['rank']}"] = r[key][sub]["launches"]
        counts[f"pp train rank {r['rank']}"] = r["pp_train"]["launches"]
        counts[f"pp llama rank {r['rank']}"] = r["pp_llama"]["launches"]
    mb, f32, pt, pl = (line[k] for k in ("moe_bf16", "moe_f32", "pp_train", "pp_llama"))
    log(f"  world {line['world']} ({line['backend']}) of {n} cards, started in "
        f"{line['start_s']:.1f} s")
    for sub in ("dense", "routed"):
        r = mb[sub]
        log(f"  a. Mixtral-8x7B widths, {MOE_LAYERS} layers, bf16, {sub}, mesh "
            f"{mb['mesh']}: losses {r['losses']}; ms per step (median of "
            f"{len(r['step_ms'])}) {r['step_ms_median']:.2f}, range "
            f"{r['step_ms_min']:.2f}-{r['step_ms_max']:.2f}; launches per rank "
            f"over {EP_CHECKED} steps {r['launches']}; peak GiB per rank "
            f"{gib['moe_bf16 ' + sub]}")
    for sub in ("dense", "routed"):
        log(f"  a. f32, 1 layer, {sub}: EP losses {f32[sub]['losses']} vs "
            f"unsharded {f32[sub]['unsharded_losses']}"
            + (f"; dropped slots at capacity {EP_CAPACITY} and {EP_SQUEEZE} "
               f"{f32[sub]['dropped_slots']} of {f32[sub]['total_slots']} "
               f"(unsharded {f32[sub]['unsharded_dropped_slots']})"
               if sub == "routed" else ""))
    log(f"  b. GPT-2 small f32 pipeline, pp {pt['pp']}, {pt['microbatches']} "
        f"microbatches: losses {pt['losses']} vs unsharded {pt['unsharded_losses']}; "
        f"peak GiB per rank {gib['pp_train']}; "
        f"ms per step (median of {len(pt['step_ms'])}) {pt['step_ms_median']:.2f}, "
        f"range {pt['step_ms_min']:.2f}-{pt['step_ms_max']:.2f} (phase 22 times the "
        f"dp x tp step on the same batch); launches per rank "
        f"{pt['launches']}")
    log(f"  c. Llama-3 8B widths, {pl['layers']} layers, bf16 pipeline forward, pp "
        f"{pl['pp']}: {pl['ms']:.2f} ms (plain {pl['plain_ms']:.2f}), oracle "
        f"{pl['oracle_ok']} (rel_fro {pl['rel_fro']:.3e}, {pl['violations']} "
        f"outside the band); launches per rank {pl['launches']}; peak GiB per "
        f"rank {gib['pp_llama']}")
    # d. the CLI on the card: each command starts its own world
    line["cli"] = {}
    for label, argv in (
            ("mixtral-tiny routed", ["train", "--model", "mixtral-tiny",
                                     "--routed", "--steps", "2"]),
            (f"gpt2 pp {n}", ["train", "--model", "gpt2", "--pp", str(n),
                              "--steps", "2"])):
        rc, out, err, wall, _ = cli_call(torch, main, argv)
        steps = [ln for ln in out.splitlines() if ln.startswith("step ")]
        if rc != 0 or [ln.split(":")[0] for ln in steps] != ["step 1", "step 2"]:
            raise AssertionError(f"d. `{' '.join(argv)}` exited {rc}: {out!r} "
                                 f"{err[-2000:]!r}")
        line["cli"][label] = {"exit": rc, "stdout": steps, "wall_s": wall,
                              "stderr_last": err.strip().splitlines()[-1:]}
        log(f"  d. `{' '.join(argv)}`: exit 0, {steps}, {wall:.1f} s")
    line["launches_per_rank"] = counts
    return line, counts


# phase 25: the record tools.  a: ``lint --parallel`` (and ``--json``)
# through the port's __main__ on the cards' count, then the collective
# sweep on a simulated world of ARTIFACT_SIM_RANKS ranks, each probe's
# recorded collectives printed.  b: ``capture_artifacts.main([n,
# "train"])`` at full size into a temporary directory (phase 18 a's run
# when the whole script runs): exit 0, the TRAIN record's fields, flash
# and LayerNorm launches counted.  c: ``rankcheck_artifact.main``: its
# refusal below four cards, both legs on four.
ARTIFACT_ROUND = 23
ARTIFACT_SIM_RANKS = 8
#: the keys tests/test_artifacts_schema.py asks of the JAX TRAIN record
TRAIN_RECORD_KEYS = ("model", "platform", "oracle_ok", "policies",
                     "executed_step_ms")


@contextlib.contextmanager
def records_under(module, root: Path):
    """``module``'s records (and ``capture_artifacts``' calibration cache)
    under ``root`` while the block runs."""
    names = [n for n in ("REPO_ROOT", "CACHE_DIR") if hasattr(module, n)]
    saved = {n: getattr(module, n) for n in names}
    module.REPO_ROOT = str(root)
    if "CACHE_DIR" in saved:
        module.CACHE_DIR = str(root / ".costmodel_torch")
    try:
        yield root
    finally:
        for n, v in saved.items():
            setattr(module, n, v)


def capture_record(CA, root: Path, leg: str) -> tuple:
    """``capture_artifacts.main([ARTIFACT_ROUND, leg])`` writing under
    ``root``: (its record, exit code)."""
    with records_under(CA, root):
        rc = CA.main([str(ARTIFACT_ROUND), leg])
    prefix = CA.LEGS[leg][0]
    return json.loads((root / f"{prefix}_TORCH_r{ARTIFACT_ROUND:02d}.json")
                      .read_text()), rc


def capture_train_leg(torch, P) -> tuple:
    """The train capture leg at full size (a fresh calibration: 1 warm-up
    + 3 profile steps, the anchor's 2, the oracle's 4 and 4 timed) in a
    temporary directory, its launches counted: (record, launches)."""
    import tempfile

    from distributed_llm_scheduler_tpu_torch.eval import capture_artifacts as CA

    per_step, per_ref = train_launches(P.GPT2Config.small().n_layer)
    bench_steps = 2 + 4 + 4
    with tempfile.TemporaryDirectory() as td:
        (rec, rc), counts = counted(
            "train capture",
            {k: n * bench_steps + per_ref[k] for k, n in per_step.items()},
            lambda: capture_record(CA, Path(td), "train"))
    missing = [k for k in TRAIN_RECORD_KEYS if k not in rec]
    bad = [p for p, r in rec.get("policies", {}).items()
           if not (r["makespan_ms"] > 0 and 0 < r["completion"] <= 1)]
    if (rc != 0 or CA._has_error(rec) or missing or bad
            or not rec["oracle_ok"] or len(rec["policies"]) != 10
            or rec["platform"] != "cuda" or rec["card"] != nvidia_smi_line()):
        raise AssertionError(f"train capture: exit {rc}, missing {missing}, "
                             f"policies off {bad}: {json.dumps(rec)[:2000]}")
    return rec, counts


def collectives_summary(seqs: dict) -> dict:
    """One probe's recorded collectives: how many each rank issued, rank
    0's in order (op, shapes, perm, group), a run of equal ones as one
    entry with its count."""
    runs = []
    for c in seqs[0]:
        text = c.describe() + f" on {list(c.group)}"
        if runs and runs[-1][1] == text:
            runs[-1][0] += 1
        else:
            runs.append([1, text])
    return {"per_rank": [len(seqs[r]) for r in sorted(seqs)],
            "rank0": [f"{n} x {t}" if n > 1 else t for n, t in runs]}


def run_artifacts_path(torch, P, A, N, train=None) -> tuple:
    """Phase 25, a-c (``train``: phase 18 a's (record, launches), else b
    runs the leg).  Returns (ARTIFACTS_LINE dict, {run: launches})."""
    import tempfile

    from distributed_llm_scheduler_tpu_torch.__main__ import main
    from distributed_llm_scheduler_tpu_torch.analysis import sweep_parallel_collectives
    from distributed_llm_scheduler_tpu_torch.eval import rankcheck_artifact as RA

    cards = torch.cuda.device_count()
    line, counts = {"cards": cards}, {}
    t = time.perf_counter()
    rc, out, err, wall, ran = cli_call(torch, main, ["lint", "--parallel"])
    if rc != 0 or out.strip() != "analysis: 0 error(s), 0 warning(s), 0 info":
        raise AssertionError(f"a. lint --parallel exited {rc}: {out!r} "
                             f"{err[-2000:]!r}")
    rc_j, out_j, err_j, wall_j, _ = cli_call(torch, main, ["lint", "--parallel",
                                                           "--json"])
    rep = json.loads(out_j) if rc_j == 0 else {}
    if rc_j != 0 or rep.get("diagnostics") != [] or rep.get("exit_code") != 0:
        raise AssertionError(f"a. lint --parallel --json exited {rc_j}: "
                             f"{out_j!r} {err_j[-2000:]!r}")
    if any(ran.values()):
        raise AssertionError(f"a. lint --parallel launched kernels: {ran}")
    line["lint_parallel"] = {"exit": rc, "wall_s": wall, "json_wall_s": wall_j,
                             "stdout": out.strip()}
    log(f"  a. lint --parallel on {cards} card(s): exit 0, {out.strip()!r} "
        f"({wall:.1f} s); --json: exit 0, no diagnostic ({wall_j:.1f} s)")
    traces = {}
    t0 = time.perf_counter()
    rep = sweep_parallel_collectives(
        devices=[torch.device("cpu")] * ARTIFACT_SIM_RANKS, traces=traces)
    sweep_s = time.perf_counter() - t0
    if not rep.ok or rep.diagnostics:
        raise AssertionError(f"a. sweep at {ARTIFACT_SIM_RANKS} ranks: "
                             f"{[d.render() for d in rep.diagnostics]}")
    line["sweep"] = {"ranks": ARTIFACT_SIM_RANKS, "wall_s": sweep_s,
                     "probes": {k: collectives_summary(v) for k, v in traces.items()}}
    log(f"  a. the collective sweep on {ARTIFACT_SIM_RANKS} simulated ranks: "
        f"clean in {sweep_s:.2f} s")
    for name, summary in line["sweep"]["probes"].items():
        if not any(summary["per_rank"]):
            raise AssertionError(f"a. probe {name} issued no collective")
        log(f"    {name}: collectives per rank {summary['per_rank']}; rank 0: "
            + "; ".join(summary["rank0"]))

    if train is None:
        log("  b. the train capture leg at full size")
        train = capture_train_leg(torch, P)
        line["train_capture_run"] = "phase 25 b"
    else:
        line["train_capture_run"] = "phase 18 a"
    rec, counts["train capture"] = train
    line["train_capture"] = {k: rec[k] for k in (
        "model", "platform", "card", "oracle_ok", "executed_step_ms",
        "best_policy", "best_makespan_ms", "vs_roundrobin", "capture_wall_s")}
    log(f"  b. capture_artifacts train ({line['train_capture_run']}'s run): "
        f"exit 0, {rec['model']}, oracle {rec['oracle_ok']}, executed step "
        f"{rec['executed_step_ms']} ms, best {rec['best_policy']} "
        f"{rec['best_makespan_ms']} ms, vs_roundrobin {rec['vs_roundrobin']}, "
        f"capture_wall_s {rec['capture_wall_s']}; launches "
        f"{counts['train capture']}")

    with tempfile.TemporaryDirectory() as td:
        err = io.StringIO()
        t0 = time.perf_counter()
        with records_under(RA, Path(td)), contextlib.redirect_stderr(err):
            rc = RA.main([str(ARTIFACT_ROUND)])
        rank_s = time.perf_counter() - t0
        lines = err.getvalue().strip().splitlines()
        if cards < RA.CARDS:
            if rc != 2 or len(lines) != 1 or list(Path(td).iterdir()):
                raise AssertionError(f"c. rankcheck_artifact on {cards} card(s): "
                                     f"exit {rc}, {lines}")
            line["rankcheck"] = {"exit": rc, "refusal": lines[0]}
            log(f"  c. rankcheck_artifact on {cards} card(s): exit 2, {lines[0]!r}")
        else:
            path = Path(td) / f"RANKCHECK_TORCH_r{ARTIFACT_ROUND:02d}.json"
            if rc not in (0, 1) or not path.exists():
                raise AssertionError(f"c. rankcheck_artifact exited {rc}: "
                                     f"{lines[-20:]}")
            line["rankcheck"] = dict(exit=rc, seconds=rank_s,
                                     **rank_record_summary(json.loads(path.read_text())))
            log(f"  c. rankcheck_artifact on {cards} cards: exit {rc} "
                f"({rank_s:.1f} s): {line['rankcheck']}")
    line["seconds"] = time.perf_counter() - t
    return line, counts


def rank_record_summary(rec: dict) -> dict:
    """Each leg's verdict of a RANKCHECK_TORCH record."""
    return {leg: rank_summary(rec[leg]) for leg in ("flagship", "separating")}


def record_tools_only() -> int:
    """``python3 chip_smoke.py --record-tools``: phase 25 alone (the
    kernels built first; b runs the train capture leg itself), its
    ``ARTIFACTS_LINE`` and the card's name and power limit."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import distributed_llm_scheduler_tpu_torch as P
    from distributed_llm_scheduler_tpu_torch.ops import attention as A
    from distributed_llm_scheduler_tpu_torch.ops import kernels
    from distributed_llm_scheduler_tpu_torch.ops import norms as N

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    secs = kernels.build(A.KERNEL, N.SOURCE)
    log(f"built {A.KERNEL}.cu, {N.SOURCE}.cu in {secs:.1f} s; {smi}")
    line, counts = run_artifacts_path(torch, P, A, N)
    line["card"] = smi
    line["counts"] = counts
    print("ARTIFACTS_LINE " + json.dumps(line), flush=True)
    log(f"  phase 25 in {line['seconds']:.1f} s")
    print(smi, flush=True)
    return 0


#: a capture record's headline values (and where they sit), printed by
#: ``--artifacts``
HEADLINES = {
    "STREAM": ("model", "capped_makespan_ms", "uncapped_makespan_ms",
               "slowdown", "bound_utilization", "budget_respected",
               "oracle_ok", "quantized_capped_makespan_ms", "capture_wall_s"),
    "DECODE": ("decode_tok_s", "ms_per_token_step", "bound_utilization",
               "decode.paged_tok_s", "decode.paged_speedup",
               "decode.paged_tokens_exact", "decode.kernel_tokens_exact",
               "decode.kernel_vs_gather_speedup", "whole_program_wall_s",
               "capture_wall_s"),
    "TRAIN": ("model", "oracle_ok", "executed_step_ms", "best_policy",
              "best_makespan_ms", "vs_roundrobin", "capture_wall_s"),
}


def artifacts_only(out: Path) -> int:
    """``python3 chip_smoke.py --artifacts [OUT]``: every capture leg of
    ``eval/capture_artifacts`` at full size on the cards, and on four
    cards both legs of ``eval/rankcheck_artifact``, each writing its
    ``*_TORCH_r{ARTIFACT_ROUND}.json`` record under OUT (default: the
    checkout's root) with the kernels' launches of each leg counted;
    prints ``ARTIFACTS_RECORDS_LINE`` (each record's headline values) and
    the card's name and power limit.  Exit 1 when a capture leg failed (a
    stub in its record); a rank-check verdict below its bar is printed,
    not a failure."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from distributed_llm_scheduler_tpu_torch.eval import capture_artifacts as CA
    from distributed_llm_scheduler_tpu_torch.eval import rankcheck_artifact as RA
    from distributed_llm_scheduler_tpu_torch.ops import attention as A
    from distributed_llm_scheduler_tpu_torch.ops import kernels
    from distributed_llm_scheduler_tpu_torch.ops import norms as N

    smi = nvidia_smi_line()
    secs = kernels.build(A.KERNEL, A.PAGED_SOURCE, N.SOURCE)
    log(f"built {A.KERNEL}.cu, {A.PAGED_SOURCE}.cu, {N.SOURCE}.cu in "
        f"{secs:.1f} s; {smi}")
    out.mkdir(parents=True, exist_ok=True)
    names = (A.KERNEL, A.PAGED_KERNEL, A.PAGED_RAGGED_KERNEL, N.LN_KERNEL,
             N.RMS_KERNEL)
    line, failed = {"card": smi, "cards": torch.cuda.device_count(),
                    "round": ARTIFACT_ROUND, "records": {}}, []
    t_all = time.perf_counter()
    for leg, (prefix, _) in CA.LEGS.items():
        kernels.reset_launches()
        t = time.perf_counter()
        rec, rc = capture_record(CA, out, leg)
        torch.cuda.synchronize()
        head = {k: rec.get(k) for k in HEADLINES[prefix]}
        head.update(exit=rc, seconds=time.perf_counter() - t,
                    launches=ran_counts(names), card=rec.get("card"))
        line["records"][prefix] = head
        if rc != 0 or CA._has_error(rec):
            failed.append(prefix)
        log(f"  {prefix}_TORCH_r{ARTIFACT_ROUND:02d}.json: exit {rc}, {head}")
        gc_cuda(torch)
    if torch.cuda.device_count() >= RA.CARDS:
        kernels.reset_launches()
        t = time.perf_counter()
        with records_under(RA, out):
            rc = RA.main([str(ARTIFACT_ROUND)])
        rec = json.loads((out / f"RANKCHECK_TORCH_r{ARTIFACT_ROUND:02d}.json")
                         .read_text())
        line["records"]["RANKCHECK"] = dict(
            exit=rc, seconds=time.perf_counter() - t, card=rec["card"],
            launches=ran_counts(names), **rank_record_summary(rec))
        log(f"  RANKCHECK_TORCH_r{ARTIFACT_ROUND:02d}.json: exit {rc} (0: both "
            f"legs agree on the winner with tau >= 0.8), "
            f"{line['records']['RANKCHECK']}")
    else:
        log(f"  rankcheck_artifact: {torch.cuda.device_count()} card(s), "
            f"needs {RA.CARDS}: not run")
    line["seconds"] = time.perf_counter() - t_all
    line["failed"] = failed
    print("ARTIFACTS_RECORDS_LINE " + json.dumps(line), flush=True)
    print(smi, flush=True)
    return 1 if failed else 0


def compiled_cards_only() -> int:
    """``python3 chip_smoke.py --compiled-cards``: phase 23 alone over every
    visible card (the kernels built first), its ``COMPILED_CARDS_LINE`` and
    the card's name and power limit."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import distributed_llm_scheduler_tpu_torch as P
    from distributed_llm_scheduler_tpu_torch.ops import attention as A
    from distributed_llm_scheduler_tpu_torch.ops import kernels
    from distributed_llm_scheduler_tpu_torch.ops import norms as N

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    secs = kernels.build(A.KERNEL, N.SOURCE)
    log(f"built {A.KERNEL}.cu, {N.SOURCE}.cu in {secs:.1f} s; {smi}")
    t = time.perf_counter()
    line, counts = run_compiled_cards_path(torch, P, A, N)
    line["seconds"] = time.perf_counter() - t
    line["card"] = smi
    line["counts"] = counts
    print("COMPILED_CARDS_LINE " + json.dumps(line), flush=True)
    print(smi, flush=True)
    return 0


def gc_cuda(torch) -> None:
    """Free what a leg left on the card: the stored decode programs of
    ``generate`` (their caches and graphs), then unreferenced tensors."""
    import gc

    from distributed_llm_scheduler_tpu_torch.models import decode

    decode.clear_programs()
    gc.collect()
    torch.cuda.empty_cache()


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


def preflight_passes(root: Path) -> int:
    """``python3 chip_smoke.py --preflight-passes [ROOT]``: the package
    under ROOT (default: this checkout) measures the task footprints of
    ``lint --preflight``'s DAG (GPT-2 small f32, batch 1, seq 512) twice,
    in this fresh process, and prints one JSON line: each pass's
    footprints where the two differ, in MB.  A first pass that reads more
    than the second carries the process's one-time allocations."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    root = root.resolve()
    sys.path.insert(0, str(root))
    from distributed_llm_scheduler_tpu_torch.ops import attention as A
    from distributed_llm_scheduler_tpu_torch.ops import kernels
    from distributed_llm_scheduler_tpu_torch.ops import norms as N
    from distributed_llm_scheduler_tpu_torch.utils.config import RunConfig
    from distributed_llm_scheduler_tpu_torch.utils.hbm import (
        preflight_task_memory,
    )

    if not Path(kernels.__file__).resolve().is_relative_to(root):
        raise AssertionError(f"imported {kernels.__file__}, not the package "
                             f"under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build(A.KERNEL, N.SOURCE)
    dev = torch.device("cuda", 0)
    passes = []
    for _ in range(2):
        dag = RunConfig(model="gpt2").build_graph()
        passes.append(preflight_task_memory(
            dag.graph, dag.init_params(device=dev), dag.make_inputs(device=dev)))
    differ = {t: [gb[t] * 1024 for gb in passes] for t in passes[0]
              if passes[0][t] != passes[1][t]}
    print(json.dumps({"tree": str(root), "tasks": len(passes[0]),
                      "differ_mb": differ, "device": nvidia_smi_line()}),
          flush=True)
    return 0


def parallel_only() -> int:
    """``python3 chip_smoke.py --parallel``: phase 22 alone over every
    visible card (the kernels built first), its ``PARALLEL_LINE`` and the
    card's name and power limit."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from distributed_llm_scheduler_tpu_torch.ops import attention as A
    from distributed_llm_scheduler_tpu_torch.ops import kernels
    from distributed_llm_scheduler_tpu_torch.ops import norms as N

    smi = nvidia_smi_line()
    secs = kernels.build(A.KERNEL, N.SOURCE)
    log(f"built {A.KERNEL}.cu, {N.SOURCE}.cu in {secs:.1f} s; {smi}")
    line, counts = run_parallel_path(torch, A, N)
    line["card"] = smi
    line["counts"] = counts
    print("PARALLEL_LINE " + json.dumps(line), flush=True)
    print(smi, flush=True)
    return 0


def expert_pipeline_only() -> int:
    """``python3 chip_smoke.py --expert-pipeline``: phase 24 alone over
    every visible card (the kernels built first), its
    ``EXPERT_PIPELINE_LINE`` and the card's name and power limit."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from distributed_llm_scheduler_tpu_torch.ops import attention as A
    from distributed_llm_scheduler_tpu_torch.ops import kernels
    from distributed_llm_scheduler_tpu_torch.ops import norms as N

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    secs = kernels.build(A.KERNEL, N.SOURCE)
    log(f"built {A.KERNEL}.cu, {N.SOURCE}.cu in {secs:.1f} s; {smi}")
    t = time.perf_counter()
    line, _ = run_expert_pipeline_path(torch, A, N)
    line["seconds"] = time.perf_counter() - t
    line["card"] = smi
    print("EXPERT_PIPELINE_LINE " + json.dumps(line), flush=True)
    log(f"  phase 24 in {line['seconds']:.1f} s")
    print(smi, flush=True)
    return 0


def main() -> int:
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
    if sys.argv[1:2] == ["--parallel"]:
        return parallel_only()
    if sys.argv[1:2] == ["--compiled-cards"]:
        return compiled_cards_only()
    if sys.argv[1:2] == ["--expert-pipeline"]:
        return expert_pipeline_only()
    if sys.argv[1:2] == ["--record-tools"]:
        return record_tools_only()
    if sys.argv[1:2] == ["--artifacts"]:
        return artifacts_only(Path(sys.argv[2]) if len(sys.argv) > 2 else ROOT)
    if sys.argv[1:2] == ["--preflight-passes"]:
        return preflight_passes(Path(sys.argv[2]) if len(sys.argv) > 2
                                else ROOT)
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
    log(f"[1/25] device: {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("  TF32 off for matmul and cuDNN")

    sources = (A.KERNEL, A.PAGED_SOURCE, N.SOURCE)
    secs = kernels.build(*sources)
    log(f"[2/25] built {', '.join(f'{n}.cu' for n in sources)} with "
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

    log("[3/25] flash kernel check against its plain version")
    attn = check_attention_kernel(
        torch, A, dev, P.LlamaConfig.llama3_8b(dtype=torch.bfloat16))

    log("[4/25] paged kernel check against the plain versions")
    paged = check_paged_kernels(torch, A, DB, dev)
    ragged_n = run_ragged_op_path(torch, A, DB, dev)

    log("[5/25] LayerNorm and RMSNorm kernel check against the plain versions")
    norms = check_norm_kernels(torch, N, dev)

    def phase_done():  # free the phase's tensors before the next one
        gc_cuda(torch)

    log("[6/25] flagship forward path: GPT-2 small bf16 DAG on the card")
    gpt2_n = run_main_path(torch, P, dev)
    phase_done()

    log("[7/25] execution ladder: the flagship per task, planned, coalesced, "
        "segmented and compiled")
    ladder_n = run_ladder_path(torch, P, dev)
    phase_done()

    log("[8/25] north-star bench: GPT-2 small bf16, 10 policies replayed")
    bench_n, bench_result = run_bench_path(torch, P, dev)
    phase_done()

    log("[9/25] serve path: GPT-2 small bf16 through the paged decode engine")
    serve_launches, serve_ragged, serve_ln, serve_tr, served = run_serve_path(
        torch, P, A, dev)
    phase_done()

    log("[10/25] Llama path: Llama-3 8B bf16 DAG, pipeline stages, on the card")
    llama_n = run_llama_path(torch, P, dev)
    phase_done()

    log("[11/25] f32 leg: GPT-2 placed on the card vs fused on the CPU")
    run_f32_leg(torch, P, dev)

    log("[12/25] f32 serve leg: the engine on the card vs on the CPU")
    run_f32_serve_leg(torch, P, dev)
    phase_done()

    log("[13/25] f32 Llama leg: placed on the card vs fused on the CPU")
    run_llama_f32_leg(torch, P, dev)
    phase_done()

    log("[14/25] parameter streaming: GPT-2 medium and the flagship under "
        "budgets below their params")
    stream_n = run_stream_path(torch, P, dev)
    phase_done()

    log("[15/25] online serving: the serve bench on the card, then the "
        "frontend over GPT-2 small bf16 on a real clock")
    t15 = time.perf_counter()
    bench_on_card = run_serve_bench_on_card(torch, dev)
    online, online_n = run_online_path(torch, P, A, dev, served)
    online["serve_bench"] = bench_on_card
    print("ONLINE_LINE " + json.dumps(online), flush=True)
    log(f"  phase 15 in {time.perf_counter() - t15:.1f} s")
    phase_done()

    log("[16/25] run doctor: the flagship and the engine traced, the soak "
        "doctor and the health-routed fleet")
    t16 = time.perf_counter()
    doctor, doctor_n = run_doctor_path(torch, P, A, dev, served)
    doctor["seconds"] = time.perf_counter() - t16
    doctor["card"] = smi
    print("DOCTOR_LINE " + json.dumps(doctor), flush=True)
    log(f"  phase 16 in {doctor['seconds']:.1f} s")
    del served
    phase_done()

    log("[17/25] searched placements: the bench's refine and search "
        "placements on the card, the pre-execution gate and analyze()")
    t17 = time.perf_counter()
    searched, search_n = run_search_phase(torch, P, A, N, dev, bench_result)
    searched["seconds"] = time.perf_counter() - t17
    searched["card"] = smi
    print("SEARCH_LINE " + json.dumps(searched), flush=True)
    log(f"  phase 17 in {searched['seconds']:.1f} s")
    del bench_result
    phase_done()

    log("[18/25] BASELINE.json configs #5 and #4: the GPT-2 training step "
        "and the Mixtral-8x7B MoE forward")
    t18 = time.perf_counter()
    train, train_n, moe, moe_n = run_baseline_configs(torch, P, A, N, dev)
    log(f"  phase 18 in {time.perf_counter() - t18:.1f} s")
    phase_done()

    log("[19/25] decoding: Llama-3 8B and Mixtral through generate and the "
        "decode-step DAG, GPT-2 small through the decode bench")
    t19 = time.perf_counter()
    decoded, decode_n, decode_norms = run_decode_path(torch, P, A, N, dev)
    decoded["seconds"] = time.perf_counter() - t19
    print("DECODE_LINE " + json.dumps(decoded), flush=True)
    log(f"  phase 19 in {decoded['seconds']:.1f} s")
    phase_done()

    log("[20/25] the command line on the card: execute, trace, metrics, "
        "generate, schedule and the serving commands through the port's "
        "__main__")
    t20 = time.perf_counter()
    cli_line, cli_n = run_cli_path(torch, P, A, N)
    cli_line["seconds"] = time.perf_counter() - t20
    cli_line["card"] = smi
    print("CLI_LINE " + json.dumps(cli_line), flush=True)
    log(f"  phase 20 in {cli_line['seconds']:.1f} s")
    phase_done()

    log("[21/25] the pre-flight lint and the sim-against-card rank check: "
        "lint, lint --preflight, lint --serving and rankcheck through the "
        "port's __main__, run_rank_check on 8 nodes of the card, the tracer")
    t21 = time.perf_counter()
    lint_line, lint_n = run_lint_rank_path(torch, P, A, N, dev)
    lint_line["seconds"] = time.perf_counter() - t21
    lint_line["card"] = smi
    print("LINT_RANK_LINE " + json.dumps(lint_line), flush=True)
    log(f"  phase 21 in {lint_line['seconds']:.1f} s")
    phase_done()

    log("[22/25] the parallel layer on torch.distributed: the dp x tp GPT-2 "
        "training step and its checkpoint, Llama-3 8B tensor-parallel "
        "decode, ring and Ulysses attention, one process per card")
    par_line, par_n = run_parallel_path(torch, A, N)
    par_line["card"] = smi
    print("PARALLEL_LINE " + json.dumps(par_line), flush=True)
    log(f"  phase 22 in {par_line['seconds']:.1f} s")
    phase_done()

    log("[23/25] the compiled rung over the cards: the flagship in a world "
        "of one process per card against the planned rung, and the "
        "ladder's two benches")
    t23 = time.perf_counter()
    cc_line, cc_n = run_compiled_cards_path(torch, P, A, N)
    cc_line["seconds"] = time.perf_counter() - t23
    cc_line["card"] = smi
    print("COMPILED_CARDS_LINE " + json.dumps(cc_line), flush=True)
    log(f"  phase 23 in {cc_line['seconds']:.1f} s")
    phase_done()

    log("[24/25] expert and pipeline parallelism: the dp x ep Mixtral step, "
        "dense and routed, the GPipe GPT-2 step and Llama forward, one "
        "process per card, and the train command's two new paths")
    t24 = time.perf_counter()
    ep_line, ep_n = run_expert_pipeline_path(torch, A, N)
    ep_line["seconds"] = time.perf_counter() - t24
    ep_line["card"] = smi
    print("EXPERT_PIPELINE_LINE " + json.dumps(ep_line), flush=True)
    log(f"  phase 24 in {ep_line['seconds']:.1f} s")
    phase_done()

    log("[25/25] the record tools: lint --parallel and the collective sweep, "
        "the train capture leg, the rank-check record")
    art_line, art_n = run_artifacts_path(
        torch, P, A, N, train=(train["bench"], train_n["train bench"]))
    art_line["card"] = smi
    print("ARTIFACTS_LINE " + json.dumps(art_line), flush=True)
    log(f"  phase 25 in {art_line['seconds']:.1f} s")

    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")

    def by_path(kernel, runs):
        return {f"{path} {label}": n[kernel]
                for path, counts in runs for label, n in counts.items()
                if kernel in n}

    csrc = "distributed_llm_scheduler_tpu_torch/csrc/"
    tpu = "distributed_llm_scheduler_tpu/ops/attention.py:"
    tpu_norms = "distributed_llm_scheduler_tpu/ops/norms.py:"
    runs = (("gpt2", gpt2_n), ("ladder", ladder_n), ("bench", bench_n),
            ("llama", llama_n), ("stream", stream_n), ("run", doctor_n),
            ("searched", search_n), ("decode", decode_n), ("cli", cli_n),
            ("lint", lint_n), ("parallel", par_n), ("compiled cards", cc_n),
            ("expert pipeline", ep_n), ("record tools", art_n))
    line = {"kernels": [
        {"name": A.KERNEL, "route": "cuda", "source": csrc + "flash_attention.cu",
         "replaces": tpu + "152",
         "launches": gpt2_n["greedy x1"][A.KERNEL],
         "launches_by_path": by_path(A.KERNEL, runs), **attn,
         "train": {"launches_per_step": train["launches_per_step"][A.KERNEL],
                   "launches_by_run": {k: n[A.KERNEL] for k, n in train_n.items()},
                   "at_train_shape": train["kernels"]["flash"]},
         "moe": {"launches_per_forward": moe["launches_per_forward"][A.KERNEL],
                 "launches_by_run": {k: n[A.KERNEL] for k, n in moe_n.items()},
                 "at_moe_shape": moe["kernels"]["flash"]}},
        {"name": A.PAGED_KERNEL, "route": "cuda",
         "source": csrc + "paged_attention.cu", "replaces": tpu + "411",
         "launches": serve_launches["serve run 1"],
         "launches_by_path": {**serve_launches, **{
             k: n[A.PAGED_KERNEL] for k, n in online_n.items()}, **{
             k: n[A.PAGED_KERNEL] for k, n in doctor_n.items()
             if A.PAGED_KERNEL in n}, **by_path(A.PAGED_KERNEL, (
                 ("decode", decode_n), ("cli", cli_n), ("lint", lint_n)))},
         **paged[A.PAGED_KERNEL], "serve_trace": serve_tr},
        {"name": A.PAGED_RAGGED_KERNEL, "route": "cuda",
         "source": csrc + "paged_attention.cu", "replaces": tpu + "547",
         "launches": ragged_n[A.PAGED_RAGGED_KERNEL],
         "launches_by_path": {"ragged op path": ragged_n[A.PAGED_RAGGED_KERNEL],
                              **serve_ragged,
                              **by_path(A.PAGED_RAGGED_KERNEL,
                                        (("decode", decode_n),))},
         "launches_by_variant": {k.split(".")[1]: v for k, v in ragged_n.items()
                                 if "." in k},
         "ptxas": ragged_ptxas, **paged[A.PAGED_RAGGED_KERNEL]},
        {"name": N.LN_KERNEL, "route": "cuda", "source": csrc + "norms.cu",
         "replaces": tpu_norms + "58",
         "launches": gpt2_n["greedy x1"][N.LN_KERNEL],
         "launches_by_path": {**by_path(N.LN_KERNEL, runs),
                              **{f"gpt2 {k}": v for k, v in serve_ln.items()},
                              **{k: n[N.LN_KERNEL] for k, n in online_n.items()}},
         **norms[N.LN_KERNEL],
         "train": {"launches_per_step": train["launches_per_step"][N.LN_KERNEL],
                   "launches_by_run": {k: n[N.LN_KERNEL] for k, n in train_n.items()},
                   "at_train_shape": train["kernels"]["layer_norm"],
                   "norm_backward_share": train["trace"]["norm_backward_share"]},
         "decode": {"launches_per_forward": decode_n["gpt2 decode"][N.LN_KERNEL]
                    // decode_calls(DECODE_REPS, DECODE["new_tokens"]),
                    "at_decode_shapes": decode_norms.get(N.LN_KERNEL, [])}},
        {"name": N.RMS_KERNEL, "route": "cuda", "source": csrc + "norms.cu",
         "replaces": tpu_norms + "76",
         "launches": llama_n["pipeline x8"][N.RMS_KERNEL],
         "launches_by_path": by_path(N.RMS_KERNEL, runs),
         **norms[N.RMS_KERNEL], "ptxas": norm_ptxas,
         "moe": {"launches_per_forward": moe["launches_per_forward"][N.RMS_KERNEL],
                 "launches_by_run": {k: n[N.RMS_KERNEL] for k, n in moe_n.items()},
                 "at_moe_shape": moe["kernels"]["rms_norm"]},
         "decode": {"launches_per_llama_step":
                    decode_n["decode step heft x8"][N.RMS_KERNEL],
                    "at_decode_shapes": decode_norms.get(N.RMS_KERNEL, [])}},
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
