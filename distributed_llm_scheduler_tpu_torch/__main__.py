"""CLI: ``python -m distributed_llm_scheduler_tpu_torch <command>``.

The PyTorch port of the JAX package's command line, for the commands whose
code is all ported (the flags, defaults, help texts and exit codes are the
JAX package's):

* ``schedule``  — build a DAG, place it with a policy, report + save
* ``lint``      — static analysis of a DAG + schedule + sharding and
  quantization config (``--fix``, ``--preflight``), or ``--serving``: the
  page-lifetime, request-lifecycle and determinism passes over the serve
  bench's scenario (``--parallel`` waits for the collective sweep)
* ``sweep``     — the full evaluation sweep (CSV + PNG + summary)
* ``execute``   — run a scheduled model DAG on live devices
* ``visualize`` — DAG structure and Gantt renderings
* ``train``     — a few sharded training steps, one process per device:
  GPT-2 dp x tp or (``--pp``) a pipeline, Mixtral dp x ep
* ``generate``  — autoregressive KV-cache decoding (any model family)
* ``bench``     — the north-star benchmark (one JSON line)
* ``trace``     — traced execute (+ paged-decode leg) -> Perfetto JSON
* ``metrics``   — same run, metrics-registry snapshot JSON;
  ``metrics diff`` — deltas between two snapshots (or two samples of one
  time series)
* ``slo``       — sliding-window SLO report + gate over a request log
* ``serve``     — online serving run on a virtual clock (SLO admission,
  preemption) over the paged decode engine
* ``soak``      — duration-bounded serving soak with trend health gating
* ``doctor``    — run doctor: attribution + cost-model drift of a live
  run, or ``--trace``, ``--memory``, ``--slo``, ``--soak``, ``--fleet``,
  ``--serve``, ``--requests``
* ``regress``   — perf-regression gate between two bench artifacts
* ``rankcheck`` — does the simulator rank the policies the way the live
  devices do (``--stress``: the transfer-bound DAG on 4 cards)

Exit codes of the gating commands: 0 ok, 1 a gate breached (``lint``:
an error; ``rankcheck``: the predicted winner lost), 2 malformed input or
a configuration that cannot run, 3 (``rankcheck``) fewer than two
policies placed the whole graph.  Live devices are the CUDA cards;
``DLS_PLATFORM=cpu`` runs on the CPU instead (``utils/config.py``).  With
no card and no such setting the device commands fail with a message:
nothing falls back to the CPU.  A command that cannot run exits 2 with
one line on stderr.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from .utils.config import ConfigError


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", default="gpt2",
                   help="gpt2[-medium|-tiny] | llama[-8b|-tiny] | "
                        "mixtral[-8x7b|-tiny] | llm | random | pipeline")
    p.add_argument("--backend", default="sim",
                   help="sim | sim-reference (replay fidelity for schedule/visualize)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--vocab-shards", type=int, default=1, dest="vocab_shards",
                   help="shard the embedding/LM-head tables across tasks")
    p.add_argument("--fuse", action="store_true",
                   help="fuse linear task chains before scheduling")
    p.add_argument("--quantize", default="none", choices=["none", "int8"],
                   help="int8: per-channel weight quantization — halves/"
                        "quarters param bytes for placement, loads, and HBM")
    p.add_argument("--train-step", action="store_true",
                   help="schedule one fwd+bwd+optimizer step (gpt2* models)")
    p.add_argument("--routed", action="store_true",
                   help="mixtral*: expert tasks compute capacity-buffer "
                        "sparse dispatch (top_k/E of the dense FLOPs) "
                        "instead of dense every-expert-sees-every-token")
    p.add_argument("--capacity-factor", type=float, default=2.0,
                   dest="capacity_factor",
                   help="routed capacity slack (x k*N/E tokens per expert; "
                        "over-capacity assignments drop)")
    p.add_argument("--num-layers", type=int, default=None)
    p.add_argument("--num-nodes", type=int, default=8)
    p.add_argument("--slices", type=int, default=1,
                   help=">1: multi-slice topology (nodes split slice-by-"
                        "slice, DCN charged between slices)")
    p.add_argument("--hbm-gb", type=float, default=14.0)
    p.add_argument("--memory-regime", type=float, default=1.0)
    p.add_argument("--scheduler", default="heft")
    p.add_argument("--search-budget", type=int, default=None,
                   dest="search_budget",
                   help="--scheduler search: evaluation budget for the "
                        "annealed placement search (default 800)")
    p.add_argument("--search-seed", type=int, default=None,
                   dest="search_seed",
                   help="--scheduler search: RNG seed; same seed + "
                        "budget reproduces the placement digest exactly")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-dir", default="evaluation_results")


def _config_from(args: argparse.Namespace):
    from .utils.config import RunConfig

    fields = {f.name for f in dataclasses.fields(RunConfig)}
    kw = {k: v for k, v in vars(args).items() if k in fields and v is not None}
    return RunConfig(**kw)


# families with HF name maps (frontend/pretrained.py); drives both the
# fail-fast family check and the mapper dispatch
_WEIGHT_MAPPERS = {
    "gpt2": "gpt2_params_from_state_dict",
    "llama": "llama_params_from_state_dict",
    "mixtral": "mixtral_params_from_state_dict",
}
_WEIGHTS_UNSUPPORTED = (
    f"--weights supports the {', '.join(sorted(_WEIGHT_MAPPERS))} "
    "families (HF name maps in frontend/pretrained.py)"
)


def _weights_family(model_name: str):
    return next(
        (f for f in _WEIGHT_MAPPERS if model_name.startswith(f)), None
    )


def _load_pretrained_weights(path: str, config, model_name: str):
    """torch state-dict file -> flat param dict (CPU tensors), or None after
    printing the error (shared by ``execute --weights`` and ``generate
    --weights``)."""
    import torch

    from .frontend import pretrained

    family = _weights_family(model_name)
    if family is None:
        print(_WEIGHTS_UNSUPPORTED, file=sys.stderr)
        return None
    mapper = getattr(pretrained, _WEIGHT_MAPPERS[family])
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        params = mapper(sd, config)
    except (OSError, ValueError, RuntimeError) as e:
        print(f"--weights {path}: {e}", file=sys.stderr)
        return None
    print(f"loaded {len(params)} params from {path}", file=sys.stderr)
    return params


def _export_trace(schedule, path: str, graph=None) -> int:
    """Shared --trace export: 0 on success, 2 (with stderr) on failure.
    ``graph`` adds cross-device transfer-edge flow arrows."""
    from .utils.profiling import export_chrome_trace

    try:
        print("trace ->", export_chrome_trace(schedule, path, graph=graph),
              file=sys.stderr)
        return 0
    except ValueError as e:  # degenerate replay with no timed tasks
        print(str(e), file=sys.stderr)
        return 2


def _replay_backend(cfg):
    """The sim backend the schedule/visualize replay commands accept; the
    device backend has a different execute() contract (live params/inputs)
    and is driven by the ``execute`` command instead."""
    if cfg.backend not in ("sim", "sim-reference"):
        raise SystemExit(
            f"--backend {cfg.backend!r} is not valid here; schedule/visualize "
            "replay with sim | sim-reference (run live devices via `execute`)"
        )
    return cfg.build_backend()


def cmd_schedule(args) -> int:
    from .utils.serialization import save_graph, save_schedule

    cfg = _config_from(args)
    dag = cfg.build_graph()
    graph = getattr(dag, "graph", dag)
    cluster = cfg.build_cluster()
    schedule = cfg.build_scheduler().schedule(graph, cluster)
    if args.validate:
        from .core.validate import validate_schedule

        vrep = validate_schedule(graph, cluster, schedule)
        print(f"validator: {vrep.summary()}", file=sys.stderr)
        if not vrep.ok:
            return 2
    rep = _replay_backend(cfg).execute(
        graph, cluster, schedule, dag_type=cfg.model
    )
    print(json.dumps({
        "graph": graph.summary(),
        "schedule": {k: v for k, v in schedule.summary().items()},
        "makespan_s": rep.makespan,
        "cache_hit_rate": rep.cache_hit_rate,
        "load_balance": rep.load_balance_score,
    }, indent=1, default=str))
    if args.trace and _export_trace(schedule, args.trace, graph=graph):
        return 2
    if args.save:
        print("graph ->", save_graph(graph, f"{cfg.out_dir}/{graph.name}.graph.json"))
        print("schedule ->", save_schedule(
            schedule, f"{cfg.out_dir}/{graph.name}.{cfg.scheduler}.schedule.json"
        ))
    return 0


def _cmd_lint_serving(args) -> int:
    """The serving half of the lint (``lint --serving``): run the
    serve_bench scenario with the page-ownership seam attached, then
    the three serving-safety passes — the page-lifetime prover
    (PGL00x) over the recorded event stream, the request-lifecycle
    checker (LCY00x) over both the frontend's rows and the engine's
    reqlog, and the repo-wide determinism lint (DET00x).
    ``--prefix`` serves the shared-prefix session workload on a
    sharing-enabled engine instead, so the prover replays the
    ref-counted share/unshare/cow/write lattice (PGL006/PGL007).
    ``--inject-leak N`` swaps in the leaky-pool fault injector (the CI
    must-fail leg: exit 1 naming PGL001); ``--inject-underflow`` (with
    ``--prefix``) swaps in the refcount-underflow injector (exit 1
    naming PGL006)."""
    import functools

    from .analysis import (
        Severity,
        analyze_determinism,
        analyze_lifecycle,
        analyze_pages,
    )
    from .eval.serve_bench import (
        PREFIX_SCENARIO,
        SCENARIO,
        build_serve_engine,
    )
    from .models.kv_pages import PageOwnershipLog
    from .obs.slo import SLOPolicy
    from .serve.frontend import (
        ServiceTimeModel,
        ServingFrontend,
        VirtualClock,
    )
    from .serve.loadgen import (
        poisson_arrivals,
        session_arrivals,
        session_prompt_token_ids,
    )
    from .serve.soak import inject_page_leak, inject_refcount_underflow
    from .utils.config import platform_devices

    if args.inject_leak is not None and args.inject_leak < 1:
        print(f"--inject-leak must be >= 1, got {args.inject_leak}",
              file=sys.stderr)
        return 2
    prefix = bool(getattr(args, "prefix", False))
    prompt_fn = None
    if prefix:
        sc = dict(SCENARIO, **PREFIX_SCENARIO)
        arrivals = session_arrivals(
            sc["prefix_rate_rps"], sc["n_sessions"], args.seed,
            system_len=sc["system_len"], user_len=sc["user_len"],
            turns=sc["turns"],
            max_new_tokens=sc["prefix_max_new_tokens"],
            priorities=sc["priorities"],
            priority_weights=sc["priority_weights"],
            think_time_s=sc["think_time_s"],
        )
        prompt_fn = functools.partial(
            session_prompt_token_ids,
            system_len=sc["system_len"], user_len=sc["user_len"],
        )
    else:
        sc = SCENARIO
        arrivals = poisson_arrivals(
            sc["rate_rps"], sc["n_requests"], args.seed,
            prompt_lens=sc["prompt_lens"],
            max_new_tokens=sc["max_new_tokens"],
            priorities=sc["priorities"],
            priority_weights=sc["priority_weights"],
        )
    eng, _pool = build_serve_engine(
        slots=sc["slots"], page_size=sc["page_size"],
        n_pages=sc["n_pages"], pages_per_seq=sc["pages_per_seq"],
        seg_steps=sc["seg_steps"], clock=VirtualClock(),
        sharing=prefix, device=platform_devices(1)[0],
    )
    ownlog = PageOwnershipLog()
    eng.attach_ownership_log(ownlog)
    if args.inject_leak is not None:
        inject_page_leak(eng, args.inject_leak)
    if getattr(args, "inject_underflow", False):
        inject_refcount_underflow(eng)
    fe = ServingFrontend(
        eng, arrivals,
        SLOPolicy(ttft_s=sc["ttft_s"], window_s=sc["window_s"],
                  percentile=sc["percentile"]),
        admission="slo", preemption=True,
        time_model=ServiceTimeModel(
            wave_s=sc["wave_s"], segment_s=sc["segment_s"],
            idle_s=sc["idle_s"],
        ),
        prompt_fn=prompt_fn,
    )
    fe.run()
    rep = analyze_determinism()
    rep.extend(analyze_pages(ownlog))
    rep.extend(analyze_lifecycle(fe.request_rows(), final=True,
                                 label="serving"))
    rep.extend(analyze_lifecycle(eng.reqlog.snapshot(), final=True,
                                 label="engine"))
    rep = rep.dedupe()
    if args.json:
        print(json.dumps(rep.to_json()))
        return rep.exit_code
    min_sev = Severity.INFO if args.verbose else Severity.WARNING
    print(rep.render(min_severity=min_sev))
    if not rep.diagnostics:
        n_pool = sum(
            1 for e in ownlog.events
            if e["kind"] in ("alloc", "free", "share", "unshare")
        )
        shared = sum(
            len(e["pages"]) for e in ownlog.events
            if e["kind"] == "share"
        )
        extra = (
            f" ({shared} shared-page references ref-counted)"
            if prefix else ""
        )
        print(
            f"serving lint clean: {len(ownlog)} ownership events "
            f"replayed, free+used tiling proven at all {n_pool} pool "
            f"events{extra}; lifecycle and determinism passes found "
            "nothing",
            file=sys.stderr,
        )
    return rep.exit_code


def cmd_lint(args) -> int:
    """Static analysis (analysis/): build the DAG, schedule it, and lint
    graph + schedule + memory + sharding + quantization without executing
    anything.  Exit 1 on errors, 0 otherwise; 2 for a configuration that
    cannot run.  ``--preflight`` runs each distinct task once on the card
    (the allocator's peak); ``--serving`` runs its scenario's engine there
    too, unless ``DLS_PLATFORM=cpu``."""
    from .analysis import _spec_shapes, analyze
    from .parallel.mesh import factorize_mesh

    if getattr(args, "serving", False):
        if args.parallel or args.decode or args.paged or args.preflight \
                or args.fix:
            print("--serving runs the serving-safety passes and combines "
                  "only with --json/--verbose/--prefix/--inject-leak/"
                  "--inject-underflow/--seed",
                  file=sys.stderr)
            return 2
        if getattr(args, "inject_underflow", False) \
                and not getattr(args, "prefix", False):
            print("--inject-underflow needs the sharing-enabled workload: "
                  "use lint --serving --prefix --inject-underflow",
                  file=sys.stderr)
            return 2
        return _cmd_lint_serving(args)
    if getattr(args, "inject_leak", None) is not None:
        print("--inject-leak only applies to lint --serving",
              file=sys.stderr)
        return 2
    if getattr(args, "prefix", False) \
            or getattr(args, "inject_underflow", False):
        print("--prefix/--inject-underflow only apply to lint --serving",
              file=sys.stderr)
        return 2

    if args.parallel:
        # the sweep traces every strategy of the parallel layer through
        # its collective_probe hook; the hooks and the sweep are not
        # ported yet
        print("lint --parallel: the collective sweep of the parallel layer "
              "(analysis/parallel_sweep, the collective_probe hooks) is not "
              "ported to PyTorch yet (ROADMAP.md A.11 item 3)", file=sys.stderr)
        return 2

    cfg = _config_from(args)
    if args.decode and _weights_family(cfg.model) is None:
        print("--decode needs a real model family (gpt2*/llama*/mixtral*)",
              file=sys.stderr)
        return 2
    if args.paged and _weights_family(cfg.model) != "gpt2":
        print("--paged lints the paged decode step (gpt2 family only)",
              file=sys.stderr)
        return 2
    if args.paged:
        from .frontend.decode_dag import build_paged_decode_dag

        dag = build_paged_decode_dag(
            cfg.model_config(), slots=cfg.batch,
            page_size=getattr(args, "page_size", 16),
        )
    elif args.decode:
        from .frontend.decode_dag import build_decode_dag_any

        dag = build_decode_dag_any(cfg.model_config(), batch=cfg.batch)
        if cfg.quantize == "int8":
            from .utils.quantize import quantize_dag

            dag = quantize_dag(dag)
    else:
        dag = cfg.build_graph()
    graph = getattr(dag, "graph", dag)
    if args.fix:
        from .analysis import fix_duplicate_dependencies

        fixed = fix_duplicate_dependencies(graph)
        if fixed:
            shown = ", ".join(fixed[:5]) + ("..." if len(fixed) > 5 else "")
            print(f"--fix: deduplicated dependencies on {len(fixed)} "
                  f"task(s): {shown}", file=sys.stderr)
    compiled_gb = analytic_gb = None
    if args.preflight:
        if not hasattr(dag, "init_params"):
            print("--preflight needs a model DAG (gpt2*/llama*/mixtral*): "
                  "the preflight runs the real task fns", file=sys.stderr)
            return 2
        from .utils.config import platform_devices
        from .utils.hbm import preflight_task_memory

        # preflight mutates memory_required up to max(analytic,
        # compiled): snapshot the analytic estimates first so the cost
        # pass compares against what the frontend actually declared.
        # On the card each distinct task runs once (the allocator's
        # peak); on the CPU nothing is measured
        dev = platform_devices(1)[0]
        analytic_gb = {t.task_id: t.memory_required for t in graph}
        compiled_gb = preflight_task_memory(
            graph, dag.init_params(device=dev), dag.make_inputs(device=dev)
        )
    cluster = cfg.build_cluster()
    schedule = cfg.build_scheduler().schedule(graph, cluster)
    if args.fix:
        from .analysis import fix_per_node_order

        resorted = fix_per_node_order(graph, schedule)
        if resorted is None:
            print("--fix: no legal topological order exists (dependency "
                  "cycle among placed tasks); order left as scheduled",
                  file=sys.stderr)
        elif resorted:
            shown = ", ".join(resorted[:5]) + (
                "..." if len(resorted) > 5 else ""
            )
            print(f"--fix: re-sorted execution order on {len(resorted)} "
                  f"node(s): {shown}", file=sys.stderr)

    family = _weights_family(cfg.model)
    param_specs = getattr(dag, "param_specs", None)
    param_shapes = mesh_axes = None
    if family is not None and param_specs:
        param_shapes = _spec_shapes(param_specs)
        mesh_axes = factorize_mesh(cfg.num_nodes)
    rep = analyze(
        graph,
        cluster,
        schedule,
        strict=args.strict,
        param_shapes=param_shapes,
        mesh_axes=mesh_axes,
        family=family or "gpt2",
        param_specs=param_specs if cfg.quantize == "int8" else None,
        compiled_gb=compiled_gb,
        analytic_gb=analytic_gb,
        # typecheck (TYP001-TYP004) inputs: param *specs* carry the same
        # avals as initialized weights without materializing any arrays
        params=param_specs,
        graph_input=getattr(dag, "input_spec", None),
        chunk_tokens=getattr(args, "chunk_tokens", None),
        decode_budget=(
            cfg.batch * args.seg_steps
            if getattr(args, "chunk_tokens", None) is not None
            else None
        ),
    )
    if schedule.failed and not args.json:
        print(f"note: scheduler failed {len(schedule.failed)} task(s) "
              "under this memory regime (not a schedule defect)",
              file=sys.stderr)
    if args.json:
        print(json.dumps(rep.to_json()))
        return rep.exit_code
    from .analysis import Severity

    min_sev = Severity.INFO if args.verbose else Severity.WARNING
    print(rep.render(min_severity=min_sev))
    return rep.exit_code


def cmd_sweep(args) -> int:
    from .eval.evaluator import Evaluator

    cfg = _config_from(args)
    try:
        ev = Evaluator(
            node_counts=cfg.node_counts,
            memory_regimes=cfg.memory_regimes,
            slices=cfg.slices,
        )
    except ValueError as e:  # e.g. no node count divisible by --slices
        print(str(e), file=sys.stderr)
        return 2
    ev.run_experiments(num_runs=args.num_runs, seed=cfg.seed)
    print("csv ->", ev.write_csv(f"{cfg.out_dir}/raw_results.csv"))
    print("png ->", ev.write_plots(f"{cfg.out_dir}/scheduler_performance.png"))
    ev.print_summary()
    return 0


def cmd_execute(args) -> int:
    from .backends.device import DeviceBackend, _tree_to, pin_params

    cfg = _config_from(args)
    if args.profile and args.segments:
        print("--segments fuses away task boundaries; per-task --profile "
              "timings need per-task dispatch", file=sys.stderr)
        return 2
    if args.trace and not args.profile:
        # fail BEFORE the device run: timings only exist in profile mode
        print("--trace needs per-task timings; add --profile",
              file=sys.stderr)
        return 2
    if cfg.slices > 1:
        # live clusters carry their real topology; an artificial
        # --slices would silently not apply
        print("execute binds live devices, whose slice topology is "
              "detected, not configured; drop --slices (use `schedule "
              "--slices N` for modeled multislice runs)", file=sys.stderr)
        return 2
    if cfg.weights and _weights_family(cfg.model) is None:
        # fail fast, before graph build / device binding / scheduling
        print(_WEIGHTS_UNSUPPORTED, file=sys.stderr)
        return 2
    dag = cfg.build_graph()
    if not hasattr(dag, "graph"):
        print("execute needs a model DAG (gpt2* / llama* / mixtral*); "
              "synthetic graphs have no fns", file=sys.stderr)
        return 2
    cluster = cfg.build_cluster_with_devices()
    schedule = cfg.build_scheduler().schedule(dag.graph, cluster)
    backend = DeviceBackend(cluster)
    dev = cluster.devices[0].torch_device
    # streamed params stay on the host (the streamer loads them per task)
    pdev = "cpu" if args.stream_params else dev
    if cfg.weights:
        from .frontend.pretrained import fit_params_to_dag

        params = _load_pretrained_weights(cfg.weights, dag.config, cfg.model)
        if params is None:
            return 2
        try:
            params = fit_params_to_dag(dag, params)
        except ValueError as e:
            print(f"--weights {cfg.weights}: {e}", file=sys.stderr)
            return 2
        if cfg.quantize == "int8":
            # checkpoints load in fp; convert to the quantized DAG's layout
            from .utils.quantize import quantize_like

            params = quantize_like(dag, params)
        params = _tree_to(params, pdev)
    else:
        params = dag.init_params(device=pdev)
    if args.stream_params and dev.type == "cuda":
        params = pin_params(params)
    ids = dag.make_inputs(device=dev)
    inject = None
    if args.inject_failure:
        # validate the spec BEFORE the expensive device run
        inject = _parse_injection(args.inject_failure, cluster)
        if inject is None:
            return 2
    rep = backend.execute(
        dag.graph, schedule, params, ids, profile=args.profile,
        segments=args.segments, keep_outputs=bool(inject),
        stream_params=args.stream_params,
    )
    summary = rep.summary()
    if inject:
        recovery = _injected_recovery(
            inject, dag, schedule, cluster, cfg, rep, params, ids,
            segments=args.segments, stream_params=args.stream_params,
        )
        summary["recovery"] = recovery
        print(json.dumps(summary, indent=1, default=str))
        if not recovery["output_matches_uninterrupted"]:
            # a failed recovery must be scriptable, not buried in JSON
            msg = (
                "remainder could not be placed on the survivors"
                if "reschedule_failed_tasks" in recovery
                else "recovered output does NOT match the uninterrupted run"
            )
            print(f"--inject-failure: {msg}", file=sys.stderr)
            return 1
    else:
        print(json.dumps(summary, indent=1, default=str))
    if args.trace and _export_trace(schedule, args.trace, graph=dag.graph):
        return 2
    from .obs import ambient_tracer, trace_enabled

    if trace_enabled():
        # DLS_TRACE=1: the run recorded into the ambient tracer with no
        # flags; export its unified timeline next to the other artifacts
        amb = ambient_tracer()
        if amb is not None and len(amb):
            from .obs.export import export_perfetto

            os.makedirs(cfg.out_dir, exist_ok=True)
            print("ambient trace ->", export_perfetto(
                amb, f"{cfg.out_dir}/execute.trace.json"
            ), file=sys.stderr)
    return 0


def _parse_injection(spec: str, cluster):
    """Validate `--inject-failure NODE[:FRAC]`; (node_id, frac) or None."""
    node, _, frac_s = spec.partition(":")
    try:
        frac = float(frac_s) if frac_s else 0.5
    except ValueError:
        print(f"--inject-failure: bad fraction {frac_s!r}", file=sys.stderr)
        return None
    if not 0.0 <= frac <= 1.0:
        print(f"--inject-failure: fraction {frac} outside [0, 1]",
              file=sys.stderr)
        return None
    # literal node id first: a cluster whose ids are themselves numeric
    # strings must stay addressable by id (the index reading would shadow
    # it and could resolve to a different device)
    if node not in cluster and node.isdigit():
        idx = int(node)
        if idx >= len(cluster):
            print(f"--inject-failure: node index {idx} out of range "
                  f"(cluster has {len(cluster)} devices)", file=sys.stderr)
            return None
        node = cluster.devices[idx].node_id
    if node not in cluster:
        print(f"--inject-failure: unknown node {node!r} "
              f"(have {cluster.ids()})", file=sys.stderr)
        return None
    if len(cluster) < 2:
        print("--inject-failure needs >= 2 devices", file=sys.stderr)
        return None
    return node, frac


def _injected_recovery(
    inject, dag, schedule, cluster, cfg, first_rep, params, ids,
    segments: bool, stream_params: bool = False,
):
    """Fault injection for `execute --inject-failure NODE[:FRAC]`: treat
    the first FRAC of the assignment order as completed when NODE dies,
    re-place the remainder on the survivors, re-execute feeding the
    retained surviving outputs, and verify the recovered output matches
    the uninterrupted run.  Returns the recovery summary dict."""
    import torch

    from .backends.device import DeviceBackend
    from .sched.elastic import reschedule

    node, frac = inject
    # the uninterrupted output, kept apart from any graph-owned buffer
    first_out = (first_rep.output.detach().clone()
                 if first_rep.output is not None else None)
    order = schedule.assignment_order
    completed = set(order[: int(len(order) * frac)])
    survivors = cluster.without(node)
    new_s, remainder, must_run, available = reschedule(
        dag.graph, schedule, completed, {node}, survivors,
        cfg.build_scheduler(), have_outputs=first_rep.task_outputs,
    )
    summary = {
        "killed_node": node,
        "completed_before_failure": len(completed),
        "reused_outputs": len(available),
        "rerun_tasks": len(must_run),
    }
    if new_s.failed:
        # distinguish "remainder would not fit on the survivors" from a
        # numerical recovery failure
        summary["reschedule_failed_tasks"] = len(new_s.failed)
        summary["output_matches_uninterrupted"] = False
        return summary
    ext = {t: first_rep.task_outputs[t] for t in available}
    rec = DeviceBackend(survivors).execute(
        remainder, new_s, params, ids,
        ext_outputs=ext, segments=segments, keep_outputs=True,
        stream_params=stream_params,
    )
    # compare the ORIGINAL graph's final task: retained if it survived the
    # failure, recomputed (rec.task_outputs) otherwise — rec.output is the
    # remainder's own last task, which need not be the model's output
    final = dag.graph.topo_order[-1]
    recovered_final = (
        ext[final] if final in available else rec.task_outputs.get(final)
    )
    ok = first_out is not None and recovered_final is not None and (
        bool(torch.allclose(
            first_out.float().cpu(), recovered_final.float().cpu(),
            rtol=2e-4, atol=2e-4,
        ))
    )
    summary["recovered_makespan_ms"] = rec.makespan_s * 1e3
    summary["output_matches_uninterrupted"] = ok
    return summary


def _visualize_menu(args, cfg) -> int:
    """Stdin-driven visualization menu (reference ``visu.py:294-339``):
    re-render, switch policy, and inspect without re-running the CLI.
    Figures still save to files; ``--show`` additionally opens them."""
    from .visu.plots import visualize_dag, visualize_schedule

    dag = cfg.build_graph()
    graph = getattr(dag, "graph", dag)
    banner = ("[1] simple DAG  [2] detailed DAG  [3 <policy>] gantt "
              f"(default {cfg.scheduler})  [4] summary  [q] quit")
    print(banner)
    while True:
        try:
            choice = input("> ").strip()
        except EOFError:
            return 0
        if choice in ("q", "quit", "exit"):
            return 0
        if choice in ("1", "2"):
            print("dag ->", visualize_dag(
                graph, f"{cfg.out_dir}/{graph.name}.dag.png",
                detailed=choice == "2", show=args.show,
            ))
        elif choice == "3" or choice.startswith("3 "):
            policy = choice[1:].strip() or cfg.scheduler
            from . import get_scheduler

            try:
                sched_cls = get_scheduler(policy)
            except (KeyError, ValueError) as e:
                print(e)
                continue
            # fresh graph + cluster per render: scheduling mutates state
            d2 = cfg.build_graph()
            g2 = getattr(d2, "graph", d2)
            cluster = cfg.build_cluster()
            schedule = sched_cls.schedule(g2, cluster)
            if schedule.failed:
                print(f"{policy}: {len(schedule.failed)} tasks failed to "
                      "place; no gantt", file=sys.stderr)
                continue
            _replay_backend(cfg).execute(g2, cluster, schedule)
            print("gantt ->", visualize_schedule(
                schedule, f"{cfg.out_dir}/{g2.name}.{policy}.gantt.png",
                show=args.show,
            ))
        elif choice == "4":
            for k, v in graph.summary().items():
                print(f"  {k}: {v}")
        else:
            print(f"unknown choice {choice!r}; {banner}")


def cmd_visualize(args) -> int:
    from .visu.plots import visualize_dag, visualize_schedule

    cfg = _config_from(args)
    if getattr(args, "from_trace", None):
        # measured gantt: render the exported trace's device spans (what
        # actually ran under DLS_TRACE=1), not a fresh simulated replay
        from .visu.plots import visualize_trace_gantt

        stem = os.path.splitext(os.path.basename(args.from_trace))[0]
        try:
            print("gantt ->", visualize_trace_gantt(
                args.from_trace, f"{cfg.out_dir}/{stem}.gantt.png",
                show=args.show,
            ))
        except (OSError, ValueError) as e:
            print(f"--from-trace {args.from_trace}: {e}", file=sys.stderr)
            return 2
        return 0
    if getattr(args, "menu", False):
        return _visualize_menu(args, cfg)
    dag = cfg.build_graph()
    graph = getattr(dag, "graph", dag)
    print("dag ->", visualize_dag(
        graph, f"{cfg.out_dir}/{graph.name}.dag.png", detailed=args.detailed,
        show=args.show,
    ))
    cluster = cfg.build_cluster()
    schedule = cfg.build_scheduler().schedule(graph, cluster)
    _replay_backend(cfg).execute(graph, cluster, schedule)
    print("gantt ->", visualize_schedule(
        schedule, f"{cfg.out_dir}/{graph.name}.{cfg.scheduler}.gantt.png",
        show=args.show,
    ))
    return 0


def cmd_train(args) -> int:
    """A few sharded training steps, one process per device
    (``utils/config.platform_world``), rank 0's lines printed: GPT-2 dp x
    tp, or with ``--pp`` a GPipe pipeline over ``--pp`` stage devices;
    ``mixtral*`` dp x ep (:func:`_cmd_train_moe`)."""
    if args.model.startswith("mixtral"):
        return _cmd_train_moe(args)
    from .models.gpt2 import GPT2Config
    from .utils.config import platform_world

    cfg_map = {"gpt2": GPT2Config.small, "gpt2-medium": GPT2Config.medium,
               "gpt2-tiny": GPT2Config.tiny}
    if args.model not in cfg_map:
        # silently training a default GPT-2 when asked for llama would be
        # worse than refusing
        print(f"train supports {sorted(cfg_map)} and mixtral* (dp x ep "
              "expert parallelism, --routed for sparse dispatch); llama "
              "trains via the task-graph path: --train-step on "
              "schedule/execute", file=sys.stderr)
        return 2
    mcfg = cfg_map[args.model]()
    world = platform_world()
    if args.pp:
        # pipeline-parallel training: a stage a rank, one GPipe schedule
        # per step (parallel/pipeline_pp.py)
        if args.scan:
            # stages already apply their layer blocks one by one; a
            # separate --scan would be a no-op claim
            print("--pp already scans layer blocks within each stage; "
                  "drop --scan", file=sys.stderr)
            return 2
        layers = mcfg.n_layer
        if args.pp < 1 or layers % args.pp or args.pp > world:
            print(f"--pp {args.pp} must be >= 1, divide n_layer={layers}, "
                  f"and not exceed {world} devices", file=sys.stderr)
            return 2
        world = args.pp  # the stages; the other devices stay idle
    return _run_train_loop(
        args, mcfg, world, min(args.seq_len, mcfg.n_positions),
        dict(pp=args.pp, microbatches=args.microbatches, remat=args.remat,
             scan=args.scan))


def _run_train_loop(args, config, world: int, seq: int, path: dict) -> int:
    """The train command's scaffold for every path: ``parallel.train.
    run_train_loop`` (init or resume, the synthetic batch, the steps, the
    save) on a world of ``world`` ranks, and rank 0's notes and lines
    printed."""
    from .parallel import launch
    from .parallel.train import run_train_loop

    res = launch.spawn(
        run_train_loop, world,
        args=(config, args.steps, seq, args.seed, args.ckpt, path),
        timeout=None)
    if res["resumed"]:
        print(res["resumed"], file=sys.stderr)
    for line in res["stdout"]:
        print(line)
    if res["saved"]:
        print(res["saved"], file=sys.stderr)
    return 0


def _cmd_train_moe(args) -> int:
    """Mixtral training on a dp x ep mesh (dense or routed dispatch): the
    CLI face of ``parallel/expert.make_moe_train_step``."""
    from .models.mixtral import MixtralConfig
    from .parallel.expert import expert_mesh_axes
    from .utils.config import platform_world

    cfg_map = {
        "mixtral": MixtralConfig.mixtral_8x7b,
        "mixtral-8x7b": MixtralConfig.mixtral_8x7b,
        "mixtral-tiny": MixtralConfig.tiny,
    }
    if args.model not in cfg_map:
        print(f"unknown model {args.model!r}; mixtral variants are "
              f"{sorted(cfg_map)}", file=sys.stderr)
        return 2
    if args.pp or args.scan:
        print("--pp/--scan are the GPT-2 train path's flags; the MoE "
              "path trains dp x ep", file=sys.stderr)
        return 2
    mcfg = cfg_map[args.model]()
    world = platform_world()
    # widest ep that divides both the expert count and the device count;
    # the other devices are dp
    dp, ep = expert_mesh_axes(mcfg.n_experts, world)
    print(f"mesh dp={dp} x ep={ep}"
          + (f", routed (capacity x{args.capacity_factor})"
             if args.routed else ", dense dispatch"),
          file=sys.stderr)
    return _run_train_loop(
        args, mcfg, world, min(args.seq_len, mcfg.max_seq_len),
        dict(remat=args.remat, routed=args.routed,
             capacity_factor=args.capacity_factor))


def cmd_generate(args) -> int:
    # flag validation FIRST — before config resolution, checkpoint
    # loading, or any device-touching work: scheduling flags without
    # --task-graph are dead (the whole-program loop does no scheduling),
    # and --task-graph sampling is greedy-only
    if not getattr(args, "task_graph", False):
        passed = [
            k for k in ("scheduler", "num_nodes", "hbm_gb", "loop_steps")
            if getattr(args, k, None) is not None
        ]
        if passed:
            print(f"--{'/--'.join(p.replace('_', '-') for p in passed)} "
                  "only apply with --task-graph (the whole-program decode "
                  "loop does no scheduling)", file=sys.stderr)
            return 2
    elif args.temperature != 0.0:
        print("--task-graph generation is greedy; drop --temperature",
              file=sys.stderr)
        return 2
    elif getattr(args, "kv_int8", False):
        print("--kv-int8 applies to the whole-program decode loop; the "
              "task-graph path places dense cache slabs", file=sys.stderr)
        return 2
    elif getattr(args, "loop_steps", None) is not None and args.loop_steps < 1:
        print("--loop-steps must be >= 1", file=sys.stderr)
        return 2
    # --quantize composes with --task-graph: weights quantize (channel
    # scheme — the DAG path's byte-accounting contract), cache slabs
    # stay fp (quantize_dag exclude_prefixes)

    import torch

    from .models import gpt2, llama, mixtral
    from .utils.config import RunConfig, platform_devices

    # same variant table as every other subcommand (utils/config.py)
    try:
        config = RunConfig(model=args.model).model_config()
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    if config is None:
        print("generate needs a real model family (gpt2* / llama* / "
              "mixtral*); synthetic graphs have no decode path",
              file=sys.stderr)
        return 2
    # family resolution shared with the weights table (prefix match, not
    # first letter: a future 'mistral-*' must not silently bind mixtral)
    mod = {
        "gpt2": gpt2, "llama": llama, "mixtral": mixtral,
    }[_weights_family(args.model)]

    task_graph = getattr(args, "task_graph", False)
    if task_graph:
        # Real defaults for the scheduled path (None = not passed):
        if args.scheduler is None:
            args.scheduler = "heft"
        if args.num_nodes is None:
            args.num_nodes = 1
        if args.hbm_gb is None:
            args.hbm_gb = 14.0
        cfg = _config_from(args)
        cluster = cfg.build_cluster_with_devices()
        dev = cluster.devices[0].torch_device
    else:
        dev = platform_devices()[0]

    if args.weights:
        params = _load_pretrained_weights(args.weights, config, args.model)
        if params is None:
            return 2
        params = {k: v.to(dev) for k, v in params.items()}
    else:
        from .models.family import init_params

        params = init_params(mod, config, args.seed, dev)

    try:
        prompt = [int(t) for t in args.prompt_ids.split(",") if t.strip()]
    except ValueError:
        print(f"--prompt-ids must be comma-separated token ids, got "
              f"{args.prompt_ids!r}", file=sys.stderr)
        return 2
    if not prompt or any(t < 0 or t >= config.vocab_size for t in prompt):
        print(f"prompt ids must be in [0, {config.vocab_size})", file=sys.stderr)
        return 2
    ids = torch.tensor([prompt], dtype=torch.int32, device=dev)

    if task_graph:
        return _generate_task_graph(args, cfg, cluster, config, params,
                                    prompt, ids)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    quantized = getattr(args, "quantize", "none") == "int8"
    try:
        if quantized:
            # int8 weights in device memory (decode is bandwidth-bound),
            # dequantized inside each step — the grouped+rowwise fidelity
            # scheme the decode bench measures (utils/quantize)
            from .models import decode as decode_mod
            from .utils.quantize import (
                ROWWISE_EMBED_KEYS,
                dequantize,
                quantize_params,
            )

            fam = _weights_family(args.model)
            qparams = quantize_params(
                params, scheme="grouped",
                rowwise_keys=ROWWISE_EMBED_KEYS.get(fam, ()),
            )
            dt = config.dtype

            def fwd_q(p, *a, **kw):
                return mod.forward_cached(
                    {k: dequantize(v, dt) for k, v in p.items()}, *a, **kw
                )

            out = decode_mod.generate(
                fwd_q, mod.init_cache, qparams, ids, config,
                max_new_tokens=args.max_new_tokens,
                temperature=args.temperature, top_k=args.top_k,
                generator=gen,
                kv_int8=bool(getattr(args, "kv_int8", False)),
            )
        else:
            out = mod.generate(
                params, ids, config, max_new_tokens=args.max_new_tokens,
                temperature=args.temperature, top_k=args.top_k,
                generator=gen,
                kv_int8=bool(getattr(args, "kv_int8", False)),
            )
    except ValueError as e:  # e.g. past the model's position limit
        print(str(e), file=sys.stderr)
        return 2
    new = [int(t) for t in out[0, len(prompt):].tolist()]
    result = {
        "model": args.model,
        "prompt_ids": prompt,
        "generated_ids": new,
        "temperature": args.temperature,
    }
    if quantized:
        result["weights"] = "int8"
    print(json.dumps(result))
    return 0


def _generate_task_graph(args, cfg, cluster, config, params, prompt, ids
                         ) -> int:
    """``generate --task-graph``: inference through the scheduling layer
    (frontend/decode_dag): prefill + per-token decode-step DAGs, placed by
    --scheduler, cache updates written into the slabs between steps.
    Greedy only (the step DAG exports logits)."""
    import torch

    from .backends.device import DeviceBackend
    from .frontend.decode_dag import (
        apply_cache_updates,
        build_decode_dag_any,
        cache_dims,
        decode_inputs,
    )
    from .models.decode import _position_limit

    max_len = len(prompt) + args.max_new_tokens
    limit = _position_limit(config)
    if limit and max_len > limit:
        # same clean error the whole-program path produces
        print(f"prompt ({len(prompt)}) + max_new_tokens "
              f"({args.max_new_tokens}) exceeds the model's position "
              f"limit {limit}", file=sys.stderr)
        return 2
    backend = DeviceBackend(cluster)
    new = []
    # weights + zero cache slabs, allocated ONCE (shapes are fixed by
    # max_len); each step's updates are written into them in place
    params_c = dict(params)
    n_layers, nkv, hd = cache_dims(config)
    for i in range(n_layers):
        for kind in ("k", "v"):
            params_c[f"cache_{kind}_{i}"] = torch.zeros(
                (1, nkv, max_len, hd), dtype=config.dtype, device=ids.device
            )
    # position is runtime data: ONE graph + schedule per step_len class
    # (prefill, then single-token) serves every position
    loop_k = getattr(args, "loop_steps", None)
    quantize_tg = getattr(args, "quantize", "none") == "int8"
    if quantize_tg:
        # int8 WEIGHTS through the scheduler (channel scheme — the DAG
        # path's byte-accounting contract); cache slabs stay fp, the
        # per-step write path updates them in place
        from .utils.quantize import quantize_dag, quantize_like

    def _tg_dag(step_len):
        d = build_decode_dag_any(
            config, batch=1, step_len=step_len, max_len=max_len
        )
        return quantize_dag(
            d, exclude_prefixes=("cache_",)
        ) if quantize_tg else d

    def greedy(rep):  # on-device argmax: one int32 crosses, not logits
        return torch.argmax(
            rep.output[:, -1, :], dim=-1
        ).to(torch.int32)[:, None]

    cur, pos = None, 0
    if args.max_new_tokens > 0:
        # shared prefill: one scheduled dispatch of the prompt-length class
        pdag = _tg_dag(len(prompt))
        if quantize_tg:
            params_c = quantize_like(pdag, params_c)
        sched_p = cfg.build_scheduler().schedule(pdag.graph, cluster)
        if sched_p.failed:
            print(f"prefill: {len(sched_p.failed)} tasks failed to "
                  "place", file=sys.stderr)
            return 1
        rep = backend.execute(
            pdag.graph, sched_p, params_c,
            decode_inputs(ids, 0, max_len=max_len), keep_outputs=True,
        )
        if args.max_new_tokens > 1:  # sole step's update unused
            apply_cache_updates(params_c, rep.task_outputs, config, pos=0)
        cur = greedy(rep)
        new.append(int(cur[0, 0]))
        pos = len(prompt)
    remaining = max(args.max_new_tokens - 1, 0)
    if remaining:
        ddag = _tg_dag(1)
        sched_d = cfg.build_scheduler().schedule(ddag.graph, cluster)
        if sched_d.failed:
            print(f"decode step: {len(sched_d.failed)} tasks failed "
                  "to place", file=sys.stderr)
            return 1
    if remaining and loop_k is not None:
        # decode in loop_k-token windows through the scheduled step DAG
        # (backends/decode_loop), one host round-trip per window
        from .backends.decode_loop import (
            build_decode_loop,
            split_cache_params,
        )

        weights, caches = split_cache_params(params_c)
        loops: dict = {}  # two at most: full + tail window
        while remaining:
            k = min(loop_k, remaining)
            if k not in loops:
                try:
                    loops[k] = build_decode_loop(
                        ddag.graph, sched_d, config, steps=k
                    )
                except ValueError as e:
                    if "single-node placement" not in str(e):
                        raise
                    # the loop only amortizes the single-device steady
                    # state
                    print(f"{e}; drop --loop-steps for the per-token "
                          "dispatch path", file=sys.stderr)
                    return 2
            toks, caches = loops[k](weights, caches, cur, pos)
            new.extend(int(t) for t in toks[0].tolist())
            cur = toks[:, -1:]
            pos += k
            remaining -= k
    elif remaining:
        first_of_class = True
        while remaining:
            rep = backend.execute(
                ddag.graph, sched_d, params_c,
                decode_inputs(cur, pos, max_len=max_len),
                keep_outputs=True,
                # the class's first step warms up; later tokens skip the
                # throwaway run or every one executes twice
                warmup=first_of_class,
            )
            first_of_class = False
            cur = greedy(rep)
            new.append(int(cur[0, 0]))
            remaining -= 1
            if remaining:  # last step's update unused
                apply_cache_updates(params_c, rep.task_outputs, config,
                                    pos=pos)
            pos += 1
    result = {
        "model": args.model,
        "prompt_ids": prompt,
        "generated_ids": new,
        "task_graph": True,
        "scheduler": cfg.scheduler,
    }
    if loop_k is not None:
        result["loop_steps"] = loop_k
    if quantize_tg:
        result["weights"] = "int8"
    print(json.dumps(result))
    return 0


def cmd_rankcheck(args) -> int:
    """Sim-vs-real rank agreement: schedule with several policies,
    predict makespans with the full-fidelity simulator, execute each
    placement on the live devices, report rank agreement as JSON.  Exit 0
    when the predicted winner wins, 1 when it does not, 2 for a
    configuration that cannot run, 3 when fewer than two policies produce
    complete placements.  The cluster is the live devices ``--num-nodes``
    binds (a prefix of the cards; ``DLS_PLATFORM=cpu``: CPU nodes)."""
    from .eval.rankcheck import run_rank_check

    if args.stress:
        # the separating configuration: transfer-bound by construction,
        # so the sim claims a winner and the check bites
        from .core.cluster import Cluster
        from .frontend.stress_dag import build_transfer_stress_dag
        from .utils.config import platform_devices

        devs = platform_devices(4)
        distinct = list(dict.fromkeys(devs))
        if len(distinct) < 4:
            # nodes sharing one card (or the host) copy nothing between
            # them, so fewer than 4 cards collapse the regime into a tie
            # (2-3 divide the 6 chains, so round-robin accidentally gets
            # perfect chain locality) — a vacuous pass here would defeat
            # the flag's whole point
            print(f"rankcheck --stress needs >= 4 cards ({len(distinct)} "
                  "distinct device(s) here; nodes sharing a card copy "
                  "nothing between them)", file=sys.stderr)
            return 2
        dag = build_transfer_stress_dag(chains=6, length=6, edge_mb=8.0)
        cluster = Cluster.from_torch_devices(distinct[:4], hbm_cap_gb=4.0)
        if args.policies is None:
            # five policies spanning distinct makespan tiers on this graph
            args.policies = "roundrobin,critical,dfs,greedy,pipeline"
    else:
        cfg = _config_from(args)
        dag = cfg.build_graph()  # applies --fuse / --quantize per RunConfig
        if not hasattr(dag, "graph"):
            print("rankcheck needs a model DAG (gpt2* / llama* / mixtral*); "
                  "synthetic graphs have no fns", file=sys.stderr)
            return 2
        cluster = cfg.build_cluster_with_devices()
    dev = cluster.devices[0].torch_device
    if args.policies is None:
        args.policies = "roundrobin,critical,pipeline,pack"
    report = run_rank_check(
        dag.graph,
        dag.init_params(device=dev),
        dag.make_inputs(device=dev),
        policies=[p.strip() for p in args.policies.split(",") if p.strip()],
        cluster=cluster,
        measure_repeats=args.measure_repeats,
        reps=args.reps,
        anchor_calibrate=args.anchor_calibrate,
    )
    print(json.dumps(report, indent=1))
    if report["winner_agreement"] is None:
        # <2 surviving policies: nothing was rankable — distinct exit code
        # so callers don't conflate it with a measured rank refutation
        print("rankcheck: fewer than 2 policies produced complete "
              "placements; no ranking to check", file=sys.stderr)
        return 3
    return 0 if report["winner_agreement"] else 1


def _observed_run(args, tracer, metrics) -> int:
    """Shared ``trace``/``metrics`` runner: one observed
    ``DeviceBackend.execute`` of the model DAG on the live devices, plus
    (gpt2 family, unless --skip-decode) a small paged continuous-batching
    decode leg on one device so the decode counter tracks (queue depth,
    page-pool occupancy) and TTFT/TPOT histograms populate.  0, or 2 when
    the configuration cannot run."""
    from .backends.device import DeviceBackend

    cfg = _config_from(args)
    dag = cfg.build_graph()
    if not hasattr(dag, "graph"):
        print("trace/metrics need a model DAG (gpt2* / llama* / mixtral*); "
              "synthetic graphs have no fns", file=sys.stderr)
        return 2
    cluster = cfg.build_cluster_with_devices()
    dev = cluster.devices[0].torch_device
    schedule = cfg.build_scheduler().schedule(dag.graph, cluster)
    backend = DeviceBackend(cluster)
    backend.execute(
        dag.graph, schedule, dag.init_params(device=dev),
        dag.make_inputs(device=dev), trace=tracer, metrics=metrics,
    )
    if getattr(args, "skip_decode", False):
        return 0
    if _weights_family(cfg.model) != "gpt2":
        print("decode leg skipped: paged decode is gpt2-family only "
              "(the execute leg above still traced)", file=sys.stderr)
        return 0
    import numpy as np

    from .core.cluster import Cluster
    from .frontend.decode_dag import build_paged_decode_dag
    from .models.kv_pages import PagePool

    mcfg = cfg.model_config()
    slots, ps, n_pages, ppseq = 2, 8, 32, 4
    ddag = build_paged_decode_dag(
        mcfg, slots=slots, page_size=ps, n_pages=n_pages,
        pages_per_seq=ppseq,
    )
    params = ddag.init_params(device=dev)
    weights = {k: v for k, v in params.items()
               if not (k.startswith("cache_") or k == "page_table")}
    dcluster = Cluster.from_torch_devices([dev])
    pool = PagePool(n_pages=n_pages, page_size=ps)
    eng = DeviceBackend(dcluster).paged_decode_engine(
        ddag.graph, cfg.build_scheduler().schedule(ddag.graph, dcluster),
        mcfg, weights, pool, slots=slots, pages_per_seq=ppseq, seg_steps=4,
        trace=tracer, metrics=metrics,
    )
    # 4 requests over 2 slots: admission waves, retirement churn, and
    # queue-depth movement — enough to exercise every decode counter
    for i in range(4):
        ids = np.asarray([[1 + (i % 3), 2, 3, 4, 5, 6, 7, 8]], np.int32)
        eng.submit(f"r{i}", ids, 6)
    eng.run()
    return 0


def cmd_trace(args) -> int:
    from .obs.export import export_perfetto, trace_summary, validate_trace
    from .obs.metrics import MetricsRegistry
    from .obs.trace import Tracer

    tracer = Tracer()
    rc = _observed_run(args, tracer, MetricsRegistry())
    if rc:
        return rc
    if not len(tracer):
        print("trace: no events recorded", file=sys.stderr)
        return 2
    path = export_perfetto(tracer, args.out)
    errs = validate_trace(path)
    if errs:
        for e in errs[:10]:
            print(f"trace: {e}", file=sys.stderr)
        return 2
    print("trace ->", path, file=sys.stderr)
    print(json.dumps(trace_summary(path), indent=1))
    return 0


def cmd_metrics(args) -> int:
    from .obs.metrics import MetricsRegistry, validate_snapshot

    reg = MetricsRegistry()
    rc = _observed_run(args, None, reg)
    if rc:
        return rc
    snap = reg.snapshot()
    errs = validate_snapshot(snap)
    if errs:
        for e in errs[:10]:
            print(f"metrics: {e}", file=sys.stderr)
        return 2
    if args.out:
        with open(args.out, "w") as f:
            json.dump(snap, f, indent=1)
        print("metrics ->", args.out, file=sys.stderr)
    print(json.dumps(snap, indent=1))
    return 0


def _slo_live_requests(args, flight):
    """One small paged continuous-batching leg (gpt2 family, 2 slots) on
    the first live device, with the flight recorder wired; returns ``(rc,
    dls.requests/1 snapshot)`` — rc 2 when the configuration cannot
    run."""
    from .backends.device import DeviceBackend

    cfg = _config_from(args)
    if _weights_family(cfg.model) != "gpt2":
        print("slo: live run needs a gpt2-family model (paged decode)",
              file=sys.stderr)
        return 2, None
    import numpy as np

    from .core.cluster import Cluster
    from .frontend.decode_dag import build_paged_decode_dag
    from .models.kv_pages import PagePool
    from .utils.config import platform_devices

    dev = platform_devices(1)[0]
    mcfg = cfg.model_config()
    slots, ps, n_pages, ppseq = 2, 8, 32, 4
    ddag = build_paged_decode_dag(
        mcfg, slots=slots, page_size=ps, n_pages=n_pages,
        pages_per_seq=ppseq,
    )
    params = ddag.init_params(device=dev)
    weights = {k: v for k, v in params.items()
               if not (k.startswith("cache_") or k == "page_table")}
    dcluster = Cluster.from_torch_devices([dev])
    pool = PagePool(n_pages=n_pages, page_size=ps)
    eng = DeviceBackend(dcluster).paged_decode_engine(
        ddag.graph, cfg.build_scheduler().schedule(ddag.graph, dcluster),
        mcfg, weights, pool, slots=slots, pages_per_seq=ppseq, seg_steps=4,
        flight=flight,
    )
    n_req = getattr(args, "n_requests", 4) or 4
    for i in range(n_req):
        ids = np.asarray([[1 + (i % 3), 2, 3, 4, 5, 6, 7, 8]], np.int32)
        eng.submit(f"r{i}", ids, 6)
    eng.run()
    return 0, eng.reqlog.snapshot()


def cmd_slo(args) -> int:
    """SLO report + gate over a request log (``--requests``: a
    ``dls.requests/1`` snapshot, a flight dump, or a decode-bench
    artifact with a paged leg) or a fresh live paged-decode run.  Exit 0
    when every window meets the policy, 1 on breach (the worst window
    and metric are named on stderr), 2 on malformed/empty request logs
    or an unrunnable configuration."""
    from .obs import FlightRecorder, SLOPolicy, evaluate_slo
    from .obs import reqlog as _reqlog

    try:
        policy = SLOPolicy(
            ttft_s=args.ttft, tpot_s=args.tpot, e2e_s=args.e2e,
            window_s=args.window, percentile=args.percentile,
        )
    except ValueError as e:
        print(f"slo: {e} (pass --ttft/--tpot/--e2e)", file=sys.stderr)
        return 2

    flight = None
    if args.requests:
        try:
            with open(args.requests) as f:
                obj = json.load(f)
        except (OSError, ValueError) as e:
            print(f"slo: unreadable request log {args.requests}: {e}",
                  file=sys.stderr)
            return 2
        if not isinstance(obj, dict):
            print(f"slo: {args.requests} is not a JSON object",
                  file=sys.stderr)
            return 2
        if obj.get("schema") == _reqlog.SCHEMA:
            snap = obj
        elif isinstance(obj.get("request_log"), dict):
            snap = obj["request_log"]       # a flight-recorder dump
        elif (isinstance(obj.get("paged"), dict)
              and isinstance(obj["paged"].get("requests"), dict)):
            snap = obj["paged"]["requests"]  # a decode-bench artifact
        else:
            print(f"slo: no dls.requests/1 block found in {args.requests}",
                  file=sys.stderr)
            return 2
    else:
        flight = FlightRecorder()
        rc, snap = _slo_live_requests(args, flight)
        if rc:
            return rc

    errs = _reqlog.validate_request_log(snap)
    if errs:
        for e in errs[:10]:
            print(f"slo: {e}", file=sys.stderr)
        return 2
    if not snap.get("requests"):
        print("slo: request log is empty", file=sys.stderr)
        return 2

    report = evaluate_slo(snap, policy)
    out = {
        "requests": _reqlog.summarize_request_log(snap),
        "slo": report.summary(),
    }
    if report.exceeds() and flight is not None and args.flight_dir:
        from .obs.export import validate_trace

        rec = flight.maybe_dump(args.flight_dir, slo_report=report)
        out["flight_dump"] = dict(
            rec, trace_valid=validate_trace(rec["trace"]) == []
        )
    print(json.dumps(out, indent=1))
    if report.exceeds():
        b = report.worst_breach()
        print(
            f"slo: {b['metric']} {b['percentile']}={b['value']:.6g}s "
            f"exceeds target {b['target']:.6g}s in window {b['window']} "
            f"[{b['t_start']:.3f}s, {b['t_end']:.3f}s)", file=sys.stderr,
        )
        return 1
    return 0


def cmd_serve(args) -> int:
    """Online serving run: open-loop arrivals (seeded Poisson or a
    ``dls.arrivals/1`` trace) through the event-loop front-end over the
    paged decode engine on a virtual clock — SLO-aware admission and
    priority preemption when ``--admission slo`` (the default).  Exit 0
    when the run meets the policy, 1 on SLO breach (flight rings dumped
    to --flight-dir when given), 2 on malformed traces / policies /
    configurations."""
    from .obs import FlightRecorder, SLOPolicy
    from .serve import (
        ServiceTimeModel,
        ServingFrontend,
        VirtualClock,
        load_trace,
        poisson_arrivals,
        save_trace,
    )

    try:
        policy = SLOPolicy(
            ttft_s=args.ttft, tpot_s=args.tpot, e2e_s=args.e2e,
            window_s=args.window, percentile=args.percentile,
        )
    except ValueError as e:
        print(f"serve: {e} (pass --ttft/--tpot/--e2e)", file=sys.stderr)
        return 2
    if args.admission == "slo" and policy.ttft_s is None:
        print("serve: slo admission needs a --ttft target",
              file=sys.stderr)
        return 2

    if args.trace:
        try:
            arrivals = load_trace(args.trace)
        except (OSError, ValueError) as e:
            print(f"serve: {e}", file=sys.stderr)
            return 2
    else:
        try:
            arrivals = poisson_arrivals(
                args.rate, args.n_requests, args.seed,
                prompt_lens=(8, 16), max_new_tokens=(8, 16),
                priorities=(0, 1), priority_weights=(0.3, 0.7),
            )
        except ValueError as e:
            print(f"serve: {e}", file=sys.stderr)
            return 2
    if args.save_trace:
        save_trace(arrivals, args.save_trace)
        print(f"serve: trace -> {args.save_trace}", file=sys.stderr)

    cfg = _config_from(args)
    if _weights_family(cfg.model) != "gpt2":
        print("serve: needs a gpt2-family model (paged decode)",
              file=sys.stderr)
        return 2
    slots, ps, n_pages, ppseq = 4, 8, 13, 4
    too_big = [a.rid for a in arrivals
               if a.prompt_len + a.max_new_tokens > ppseq * ps]
    if too_big:
        print(f"serve: {len(too_big)} arrival(s) exceed the per-request "
              f"KV capacity of {ppseq * ps} tokens (first: "
              f"{too_big[0]!r})", file=sys.stderr)
        return 2

    from .backends.device import DeviceBackend
    from .core.cluster import Cluster
    from .frontend.decode_dag import build_paged_decode_dag
    from .models.kv_pages import PagePool
    from .utils.config import platform_devices

    dev = platform_devices(1)[0]
    clock = VirtualClock()
    flight = FlightRecorder(clock=clock)
    mcfg = cfg.model_config()
    ddag = build_paged_decode_dag(
        mcfg, slots=slots, page_size=ps, n_pages=n_pages,
        pages_per_seq=ppseq, attention_impl=args.attention_impl,
    )
    params = ddag.init_params(device=dev)
    weights = {k: v for k, v in params.items()
               if not (k.startswith("cache_") or k == "page_table")}
    dcluster = Cluster.from_torch_devices([dev])
    pool = PagePool(n_pages=n_pages, page_size=ps)
    eng = DeviceBackend(dcluster).paged_decode_engine(
        ddag.graph, cfg.build_scheduler().schedule(ddag.graph, dcluster),
        mcfg, weights, pool, slots=slots, pages_per_seq=ppseq,
        seg_steps=4, clock=clock, flight=flight,
        attention_impl=args.attention_impl,
        chunk_tokens=args.chunk_tokens,
    )
    fe = ServingFrontend(
        eng, arrivals, policy, admission=args.admission,
        preemption=not args.no_preempt,
        time_model=ServiceTimeModel(),
    )
    report = fe.run()

    out = {k: v for k, v in report.items() if k != "requests"}
    if report["breached"] and args.flight_dir:
        from .obs.export import validate_trace

        rec = flight.maybe_dump(args.flight_dir,
                                slo_report=fe.slo_report)
        out["flight_dump"] = dict(
            rec, trace_valid=validate_trace(rec["trace"]) == []
        )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
        print(f"serve: report -> {args.out}", file=sys.stderr)
    print(json.dumps(out, indent=1, sort_keys=True))
    if report["breached"]:
        b = fe.slo_report.worst_breach()
        print(
            f"serve: {b['metric']} {b['percentile']}={b['value']:.6g}s "
            f"exceeds target {b['target']:.6g}s in window {b['window']} "
            f"[{b['t_start']:.3f}s, {b['t_end']:.3f}s)", file=sys.stderr,
        )
        return 1
    return 0


def cmd_soak(args) -> int:
    """Duration-bounded serving soak with health gating: sustained
    seeded Poisson load over the paged decode engine (virtual time by
    default; ``--real-clock`` serves wall-clock arrivals), sampled every
    ``--sample-every`` seconds into the bounded time-series store and
    gated by the leak/degradation detector battery (HLT001–HLT006)
    after ``--warmup`` exclusion.  Exit 0 healthy (schema-valid
    ``dls.soak/1`` artifact), 1 on a detector breach (the worst
    series+slope named on stderr; flight rings dumped to --flight-dir),
    2 on a malformed config or artifact.  ``--inject-leak`` /
    ``--inject-jit-churn`` are the test/CI fault injectors."""
    from .serve.soak import SoakConfig, run_soak, validate_soak_artifact
    from .utils.config import platform_devices

    try:
        cfg = SoakConfig(
            duration_s=args.duration, sample_every_s=args.sample_every,
            warmup_s=args.warmup, rate_rps=args.rate, seed=args.seed,
            admission=args.admission, ttft_s=args.ttft,
            window_s=args.window, percentile=args.percentile,
            capacity=args.capacity, real_clock=args.real_clock,
            attention_impl=args.attention_impl,
            chunk_tokens=args.chunk_tokens,
        )
        cfg.validate()
        if args.inject_leak is not None and args.inject_leak < 1:
            raise ValueError(
                f"--inject-leak must be >= 1, got {args.inject_leak}"
            )
    except ValueError as e:
        print(f"soak: {e}", file=sys.stderr)
        return 2
    art = run_soak(
        cfg, flight_dir=args.flight_dir,
        inject_leak_every=args.inject_leak,
        inject_churn=args.inject_jit_churn,
        device=platform_devices(1)[0],
    )
    errs = validate_soak_artifact(art)
    if errs:
        for e in errs[:10]:
            print(f"soak: artifact invalid: {e}", file=sys.stderr)
        return 2
    if art["flight_dumps"]:
        from .obs.export import validate_trace

        for rec in art["flight_dumps"]:
            rec["trace_valid"] = validate_trace(rec["trace"]) == []
    if args.out:
        with open(args.out, "w") as f:
            json.dump(art, f, indent=1, sort_keys=True)
        print(f"soak: artifact -> {args.out}", file=sys.stderr)
    print(json.dumps(
        {k: v for k, v in art.items() if k != "timeseries"},
        indent=1, sort_keys=True,
    ))
    if art["verdict"] == "breach":
        worst = max(
            (f for f in art["health"]["findings"]
             if f["severity"] == "error" and f["slope"] is not None),
            key=lambda f: abs(f["slope"]) / f["threshold"],
        )
        print(
            f"soak: {worst['code']} {worst['detector']}: "
            f"{worst['series']} slope {worst['slope']:+.6g}/s exceeds "
            f"{worst['threshold']:g}/s past warmup "
            f"({art['config']['warmup_s']:g}s)", file=sys.stderr,
        )
        return 1
    steady = art["steady_state"]
    print(
        f"soak: healthy — {art['soak.goodput_tok_s']:.1f} tok/s steady "
        f"state over {steady['span_s']:.2f}s "
        f"({art['clock']} clock, {art['serving']['completed']} completed, "
        f"{art['serving']['pages_leaked']} pages leaked)",
        file=sys.stderr,
    )
    return 0


def cmd_doctor(args) -> int:
    """Run doctor: measured critical-path attribution (+ cost-model
    drift when the run is live).  ``--trace`` diagnoses an exported
    trace JSON offline; without it, one profiled ``DeviceBackend``
    execute of the model DAG is attributed directly.  Exit 2 when
    nothing is attributable, 1 when drift exceeds ``--drift-threshold``,
    0 otherwise.

    ``--slo`` switches to the SLO doctor: one flight-recorded paged
    decode leg, the sliding-window report for the ``--slo-*`` targets,
    exit 1 on breach.

    ``--memory`` switches to the MEMORY doctor: one memprof-instrumented
    execute (the default planned path — no per-task profile fences
    needed), printing the per-device memory timelines/watermarks
    (``memory``) and the measured-vs-predicted peak comparison
    (``mem_drift``).  Exit 2 when nothing was recorded or the timeline
    invariant fails, 1 when any device's two-sided drift ratio exceeds
    ``--mem-drift-threshold``, 0 otherwise.

    ``--requests`` switches to the REQUEST doctor: per-request
    waterfall latency attribution with exact tiling and ranked
    aggressor→victim interference pairs, live (bare flag) or offline
    over a saved serve artifact / flight dump / request log.  Exit 1
    when a breaching request's dominant wait bucket exceeds
    ``--dominant-threshold``, 2 malformed.

    ``--fleet`` switches to the FLEET doctor: the per-replica health
    battery over a live chaos leg (bare flag) or a saved
    ``dls.fleet/1`` artifact, exit 1 when any replica currently
    breaches."""
    from .obs.attribution import attribute_run, attribute_trace

    if getattr(args, "memory", False):
        return _cmd_doctor_memory(args)
    if getattr(args, "slo", False):
        return _cmd_doctor_slo(args)
    if getattr(args, "soak", None):
        return _cmd_doctor_soak(args)
    if getattr(args, "fleet", None):
        return _cmd_doctor_fleet(args)
    if getattr(args, "serve", None):
        return _cmd_doctor_serve(args)
    if getattr(args, "requests", None):
        return _cmd_doctor_requests(args)
    if args.trace:
        try:
            att = attribute_trace(args.trace)
        except (OSError, ValueError) as e:
            print(f"doctor: unreadable trace {args.trace}: {e}",
                  file=sys.stderr)
            return 2
        if not att.critical_path:
            print("doctor: trace has no attributable device spans",
                  file=sys.stderr)
            return 2
        print(json.dumps({"attribution": att.summary()}, indent=1))
        return 0

    from .backends.device import DeviceBackend
    from .obs.drift import compute_drift
    from .obs.trace import Tracer

    cfg = _config_from(args)
    dag = cfg.build_graph()
    if not hasattr(dag, "graph"):
        print("doctor needs a model DAG (gpt2* / llama* / mixtral*) or "
              "an exported trace via --trace", file=sys.stderr)
        return 2
    cost_model = None
    if args.costmodel:
        from .utils.costmodel import CostModel

        try:
            cost_model = CostModel.load(args.costmodel)
        except (OSError, ValueError) as e:
            print(f"doctor: --costmodel {args.costmodel}: {e}",
                  file=sys.stderr)
            return 2
        # schedule against the predictions being audited, exactly like
        # a calibrated bench run would
        cost_model.apply(dag.graph)
    cluster = cfg.build_cluster_with_devices()
    dev = cluster.devices[0].torch_device
    schedule = cfg.build_scheduler().schedule(dag.graph, cluster)
    tracer = Tracer()
    DeviceBackend(cluster).execute(
        dag.graph, schedule, dag.init_params(device=dev),
        dag.make_inputs(device=dev), profile=True, trace=tracer,
    )
    att = attribute_run(tracer)
    drift = compute_drift(dag.graph, schedule, cost_model)
    print(json.dumps(
        {"attribution": att.summary(), "drift": drift.summary()},
        indent=1,
    ))
    if not att.critical_path:
        print("doctor: run produced no attributable device spans",
              file=sys.stderr)
        return 2
    if drift.exceeds(args.drift_threshold):
        print(f"doctor: worst per-task drift ratio "
              f"{drift.worst_ratio():.2f}x exceeds the "
              f"--drift-threshold {args.drift_threshold:g}x gate",
              file=sys.stderr)
        return 1
    return 0


def _cmd_doctor_memory(args) -> int:
    """The memory half of the doctor (``doctor --memory``)."""
    from .backends.device import DeviceBackend
    from .obs import MemoryProfiler, compute_mem_drift
    from .obs.trace import Tracer

    cfg = _config_from(args)
    dag = cfg.build_graph()
    if not hasattr(dag, "graph"):
        print("doctor --memory needs a model DAG (gpt2* / llama* / "
              "mixtral*); synthetic graphs have no fns", file=sys.stderr)
        return 2
    cluster = cfg.build_cluster_with_devices()
    dev = cluster.devices[0].torch_device
    schedule = cfg.build_scheduler().schedule(dag.graph, cluster)
    tracer = Tracer()
    mem = MemoryProfiler(tracer=tracer)
    DeviceBackend(cluster).execute(
        dag.graph, schedule, dag.init_params(device=dev),
        dag.make_inputs(device=dev), trace=tracer, memprof=mem,
    )
    if not len(mem):
        print("doctor: run recorded no memory events", file=sys.stderr)
        return 2
    errs = mem.verify()
    if errs:
        for e in errs[:10]:
            print(f"doctor: memory timeline invariant: {e}",
                  file=sys.stderr)
        return 2
    drift = compute_mem_drift(dag.graph, cluster, schedule, mem)
    print(json.dumps(
        {"memory": mem.summary(), "mem_drift": drift.summary()},
        indent=1,
    ))
    for w in drift.warnings:
        print(f"doctor: {w}", file=sys.stderr)
    if drift.exceeds(args.mem_drift_threshold):
        print(f"doctor: worst per-device memory drift ratio "
              f"{drift.worst_ratio():.2f}x exceeds the "
              f"--mem-drift-threshold {args.mem_drift_threshold:g}x gate",
              file=sys.stderr)
        return 1
    return 0


def _cmd_doctor_slo(args) -> int:
    """The SLO half of the doctor (``doctor --slo``)."""
    from .obs import FlightRecorder, SLOPolicy, evaluate_slo
    from .obs.reqlog import summarize_request_log

    try:
        policy = SLOPolicy(
            ttft_s=args.slo_ttft, tpot_s=args.slo_tpot,
            e2e_s=args.slo_e2e, window_s=args.slo_window,
        )
    except ValueError as e:
        print(f"doctor --slo: {e} (pass --slo-ttft/--slo-tpot/--slo-e2e)",
              file=sys.stderr)
        return 2
    flight = FlightRecorder()
    rc, snap = _slo_live_requests(args, flight)
    if rc:
        return rc
    if not snap.get("requests"):
        print("doctor --slo: run recorded no requests", file=sys.stderr)
        return 2
    report = evaluate_slo(snap, policy)
    print(json.dumps(
        {"requests": summarize_request_log(snap), "slo": report.summary()},
        indent=1,
    ))
    if report.exceeds():
        b = report.worst_breach()
        print(
            f"doctor: {b['metric']} {b['percentile']}={b['value']:.6g}s "
            f"exceeds the --slo target {b['target']:.6g}s in window "
            f"{b['window']}", file=sys.stderr,
        )
        return 1
    return 0


def _cmd_doctor_soak(args) -> int:
    """The soak half of the doctor (``doctor --soak SOAK_JSON``):
    re-gate a saved ``dls.soak/1`` artifact offline by rebuilding the
    time-series store from its embedded snapshot and re-running the
    default detector battery.  Exit 2 malformed, 1 on breach, 0
    healthy."""
    from .obs.health import report_from_soak_artifact
    from .serve.soak import load_soak_artifact

    try:
        art = load_soak_artifact(args.soak)
        report = report_from_soak_artifact(art)
    except (OSError, ValueError) as e:
        print(f"doctor --soak: {e}", file=sys.stderr)
        return 2
    print(json.dumps(
        {
            "soak": {
                "clock": art["clock"],
                "verdict_recorded": art["verdict"],
                "steady_state": art["steady_state"],
                "injection": art.get("injection", {}),
            },
            "health": report.to_json(),
        },
        indent=1,
    ))
    if report.exceeds():
        w = report.worst_breach()
        print(
            f"doctor: {w.code} {w.detector}: {w.series} slope "
            f"{w.slope:+.6g}/s exceeds {w.threshold:g}/s past warmup "
            f"({report.warmup_s:g}s)", file=sys.stderr,
        )
        return 1
    return 0


def _cmd_doctor_fleet(args) -> int:
    """The fleet doctor (``doctor --fleet [live|ART_JSON]``): gate a
    replica fleet on the per-replica health battery.

    ``live`` (the default when the flag is bare) runs the serve-bench
    fleet chaos leg — N=3 replicas on the lockstep virtual clock, the
    page leak injected on one, scored routing + the HLT001 battery —
    and gates the resulting :class:`~.obs.fleet.FleetHealthReport`.  A
    healed breach (drained, restarted, readmitted) lives in the event
    history, not the current findings, so a fleet that failed over
    cleanly exits 0.  A path re-gates a saved ``dls.fleet/1`` artifact
    (or a bare ``dls.fleet-health/1`` block) offline.  Exit 2
    malformed, 1 when any replica currently breaches, 0 healthy."""
    from .obs.fleet import report_from_fleet_artifact

    if args.fleet == "live":
        from .eval import serve_bench
        from .obs.fleet import fleet_detectors
        from .obs.slo import SLOPolicy
        from .serve.frontend import ServiceTimeModel
        from .serve.loadgen import poisson_arrivals
        from .utils.config import platform_devices

        sc = dict(serve_bench.SCENARIO, **serve_bench.FLEET_SCENARIO)
        arrivals = poisson_arrivals(
            sc["fleet_rate_rps"], sc["fleet_n_requests"], args.seed or 7,
            prompt_lens=sc["prompt_lens"],
            max_new_tokens=sc["max_new_tokens"],
            priorities=sc["priorities"],
            priority_weights=sc["priority_weights"],
        )
        policy = SLOPolicy(
            ttft_s=sc["ttft_s"], window_s=sc["window_s"],
            percentile=sc["percentile"],
        )
        tm = ServiceTimeModel(
            wave_s=sc["wave_s"], segment_s=sc["segment_s"],
            idle_s=sc["idle_s"],
        )
        leg = serve_bench.run_fleet_leg(
            arrivals, policy, tm, sc, routing="score",
            detectors=fleet_detectors(), leak=True,
            device=platform_devices(1)[0],
        )
        obj = {"fleet_health": leg["fleet_health"]}
        context = {
            "mode": "live",
            "goodput_tok_s": leg["goodput_tok_s"],
            "drains": leg["drains"],
            "restarts": leg["restarts"],
            "migrations": leg["migrations"],
            "pages_leaked": leg["pages_leaked"],
        }
    else:
        try:
            with open(args.fleet) as f:
                obj = json.load(f)
        except (OSError, ValueError) as e:
            print(f"doctor --fleet: {e}", file=sys.stderr)
            return 2
        context = {"mode": "offline", "path": args.fleet}
        if isinstance(obj, dict):
            context["schema"] = obj.get("schema")
    try:
        report = report_from_fleet_artifact(obj)
    except ValueError as e:
        print(f"doctor --fleet: {e}", file=sys.stderr)
        return 2
    print(json.dumps(
        {"fleet": context, "fleet_health": report.to_json()},
        indent=1,
    ))
    if report.exceeds():
        rid, w = report.worst_breach() or report.breaches()[0]
        print(
            f"doctor: replica {rid}: {w.code} {w.detector}: {w.series} "
            f"slope {w.slope:+.6g}/s exceeds {w.threshold:g}/s",
            file=sys.stderr,
        )
        return 1
    n = len(report.replicas)
    print(
        f"fleet: healthy — {n} replicas, {report.drains()} drains, "
        f"{report.restarts()} restarts on record", file=sys.stderr,
    )
    return 0


def _cmd_doctor_serve(args) -> int:
    """The serving-safety half of the doctor (``doctor --serve
    ART_JSON``): re-gate a committed ``dls.serve/1`` or ``dls.soak/1``
    artifact offline through the page-lifetime and request-lifecycle
    passes — leaked-page gauges become PGL001 errors, embedded
    ownership-event streams are replayed page by page, and per-request
    rows are protocol-checked.  Exit 2 malformed/unknown schema, 1 when
    any pass errors, 0 clean — mirroring ``doctor --soak``."""
    from .analysis import analyze_serve_artifact
    from .eval.serve_bench import validate_serve_artifact
    from .serve.soak import validate_soak_artifact

    try:
        with open(args.serve) as f:
            art = json.load(f)
    except (OSError, ValueError) as e:
        print(f"doctor --serve: {e}", file=sys.stderr)
        return 2
    schema = art.get("schema") if isinstance(art, dict) else None
    if schema == "dls.serve/1":
        problems = validate_serve_artifact(art)
    elif schema == "dls.soak/1":
        problems = validate_soak_artifact(art)
    else:
        print(f"doctor --serve: unknown artifact schema {schema!r} "
              "(want dls.serve/1 or dls.soak/1)", file=sys.stderr)
        return 2
    if problems:
        for p in problems:
            print(f"doctor --serve: {p}", file=sys.stderr)
        return 2
    try:
        rep = analyze_serve_artifact(art).dedupe()
    except ValueError as e:
        print(f"doctor --serve: {e}", file=sys.stderr)
        return 2
    print(json.dumps(
        {
            "serve": {
                "schema": schema,
                "seed": art.get("seed"),
                "clock": art.get("clock"),
            },
            "lint": rep.to_json(),
        },
        indent=1,
    ))
    if rep.errors:
        d = rep.errors[0]
        print(f"doctor: {d.code}: {d.message}", file=sys.stderr)
        return 1
    return 0


def _cmd_doctor_requests(args) -> int:
    """The request doctor (``doctor --requests [live|ART_JSON]``):
    per-request waterfall attribution — each request's e2e decomposed
    into the eight interference buckets (exact tiling to 1e-9) with the
    ranked aggressor→victim pairs.

    ``live`` (the default when the flag is bare) serves the serve-bench
    overload scenario on a virtual clock with the waterfall recorder
    wired, so the attribution runs span-exact.  A path re-gates a saved
    artifact offline: a ``dls.serve/1`` artifact (each leg's rows), a
    flight-recorder dump (its ``request_log``; pass the matching
    ``flight_trace.json`` via ``--requests-trace`` to upgrade rows-only
    to span attribution), or a bare ``dls.requests/1`` snapshot.  Exit 2
    malformed/empty, 1 when a breaching request's dominant wait bucket
    exceeds ``--dominant-threshold``, 0 otherwise."""
    from .obs.interference import attribute_requests, events_from_perfetto

    events = None
    if getattr(args, "requests_trace", None):
        try:
            with open(args.requests_trace) as f:
                events = events_from_perfetto(json.load(f))
        except (OSError, ValueError) as e:
            print(f"doctor --requests-trace: {e}", file=sys.stderr)
            return 2
    ttft_target = getattr(args, "slo_ttft", None)
    threshold = getattr(args, "dominant_threshold", 0.5)

    legs = {}
    if args.requests == "live":
        from .eval import serve_bench
        from .obs.slo import SLOPolicy
        from .obs.trace import Tracer
        from .serve.frontend import (
            ServiceTimeModel,
            ServingFrontend,
            VirtualClock,
        )
        from .serve.loadgen import poisson_arrivals
        from .utils.config import platform_devices

        sc = serve_bench.SCENARIO
        clock = VirtualClock()
        eng, _pool = serve_bench.build_serve_engine(
            slots=sc["slots"], page_size=sc["page_size"],
            n_pages=sc["n_pages"], pages_per_seq=sc["pages_per_seq"],
            seg_steps=sc["seg_steps"], clock=clock,
            device=platform_devices(1)[0],
        )
        eng.rebind_obs(clock=clock, tracer=Tracer(clock=clock))
        arrivals = poisson_arrivals(
            sc["rate_rps"], sc["n_requests"], args.seed or 7,
            prompt_lens=sc["prompt_lens"],
            max_new_tokens=sc["max_new_tokens"],
            priorities=sc["priorities"],
            priority_weights=sc["priority_weights"],
        )
        policy = SLOPolicy(
            ttft_s=sc["ttft_s"], window_s=sc["window_s"],
            percentile=sc["percentile"],
        )
        tm = ServiceTimeModel(
            wave_s=sc["wave_s"], segment_s=sc["segment_s"],
            idle_s=sc["idle_s"],
        )
        fe = ServingFrontend(
            eng, arrivals, policy, admission="slo", preemption=True,
            time_model=tm,
        )
        rep = fe.run()
        if ttft_target is None:
            ttft_target = sc["ttft_s"]
        legs["live"] = (rep["requests"], list(eng.tracer.events))
    else:
        try:
            with open(args.requests) as f:
                obj = json.load(f)
        except (OSError, ValueError) as e:
            print(f"doctor --requests: {e}", file=sys.stderr)
            return 2
        if not isinstance(obj, dict):
            print(f"doctor --requests: {args.requests} is not a JSON "
                  "object", file=sys.stderr)
            return 2
        schema = obj.get("schema")
        if schema == "dls.serve/1":
            if ttft_target is None:
                ttft_target = (obj.get("policy") or {}).get("ttft_s")
            for name, leg in (obj.get("legs") or {}).items():
                rows = leg.get("requests")
                if rows:
                    legs[name] = (rows, events)
        elif isinstance(obj.get("request_log"), dict):
            legs["flight"] = (
                obj["request_log"].get("requests") or [], events
            )
        elif schema == "dls.requests/1":
            legs["requests"] = (obj.get("requests") or [], events)
        else:
            print(f"doctor --requests: no request rows in "
                  f"{args.requests} (want dls.serve/1, a flight dump, "
                  "or dls.requests/1)", file=sys.stderr)
            return 2
    reports = {
        name: attribute_requests(
            rows, events=evs, ttft_target_s=ttft_target,
            threshold=threshold,
        )
        for name, (rows, evs) in legs.items()
    }
    print(json.dumps(
        {"interference": {
            name: r.summary() for name, r in reports.items()
        }},
        indent=1, sort_keys=True,
    ))
    if not any(r.n_attributed for r in reports.values()):
        print("doctor --requests: no attributable requests "
              "(every row lacks a terminal timestamp)", file=sys.stderr)
        return 2
    for name, r in sorted(reports.items()):
        if r.exceeds():
            f0 = r.findings[0]
            agg = f0.get("top_aggressor")
            print(
                f"doctor: [{name}] request {f0['rid']} breached "
                f"ttft {f0['ttft_s']:.6g}s > {ttft_target:.6g}s with "
                f"{f0['dominant']} = {f0['dominant_frac']:.0%} of e2e"
                + (f" (top aggressor: {agg})" if agg else ""),
                file=sys.stderr,
            )
            return 1
    return 0


def cmd_metrics_diff(args) -> int:
    """``metrics diff A B``: counter/gauge deltas and histogram quantile
    shifts between two ``dls.metrics/1`` snapshots — or, with
    ``--at I --vs J``, between two sample indices of ONE
    ``dls.timeseries/1`` file (a ``dls.soak/1`` artifact's embedded
    series also works), so start-of-soak vs end-of-soak diffs need no
    hand-edited JSON.  Exit 2 on an unreadable file, schema mismatch, or
    an index no series can satisfy."""
    from .obs.metrics import diff_snapshots

    if args.at is not None or args.vs is not None:
        if args.at is None or args.vs is None:
            print("metrics diff: --at and --vs go together",
                  file=sys.stderr)
            return 2
        if args.snapshot_b is not None:
            print("metrics diff: --at/--vs index ONE timeseries file, "
                  "not two snapshots", file=sys.stderr)
            return 2
        from .obs.timeseries import snapshot_at

        try:
            with open(args.snapshot_a) as f:
                obj = json.load(f)
        except (OSError, ValueError) as e:
            print(f"metrics diff: unreadable timeseries "
                  f"{args.snapshot_a}: {e}", file=sys.stderr)
            return 2
        if isinstance(obj, dict) and "timeseries" in obj:
            obj = obj["timeseries"]     # a dls.soak/1 artifact
        try:
            snaps = [snapshot_at(obj, args.at), snapshot_at(obj, args.vs)]
        except ValueError as e:
            print(f"metrics diff: {e}", file=sys.stderr)
            return 2
        if not snaps[0]["gauges"] or not snaps[1]["gauges"]:
            which = args.at if not snaps[0]["gauges"] else args.vs
            print(f"metrics diff: no series holds sample index {which}",
                  file=sys.stderr)
            return 2
    else:
        if args.snapshot_b is None:
            print("metrics diff: need two snapshot files (or --at/--vs "
                  "over one timeseries)", file=sys.stderr)
            return 2
        snaps = []
        for path in (args.snapshot_a, args.snapshot_b):
            try:
                with open(path) as f:
                    snaps.append(json.load(f))
            except (OSError, ValueError) as e:
                print(f"metrics diff: unreadable snapshot {path}: {e}",
                      file=sys.stderr)
                return 2
    try:
        diff = diff_snapshots(*snaps)
    except ValueError as e:
        print(f"metrics diff: {e}", file=sys.stderr)
        return 2
    print(json.dumps(diff, indent=1))
    return 0


def cmd_regress(args) -> int:
    """Compare a fresh bench artifact against a committed baseline;
    exit with the verdict (non-zero on any regressed/missing metric)."""
    from .eval.regress import compare_artifacts, parse_tolerances

    try:
        tolerances = parse_tolerances(args.tolerance or [])
    except ValueError as e:
        print(f"regress: {e}", file=sys.stderr)
        return 2
    metrics = None
    if args.metrics:
        metrics = [m.strip() for m in args.metrics.split(",") if m.strip()]
    try:
        verdict = compare_artifacts(
            args.fresh, args.baseline,
            tolerances=tolerances, metrics=metrics,
            default_tolerance=args.default_tolerance,
        )
    except (OSError, ValueError) as e:
        print(f"regress: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(verdict.to_json(), indent=1))
    else:
        print(verdict.render())
    return verdict.exit_code



def cmd_bench(args) -> int:
    """The port's own north-star bench (``eval/bench.py``), on the card."""
    from .eval import bench

    return bench.main([args.config])


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="distributed_llm_scheduler_tpu_torch",
        description="memory-constrained DAG scheduling for LLMs on NVIDIA "
                    "GPUs (the PyTorch port)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("schedule", help="place a DAG and report metrics")
    _add_common(p)
    p.add_argument("--trace", default=None,
                   help="write the replay timeline as a Chrome/Perfetto "
                        "trace JSON to this path")
    p.add_argument("--save", action="store_true", help="save graph+schedule JSON")
    p.add_argument("--validate", action="store_true",
                   help="run the independent schedule checker (exit 2 on violations)")
    p.set_defaults(fn=cmd_schedule)

    p = sub.add_parser(
        "lint",
        help="static analysis: lint a DAG + schedule + sharding config "
             "without executing (exit 1 on errors)",
    )
    _add_common(p)
    p.add_argument("--parallel", action="store_true",
                   help="sweep the hand-written parallel layer instead of "
                        "a DAG: trace every registered entry point "
                        "(parallel/*) and check collective ordering "
                        "(COL003/COL004/COL008) plus the MPMD "
                        "happens-before self-check (COL005-COL007); not "
                        "ported yet (exits 2, ROADMAP.md A.11)")
    p.add_argument("--serving", action="store_true",
                   help="run the serving-safety passes instead of a DAG: "
                        "page-lifetime prover (PGL00x) over an "
                        "ownership-instrumented serve_bench scenario, "
                        "request-lifecycle checker (LCY00x) over frontend "
                        "+ engine logs, repo-wide determinism lint "
                        "(DET00x)")
    p.add_argument("--prefix", action="store_true",
                   help="with --serving: serve the shared-prefix session "
                        "workload on a sharing-enabled engine so the "
                        "prover replays the ref-counted "
                        "share/unshare/cow/write lattice "
                        "(PGL006/PGL007)")
    p.add_argument("--inject-leak", type=int, default=None,
                   dest="inject_leak", metavar="N",
                   help="with --serving: withhold one page from every "
                        "Nth free (the leaky-pool fault injector) — the "
                        "prover must exit 1 naming PGL001")
    p.add_argument("--inject-underflow", action="store_true",
                   dest="inject_underflow",
                   help="with --serving --prefix: lose one reference per "
                        "share (the refcount-underflow fault injector) — "
                        "the prover must exit 1 naming PGL006")
    p.add_argument("--decode", action="store_true",
                   help="lint the single-token decode-step DAG instead of "
                        "the full forward")
    p.add_argument("--paged", action="store_true",
                   help="lint the paged KV-cache decode-step DAG "
                        "(--batch sets the slot count; gpt2 family only)")
    p.add_argument("--page-size", type=int, default=16,
                   help="rows per KV page for --paged (default 16); "
                        "DEC005 warns when the geometry makes the fused "
                        "Pallas kernel ineligible (gather fallback)")
    p.add_argument("--chunk-tokens", type=int, default=None,
                   dest="chunk_tokens", metavar="N",
                   help="with --paged: also lint the chunked-prefill "
                        "chunk size (DEC006 warns when the ragged "
                        "multi-token-q kernel is ineligible at this "
                        "size, or when one chunk exceeds the "
                        "slots*seg-steps per-segment prefill budget)")
    p.add_argument("--seg-steps", type=int, default=8,
                   dest="seg_steps", metavar="K",
                   help="decode steps per segment for the DEC006 budget "
                        "check (default 8, the engine default; --batch "
                        "sets the slot count)")
    p.add_argument("--fix", action="store_true",
                   help="apply mechanical fixes before linting "
                        "(DAG003 duplicate-dependency dedup keeping the "
                        "original call arity; SCH005/PIP001 per-node "
                        "order re-sort when a legal topological order "
                        "exists)")
    p.add_argument("--preflight", action="store_true",
                   help="also run the memory preflight (each distinct "
                        "task once on the card, the allocator's peak) and "
                        "flag tasks whose analytic estimate diverges >2x "
                        "from it (CST00x warnings; model DAGs only)")
    p.add_argument("--strict", action="store_true",
                   help="treat eviction-required residency (MEM002) as an "
                        "error")
    p.add_argument("--verbose", action="store_true",
                   help="also print info-level diagnostics (per-node peak "
                        "residency)")
    p.add_argument("--json", action="store_true",
                   help="emit the report as one machine-readable JSON "
                        "object (schema dls.lint/1) on stdout instead of "
                        "rendered text; exit codes unchanged")
    p.set_defaults(fn=cmd_lint)

    p = sub.add_parser("sweep", help="full evaluation sweep (CSV+PNG)")
    _add_common(p)
    p.add_argument("--num-runs", type=int, default=3)
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("execute", help="run a scheduled DAG on live devices")
    _add_common(p)
    p.add_argument("--profile", action="store_true")
    p.add_argument("--segments", action="store_true",
                   help="fuse each device's contiguous scheduled run into "
                        "one program (a CUDA graph on a card; "
                        "incompatible with --profile)")
    p.add_argument("--trace", default=None,
                   help="write measured task timeline (needs --profile) as "
                        "a Chrome/Perfetto trace JSON to this path")
    p.add_argument("--stream-params", action="store_true",
                   dest="stream_params",
                   help="planned param streaming (prefetch + Belady "
                        "eviction) under each node's HBM budget — executes "
                        "models whose weights exceed the budget (bandwidth "
                        "for capacity); composes with --segments (one "
                        "batched load per fused program)")
    p.add_argument("--inject-failure", default=None, metavar="NODE[:FRAC]",
                   dest="inject_failure",
                   help="fault injection: kill NODE (id or index) after "
                        "FRAC (default 0.5) of the run, reschedule the "
                        "remainder on the survivors with retained outputs, "
                        "and verify the recovered result")
    p.add_argument("--weights", default=None,
                   help="torch state-dict file with pretrained GPT-2 / "
                        "Llama / Mixtral weights (HF layout); random "
                        "init when omitted")
    p.set_defaults(fn=cmd_execute)

    p = sub.add_parser("visualize", help="render DAG + Gantt PNGs")
    _add_common(p)
    p.add_argument("--detailed", action="store_true")
    p.add_argument("--show", action="store_true",
                   help="also open figures in a window (interactive analog "
                        "of the reference's visu menu)")
    p.add_argument("--menu", action="store_true",
                   help="stdin-driven menu loop: re-render DAG/Gantt, "
                        "switch policies, and print summaries without "
                        "re-running the CLI")
    p.add_argument("--from-trace", default=None, dest="from_trace",
                   metavar="TRACE_JSON",
                   help="render the gantt from an exported trace JSON "
                        "(measured spans from a DLS_TRACE=1 run) instead "
                        "of a simulated replay; critical-path spans get "
                        "a highlight edge")
    p.set_defaults(fn=cmd_visualize)

    p = sub.add_parser("train", help="run sharded training steps")
    _add_common(p)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--pp", type=int, default=0,
                   help="N>0: pipeline-parallel training over N stage "
                        "devices (GPipe scan; microbatches default to N)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize transformer blocks in the backward "
                        "pass (torch.utils.checkpoint): memory for FLOPs")
    p.add_argument("--scan", action="store_true",
                   help="apply one block over stacked layer params "
                        "(lax.scan's layout)")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint directory: resumed from if it exists, "
                        "written (params + optimizer state + step) at the "
                        "end of the run")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser(
        "generate", help="autoregressive KV-cache decoding (one JSON line)"
    )
    p.add_argument("--model", default="gpt2-tiny",
                   help="gpt2[-medium|-tiny] | llama-8b|-tiny | "
                        "mixtral-8x7b|-tiny")
    p.add_argument("--prompt-ids", default="1,2,3", dest="prompt_ids",
                   help="comma-separated prompt token ids")
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy")
    p.add_argument("--top-k", type=int, default=0, dest="top_k")
    p.add_argument("--weights", default=None,
                   help="torch state-dict file with pretrained GPT-2 / "
                        "Llama / Mixtral weights (HF layout); random "
                        "init when omitted")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--kv-int8", action="store_true", dest="kv_int8",
                   help="store the KV cache as int8 with per-row scales "
                        "(models/decode.quantize_cache): ~2x fewer cache "
                        "bytes re-read per step; lossy (greedy tokens can "
                        "differ from the bf16-cache run)")
    p.add_argument("--quantize", default="none", choices=["none", "int8"],
                   help="int8 weights, dequantized on device inside each "
                        "step: ~half the weight bytes re-read per token; "
                        "lossy like --kv-int8.  Whole-program path uses "
                        "the grouped+rowwise fidelity scheme; --task-graph "
                        "quantizes the placed weight tasks (channel "
                        "scheme, cache slabs stay fp)")
    p.add_argument("--task-graph", action="store_true", dest="task_graph",
                   help="generate through the scheduling layer: decode "
                        "steps as task DAGs (KV-cache slabs as placeable "
                        "params) placed by --scheduler and executed on "
                        "live devices; greedy sampling, all three "
                        "families. Position is a runtime input, so the "
                        "whole generation builds two graphs (prefill + "
                        "decode step), independent of token count")
    # None defaults so flags passed WITHOUT --task-graph fail fast
    # (the whole-program path does no scheduling; silent acceptance
    # would be a dead-flag lie)
    p.add_argument("--scheduler", default=None)
    p.add_argument("--num-nodes", type=int, default=None)
    p.add_argument("--hbm-gb", type=float, default=None)
    p.add_argument("--loop-steps", type=int, default=None, dest="loop_steps",
                   help="with --task-graph: run N decode steps per call "
                        "of the composed step function (backends/"
                        "decode_loop), paying one host round-trip per N "
                        "tokens instead of per token; requires the "
                        "schedule to place on a single node")
    p.set_defaults(fn=cmd_generate)

    p = sub.add_parser("bench", help="north-star benchmark (one JSON line)")
    p.add_argument("config", nargs="?", default="small",
                   choices=("small", "medium"),
                   help="bench config: GPT-2 small (flagship, default) or "
                        "medium (BASELINE config #2)")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser(
        "trace",
        help="run an observed execute (+ small paged-decode leg) and "
             "write one Perfetto-loadable trace JSON",
    )
    _add_common(p)
    p.add_argument("--out", default="trace.json",
                   help="output trace path (open at ui.perfetto.dev)")
    p.add_argument("--skip-decode", action="store_true", dest="skip_decode",
                   help="skip the paged continuous-batching decode leg "
                        "(its counter tracks and TTFT/TPOT samples)")
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser(
        "metrics",
        help="same observed run, print the metrics-registry snapshot "
             "(dls.metrics/1 JSON)",
    )
    _add_common(p)
    p.add_argument("--out", default=None,
                   help="also write the snapshot JSON to this path")
    p.add_argument("--skip-decode", action="store_true", dest="skip_decode",
                   help="skip the paged decode leg")
    p.set_defaults(fn=cmd_metrics)
    msub = p.add_subparsers(dest="metrics_cmd")
    pd = msub.add_parser(
        "diff",
        help="diff two dls.metrics/1 snapshot files: counter/gauge "
             "deltas + histogram p50/p95 shifts (exit 2 on schema "
             "mismatch); or with --at/--vs, diff two sample indices of "
             "one dls.timeseries/1 file (dls.soak/1 artifacts work too)",
    )
    pd.add_argument("snapshot_a",
                    help="before snapshot JSON (with --at/--vs: the "
                         "timeseries or soak-artifact JSON)")
    pd.add_argument("snapshot_b", nargs="?", default=None,
                    help="after snapshot JSON (omit with --at/--vs)")
    pd.add_argument("--at", type=int, default=None, metavar="INDEX",
                    help="'before' sample index into each series "
                         "(Python-style; negatives count from the end)")
    pd.add_argument("--vs", type=int, default=None, metavar="INDEX",
                    help="'after' sample index into each series")
    pd.set_defaults(fn=cmd_metrics_diff)

    p = sub.add_parser(
        "slo",
        help="sliding-window SLO report + gate (exit 1 on breach) over "
             "a request log or a fresh flight-recorded paged-decode run",
    )
    _add_common(p)
    p.add_argument("--requests", default=None, metavar="PATH",
                   help="offline mode: evaluate this dls.requests/1 "
                        "snapshot (also accepts a flight-recorder dump "
                        "or a decode-bench artifact with a paged leg) "
                        "instead of running live")
    p.add_argument("--ttft", type=float, default=None, metavar="SECONDS",
                   help="per-window TTFT target at --percentile")
    p.add_argument("--tpot", type=float, default=None, metavar="SECONDS",
                   help="per-window TPOT (inter-token) target")
    p.add_argument("--e2e", type=float, default=None, metavar="SECONDS",
                   help="per-window end-to-end latency target")
    p.add_argument("--window", type=float, default=1.0, metavar="SECONDS",
                   help="sliding wall-clock window size (default 1.0)")
    p.add_argument("--percentile", default="p95",
                   choices=("p50", "p95", "p99"),
                   help="which per-window quantile gates (default p95)")
    p.add_argument("--n-requests", type=int, default=4, dest="n_requests",
                   help="live mode: requests to submit over the 2-slot "
                        "engine (default 4)")
    p.add_argument("--flight-dir", default=None, dest="flight_dir",
                   metavar="DIR",
                   help="live mode: on breach, dump the flight-recorder "
                        "rings (Perfetto trace + request log) here")
    p.set_defaults(fn=cmd_slo)

    p = sub.add_parser(
        "serve",
        help="online serving run on a virtual clock: open-loop arrivals "
             "through the SLO-aware front-end over the paged decode "
             "engine (exit 1 on SLO breach, 2 on malformed input)",
    )
    _add_common(p)
    p.add_argument("--rate", type=float, default=40.0, metavar="RPS",
                   help="offered load for the seeded Poisson generator "
                        "(default 40.0 req/s; ignored with --trace)")
    p.add_argument("--requests", type=int, default=32, dest="n_requests",
                   help="number of arrivals to generate (default 32; "
                        "ignored with --trace)")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="replay this dls.arrivals/1 trace instead of "
                        "generating arrivals (malformed -> exit 2)")
    p.add_argument("--save-trace", default=None, dest="save_trace",
                   metavar="PATH",
                   help="write the arrival schedule as a dls.arrivals/1 "
                        "trace for exact replay")
    p.add_argument("--admission", default="slo", choices=("slo", "fifo"),
                   help="admission policy: slo (shed/defer low tiers on "
                        "TTFT-window breach; default) or fifo admit-all")
    p.add_argument("--no-preempt", action="store_true", dest="no_preempt",
                   help="disable priority preemption (slo admission only)")
    p.add_argument("--ttft", type=float, default=2.0, metavar="SECONDS",
                   help="per-window TTFT target at --percentile "
                        "(default 2.0)")
    p.add_argument("--tpot", type=float, default=None, metavar="SECONDS",
                   help="per-window TPOT (inter-token) target")
    p.add_argument("--e2e", type=float, default=None, metavar="SECONDS",
                   help="per-window end-to-end latency target")
    p.add_argument("--window", type=float, default=0.5, metavar="SECONDS",
                   help="sliding virtual-time window size (default 0.5)")
    p.add_argument("--percentile", default="p95",
                   choices=("p50", "p95", "p99"),
                   help="which per-window quantile gates (default p95)")
    p.add_argument("--flight-dir", default=None, dest="flight_dir",
                   metavar="DIR",
                   help="on breach, dump the flight-recorder rings "
                        "(Perfetto trace + request log) here")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="write the full serving report (including "
                        "per-request rows) here")
    p.add_argument("--attention-impl", default=None, dest="attention_impl",
                   choices=("auto", "kernel", "plain"),
                   help="paged attention implementation baked into the "
                        "engine (default: op-level auto — the CUDA paged "
                        "kernel on a card, the plain PyTorch version on "
                        "the CPU)")
    p.add_argument("--chunk-tokens", type=int, default=None,
                   dest="chunk_tokens", metavar="N",
                   help="chunked prefill: prompts longer than N tokens "
                        "admit with first-chunk pages only and prefill "
                        "N tokens per segment fused into the decode "
                        "waves (default: whole-prompt admission; "
                        "greedy tokens are bitwise identical either "
                        "way)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "soak",
        help="duration-bounded serving soak with bounded time-series "
             "telemetry and trend health gating (exit 1 on "
             "leak/degradation breach, 2 on malformed input)",
    )
    _add_common(p)
    p.add_argument("--duration", type=float, default=4.0, metavar="SECONDS",
                   help="soak length in clock seconds (default 4.0)")
    p.add_argument("--sample-every", type=float, default=0.1,
                   dest="sample_every", metavar="SECONDS",
                   help="telemetry sampling cadence (default 0.1)")
    p.add_argument("--warmup", type=float, default=1.0, metavar="SECONDS",
                   help="prefix excluded from every trend (default 1.0)")
    p.add_argument("--rate", type=float, default=12.0, metavar="RPS",
                   help="sustained offered load for the seeded Poisson "
                        "generator (default 12.0 req/s)")
    p.add_argument("--admission", default="slo", choices=("slo", "fifo"),
                   help="front-end admission policy (default slo)")
    p.add_argument("--ttft", type=float, default=0.3, metavar="SECONDS",
                   help="admission TTFT target at --percentile "
                        "(default 0.3)")
    p.add_argument("--window", type=float, default=0.2, metavar="SECONDS",
                   help="admission sliding-window size (default 0.2)")
    p.add_argument("--percentile", default="p95",
                   choices=("p50", "p95", "p99"),
                   help="which per-window quantile gates admission "
                        "(default p95)")
    p.add_argument("--capacity", type=int, default=512,
                   help="per-series ring capacity; overflow decimates "
                        "2:1 (default 512)")
    p.add_argument("--real-clock", action="store_true", dest="real_clock",
                   help="run against the wall clock (monotonic time, "
                        "real idle sleeps) instead of the virtual clock")
    p.add_argument("--flight-dir", default=None, dest="flight_dir",
                   metavar="DIR",
                   help="on the first health breach, dump the flight-"
                        "recorder rings (Perfetto trace + request log) "
                        "here while the anomaly is still in them")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="write the full dls.soak/1 artifact (including "
                        "the timeseries snapshot) here")
    p.add_argument("--inject-leak", type=int, default=None,
                   dest="inject_leak", metavar="N",
                   help="testing: withhold one page from every Nth "
                        "free() — must trip HLT001")
    p.add_argument("--inject-jit-churn", action="store_true",
                   dest="inject_jit_churn",
                   help="testing: plant a fresh prefill compile-cache "
                        "entry every segment — must trip HLT003")
    p.add_argument("--attention-impl", default=None, dest="attention_impl",
                   choices=("auto", "kernel", "plain"),
                   help="paged attention implementation baked into the "
                        "engine (default: op-level auto)")
    p.add_argument("--chunk-tokens", type=int, default=None,
                   dest="chunk_tokens", metavar="N",
                   help="chunked prefill chunk size for the soak engine "
                        "(default: whole-prompt admission)")
    p.set_defaults(fn=cmd_soak)

    p = sub.add_parser(
        "doctor",
        help="explain a run: measured critical-path attribution "
             "(compute/transfer/dispatch/idle) + cost-model drift",
    )
    _add_common(p)
    p.add_argument("--trace", default=None, metavar="TRACE_JSON",
                   help="diagnose an exported trace JSON offline instead "
                        "of running a profiled execute")
    p.add_argument("--costmodel", default=None, metavar="PATH",
                   help="calibrated CostModel JSON (utils/costmodel "
                        "cache entry) to audit; defaults to the graph's "
                        "analytic compute_time estimates")
    p.add_argument("--drift-threshold", type=float, default=None,
                   dest="drift_threshold", metavar="RATIO",
                   help="exit 1 when any task's two-sided predicted-vs-"
                        "measured ratio max(r, 1/r) exceeds RATIO "
                        "(default: report only, never gate)")
    p.add_argument("--memory", action="store_true",
                   help="memory doctor: measured per-device memory "
                        "timelines, watermark attribution, and "
                        "measured-vs-predicted peak drift instead of the "
                        "time doctor")
    p.add_argument("--mem-drift-threshold", type=float, default=None,
                   dest="mem_drift_threshold", metavar="RATIO",
                   help="with --memory: exit 1 when any device's "
                        "two-sided measured-vs-predicted peak ratio "
                        "max(r, 1/r) exceeds RATIO (default: report "
                        "only, never gate)")
    p.add_argument("--slo", action="store_true",
                   help="SLO doctor: one flight-recorded paged decode "
                        "leg, sliding-window report for the --slo-* "
                        "targets, exit 1 on breach")
    p.add_argument("--slo-ttft", type=float, default=None, dest="slo_ttft",
                   metavar="SECONDS", help="with --slo: TTFT target")
    p.add_argument("--slo-tpot", type=float, default=None, dest="slo_tpot",
                   metavar="SECONDS", help="with --slo: TPOT target")
    p.add_argument("--slo-e2e", type=float, default=None, dest="slo_e2e",
                   metavar="SECONDS", help="with --slo: e2e target")
    p.add_argument("--slo-window", type=float, default=1.0,
                   dest="slo_window", metavar="SECONDS",
                   help="with --slo: window size (default 1.0)")
    p.add_argument("--soak", default=None, metavar="SOAK_JSON",
                   help="soak doctor: re-gate a saved dls.soak/1 "
                        "artifact offline — rebuild its timeseries and "
                        "re-run the leak/degradation detector battery "
                        "(exit 1 on breach, 2 malformed)")
    p.add_argument("--fleet", nargs="?", const="live", default=None,
                   metavar="FLEET_JSON",
                   help="fleet doctor: gate the per-replica health "
                        "battery — bare flag runs the fleet chaos leg "
                        "live (leak injected, drain/restart must heal "
                        "it); a path re-gates a saved dls.fleet/1 "
                        "artifact or dls.fleet-health/1 block offline "
                        "(exit 1 when any replica currently breaches, "
                        "2 malformed)")
    p.add_argument("--serve", default=None, metavar="ART_JSON",
                   help="serving-safety doctor: re-gate a committed "
                        "dls.serve/1 or dls.soak/1 artifact offline "
                        "through the page-lifetime (PGL00x) and "
                        "request-lifecycle (LCY00x) passes (exit 1 on "
                        "findings, 2 malformed)")
    p.add_argument("--requests", nargs="?", const="live", default=None,
                   metavar="ART_JSON",
                   help="request doctor: per-request waterfall latency "
                        "attribution (exact bucket tiling + ranked "
                        "aggressor→victim pairs) — bare flag runs the "
                        "serve-bench scenario live with the waterfall "
                        "recorder; a path re-gates a dls.serve/1 "
                        "artifact, flight dump, or dls.requests/1 "
                        "snapshot offline (exit 1 when a breaching "
                        "request is wait-dominated, 2 malformed)")
    p.add_argument("--requests-trace", default=None, dest="requests_trace",
                   metavar="TRACE_JSON",
                   help="with --requests FLIGHT_DUMP: the matching "
                        "flight_trace.json, upgrading rows-only "
                        "attribution to span-exact")
    p.add_argument("--dominant-threshold", type=float, default=0.5,
                   dest="dominant_threshold", metavar="FRAC",
                   help="with --requests: exit 1 when a breaching "
                        "request's dominant wait bucket exceeds this "
                        "fraction of its e2e (default 0.5)")
    p.set_defaults(fn=cmd_doctor)

    p = sub.add_parser(
        "regress",
        help="perf-regression gate: fresh bench artifact vs committed "
             "baseline with per-metric tolerances (non-zero on regression)",
    )
    p.add_argument("--fresh", required=True,
                   help="freshly measured bench artifact JSON")
    p.add_argument("--baseline", required=True,
                   help="committed baseline artifact (e.g. "
                        "BENCH_MEDIUM_r05.json)")
    p.add_argument("--tolerance", action="append", default=None,
                   metavar="METRIC=FRAC",
                   help="per-metric relative tolerance (repeatable), "
                        "e.g. --tolerance value=0.25")
    p.add_argument("--default-tolerance", type=float, default=0.10,
                   dest="default_tolerance",
                   help="tolerance for metrics without an explicit "
                        "--tolerance (default 0.10)")
    p.add_argument("--metrics", default=None,
                   help="comma-separated metric names to check (default: "
                        "the quality set present in the baseline)")
    p.add_argument("--json", action="store_true",
                   help="print the structured verdict instead of the "
                        "table")
    p.set_defaults(fn=cmd_regress)

    p = sub.add_parser(
        "rankcheck",
        help="sim-vs-real policy rank agreement on live devices (JSON)",
    )
    _add_common(p)
    p.add_argument("--policies", default=None,
                   help="comma-separated policies to rank (default: "
                        "roundrobin,critical,pipeline,pack; --stress "
                        "defaults to all 8 distinct-tier policies)")
    p.add_argument("--measure-repeats", type=int, default=3)
    p.add_argument("--reps", type=int, default=1,
                   help="amortized repetitions per measured run")
    p.add_argument("--anchor-calibrate", action="store_true",
                   help="two-anchor in-situ calibration (busy-host "
                        "compute scale + dispatcher-blocking staging "
                        "rate) before predicting; anchors are in-sample, "
                        "other policies and the ordering out-of-sample "
                        "(eval/rankcheck.py)")
    p.add_argument("--stress", action="store_true",
                   help="use the transfer-stress DAG (frontend/stress_dag): "
                        "cheap compute, large cross-device activations — "
                        "the regime where the sim PREDICTS separation, so "
                        "rank agreement is asserted without the tie escape "
                        "(ignores --model; 4 cards, 8 policies unless "
                        "--policies given explicitly)")
    p.set_defaults(fn=cmd_rankcheck)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (ValueError, ConfigError) as e:
        # a configuration that cannot run (an unknown model or policy, no
        # card, a failed engine build): one line, no traceback.  Faults on
        # the card (launch failures, out of memory) keep theirs
        print(f"{args.cmd}: {' '.join(str(e).split())}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
