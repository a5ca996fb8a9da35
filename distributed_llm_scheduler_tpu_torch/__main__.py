"""CLI: ``python -m distributed_llm_scheduler_tpu_torch <command>``.

The PyTorch port of the JAX package's command line, for the commands whose
code is all ported (the flags, defaults and help texts are the JAX
package's):

* ``schedule``  — build a DAG, place it with a policy, report + save
* ``sweep``     — the full evaluation sweep (CSV + PNG + summary)
* ``execute``   — run a scheduled model DAG on live devices
* ``visualize`` — DAG structure and Gantt renderings
* ``generate``  — autoregressive KV-cache decoding (any model family)
* ``bench``     — the north-star benchmark (one JSON line)
* ``trace``     — traced execute (+ paged-decode leg) -> Perfetto JSON
* ``metrics``   — same run, metrics-registry snapshot JSON

Live devices are the CUDA cards; ``DLS_PLATFORM=cpu`` runs on the CPU
instead (``utils/config.py``).  With no card and no such setting the
device commands fail with a message: nothing falls back to the CPU.  A
command that cannot run exits 2 with one line on stderr.
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
