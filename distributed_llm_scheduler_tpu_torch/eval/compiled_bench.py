"""Whole-program compiled-path bench: one launch per run, and faster.

PyTorch port of ``distributed_llm_scheduler_tpu.eval.compiled_bench``.
Lowering the ENTIRE placed run into one program per device (each card's
share captured into one CUDA graph, the cross-card edges sends and
receives inside it; :mod:`..backends.compiled_world`) must

* keep outputs bit-identical to the planned interpreted path,
* cut host launches per run to O(devices) -- one input copy per input
  tensor plus ONE replay per rank, never O(tasks),
* cut host dispatch wall at least ``--min-overhead-reduction`` (default
  5x) vs the planned path,
* not lose makespan to the segmented runner (the previous production
  rung): compiled makespan <= segmented * (1 + ``--makespan-slack``).

Measured on a medium-structured DAG (24 layers, microbatches=8,
vocab_shards=8 by default -- the BENCH_MEDIUM shape with tiny tensor
dims) placed across the devices, one node per device as the reference
has one node per mesh device: every visible card, or under
``DLS_PLATFORM=cpu`` ``DLS_CPU_WORLD`` gloo ranks (node ``r`` bound to
``torch.device("cpu", r)``).  With two devices or more the compiled leg
runs in a world of one process per device; its makespan is the largest
rank's window and its host dispatch the largest rank's host time.

Usage::

    python -m distributed_llm_scheduler_tpu_torch.eval.compiled_bench
    DLS_PLATFORM=cpu DLS_CPU_WORLD=8 python -m \\
        distributed_llm_scheduler_tpu_torch.eval.compiled_bench

The report has the reference's keys and one more, ``stand_ins``;
``fence_rtt_ms`` is None (CUDA events time the device, so there is no
readback fence to net out).  The timed segmented leg is the reference's,
re-batched, and the makespan gate reads it.  On a card a re-batched
segment's output is allclose to the planned rung's, not bit-equal, so the
segmented half of ``bit_identical`` reads one untimed run of the same
segments with ``rebatch=False``; ``stand_ins["segmented"]`` says so and
holds the re-batched leg's distance from the planned output.
"""

from __future__ import annotations
# dls-lint: allow-file(DET001) benchmark harness: wall time IS the measured quantity

import argparse
import dataclasses
import json
import statistics
import sys
import time
from typing import Any, Dict

import torch
from torch.utils._pytree import tree_leaves

from ..backends.device import DeviceBackend
from ..core.cluster import Cluster
from ..sched.policies import get_scheduler
from ..utils.config import ConfigError, platform, platform_world
from .benchlib import spread_stats


#: the reference's gates: min host-dispatch reduction vs planned, makespan
#: slack vs segmented, launches per run over n_devices
GATES = (5.0, 0.05, 1)

#: the reference's segmented leg (re-batched), timed; and the run that
#: stands in for it in the bit-identity check
SEGMENTED = dict(segments=True, planned=False)
SEGMENTED_BIT_IDENTITY = dict(SEGMENTED, rebatch=False)

#: the tolerance the re-batched leg's output is held to against planned:
#: the reference's cross-path checks (``__graft_entry__.py:333``)
REBATCH_RTOL = REBATCH_ATOL = 2e-4


def _bit_identical(a: Any, b: Any) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x.cpu(), y.cpu()) for x, y in zip(la, lb))


def bench_devices() -> list:
    """One device per node: every visible card, or ``DLS_CPU_WORLD`` CPU
    ranks (``torch.device("cpu", r)``) under ``DLS_PLATFORM=cpu``."""
    if platform() == "cpu":
        return [torch.device("cpu", r) for r in range(platform_world())]
    return [torch.device("cuda", r) for r in range(platform_world())]


def run_compiled_bench(
    n_layer: int = 24,
    batch: int = 8,
    seq_len: int = 8,
    microbatches: int = 8,
    vocab_shards: int = 8,
    policy: str = "roundrobin",
    samples: int = 3,
    reps: int = 1,
    log=None,
) -> Dict[str, Any]:
    """Measure planned / segmented / compiled on one schedule across the
    devices; return the report dict.  Gates are *evaluated* here but
    enforced by the caller."""
    from ..frontend.gpt2_dag import build_gpt2_dag
    from ..models.gpt2 import GPT2Config

    cfg = dataclasses.replace(GPT2Config.tiny(), n_layer=n_layer)
    dag = build_gpt2_dag(
        cfg, batch=batch, seq_len=seq_len,
        microbatches=microbatches, vocab_shards=vocab_shards,
    )
    graph = dag.graph
    devices = bench_devices()
    # weights and ids on the first device, as the reference's default
    # device holds them: a captured rung in one process reads its params
    # where they were at capture, and copies its input on the card
    params = dag.init_params(device=devices[0])
    ids = dag.make_inputs(device=devices[0])

    cluster = Cluster.from_torch_devices(devices, hbm_cap_gb=4.0)
    backend = DeviceBackend(cluster)
    schedule = get_scheduler(policy).schedule(graph, cluster)
    if schedule.failed:
        raise RuntimeError(
            f"policy {policy!r} failed to place "
            f"{len(schedule.failed)} tasks; bench needs a full plan"
        )

    legs = {
        "planned": dict(),
        "segmented": SEGMENTED,
        "compiled": dict(compiled=True),
    }
    results: Dict[str, Dict[str, Any]] = {}
    outputs: Dict[str, Any] = {}
    try:
        # re-batched microbatches run other GEMM shapes: on a card their
        # output is allclose to the planned rung's, not bit-equal, so the
        # bit-identity check reads this untimed run without re-batching
        rep = backend.execute(graph, schedule, params, ids,
                              **SEGMENTED_BIT_IDENTITY)
        outputs["segmented_bit_identity"] = [
            t.cpu() for t in tree_leaves(rep.output)]
        for name, kw in legs.items():
            t0 = time.perf_counter()
            # warmup execute builds and captures; timed samples reuse the
            # caches (the compiled leg's world too)
            rep = backend.execute(graph, schedule, params, ids, **kw)
            outputs[name] = [t.cpu() for t in tree_leaves(rep.output)]
            mk, ov = [], []
            for _ in range(samples):
                r = backend.execute(
                    graph, schedule, params, ids, warmup=False, reps=reps,
                    **kw
                )
                mk.append(r.makespan_s)
                ov.append(r.dispatch_overhead_s)
                rep = r
            results[name] = {
                "makespan_ms": statistics.median(mk) * 1e3,
                "dispatch_overhead_ms": statistics.median(ov) * 1e3,
                "spread": spread_stats(mk),
                "n_dispatches": rep.n_dispatches,
                "transfer_edges": rep.transfer_edges,
                "wall_s": time.perf_counter() - t0,
            }
            if log:
                extra = (f", world of {rep.world['ranks']} started in "
                         f"{rep.world['start_s']:.1f} s, "
                         f"{rep.world['n_dispatches_sum']} launches over the "
                         "ranks" if rep.world else "")
                log(
                    f"  {name}: makespan {results[name]['makespan_ms']:.2f} "
                    f"ms, host dispatch "
                    f"{results[name]['dispatch_overhead_ms']:.2f} ms "
                    f"({rep.n_dispatches} launches, median of {samples}"
                    f"{extra})"
                )
            rep = r = None  # a world's output is its ranks' memory
    finally:
        backend.close()

    bit_identical = _bit_identical(
        outputs["planned"], outputs["compiled"]
    ) and _bit_identical(outputs["planned"],
                         outputs["segmented_bit_identity"])
    rebatched = {
        "timed_flags": dict(SEGMENTED),
        "bit_identity_flags": dict(SEGMENTED_BIT_IDENTITY),
        "rebatched_bit_identical": _bit_identical(outputs["planned"],
                                                  outputs["segmented"]),
        "rebatched_max_abs_err": max(
            float((a.double() - b.double()).abs().max())
            for a, b in zip(outputs["planned"], outputs["segmented"])),
        "rebatched_allclose": all(
            torch.allclose(b, a, rtol=REBATCH_RTOL, atol=REBATCH_ATOL)
            for a, b in zip(outputs["planned"], outputs["segmented"])),
        "rtol": REBATCH_RTOL, "atol": REBATCH_ATOL,
    }
    if log:
        log(f"  bit-identical outputs (planned vs segmented without "
            f"re-batching vs compiled): {bit_identical}; re-batched "
            f"segmented: bit-identical "
            f"{rebatched['rebatched_bit_identical']}, max abs err "
            f"{rebatched['rebatched_max_abs_err']:.3e}, allclose at "
            f"{REBATCH_RTOL:g} {rebatched['rebatched_allclose']}")

    return {
        "bench": "compiled_schedule_bench",
        "platform": platform(),
        "n_devices": len(cluster.devices),
        "n_tasks": len(graph.topo_order),
        "n_input_leaves": len(tree_leaves(ids)),
        "policy": policy,
        "fence_rtt_ms": None,
        "config": {
            "n_layer": n_layer, "batch": batch, "seq_len": seq_len,
            "microbatches": microbatches, "vocab_shards": vocab_shards,
            "samples": samples, "reps": reps,
        },
        "legs": results,
        "bit_identical": bit_identical,
        "stand_ins": {"segmented": rebatched},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="whole-program compiled execution bench + gates"
    )
    ap.add_argument("--samples", type=int, default=3)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--policy", default="roundrobin")
    ap.add_argument("--n-layer", type=int, default=24)
    ap.add_argument("--seq-len", type=int, default=8)
    ap.add_argument(
        "--min-overhead-reduction", type=float, default=GATES[0],
        help="required host-dispatch-wall reduction factor, compiled vs "
        "planned (the tentpole's >=5x claim)",
    )
    ap.add_argument(
        "--makespan-slack", type=float, default=GATES[1],
        help="compiled makespan may exceed segmented by at most this "
        "fraction (timer noise allowance on shared CI hosts)",
    )
    ap.add_argument(
        "--launch-epsilon", type=int, default=GATES[2],
        help="host launches per run must be <= n_devices + this",
    )
    ap.add_argument("--out", default=None, help="write JSON report here")
    args = ap.parse_args(argv)

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    try:
        n = len(bench_devices())
    except ConfigError as e:
        print(f"compiled_bench: {e}", file=sys.stderr)
        return 2
    log(f"compiled bench: medium-structured DAG on {n} {platform()} "
        "device(s)")
    report = run_compiled_bench(
        n_layer=args.n_layer, seq_len=args.seq_len, policy=args.policy,
        samples=args.samples, reps=args.reps, log=log,
    )
    ok = evaluate_gates(report, args.min_overhead_reduction,
                        args.makespan_slack, args.launch_epsilon, log)
    text = json.dumps(report, indent=2, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0 if ok else 1


def evaluate_gates(report: Dict[str, Any], min_overhead_reduction: float,
                   makespan_slack: float, launch_epsilon: int, log) -> bool:
    """The reference's four gates over ``report``, and the re-batched
    segmented output allclose to planned (its stand-in's); adds ``gates``
    to it and returns whether all held."""
    legs = report["legs"]
    ok = True
    planned_ov = legs["planned"]["dispatch_overhead_ms"]
    compiled_ov = legs["compiled"]["dispatch_overhead_ms"]
    factor = planned_ov / compiled_ov if compiled_ov > 0 else float("inf")
    if factor < min_overhead_reduction:
        log(
            f"GATE FAIL: compiled dispatch wall {compiled_ov:.2f} ms is "
            f"only {factor:.1f}x below planned {planned_ov:.2f} ms "
            f"(need >= {min_overhead_reduction:.1f}x)"
        )
        ok = False
    launches = legs["compiled"]["n_dispatches"]
    budget = report["n_devices"] + launch_epsilon
    if launches > budget:
        log(
            f"GATE FAIL: compiled path issued {launches} host launches "
            f"> n_devices + eps = {budget}"
        )
        ok = False
    seg_mk = legs["segmented"]["makespan_ms"]
    comp_mk = legs["compiled"]["makespan_ms"]
    if comp_mk > seg_mk * (1.0 + makespan_slack):
        log(
            f"GATE FAIL: compiled makespan {comp_mk:.2f} ms exceeds "
            f"segmented {seg_mk:.2f} ms by more than "
            f"{makespan_slack:.0%}"
        )
        ok = False
    if not report["bit_identical"]:
        log("GATE FAIL: compiled outputs are not bit-identical to planned")
        ok = False
    seg = report.get("stand_ins", {}).get("segmented")
    if seg is not None and not seg["rebatched_allclose"]:
        log(f"GATE FAIL: the re-batched segmented output is "
            f"{seg['rebatched_max_abs_err']:.3e} from planned, beyond "
            f"rtol=atol={seg['rtol']:g}")
        ok = False
    report["gates"] = {
        "min_overhead_reduction": min_overhead_reduction,
        "overhead_reduction_factor": round(factor, 2),
        "makespan_slack": makespan_slack,
        "launch_epsilon": launch_epsilon,
        "passed": ok,
    }
    if ok:
        log(
            f"GATES PASS: {factor:.1f}x dispatch reduction, "
            f"{launches} launches <= {budget}, compiled {comp_mk:.2f} ms "
            f"<= segmented {seg_mk:.2f} ms (+{makespan_slack:.0%}), "
            f"bit_identical={report['bit_identical']}"
        )
    return ok


if __name__ == "__main__":
    sys.exit(main())
