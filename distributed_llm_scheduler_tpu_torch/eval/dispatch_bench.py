"""Host-dispatch-overhead microbench: planned fast path vs legacy loop.

PyTorch port of ``distributed_llm_scheduler_tpu.eval.dispatch_bench``.  On
a DAG with flagship *structure* (12 layers, microbatches=8,
vocab_shards=8 -- 921 tasks) but tiny tensor dims, host dispatch overhead
dominates wall time, and the pre-planned path must cut it.  This module
measures ``DeviceReport.dispatch_overhead_s`` (host wall inside the
dispatch loop, the synchronize excluded) for four configurations over 8
nodes (every visible card in turn, or the CPU under ``DLS_PLATFORM=cpu``),
in one process:

* ``legacy``            -- the per-task ``_run`` loop (``planned=False``)
* ``planned``           -- plan-then-dispatch, default flags
* ``coalesce``          -- planned + coalesced multi-task launches
* ``coalesce_nodonate`` -- the reference's coalesced leg with donation
                           off.  The port has no donation (the planned
                           path releases each value after its last
                           reader instead), so there is no switch to turn
                           off: this leg runs the flags of ``coalesce``,
                           and ``main``'s record says so under
                           ``stand_ins``.

Each leg is sampled ``--samples`` times (min quoted; full spread kept via
:func:`..eval.benchlib.spread_stats`) with ``--reps`` amortized reps per
sample.  The reference's two gates:

* ``coalesce_nodonate`` must reduce host dispatch wall by at least
  ``--min-reduction`` (default 0.40) vs ``legacy``;
* ``planned`` (defaults) must still beat ``legacy`` by at least
  ``--min-reduction-default`` (default 0.15).

Bit-identity is checked alongside: a ``keep_outputs`` run of the
coalesced path must reproduce every task output of the legacy loop bit
for bit.

Usage::

    python -m distributed_llm_scheduler_tpu_torch.eval.dispatch_bench
    DLS_PLATFORM=cpu python -m \\
        distributed_llm_scheduler_tpu_torch.eval.dispatch_bench
"""

from __future__ import annotations
# dls-lint: allow-file(DET001) benchmark harness: wall time IS the measured quantity

import argparse
import dataclasses
import json
import sys
import time
from typing import Any, Dict, Optional

import torch
from torch.utils._pytree import tree_leaves

from ..backends.device import DeviceBackend
from ..core.cluster import Cluster
from ..sched.policies import get_scheduler
from ..utils.config import ConfigError, platform, platform_devices
from .benchlib import spread_stats

#: nodes of the bench's cluster, as the reference's 8-device CPU mesh
N_NODES = 8

#: the reference's gates: coalesce_nodonate's and planned's least
#: reduction of host dispatch vs legacy
GATES = (0.40, 0.15)

#: legs whose reference flags the port has no switch for: the leg, and
#: what it runs instead
STAND_INS = {
    "coalesce_nodonate": "runs coalesce=True, as the coalesce leg: the port "
    "has no buffer donation to turn off (the planned path releases each "
    "value after its last reader)",
}


def _bit_identical(a: Any, b: Any) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x.cpu(), y.cpu()) for x, y in zip(la, lb))


def bench_devices() -> list:
    """The 8 nodes' devices: every visible card in turn, or the CPU."""
    devs = platform_devices()
    return [devs[i % len(devs)] for i in range(N_NODES)]


def run_dispatch_bench(
    n_layer: int = 12,
    batch: int = 8,
    seq_len: int = 8,
    microbatches: int = 8,
    vocab_shards: int = 8,
    policy: str = "greedy",
    samples: int = 5,
    reps: int = 3,
    check_outputs: bool = True,
    log=None,
) -> Dict[str, Any]:
    """Measure all four dispatch configurations; return the report dict.

    Gates are *evaluated* here (``reduction`` fields) but enforced by the
    caller -- tests and the CLI choose their own thresholds.
    """
    from ..frontend.gpt2_dag import build_gpt2_dag
    from ..models.gpt2 import GPT2Config

    cfg = dataclasses.replace(GPT2Config.tiny(), n_layer=n_layer)
    dag = build_gpt2_dag(
        cfg, batch=batch, seq_len=seq_len,
        microbatches=microbatches, vocab_shards=vocab_shards,
    )
    graph = dag.graph
    devices = bench_devices()
    params = dag.init_params(device=devices[0])
    ids = dag.make_inputs(device=devices[0])

    cluster = Cluster.from_torch_devices(devices, hbm_cap_gb=4.0)
    backend = DeviceBackend(cluster)
    schedule = get_scheduler(policy).schedule(graph, cluster)
    if schedule.failed:
        raise RuntimeError(
            f"policy {policy!r} failed to place "
            f"{len(schedule.failed)} tasks; microbench needs a full plan"
        )

    legs = {
        "legacy": dict(planned=False),
        "planned": dict(),
        "coalesce": dict(coalesce=True),
        "coalesce_nodonate": dict(coalesce=True),  # see STAND_INS
    }
    results: Dict[str, Dict[str, Any]] = {}
    for name, kw in legs.items():
        t0 = time.perf_counter()
        vals = []
        rep = None
        for _ in range(samples):
            rep = backend.execute(
                graph, schedule, params, ids, reps=reps, **kw
            )
            vals.append(rep.dispatch_overhead_s)
        results[name] = {
            "dispatch_overhead_ms": min(vals) * 1e3,
            "spread": spread_stats(vals),
            "n_dispatches": rep.n_dispatches,
            "dispatch_phases_ms": rep.summary()["dispatch_phases_ms"],
            "transfer_edges": rep.transfer_edges,
            "wall_s": time.perf_counter() - t0,
        }
        if log:
            log(
                f"  {name}: {min(vals)*1e3:.1f} ms host dispatch "
                f"({rep.n_dispatches} launches, {samples}x min)"
            )

    base = results["legacy"]["dispatch_overhead_ms"]
    for name in ("planned", "coalesce", "coalesce_nodonate"):
        results[name]["reduction_vs_legacy"] = (
            1.0 - results[name]["dispatch_overhead_ms"] / base
            if base > 0 else 0.0
        )

    bit_identical: Optional[bool] = None
    if check_outputs:
        rl = backend.execute(
            graph, schedule, params, ids, planned=False, keep_outputs=True
        )
        rc = backend.execute(
            graph, schedule, params, ids, coalesce=True, keep_outputs=True
        )
        bit_identical = set(rl.task_outputs) == set(rc.task_outputs) and all(
            _bit_identical(rl.task_outputs[t], rc.task_outputs[t])
            for t in rl.task_outputs
        )
        if log:
            log(f"  bit-identical outputs (legacy vs coalesced): {bit_identical}")

    return {
        "bench": "dispatch_microbench",
        "platform": platform(),
        "n_devices": len(set(devices)),
        "n_tasks": len(graph.topo_order),
        "policy": policy,
        "config": {
            "n_layer": n_layer, "batch": batch, "seq_len": seq_len,
            "microbatches": microbatches, "vocab_shards": vocab_shards,
            "samples": samples, "reps": reps,
        },
        "legs": results,
        "bit_identical": bit_identical,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="planned-vs-legacy host dispatch overhead microbench"
    )
    ap.add_argument("--samples", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--policy", default="greedy")
    ap.add_argument("--n-layer", type=int, default=12)
    ap.add_argument("--seq-len", type=int, default=8)
    ap.add_argument(
        "--min-reduction", type=float, default=GATES[0],
        help="required reduction for coalesce_nodonate vs legacy",
    )
    ap.add_argument(
        "--min-reduction-default", type=float, default=GATES[1],
        help="required reduction for planned (defaults) vs legacy",
    )
    ap.add_argument("--out", default=None, help="write JSON report here")
    args = ap.parse_args(argv)

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    try:
        devices = bench_devices()
    except ConfigError as e:
        print(f"dispatch_bench: {e}", file=sys.stderr)
        return 2
    log(f"dispatch microbench: flagship-structured DAG on {N_NODES} nodes "
        f"of {len(set(devices))} {platform()} device(s)")
    report = run_dispatch_bench(
        n_layer=args.n_layer, seq_len=args.seq_len, policy=args.policy,
        samples=args.samples, reps=args.reps, log=log,
    )
    ok = evaluate_gates(report, args.min_reduction,
                        args.min_reduction_default, log)
    report["stand_ins"] = dict(STAND_INS)
    text = json.dumps(report, indent=2, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0 if ok else 1


def evaluate_gates(report: Dict[str, Any], min_reduction: float,
                   min_reduction_default: float, log) -> bool:
    """The reference's gates over ``report``; adds ``gates`` to it and
    returns whether all held."""
    legs = report["legs"]
    fast = legs["coalesce_nodonate"]["reduction_vs_legacy"]
    dflt = legs["planned"]["reduction_vs_legacy"]
    ok = True
    if fast < min_reduction:
        log(
            f"GATE FAIL: coalesce_nodonate reduced dispatch wall by "
            f"{fast:.1%} < required {min_reduction:.0%}"
        )
        ok = False
    if dflt < min_reduction_default:
        log(
            f"GATE FAIL: planned (defaults) reduced dispatch wall by "
            f"{dflt:.1%} < required {min_reduction_default:.0%}"
        )
        ok = False
    if report["bit_identical"] is False:
        log("GATE FAIL: coalesced outputs are not bit-identical to legacy")
        ok = False
    report["gates"] = {
        "min_reduction": min_reduction,
        "min_reduction_default": min_reduction_default,
        "passed": ok,
    }
    if ok:
        log(
            f"GATES PASS: coalesce_nodonate -{fast:.1%}, "
            f"planned -{dflt:.1%}, bit_identical={report['bit_identical']}"
        )
    return ok


if __name__ == "__main__":
    sys.exit(main())
