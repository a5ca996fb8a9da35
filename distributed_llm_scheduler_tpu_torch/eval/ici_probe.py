"""Interconnect-estimate sensitivity in a multi-device-bound regime.

PyTorch port of ``distributed_llm_scheduler_tpu.eval.ici_probe``: a
host-only simulation (the port's policies, ``TieredLinkModel`` and
``SimulatedBackend``) that touches no device, so it runs the same on any
host.  The probe below is the JAX package's, unchanged but for the
weights' dtype (``torch.bfloat16``); its topology is the JAX package's
modeled TPU multislice, a cluster the simulator models and no card of
this port runs.

The flagship bench's ICI sweep (``benchlib.ici_sensitivity``) replays
FIXED placements in a host-link-bound regime, where a +/-4x ICI error
moves nothing — correct, but it leaves the estimated tiers untested in
any regime where interconnect could actually decide placement (VERDICT
r3 weak #7 / next #8).  This probe constructs that regime: BASELINE
config #3 — the Llama-3 8B layer DAG (15 GB bf16, cannot fit one 14 GB
core, so placement is genuinely multi-device) on a modeled 2 x v5e-8
multislice with the tiered ICI/DCN link — and, per interconnect scale,
**re-schedules** every link-aware policy before replaying, answering the
stronger question: does the estimate change which placements get chosen,
not just how a fixed placement scores?

Both estimated tiers are swept independently (ICI +/-4x, DCN +/-4x):
layer-granular DAG edges carry per-microbatch activations (a few MB), so
the intra-slice ICI tier is microseconds against millisecond tasks — the
tier with leverage is DCN, whose crossings the pipeline policy's
slice-contiguous stages exist to minimize.  Whatever the sweep finds
(winner flips, >5% makespan movement, or insensitivity) is recorded in
the JSON as the documented conclusion.

Run: ``python -m distributed_llm_scheduler_tpu_torch.eval.ici_probe [8b|tiny]``
"""

from __future__ import annotations
# dls-lint: allow-file(DET001) link probe: wall time IS the measured quantity

import dataclasses
import sys
import time
from typing import Any, Dict, Sequence

# all nine registered policies (VERDICT r4 next #3: the r4 probe covered
# only 5, leaving dfs/mru/pack/refine unexamined at the 5k-task scale)
POLICIES = (
    "roundrobin", "dfs", "greedy", "critical", "mru",
    "heft", "pipeline", "pack", "refine",
)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sweep_interconnect(
    scale_tier: str,
    scales: Sequence[float],
    graph,
    cluster,
    base_link,
    policies: Sequence[str] = POLICIES,
    base_row: Any = None,
    log=log,
) -> Dict[str, Any]:
    """Re-schedule + replay ``policies`` at each scale of one tier.

    Returns per-scale winner/makespans plus movement stats: max relative
    best-makespan change vs scale 1.0, whether the winner flips, and
    whether the winner's cross-slice edge count changes (placement
    actually moved, not just scores).
    """
    from .. import get_scheduler
    from ..backends.sim import SimulatedBackend

    assert scale_tier in ("ici", "dcn")
    tier_value = (
        base_link.interconnect_gbps if scale_tier == "ici"
        else base_link.dcn_gbps
    )
    if tier_value is None:
        # a None tier means "free" (reference fidelity); scaling it is
        # meaningless — report that instead of raising mid-sweep
        return {
            "scales": {},
            "max_best_makespan_movement": None,
            "max_any_policy_movement": None,
            "winner_flips": False,
            "skipped": f"{scale_tier} tier is None (free); nothing to scale",
        }
    slices = cluster.slice_ids()

    def cross_edges(schedule) -> int:
        n = 0
        for t in graph:
            for d in t.dependencies:
                pt, pd = schedule.placement.get(t.task_id), \
                    schedule.placement.get(d)
                if pt and pd and slices[pt] != slices[pd]:
                    n += 1
        return n

    def run_scale(scale) -> Dict[str, Any]:
        link = dataclasses.replace(
            base_link, **{
                ("interconnect_gbps" if scale_tier == "ici" else "dcn_gbps"):
                    tier_value * scale
            }
        )
        sim = SimulatedBackend(fidelity="full", link=link)
        makespans: Dict[str, float] = {}
        completions: Dict[str, float] = {}
        xedges: Dict[str, int] = {}
        for pol in policies:
            t0 = time.time()
            s = get_scheduler(pol, link=link).schedule(graph, cluster)
            r = sim.execute(graph, cluster, s)
            makespans[pol] = r.makespan
            completions[pol] = r.completed_tasks / r.num_tasks
            xedges[pol] = cross_edges(s)
            log(f"ici_probe: {scale_tier} x{scale:<4} {pol:10s} "
                f"makespan {r.makespan*1e3:9.1f} ms "
                f"cross-slice {xedges[pol]:4d} ({time.time()-t0:.1f}s)")
        complete = {p: m for p, m in makespans.items()
                    if completions[p] >= 1.0}
        winner = min(complete, key=complete.get) if complete else None
        return {
            "winner": winner,
            "best_makespan_ms": (
                round(complete[winner] * 1e3, 2) if winner else None
            ),
            # only completing policies enter the comparison stats below:
            # an incomplete run's makespan is a lower bound, not a cost
            "makespans_ms": {
                p: round(m * 1e3, 2) for p, m in complete.items()
            },
            "incomplete": sorted(
                p for p in makespans if completions[p] < 1.0
            ),
            "winner_cross_slice_edges": xedges.get(winner),
        }

    out: Dict[str, Any] = {"scales": {}}
    for scale in scales:
        key = f"x{scale}"
        if scale == 1.0 and base_row is not None:
            out["scales"][key] = base_row  # shared across tier sweeps
            continue
        out["scales"][key] = run_scale(scale)
    base = out["scales"].get("x1.0") or out["scales"].get("x1")
    movements = []
    flips = []
    any_policy = []
    for key, row in out["scales"].items():
        if base is None or row["best_makespan_ms"] is None \
                or base["best_makespan_ms"] is None:
            continue
        movements.append(
            abs(row["best_makespan_ms"] - base["best_makespan_ms"])
            / base["best_makespan_ms"]
        )
        # a FLIP requires the new winner to beat the base winner's
        # makespan at this scale by more than a tie band — two policies
        # within 2% trading first place is the sim calling them equal,
        # not the interconnect estimate changing the conclusion (same
        # claim-based semantics as eval/rankcheck)
        if row["winner"] != base["winner"] and base["winner"] is not None:
            base_winner_here = row["makespans_ms"].get(base["winner"])
            flips.append(
                base_winner_here is not None
                and row["best_makespan_ms"] < base_winner_here * 0.98
            )
        for p, m in row["makespans_ms"].items():
            b = base["makespans_ms"].get(p)
            if b:
                any_policy.append(abs(m - b) / b)
    out["max_best_makespan_movement"] = (
        round(max(movements), 4) if movements else None
    )
    # how much the estimate moves the cost of the WORST placements —
    # typically the real effect: a 4x DCN error multiplies a DCN-heavy
    # layout's makespan while leaving the winner untouched
    out["max_any_policy_movement"] = (
        round(max(any_policy), 4) if any_policy else None
    )
    out["winner_flips"] = bool(any(flips))
    return out


def run_probe(model: str = "8b", log=log) -> Dict[str, Any]:
    import torch

    from ..backends.sim import TieredLinkModel
    from ..core.cluster import Cluster
    from ..frontend.llama_dag import build_llama_dag
    from ..models.llama import LlamaConfig

    t0 = time.time()
    if model == "8b":
        cfg = LlamaConfig.llama3_8b(dtype=torch.bfloat16)
        dag = build_llama_dag(
            cfg, batch=16, seq_len=512, microbatches=16, vocab_shards=16
        )
        cluster = Cluster.multislice(2, 8, 14.0)
    else:
        cfg = LlamaConfig.tiny()
        dag = build_llama_dag(cfg, batch=4, seq_len=32, microbatches=4)
        cluster = Cluster.multislice(2, 4, dag.graph.total_param_gb())
    graph = dag.graph
    base_link = TieredLinkModel()
    log(f"ici_probe: {graph.name}: {len(graph)} tasks, "
        f"{graph.total_param_gb():.1f} GB params, "
        f"{len(cluster)} cores in 2 slices "
        f"(build {time.time()-t0:.1f}s)")
    scales = (0.25, 1.0, 4.0)
    result: Dict[str, Any] = {
        "model": graph.name,
        "n_tasks": len(graph),
        "total_param_gb": round(graph.total_param_gb(), 2),
        "cluster": f"{len(cluster)} cores / 2 slices",
        "base_ici_gbps": base_link.interconnect_gbps,
        "base_dcn_gbps": base_link.dcn_gbps,
        "link_provenance": "estimated (both tiers; that is the point)",
        "policies": list(POLICIES),
    }
    base_row = None
    for tier in ("ici", "dcn"):
        result[tier] = sweep_interconnect(
            tier, scales, graph, cluster, base_link, base_row=base_row,
            log=log,
        )
        # the x1.0 row is scale-independent: compute once, share
        base_row = result[tier]["scales"].get("x1.0", base_row)
    # the documented conclusion, computed not asserted; None = the sweep
    # measured nothing (no completing policy), NOT measured insensitivity
    moved = {
        t: result[t]["max_best_makespan_movement"] for t in ("ici", "dcn")
    }
    result["conclusion"] = {
        "ici_moves_best_makespan_over_5pct": (
            None if moved["ici"] is None else bool(moved["ici"] > 0.05)
        ),
        "dcn_moves_best_makespan_over_5pct": (
            None if moved["dcn"] is None else bool(moved["dcn"] > 0.05)
        ),
        "any_winner_flip": (
            None if moved["ici"] is None and moved["dcn"] is None
            else bool(
                result["ici"]["winner_flips"]
                or result["dcn"]["winner_flips"]
            )
        ),
    }
    result["wall_s"] = round(time.time() - t0, 1)
    return result


if __name__ == "__main__":
    import json

    which = sys.argv[1] if len(sys.argv) > 1 else "8b"
    if which not in ("8b", "tiny"):
        raise SystemExit(f"usage: ici_probe.py [8b|tiny], got {which!r}")
    print(json.dumps(run_probe(which), indent=1))
