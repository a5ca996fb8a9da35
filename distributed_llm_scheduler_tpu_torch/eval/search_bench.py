"""Searched-placement bench: annealed search vs the best hand policy.

PyTorch port of ``distributed_llm_scheduler_tpu.eval.search_bench``: the
same DAG, link, hand policies, interconnect extremes, gates and metric
keys.  Every leg is a scheduling decision scored by the event simulation
and the simulated replay, so nothing runs on a device: the cluster is
eight ``core_i`` nodes of 4 GB built directly (the JAX bench builds the
same cluster from an 8-device CPU mesh), and the report's ``platform`` is
``cpu``.  The numbers are functions of the policies' decisions alone, so
at the defaults (budget 800, seed 0) they equal ``SEARCH_r15.json``'s,
the placement digest included.

On the medium-structured DAG (GPT-2 tiny widths at 24 layers,
microbatches=8, vocab_shards=8), the searched placement must

* **strictly beat** the best hand-tuned policy's makespan under BOTH the
  event simulation and the full-fidelity simulated replay (nominal
  link), and
* keep beating it on at least one interconnect extreme: hand placements
  are found at the nominal link and *replayed* under 0.25x / 4x
  interconnect bandwidth (:func:`.benchlib.ici_sensitivity`'s
  semantics), while the search re-optimizes per extreme.

Usage::

    python -m distributed_llm_scheduler_tpu_torch.eval.search_bench \
        [--budget 800] [--seed 0] [--out FILE]

It prints the report as JSON on stdout and the gates on stderr, and exits
1 when a gate fails.  At the defaults it takes several minutes of host
time (``refine`` and three searches at 800 evaluations each).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Any, Dict

from ..backends.sim import LinkModel, SimulatedBackend
from ..core.cluster import Cluster, DeviceState
from ..sched.eventsim import simulate_placement
from ..sched.policies import get_scheduler
from ..sched.search import SearchScheduler, placement_digest

# the asymmetric-link medium scenario every search number is quoted
# against: param loads an order of magnitude slower than inter-node hops,
# so placement has real param-affinity structure
NOMINAL_LINK = LinkModel(param_load_gbps=2.0, interconnect_gbps=50.0)
HAND_POLICIES = ("pack", "refine", "pipeline", "heft")
ICI_SCALES = (0.25, 4.0)
N_NODES = 8
NODE_GB = 4.0
_EPS = 1e-9


def build_medium():
    """The medium DAG and the 8-node cluster the search is quoted on."""
    from ..frontend.gpt2_dag import build_gpt2_dag
    from ..models.gpt2 import GPT2Config

    cfg = dataclasses.replace(GPT2Config.tiny(), n_layer=24)
    dag = build_gpt2_dag(
        cfg, batch=8, seq_len=8, microbatches=8, vocab_shards=8
    )
    cluster = Cluster([DeviceState(f"core_{i}", NODE_GB)
                       for i in range(N_NODES)])
    return dag.graph, cluster


def _eventsim_ms(graph, cluster, schedule, link) -> float:
    speeds = {d.node_id: d.compute_speed for d in cluster.devices}
    _order, mk, _nf = simulate_placement(
        graph, dict(schedule.placement), speeds, link,
        cluster.slice_ids(),
    )
    return mk * 1e3


def _replay_ms(graph, cluster, schedule, link) -> float:
    graph.reset()
    cluster.reset()
    sim = SimulatedBackend(fidelity="full", link=link)
    r = sim.execute(graph, cluster, schedule, dag_type="gpt2_medium")
    if r.completed_tasks < r.num_tasks:
        raise RuntimeError(
            f"replay completed {r.completed_tasks}/{r.num_tasks} tasks"
        )
    return r.makespan * 1e3


def run_search_bench(
    budget: int = 800,
    seed: int = 0,
    log=None,
) -> Dict[str, Any]:
    """Measure hand policies vs the annealed search on the medium DAG;
    return the flat metric dict.  Gates are *evaluated* here but
    enforced by the caller."""
    graph, cluster = build_medium()

    def fresh():
        graph.reset()
        cluster.reset()

    # -- hand policies, scheduled once at the nominal link ----------------
    hand: Dict[str, Any] = {}
    hand_ms: Dict[str, Dict[str, float]] = {}
    for name in HAND_POLICIES:
        fresh()
        t0 = time.perf_counter()
        s = get_scheduler(name, link=NOMINAL_LINK, seed=seed).schedule(
            graph, cluster
        )
        if s.failed:
            continue
        hand[name] = s
        hand_ms[name] = {
            "eventsim_ms": _eventsim_ms(graph, cluster, s, NOMINAL_LINK),
            "replay_ms": _replay_ms(graph, cluster, s, NOMINAL_LINK),
            "sched_wall_s": time.perf_counter() - t0,
        }
        if log:
            log(
                f"  hand {name}: eventsim "
                f"{hand_ms[name]['eventsim_ms']:.4f} ms, replay "
                f"{hand_ms[name]['replay_ms']:.4f} ms "
                f"({hand_ms[name]['sched_wall_s']:.1f}s to schedule)"
            )
    if not hand:
        raise RuntimeError("every hand policy failed to place the DAG")
    best_hand = min(hand_ms, key=lambda n: hand_ms[n]["replay_ms"])

    # -- searched placement at the nominal link ---------------------------
    fresh()
    t0 = time.perf_counter()
    searcher = SearchScheduler(NOMINAL_LINK, budget=budget, seed=seed)
    s_sched = searcher.schedule(graph, cluster)
    search_wall = time.perf_counter() - t0
    if s_sched.failed:
        raise RuntimeError(
            f"search failed to place {len(s_sched.failed)} tasks"
        )
    search_ev = float(searcher.stats["best_makespan"]) * 1e3
    search_rp = _replay_ms(graph, cluster, s_sched, NOMINAL_LINK)
    digest = placement_digest(dict(s_sched.placement))
    if log:
        log(
            f"  search (budget={budget}, seed={seed}): eventsim "
            f"{search_ev:.4f} ms, replay {search_rp:.4f} ms, "
            f"seeded from {searcher.stats['seed_policy']}, static filter "
            f"{searcher.stats['static_filter']} ({search_wall:.1f}s)"
        )

    beats_nominal = (
        search_ev < hand_ms[best_hand]["eventsim_ms"] - _EPS
        and search_rp < hand_ms[best_hand]["replay_ms"] - _EPS
    )

    # -- ici extremes: hand placements replayed, search re-optimized ------
    ici: Dict[str, Dict[str, Any]] = {}
    for scale in ICI_SCALES:
        scaled = dataclasses.replace(
            NOMINAL_LINK,
            interconnect_gbps=NOMINAL_LINK.interconnect_gbps * scale,
        )
        hand_replay = {
            n: _replay_ms(graph, cluster, s, scaled)
            for n, s in hand.items()
        }
        hb = min(hand_replay, key=hand_replay.get)
        fresh()
        t0 = time.perf_counter()
        xs = SearchScheduler(scaled, budget=budget, seed=seed)
        x_sched = xs.schedule(graph, cluster)
        x_rp = _replay_ms(graph, cluster, x_sched, scaled)
        key = f"x{scale:g}"
        ici[key] = {
            "best_hand": hb,
            "best_hand_replay_ms": hand_replay[hb],
            "search_replay_ms": x_rp,
            "search_wall_s": time.perf_counter() - t0,
            "beats": x_rp < hand_replay[hb] - _EPS,
        }
        if log:
            log(
                f"  ici {key}: search {x_rp:.4f} ms vs best hand "
                f"{hb}={hand_replay[hb]:.4f} ms -> "
                f"{'BEAT' if ici[key]['beats'] else 'no'}"
            )

    margin = 100.0 * (
        1.0 - search_rp / hand_ms[best_hand]["replay_ms"]
    )
    report: Dict[str, Any] = {
        "bench": "search_bench",
        "platform": "cpu",
        "n_devices": len(cluster.devices),
        "n_tasks": len(graph.topo_order),
        "config": {"budget": budget, "seed": seed},
        "hand": hand_ms,
        "best_hand": best_hand,
        "ici": ici,
        "search_stats": dict(searcher.stats),
        "search_wall_s": search_wall,
        # flat regress-gated metrics (all deterministic; zero tolerance)
        "search.makespan_ms": search_ev,
        "search.replay_ms": search_rp,
        "search.best_hand_replay_ms": hand_ms[best_hand]["replay_ms"],
        "search.margin_vs_hand_pct": margin,
        "search.ici_slow_margin_pct": 100.0 * (
            1.0 - ici["x0.25"]["search_replay_ms"]
            / ici["x0.25"]["best_hand_replay_ms"]
        ),
        "search.ici_fast_margin_pct": 100.0 * (
            1.0 - ici["x4"]["search_replay_ms"]
            / ici["x4"]["best_hand_replay_ms"]
        ),
        "search.beats_hand": beats_nominal,
        "search.beats_ici_extreme": any(v["beats"] for v in ici.values()),
        "search.placement_digest": digest,
    }
    return report


def gate_failures(report: Dict[str, Any]) -> list:
    """The bench's own hard gates (regress adds baseline comparison)."""
    fails = []
    if not report["search.beats_hand"]:
        fails.append(
            "search does not strictly beat the best hand policy "
            f"({report['best_hand']}) under both eventsim and replay: "
            f"search eventsim={report['search.makespan_ms']:.4f} / "
            f"replay={report['search.replay_ms']:.4f} vs hand replay="
            f"{report['search.best_hand_replay_ms']:.4f} ms"
        )
    if not report["search.beats_ici_extreme"]:
        fails.append(
            "search beats the best hand policy on neither ici extreme"
        )
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="annealed placement search bench + gates"
    )
    ap.add_argument("--budget", type=int, default=800)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write JSON report here")
    args = ap.parse_args(argv)

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    log(
        f"search bench: medium DAG, {N_NODES} nodes of {NODE_GB:g} GB, "
        f"budget={args.budget} seed={args.seed}"
    )
    report = run_search_bench(
        budget=args.budget, seed=args.seed, log=log
    )
    fails = gate_failures(report)
    for f in fails:
        log(f"GATE FAIL: {f}")
    if not fails:
        log(
            f"GATES PASS: search {report['search.replay_ms']:.4f} ms "
            f"beats {report['best_hand']} "
            f"{report['search.best_hand_replay_ms']:.4f} ms "
            f"({report['search.margin_vs_hand_pct']:.2f}% margin), "
            f"ici extremes "
            + ", ".join(
                f"{k}:{'beat' if v['beats'] else 'no'}"
                for k, v in report["ici"].items()
            )
        )
    report["gates"] = {"passed": not fails, "failures": fails}

    text = json.dumps(report, indent=2, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0 if not fails else 1


if __name__ == "__main__":
    sys.exit(main())
