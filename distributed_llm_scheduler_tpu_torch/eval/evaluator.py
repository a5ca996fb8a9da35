"""Experiment runner + analysis/reporting: the paper's sweep.

The PyTorch port of ``distributed_llm_scheduler_tpu.eval.evaluator``
(reference ``simulation.py:154-563``, ``ImprovedSchedulerEvaluator``):
sweep of workloads × node counts × memory regimes × runs × schedulers,
metric aggregation to CSV, a 4-panel PNG figure, and console summaries
(best scheduler per metric, LLM cache-hit-rate table).  Seedable; errors
surface as recorded zero-rows *with* a warning; the backend is pluggable
between the two simulated fidelities.  Sweeps are simulation-only by
design: the synthetic workload families carry no executable fns.

The rows are plain dicts (``ExecutionReport.to_row()``), grouped here
without pandas: the CSV goes through the stdlib ``csv`` module with the
JAX package's header, column order and rows (its
``to_dataframe().to_csv(index=False)``), and the means go through numpy.
matplotlib stays an optional import inside :meth:`Evaluator.write_plots`.
"""

from __future__ import annotations

import csv
import os
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..backends.sim import ExecutionReport, SimulatedBackend
from ..core.cluster import Cluster, estimate_cluster_memory_needed
from ..core.graph import TaskGraph
from ..frontend.generators import SWEEP_WORKLOADS
from ..sched.policies import ALL_SCHEDULERS, get_scheduler

DEFAULT_NODE_COUNTS = (2, 4, 8)
DEFAULT_MEMORY_REGIMES = (1.0, 0.9, 0.8)


def _mean(values: Sequence[float]) -> float:
    return float(np.asarray(values, dtype=np.float64).mean())


def _group_mean(rows: List[Dict[str, object]], key: str, value: str
                ) -> Dict[object, float]:
    """``{key value: mean of value}`` over ``rows``, keys sorted (a pandas
    ``groupby(key)[value].mean()``)."""
    groups: Dict[object, List[float]] = {}
    for r in rows:
        groups.setdefault(r[key], []).append(r[value])
    return {k: _mean(groups[k]) for k in sorted(groups)}


def _argbest(means: Dict[object, float], best=max):
    """The first key (in sorted order) holding the best mean, as pandas'
    ``idxmax``/``idxmin``."""
    target = best(means.values())
    return next(k for k, v in means.items() if v == target)


class Evaluator:
    """Runs the scheduling sweep and aggregates results."""

    def __init__(
        self,
        schedulers: Optional[Sequence[str]] = None,
        workloads: Optional[Dict[str, Callable[[], TaskGraph]]] = None,
        backend: Optional[SimulatedBackend] = None,
        node_counts: Sequence[int] = DEFAULT_NODE_COUNTS,
        memory_regimes: Sequence[float] = DEFAULT_MEMORY_REGIMES,
        slices: int = 1,
    ):
        """``slices > 1`` runs the whole sweep on multi-slice topologies:
        clusters split slice-by-slice (even memory, speed 1.0 — slice
        membership replaces the heterogeneous-speed profile), the replay
        charges DCN on cross-slice edges (``TieredLinkModel``), and link-
        aware policies place against the same tiered costs.  Node counts
        not divisible by ``slices`` are skipped with a warning."""
        self.scheduler_names = list(schedulers or sorted(ALL_SCHEDULERS))
        self.workloads = dict(workloads or SWEEP_WORKLOADS)
        self.slices = slices
        self.link = None
        if slices > 1:
            from ..backends.sim import TieredLinkModel

            if backend is None:
                self.link = TieredLinkModel()
                backend = SimulatedBackend(fidelity="full", link=self.link)
            elif isinstance(getattr(backend, "link", None), TieredLinkModel):
                self.link = backend.link
            else:
                # a flat-link backend on multislice clusters would silently
                # never charge DCN — the misreporting this class exists to
                # prevent
                raise ValueError(
                    "slices > 1 needs a backend whose link is a "
                    "TieredLinkModel (or backend=None to build one)"
                )
            if not any(n % slices == 0 for n in node_counts):
                raise ValueError(
                    f"no node count in {tuple(node_counts)} is divisible by "
                    f"slices={slices}; the sweep would be empty"
                )
        self.backend = backend or SimulatedBackend(fidelity="full")
        self.node_counts = list(node_counts)
        self.memory_regimes = list(memory_regimes)
        self.reports: List[ExecutionReport] = []

    # -- single trial ------------------------------------------------------
    def run_single(
        self,
        graph: TaskGraph,
        cluster: Cluster,
        scheduler_name: str,
        dag_type: str = "unknown",
        memory_regime: float = 1.0,
    ) -> ExecutionReport:
        sched = get_scheduler(scheduler_name, link=self.link)
        schedule = sched.schedule(graph, cluster)
        return self.backend.execute(
            graph, cluster, schedule, dag_type=dag_type, memory_regime=memory_regime
        )

    def _make_cluster(self, needed: float, regime: float, n_nodes: int, rng):
        if self.slices > 1:
            return Cluster.multislice(
                self.slices,
                n_nodes // self.slices,
                needed * regime / n_nodes,
            )
        return Cluster.heterogeneous(needed * regime, n_nodes, rng=rng)

    # -- sweep -------------------------------------------------------------
    def run_experiments(
        self, num_runs: int = 3, seed: int = 0
    ) -> List[ExecutionReport]:
        """The reference's full sweep (simulation.py:365-416).

        Each run regenerates the workload with a distinct seed (workload
        factories taking a ``seed`` kwarg get ``seed + run_idx``), so the
        runs dimension is true replication.
        """
        import inspect
        import random

        self.reports = []  # each sweep stands alone; no stale-row mixing
        for dag_type, make_graph in self.workloads.items():
            takes_seed = "seed" in inspect.signature(make_graph).parameters
            for run_idx in range(num_runs):
                graph = (
                    make_graph(seed=seed + run_idx) if takes_seed else make_graph()
                )
                needed = estimate_cluster_memory_needed(graph)
                for n_nodes in self.node_counts:
                    if self.slices > 1 and n_nodes % self.slices:
                        warnings.warn(
                            f"skipping n_nodes={n_nodes}: not divisible by "
                            f"slices={self.slices}"
                        )
                        continue
                    for regime in self.memory_regimes:
                        rng = random.Random(seed + run_idx)
                        cluster = self._make_cluster(
                            needed, regime, n_nodes, rng
                        )
                        for name in self.scheduler_names:
                            try:
                                rep = self.run_single(
                                    graph, cluster, name,
                                    dag_type=dag_type, memory_regime=regime,
                                )
                            except Exception as e:  # record zero-row, don't abort
                                warnings.warn(
                                    f"trial failed ({name}/{dag_type}/"
                                    f"{n_nodes}n/{regime}): {e}"
                                )
                                rep = ExecutionReport(
                                    scheduler_name=name,
                                    dag_type=dag_type,
                                    num_nodes=n_nodes,
                                    num_tasks=len(graph),
                                    completed_tasks=0,
                                    failed_tasks=len(graph),
                                    makespan=0.0,
                                    cache_hits=0,
                                    cache_misses=0,
                                    load_balance_score=0.0,
                                    node_utilization={},
                                    scheduling_wall_s=0.0,
                                    memory_regime=regime,
                                )
                            self.reports.append(rep)
        return self.reports

    # -- analysis ----------------------------------------------------------
    def rows(self) -> List[Dict[str, object]]:
        """One flat dict per trial (``ExecutionReport.to_row()``)."""
        return [r.to_row() for r in self.reports]

    def write_csv(self, path: str = "evaluation_results/raw_results.csv") -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        rows = self.rows()
        with open(path, "w", newline="") as f:
            if rows:
                w = csv.DictWriter(f, fieldnames=list(rows[0]),
                                   lineterminator="\n")
                w.writeheader()
                w.writerows(rows)
            else:  # pandas writes a lone newline for an empty frame
                f.write("\n")
        return path

    def write_plots(
        self, path: str = "evaluation_results/scheduler_performance.png"
    ) -> str:
        """4-panel figure: completion vs regime, LLM completion, makespan by
        DAG type, load balance (reference simulation.py:448-514)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        rows = self.rows()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig, axes = plt.subplots(2, 2, figsize=(14, 10))

        def by_scheduler(sub):
            out: Dict[str, list] = {}
            for r in sub:
                out.setdefault(r["scheduler"], []).append(r)
            return {k: out[k] for k in sorted(out)}

        ax = axes[0][0]
        for name, sub in by_scheduler(rows).items():
            agg = _group_mean(sub, "memory_regime", "completion_rate")
            ax.plot(list(agg), list(agg.values()), marker="o", label=name)
        ax.set_xlabel("memory regime")
        ax.set_ylabel("completion rate")
        ax.set_title("Completion rate vs memory regime")
        ax.legend(fontsize=8)

        ax = axes[0][1]
        llm = [r for r in rows if str(r["dag_type"]).startswith("llm")]
        for name, sub in by_scheduler(llm).items():
            agg = _group_mean(sub, "memory_regime", "completion_rate")
            ax.plot(list(agg), list(agg.values()), marker="s", label=name)
        ax.set_xlabel("memory regime")
        ax.set_ylabel("completion rate")
        ax.set_title("LLM workloads: completion rate")
        ax.legend(fontsize=8)

        ax = axes[1][0]
        dag_types = sorted({r["dag_type"] for r in rows})
        scheds = list(by_scheduler(rows))
        width = 0.8 / max(len(scheds), 1)
        for j, name in enumerate(scheds):
            means = _group_mean(
                [r for r in rows if r["scheduler"] == name], "dag_type",
                "makespan")
            ax.bar([i + (j - (len(scheds) - 1) / 2) * width
                    for i in range(len(dag_types))],
                   [means.get(d, 0.0) for d in dag_types], width, label=name)
        ax.set_xticks(range(len(dag_types)))
        ax.set_xticklabels(dag_types)
        ax.legend(fontsize=8)
        ax.set_ylabel("makespan (s)")
        ax.set_title("Makespan by DAG type")
        ax.tick_params(axis="x", rotation=30)

        ax = axes[1][1]
        lb = _group_mean(rows, "scheduler", "load_balance_score")
        ax.bar(range(len(lb)), list(lb.values()))
        ax.set_xticks(range(len(lb)))
        ax.set_xticklabels(list(lb), rotation=90)
        ax.set_ylabel("load balance (1/(1+CV))")
        ax.set_title("Load balance by scheduler")

        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path

    def summarize(self) -> Dict[str, object]:
        """Console-summary data (reference simulation.py:517-563): per-metric
        best scheduler and the LLM cache-hit table."""
        rows = self.rows()
        metrics = ("completion_rate", "makespan", "load_balance_score",
                   "cache_hit_rate")
        per_metric = {m: _group_mean(rows, "scheduler", m) for m in metrics}
        names = list(per_metric[metrics[0]])
        out: Dict[str, object] = {}
        out["mean_metrics"] = {
            n: {m: per_metric[m][n] for m in metrics} for n in names
        }
        out["best_completion"] = _argbest(per_metric["completion_rate"])
        # makespan is only comparable between trials that executed the same
        # work: failed tasks never run, so raw means would crown the
        # scheduler that fails the most (the reference has this artifact).
        complete = [r for r in rows if r["completion_rate"] >= 1.0]
        out["best_makespan"] = (
            _argbest(_group_mean(complete, "scheduler", "makespan"), min)
            if complete else None
        )
        out["best_load_balance"] = _argbest(per_metric["load_balance_score"])
        llm = [r for r in rows if str(r["dag_type"]).startswith("llm")]
        if llm:
            out["llm_cache_hit_rate"] = _group_mean(
                llm, "scheduler", "cache_hit_rate")
        return out

    def print_summary(self) -> None:
        s = self.summarize()
        print("=== Scheduler evaluation summary ===")
        for name, metrics in s["mean_metrics"].items():
            print(
                f"  {name:12s} completion={metrics['completion_rate']:.3f} "
                f"makespan={metrics['makespan']:.3f}s "
                f"balance={metrics['load_balance_score']:.3f} "
                f"cache_hit={metrics['cache_hit_rate']:.3f}"
            )
        print(f"  best completion:   {s['best_completion']}")
        print(f"  best makespan:     {s['best_makespan']}")
        print(f"  best load balance: {s['best_load_balance']}")
        if "llm_cache_hit_rate" in s:
            print("  LLM cache hit rates:")
            for name, rate in s["llm_cache_hit_rate"].items():
                print(f"    {name:12s} {rate:.3f}")
