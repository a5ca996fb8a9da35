"""Synthetic workload generators.

PyTorch port's copy of ``distributed_llm_scheduler_tpu.frontend.generators``;
framework-free, so the DAGs are equal at the same seed (tasks, edges,
params, memory and compute time): the graphs the placement searches are
held to the JAX package on.

Capability parity with the reference's ``DAGGenerator``
(reference ``simulation.py:33-151``): the same three DAG *families* and
topologies (parallel attention heads, ≤3-dep random, all-to-all pipeline
stages), seedable (the reference draws unseeded RNG, so its sweeps aren't
reproducible — SURVEY.md §4).  Sizes and parameter-sharing are deliberate
variants, not byte-identical to the reference: attention weights are shared
across a layer's heads and the output is weight-tied to the embedding so
locality policies face the same sharing patterns real models have.  Parity
against the paper's *numbers* therefore holds qualitatively (ordering of
schedulers), not trial-for-trial.

Families:

* **LLM** — embedding → per-layer {parallel attention heads → attn-output →
  ffn → layer-output} → final output, with per-layer shared weights
  (reference ``simulation.py:36-88``).
* **Random** — topologically random DAG, ≤3 deps per task
  (reference ``simulation.py:90-114``).
* **Pipeline** — stages × width with all-to-all stage edges and a final
  aggregation task (reference ``simulation.py:116-151``).
"""

from __future__ import annotations

import random
from typing import List, Optional

from ..core.graph import Task, TaskGraph


def generate_llm_dag(
    num_layers: int = 4,
    num_heads: int = 8,
    seed: Optional[int] = 0,
) -> TaskGraph:
    """LLM-shaped DAG: embedding, per-layer parallel heads + ffn, output.

    Head count per layer is capped at 4 parallel branch tasks as in the
    reference (simulation.py:52-59); weights are shared per layer
    (attention weights across heads, ffn weights per layer), so locality
    policies have something to exploit.
    """
    rng = random.Random(seed)
    tasks: List[Task] = [
        Task("embedding", rng.uniform(0.5, 1.0), rng.uniform(0.05, 0.1),
             [], {"embed_weights"})
    ]
    prev = "embedding"
    for layer in range(num_layers):
        head_ids = []
        for h in range(min(num_heads, 4)):
            tid = f"l{layer}_head{h}"
            tasks.append(
                Task(tid, rng.uniform(0.3, 0.6), rng.uniform(0.02, 0.05),
                     [prev], {f"l{layer}_attn_w"})
            )
            head_ids.append(tid)
        attn_out = f"l{layer}_attn_out"
        tasks.append(
            Task(attn_out, rng.uniform(0.4, 0.8), rng.uniform(0.03, 0.06),
                 head_ids, {f"l{layer}_attn_w", f"l{layer}_proj_w"})
        )
        ffn = f"l{layer}_ffn"
        tasks.append(
            Task(ffn, rng.uniform(0.6, 1.2), rng.uniform(0.08, 0.15),
                 [attn_out], {f"l{layer}_ffn_w"})
        )
        layer_out = f"l{layer}_out"
        tasks.append(
            Task(layer_out, rng.uniform(0.2, 0.4), rng.uniform(0.01, 0.03),
                 [ffn], {f"l{layer}_ln_w"})
        )
        prev = layer_out
    tasks.append(
        Task("output", rng.uniform(0.5, 1.0), rng.uniform(0.05, 0.1),
             [prev], {"embed_weights"})  # weight tying with embedding
    )
    return TaskGraph(tasks, name=f"llm_{num_layers}l").freeze()


def generate_random_dag(
    num_tasks: int = 20,
    max_deps: int = 3,
    seed: Optional[int] = 0,
) -> TaskGraph:
    """Topologically random DAG: task i may depend on up to ``max_deps``
    earlier tasks (reference simulation.py:90-114)."""
    rng = random.Random(seed)
    tasks: List[Task] = []
    for i in range(num_tasks):
        deps: List[str] = []
        if i > 0:
            k = rng.randint(0, min(max_deps, i))
            deps = [f"task_{j}" for j in sorted(rng.sample(range(i), k))]
        n_params = rng.randint(1, 3)
        params = {f"param_{rng.randint(0, num_tasks // 2)}" for _ in range(n_params)}
        tasks.append(
            Task(f"task_{i}", rng.uniform(0.2, 1.5), rng.uniform(0.02, 0.2),
                 deps, params)
        )
    return TaskGraph(tasks, name=f"random_{num_tasks}").freeze()


def generate_pipeline_dag(
    num_stages: int = 4,
    tasks_per_stage: int = 3,
    seed: Optional[int] = 0,
) -> TaskGraph:
    """Pipeline-shaped DAG: all-to-all edges between consecutive stages plus
    a final aggregation task (reference simulation.py:116-151).  Tasks in a
    stage share that stage's weights."""
    rng = random.Random(seed)
    tasks: List[Task] = []
    prev_stage: List[str] = []
    for s in range(num_stages):
        stage_ids = []
        for i in range(tasks_per_stage):
            tid = f"s{s}_t{i}"
            tasks.append(
                Task(tid, rng.uniform(0.3, 1.0), rng.uniform(0.03, 0.12),
                     list(prev_stage), {f"stage{s}_w"})
            )
            stage_ids.append(tid)
        prev_stage = stage_ids
    tasks.append(
        Task("aggregate", rng.uniform(0.3, 0.6), rng.uniform(0.02, 0.05),
             list(prev_stage), {"agg_w"})
    )
    return TaskGraph(tasks, name=f"pipeline_{num_stages}x{tasks_per_stage}").freeze()


# The reference evaluator's six-workload sweep (simulation.py:366-373):
# small/large variants of each family.
SWEEP_WORKLOADS = {
    "llm_small": lambda seed=0: generate_llm_dag(num_layers=4, seed=seed),
    "llm_large": lambda seed=0: generate_llm_dag(num_layers=12, seed=seed),
    "random_small": lambda seed=0: generate_random_dag(num_tasks=20, seed=seed),
    "random_large": lambda seed=0: generate_random_dag(num_tasks=50, seed=seed),
    "pipeline_small": lambda seed=0: generate_pipeline_dag(
        num_stages=4, tasks_per_stage=3, seed=seed
    ),
    "pipeline_large": lambda seed=0: generate_pipeline_dag(
        num_stages=8, tasks_per_stage=4, seed=seed
    ),
}
