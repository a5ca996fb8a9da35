"""The port's synthetic DAG generators against the JAX package's.

The three families (LLM, random, pipeline) are seeded ``random.Random``
draws, so the contract is equality: at the same seed and size both
packages give the same graph name, tasks, dependencies, params, memory and
compute time, and the same sweep workloads.
"""

import pytest

from distributed_llm_scheduler_tpu.frontend import generators as JG
from distributed_llm_scheduler_tpu_torch.frontend import generators as PG


def fields(g):
    return g.name, g.topo_order, [
        (t.task_id, t.dependencies, sorted(t.params_needed),
         t.memory_required, t.compute_time)
        for t in g.tasks()
    ]


CASES = [
    ("generate_llm_dag", dict(num_layers=4, num_heads=8)),
    ("generate_llm_dag", dict(num_layers=12, num_heads=2)),
    ("generate_random_dag", dict(num_tasks=20)),
    ("generate_random_dag", dict(num_tasks=50, max_deps=5)),
    ("generate_pipeline_dag", dict(num_stages=4, tasks_per_stage=3)),
    ("generate_pipeline_dag", dict(num_stages=8, tasks_per_stage=4)),
]


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("gen,kw", CASES,
                         ids=[f"{g}-{i}" for i, (g, _) in enumerate(CASES)])
def test_generator_equals_jax(gen, kw, seed):
    jg = getattr(JG, gen)(seed=seed, **kw)
    pg = getattr(PG, gen)(seed=seed, **kw)
    assert fields(pg) == fields(jg)


@pytest.mark.parametrize("name", sorted(JG.SWEEP_WORKLOADS))
def test_sweep_workloads_equal_jax(name):
    assert sorted(PG.SWEEP_WORKLOADS) == sorted(JG.SWEEP_WORKLOADS)
    assert fields(PG.SWEEP_WORKLOADS[name](seed=3)) == fields(
        JG.SWEEP_WORKLOADS[name](seed=3))
