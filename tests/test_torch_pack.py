"""The port's ``pack`` policy against the JAX package's.

Placements carry no floating-point tensors, so the contract is equality:
on the same graph and cluster, with the default link and with an
injected one, the port's per-node lists, global order and completed and
failed sets equal the JAX ``pack``'s.  Graphs: the tiny GPT-2 DAG (as
built and with chains fused), the tiny Llama DAG, and the schedule-only
miniature of the bench's flagship structure (vocab-shard roots feeding a
combine, then a weight-shared layer chain per microbatch).  Clusters: a
roomy one, and a tight one where some groups fit on no device whole and
their tasks spill or fail.
"""

import jax.numpy as jnp
import pytest
import torch

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu.frontend.gpt2_dag import (
    build_gpt2_dag as jax_gpt2,
)
from distributed_llm_scheduler_tpu.frontend.llama_dag import (
    build_llama_dag as jax_llama,
)
from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config as JGPT2
from distributed_llm_scheduler_tpu.models.llama import LlamaConfig as JLlama
from distributed_llm_scheduler_tpu_torch.frontend.gpt2_dag import (
    build_gpt2_dag as torch_gpt2,
)
from distributed_llm_scheduler_tpu_torch.frontend.llama_dag import (
    build_llama_dag as torch_llama,
)
from distributed_llm_scheduler_tpu_torch.models.gpt2 import GPT2Config as TGPT2
from distributed_llm_scheduler_tpu_torch.models.llama import (
    LlamaConfig as TLlama,
)

GB = 1024**3


def mini_flagship(pkg, n_layers=6, n_shards=4, mb=2):
    """tests/test_pipeline_rebalance.py's miniature of the bench graph,
    built in package ``pkg``."""
    tasks, tails = [], []
    for m in range(mb):
        shard_ids = []
        for k in range(n_shards):
            tid = f"mb{m}_shard_{k}"
            tasks.append(pkg.Task(
                tid, 0.01, 1e-4, [], {f"S{k}"},
                param_bytes={f"S{k}": int(0.9 * GB)}, group=f"shard_{k}",
            ))
            shard_ids.append(tid)
        prev = f"mb{m}_combine"
        tasks.append(pkg.Task(prev, 0.01, 1e-4, shard_ids, set(), group="embed"))
        for i in range(n_layers):
            tid = f"mb{m}_layer_{i}"
            tasks.append(pkg.Task(
                tid, 0.01, 1e-3, [prev], {f"L{i}"},
                param_bytes={f"L{i}": int(1.3 * GB)}, group=f"layer_{i}",
            ))
            prev = tid
        tails.append(prev)
    tasks.append(pkg.Task("out", 0.01, 1e-4, tails, set(), group="head"))
    return pkg.TaskGraph(tasks, name="mini_flagship").freeze()


def _graphs(kind):
    if kind == "mini_flagship":
        return mini_flagship(J), mini_flagship(P)
    if kind == "llama":
        kw = dict(batch=4, seq_len=16, microbatches=2, vocab_shards=3)
        j = jax_llama(JLlama.tiny(dtype=jnp.float32), **kw).graph
        t = torch_llama(TLlama.tiny(dtype=torch.float32), **kw).graph
        return J.fuse_linear_chains(j), P.fuse_linear_chains(t)
    kw = dict(batch=2, seq_len=16, microbatches=2, vocab_shards=4)
    j = jax_gpt2(JGPT2.tiny(), **kw).graph
    t = torch_gpt2(TGPT2.tiny(), **kw).graph
    if kind == "gpt2_fused":
        return J.fuse_linear_chains(j), P.fuse_linear_chains(t)
    return j, t


# node budget as a fraction of the graph's param GB
BUDGETS = {"roomy": 2.0, "tight": 0.3}
LINKS = {
    "default": lambda pkg: None,
    "injected": lambda pkg: pkg.LinkModel(
        param_load_gbps=1.5, interconnect_gbps=100.0, latency_s=5e-6),
}


@pytest.mark.parametrize("link", sorted(LINKS))
@pytest.mark.parametrize("budget", sorted(BUDGETS))
@pytest.mark.parametrize("kind", ["gpt2", "gpt2_fused", "llama", "mini_flagship"])
def test_pack_places_equal_to_jax(kind, budget, link):
    jg, tg = _graphs(kind)
    gb = BUDGETS[budget] * jg.total_param_gb()
    jc, tc = J.Cluster.uniform(4, gb), P.Cluster.uniform(4, gb)
    js = J.get_scheduler("pack", link=LINKS[link](J)).schedule(jg, jc)
    ts = P.get_scheduler("pack", link=LINKS[link](P)).schedule(tg, tc)
    assert ts.per_node == js.per_node
    assert ts.assignment_order == js.assignment_order
    assert ts.completed == js.completed and ts.failed == js.failed
    if budget == "roomy":
        assert not ts.failed


def test_tight_budget_spills_groups():
    """The tight budget exercises the spill path: on the tiny Llama DAG at
    0.3x, the group plan leaves groups out that fit on no device whole,
    and ``spill_pick`` still places every one of their tasks."""
    _, tg = _graphs("llama")
    tc = P.Cluster.uniform(4, BUDGETS["tight"] * tg.total_param_gb())
    pack = P.get_scheduler("pack")
    plan = pack.plan(tg, tc.devices)
    assert set(plan) < {t.group or t.task_id for t in tg}
    s = pack.schedule(tg, tc)
    assert not s.failed and len(s.completed) == len(tg)


def test_pack_is_registered_and_link_aware():
    assert P.ALL_SCHEDULERS["pack"] is P.GroupPackScheduler
    link = P.LinkModel(param_load_gbps=2.0)
    assert P.get_scheduler("pack", link=link).link is link
