"""The port's ``sched/linearize.py`` against the JAX package's.

Both are pure Python over equal graphs and equal schedules (the port's
policies give the JAX package's per-node lists, ``test_torch_sched*``), so
the strict dispatch order, the phases, the exchanges and the IR signature
must be *equal*, on the generator DAGs and on the tiny
GPT-2 DAG under ``greedy``, ``heft`` and ``pipeline``.  A crafted
cross-node ordering cycle must raise ``OrderingDeadlock`` in both, naming
the same stuck heads.
"""

import jax
import pytest
import torch

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu.frontend import generators as gen
from distributed_llm_scheduler_tpu.frontend.gpt2_dag import (
    build_gpt2_dag as jax_build,
)
from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config as JaxConfig
from distributed_llm_scheduler_tpu.sched import linearize as JL
from distributed_llm_scheduler_tpu_torch.sched import linearize as TL

CPU = torch.device("cpu")
POLICIES = ("greedy", "heft", "pipeline")


def to_port(jg):
    """The JAX graph's schedule-only twin in the port: same ids, edges,
    sizes and times."""
    return P.TaskGraph([
        P.Task(t.task_id, t.memory_required, t.compute_time,
               list(t.dependencies), set(t.params_needed),
               dict(t.param_bytes), arg_tasks=t.arg_tasks, group=t.group)
        for t in jg
    ], name=jg.name).freeze()


GENERATED = {
    "llm": lambda: gen.generate_llm_dag(num_layers=4, seed=0),
    "random": lambda: gen.generate_random_dag(num_tasks=30, seed=3),
    "pipeline": lambda: gen.generate_pipeline_dag(num_stages=4, seed=1),
}


@pytest.fixture(scope="module")
def gpt2_graphs():
    kw = dict(batch=4, seq_len=32, microbatches=2, vocab_shards=4)
    jg = J.fuse_linear_chains(jax_build(JaxConfig.tiny(), **kw).graph)
    tg = P.fuse_linear_chains(P.build_gpt2_dag(P.GPT2Config.tiny(), **kw).graph)
    return jg, tg


def schedules(jg, tg, policy, n):
    jc = J.Cluster.uniform(n, 64.0)
    tc = P.Cluster.uniform(n, 64.0)
    js = J.get_scheduler(policy).schedule(jg, jc)
    ts = P.get_scheduler(policy).schedule(tg, tc)
    assert ts.per_node == js.per_node
    return jc, tc, js, ts


def assert_ir_equal(jir, tir):
    assert tir.devices == jir.devices
    assert tir.order == jir.order
    assert len(tir.phases) == len(jir.phases)
    for tp, jp in zip(tir.phases, jir.phases):
        assert tp.index == jp.index
        assert tp.compute == jp.compute
        assert [(e.tid, e.src, e.dst) for e in tp.exchanges] == [
            (e.tid, e.src, e.dst) for e in jp.exchanges]
    assert tir.n_exchanges == jir.n_exchanges
    # the Exchange classes differ, so compare the signature's plain parts
    strip = lambda sig: (sig[0], sig[1], tuple(
        (i, comp, tuple((e.tid, e.src, e.dst) for e in exs))
        for i, comp, exs in sig[2]))
    assert strip(tir.signature()) == strip(jir.signature())


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", sorted(GENERATED))
def test_generator_dags_linearize_equal_to_jax(name, policy):
    jg = GENERATED[name]()
    tg = to_port(jg)
    jc, tc, js, ts = schedules(jg, tg, policy, 4)
    assert TL.strict_dispatch_order(tg, ts) == JL.strict_dispatch_order(jg, js)
    assert_ir_equal(
        JL.linearize(jg, js, device_order=jc.ids()),
        TL.linearize(tg, ts, device_order=tc.ids()),
    )


@pytest.mark.parametrize("policy", POLICIES)
def test_gpt2_dag_linearizes_equal_to_jax(gpt2_graphs, policy):
    jg, tg = gpt2_graphs
    jc, tc, js, ts = schedules(jg, tg, policy, 8)
    order = TL.strict_dispatch_order(tg, ts)
    assert order == JL.strict_dispatch_order(jg, js)
    tir = TL.linearize(tg, ts, device_order=tc.ids())
    assert_ir_equal(JL.linearize(jg, js, device_order=jc.ids()), tir)
    if policy != "greedy":  # several nodes: exchanges between phases
        assert tir.n_exchanges > 0 and len(tir.phases) > 1
    # the strict order is the interpreted path's order when it exists
    assert order == P.DeviceBackend.dispatch_order(tg, ts)


def test_default_device_order_and_dropped_tasks_equal_jax(gpt2_graphs):
    """Without ``device_order`` the nodes come in first-appearance order;
    a task whose producer is unplaced is dropped with its dependents."""
    jg, tg = gpt2_graphs
    jc, tc, js, ts = schedules(jg, tg, "heft", 4)
    victim = next(t for lst in ts.per_node.values() for t in lst
                  if "layer_1" in t)
    for s in (js, ts):
        for lst in s.per_node.values():
            if victim in lst:
                lst.remove(victim)
    tir = TL.linearize(tg, ts)
    assert_ir_equal(JL.linearize(jg, js), tir)
    assert victim not in tir.order and tg.topo_order[-1] not in tir.order


def cycle_pair():
    """a (n0) and b (n1) are roots; c needs b and d needs a.  n0 runs c
    before a and n1 runs d before b: each head waits behind the other's."""
    def tasks(mod):
        return [mod.Task("a", 0.1, 0.1, []), mod.Task("b", 0.1, 0.1, []),
                mod.Task("c", 0.1, 0.1, ["b"]), mod.Task("d", 0.1, 0.1, ["a"])]

    out = []
    for mod in (J, P):
        g = mod.TaskGraph(tasks(mod), name="cycle").freeze()
        s = mod.Schedule(policy="hand",
                         per_node={"n0": ["c", "a"], "n1": ["d", "b"]},
                         assignment_order=["c", "d", "a", "b"])
        out.append((g, s))
    return out


def test_ordering_cycle_raises_in_both():
    (jg, js), (tg, ts) = cycle_pair()
    with pytest.raises(JL.OrderingDeadlock) as je:
        JL.strict_dispatch_order(jg, js)
    with pytest.raises(TL.OrderingDeadlock) as te:
        TL.strict_dispatch_order(tg, ts)
    assert te.value.heads == je.value.heads == {
        "n0": ("c", ("b",)), "n1": ("d", ("a",))}
    assert str(te.value) == str(je.value)
    with pytest.raises(TL.OrderingDeadlock):
        TL.linearize(tg, ts)
    # the interpreted path falls back to topological order instead
    assert sorted(P.DeviceBackend.dispatch_order(tg, ts)) == ["a", "b", "c", "d"]
