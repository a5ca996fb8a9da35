"""The port's whole-run rung (``execute(compiled=True)``,
``backends/compiled_schedule.py``) on the CPU.

The program is the planned run over the dispatch order of the
``ProgramIR`` (``sched/linearize.py``); on the CPU it runs eagerly.  Its
output must equal the planned path's bit for bit on every placement, as the JAX package's does
(``tests/test_compiled_schedule.py:79``), stay equal over repeated runs and
executes, and count the exchanges the JAX compiled run counts (one per
value and destination node).  The combinations the reference refuses are
refused with its message, and a graph without a recipe whose nodes span
two cards is refused (the several-card rung, ``tests/
test_torch_compiled_world.py``, rebuilds the graph in each card's
process).  The captured form runs only on a card
(``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu.backends.device import (
    DeviceBackend as JaxBackend,
)
from distributed_llm_scheduler_tpu.frontend.gpt2_dag import (
    build_gpt2_dag as jax_build,
)
from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config as JaxConfig
from distributed_llm_scheduler_tpu_torch.backends.compiled_schedule import (
    CompiledSchedule,
)
from distributed_llm_scheduler_tpu_torch.analysis import AnalysisError

CPU = torch.device("cpu")
RTOL = ATOL = 2e-4
KW = dict(batch=2, seq_len=16, microbatches=2, vocab_shards=2)


@pytest.fixture(scope="module")
def tiny():
    jdag = jax_build(JaxConfig.tiny(), **KW)
    tdag = P.build_gpt2_dag(P.GPT2Config.tiny(), **KW)
    jparams = jdag.init_params()
    tparams = P.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, CPU)
    ids = np.random.default_rng(9).integers(0, 512, (2, 16), dtype=np.int32)
    return dict(jg=jdag.graph.freeze(), tg=tdag.graph.freeze(), tdag=tdag,
                jparams=jparams, tparams=tparams, ids=ids)


def placed(tiny, policy, n):
    tc = P.Cluster.from_torch_devices([CPU] * n, hbm_cap_gb=8.0)
    return tc, P.get_scheduler(policy).schedule(tiny["tg"], tc)


@pytest.mark.parametrize("policy,n", [("greedy", 1), ("roundrobin", 2),
                                      ("roundrobin", 4), ("roundrobin", 8),
                                      ("heft", 8), ("pipeline", 4)])
def test_compiled_equals_planned_bit_for_bit(tiny, policy, n):
    tc, ts = placed(tiny, policy, n)
    backend = P.DeviceBackend(tc)
    tin = torch.from_numpy(tiny["ids"])
    planned = backend.execute(tiny["tg"], ts, tiny["tparams"], tin)
    comp = backend.execute(tiny["tg"], ts, tiny["tparams"], tin,
                           compiled=True, reps=3)
    assert comp.compiled and not comp.planned and planned.planned
    assert torch.equal(comp.output, planned.output)
    again = backend.execute(tiny["tg"], ts, tiny["tparams"], tin,
                            compiled=True, warmup=False)
    assert torch.equal(again.output, planned.output)
    fused = tiny["tdag"].reference_forward(tiny["tparams"], tin)
    np.testing.assert_allclose(comp.output.numpy(), fused.numpy(),
                               rtol=RTOL, atol=ATOL)
    # O(1) host calls: the eager IR is one call here, copy + replay on a card
    assert comp.n_dispatches == 1 < planned.n_dispatches
    assert comp.transfer_edges <= planned.transfer_edges


@pytest.mark.parametrize("n", [2, 8])
def test_exchanges_counted_as_jax(tiny, n):
    tc, ts = placed(tiny, "roundrobin", n)
    jc = J.Cluster.from_jax_devices(jax.devices()[:n], hbm_cap_gb=8.0)
    js = J.get_scheduler("roundrobin").schedule(tiny["jg"], jc)
    assert ts.per_node == js.per_node
    comp = P.DeviceBackend(tc).execute(
        tiny["tg"], ts, tiny["tparams"], torch.from_numpy(tiny["ids"]),
        compiled=True)
    jcomp = JaxBackend(jc, pre_analysis=False).execute(
        tiny["jg"], js, tiny["jparams"], jnp.asarray(tiny["ids"]),
        compiled=True)
    assert (comp.transfer_edges, comp.transfer_bytes) == (
        jcomp.transfer_edges, jcomp.transfer_bytes)
    assert comp.transfer_edges > 0
    np.testing.assert_allclose(comp.output.numpy(), np.asarray(jcomp.output),
                               rtol=RTOL, atol=ATOL)


def test_program_is_cached_and_deterministic(tiny):
    tc, ts = placed(tiny, "heft", 4)
    backend = P.DeviceBackend(tc)
    tin = torch.from_numpy(tiny["ids"])
    placed_params, _ = backend.place_params(tiny["tg"], ts, tiny["tparams"])
    a = CompiledSchedule.build(backend, tiny["tg"], ts, placed_params, tin)
    b = CompiledSchedule.build(backend, tiny["tg"], ts, placed_params, tin)
    assert a is b
    other = P.DeviceBackend(tc)
    c = CompiledSchedule.build(other, tiny["tg"], ts, placed_params, tin)
    assert c is not a and c.ir.signature() == a.ir.signature()


def test_the_program_is_the_plan_over_the_ir_order(tiny):
    """The captured program is the planned run in the IR's dispatch
    order, and every exchange of the IR is a value that plan transfers."""
    tc, ts = placed(tiny, "heft", 4)
    backend = P.DeviceBackend(tc)
    tin = torch.from_numpy(tiny["ids"])
    placed_params, _ = backend.place_params(tiny["tg"], ts, tiny["tparams"])
    prog = CompiledSchedule.build(backend, tiny["tg"], ts, placed_params, tin)
    assert [t for st in prog.plan.steps for t in st.tids] == list(prog.ir.order)
    out, _, edges, nbytes, calls, _, _ = prog.run(tin)
    exchanged = [ex.tid for ph in prog.ir.phases for ex in ph.exchanges]
    assert edges == len(exchanged) > 0 and calls == 1
    assert set(exchanged) <= set(prog.plan.xfer_nbytes)
    assert nbytes == sum(prog.plan.xfer_nbytes[t] for t in exchanged) > 0


@pytest.mark.parametrize("bad", [
    dict(segments=True), dict(profile=True), dict(coalesce=True),
    dict(keep_outputs=True), dict(planned=True), dict(ext_outputs={}),
], ids=lambda kw: next(iter(kw)))
def test_refused_combinations(tiny, bad):
    tc, ts = placed(tiny, "roundrobin", 2)
    with pytest.raises(ValueError, match="incompatible with") as e:
        P.DeviceBackend(tc).execute(
            tiny["tg"], ts, tiny["tparams"], torch.from_numpy(tiny["ids"]),
            compiled=True, **bad)
    assert repr([next(iter(bad))]) in str(e.value)


def test_stream_params_is_refused(tiny):
    """A streamed schedule that must evict is refused by the stream-safety
    pass with its diagnosis (one that fits runs compiled:
    ``test_torch_stream_pass.py``)."""
    tc, ts = placed(tiny, "greedy", 1)
    tc.devices[0].total_memory = 0.3 * tiny["tg"].total_param_gb()
    with pytest.raises(AnalysisError) as e:
        P.DeviceBackend(tc).execute(
            tiny["tg"], ts, tiny["tparams"], torch.from_numpy(tiny["ids"]),
            compiled=True, stream_params=True)
    assert {d.code for d in e.value.report.diagnostics} & {"STR002", "STR003"}


def test_a_cluster_over_two_cards_is_refused(tiny, monkeypatch):
    """Over two cards the rung runs a process per card, and each rebuilds
    the graph from its recipe: a graph without one is refused before any
    placement, so nothing touches a card and no process starts."""
    from distributed_llm_scheduler_tpu_torch.parallel import launch

    def no_world(self, *a, **k):
        raise AssertionError("a refused schedule started a world")

    monkeypatch.setattr(launch.World, "__init__", no_world)
    graph = P.build_gpt2_dag(P.GPT2Config.tiny(), **KW).graph
    graph.recipe = None
    tc = P.Cluster([
        P.DeviceState(f"core_{i}", 8.0, torch_device=torch.device("cuda", i))
        for i in range(2)
    ])
    ts = P.get_scheduler("roundrobin").schedule(graph, tc)
    with pytest.raises(ValueError, match="recipe"):
        P.DeviceBackend(tc).execute(
            graph, ts, tiny["tparams"], torch.from_numpy(tiny["ids"]),
            compiled=True)


def test_an_ordering_cycle_is_refused():
    g = P.TaskGraph([
        P.Task("a", 0.1, 0.1, [], fn=lambda p, x: x + 1),
        P.Task("b", 0.1, 0.1, [], fn=lambda p, x: x + 2),
        P.Task("c", 0.1, 0.1, ["b"], fn=lambda p, x: x * 2),
        P.Task("d", 0.1, 0.1, ["a"], fn=lambda p, x: x * 3),
    ], name="cycle").freeze()
    s = P.Schedule(policy="hand", per_node={"n0": ["c", "a"], "n1": ["d", "b"]},
                   assignment_order=["c", "d", "a", "b"])
    c = P.Cluster([P.DeviceState(n, 1.0, torch_device=CPU)
                   for n in ("n0", "n1")])
    with pytest.raises(AnalysisError) as e:
        P.DeviceBackend(c).execute(g, s, {}, torch.zeros(2), compiled=True)
    # COL002, as the JAX compiled path refuses it, naming the stalled heads
    (d,) = e.value.report.by_code("COL002")
    assert d.data["heads"] == {"n0": {"head": "c", "waits_on": ["b"]},
                               "n1": {"head": "d", "waits_on": ["a"]}}
    # the interpreted rungs fall back to topological order and run
    rep = P.DeviceBackend(c).execute(g, s, {}, torch.zeros(2))
    assert rep.n_dispatches == 4
