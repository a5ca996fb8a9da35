"""The port's compiled rung over several devices on the CPU: a gloo world
of one process per device, each running its share of the placed run with
the IR's cross-device exchanges as sends and receives
(``backends/compiled_world.py``).

The nodes of a placement are bound to ``torch.device("cpu", r)``: node
``i`` of ``n`` to rank ``i % 4``.  One world of 4 ranks runs every case
(4 nodes under ``roundrobin``, 8 under ``heft`` so that exchanges happen
inside a rank and across ranks, 4 under ``pipeline``).  Each output must
be allclose to the JAX package's compiled program on a CPU mesh of as many
devices as nodes, at the tolerance of the reference's cross-path checks
(``__graft_entry__.py:333``), and bit-equal to the port's planned rung on
the same placement in one process; ``transfer_edges``/``transfer_bytes``
and the placement digest equal the JAX run's, and each rank issues at
most one call per input tensor plus one (``tests/test_compiled_schedule.py
:101``).  One case goes through ``DeviceBackend.execute`` on a world of
2: a second call is a cache hit that starts no world, and ``close``
leaves no rank alive.  The refusals come before any process starts.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu import obs as JO
from distributed_llm_scheduler_tpu.backends.device import (
    DeviceBackend as JaxBackend,
)
from distributed_llm_scheduler_tpu.frontend.gpt2_dag import (
    build_gpt2_dag as jax_build,
)
from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config as JaxConfig
from distributed_llm_scheduler_tpu.sched.search import (
    placement_digest as jax_digest,
)
from distributed_llm_scheduler_tpu_torch import obs as TO
from distributed_llm_scheduler_tpu_torch.analysis import AnalysisError
from distributed_llm_scheduler_tpu_torch.backends import compiled_world as CW
from distributed_llm_scheduler_tpu_torch.backends.compiled_schedule import (
    CompiledSchedule,
)
from distributed_llm_scheduler_tpu_torch.parallel import launch
from distributed_llm_scheduler_tpu_torch.sched.search import placement_digest

RTOL = ATOL = 2e-4
KW = dict(batch=2, seq_len=16, microbatches=2, vocab_shards=2)
RANKS = 4
CASES = (("roundrobin", 4), ("heft", 8), ("pipeline", 4))


@pytest.fixture(scope="module", autouse=True)
def cpu_platform():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DLS_PLATFORM", "cpu")
        yield


@pytest.fixture(scope="module")
def tiny():
    jdag = jax_build(JaxConfig.tiny(), **KW)
    tdag = P.build_gpt2_dag(P.GPT2Config.tiny(), **KW)
    jparams = jdag.init_params()
    tparams = P.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, torch.device("cpu"))
    ids = np.random.default_rng(9).integers(0, 512, (2, 16), dtype=np.int32)
    return dict(jg=jdag.graph.freeze(), tg=tdag.graph, jparams=jparams,
                tparams=tparams, ids=ids)


def cluster(n: int, ranks: int = RANKS):
    return P.Cluster.from_torch_devices(
        [torch.device("cpu", i % ranks) for i in range(n)], hbm_cap_gb=8.0)


def jax_run(tiny, policy: str, n: int) -> dict:
    jc = J.Cluster.from_jax_devices(jax.devices()[:n], hbm_cap_gb=8.0)
    js = J.get_scheduler(policy).schedule(tiny["jg"], jc)
    rep = JaxBackend(jc, pre_analysis=False).execute(
        tiny["jg"], js, tiny["jparams"], jnp.asarray(tiny["ids"]),
        compiled=True)
    return dict(output=np.asarray(rep.output), edges=rep.transfer_edges,
                bytes=rep.transfer_bytes, digest=jax_digest(js.placement),
                per_node=js.per_node)


@pytest.fixture(scope="module")
def world_runs(tiny):
    """Every case in one world of 4 ranks: the world's output, the planned
    rung's and each rank's numbers, by case."""
    tin = torch.from_numpy(tiny["ids"])
    world = launch.World(RANKS)
    out = {}
    try:
        for policy, n in CASES:
            tc = cluster(n)
            ts = P.get_scheduler(policy).schedule(tiny["tg"], tc)
            backend = P.DeviceBackend(tc)
            ir, devices = CompiledSchedule.lower(backend, tiny["tg"], ts)
            prog = CW.WorldProgram(backend, tiny["tg"], ts, ir, devices,
                                   tiny["tparams"], tin, world=world)
            res = prog.run(tin, reps=2)
            planned = backend.execute(tiny["tg"], ts, tiny["tparams"], tin)
            out[policy, n] = dict(
                output=res["output"].clone(), planned=planned.output,
                ranks=res["ranks"], prog=prog, schedule=ts)
    finally:
        world.close()
    return out


@pytest.mark.parametrize("policy,n", CASES)
def test_world_equals_jax_and_planned(tiny, world_runs, policy, n):
    got = world_runs[policy, n]
    want = jax_run(tiny, policy, n)
    ts, prog = got["schedule"], got["prog"]
    assert ts.per_node == want["per_node"]
    assert placement_digest(ts.placement) == want["digest"]
    np.testing.assert_allclose(got["output"].numpy(), want["output"],
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(got["output"], got["planned"])
    assert (prog.transfer_edges, prog.transfer_bytes) == (
        want["edges"], want["bytes"])
    n_in = 1
    assert len(got["ranks"]) == RANKS
    assert all(r["calls"] <= n_in + 1 for r in got["ranks"])
    cross = len(prog.cross)
    assert 0 < cross <= prog.transfer_edges
    if n > RANKS:  # two nodes per rank: some exchanges stay inside one
        assert cross < prog.transfer_edges


def test_execute_through_the_controller(tiny, monkeypatch):
    """execute(compiled=True) on a 2-rank world, twice: the second call is
    a cache hit that starts no world and keeps the rung's observability
    contract (the memory model, a program span per node, the counters);
    a param updated in place reaches the ranks before the next run, again
    with no new world; close() leaves no rank alive."""
    started = []
    real = launch.World.__init__

    def counting(self, *a, **k):
        started.append(a)
        real(self, *a, **k)

    monkeypatch.setattr(launch.World, "__init__", counting)
    tin = torch.from_numpy(tiny["ids"])
    params = {k: v.clone() for k, v in tiny["tparams"].items()}
    tc = cluster(2, ranks=2)
    ts = P.get_scheduler("roundrobin").schedule(tiny["tg"], tc)
    backend = P.DeviceBackend(tc)
    planned = backend.execute(tiny["tg"], ts, params, tin)
    first = backend.execute(tiny["tg"], ts, params, tin, compiled=True)
    assert first.compiled and first.world["ranks"] == 2
    assert torch.equal(first.output, planned.output)
    out1 = first.output.clone()
    ticks = iter(range(10 ** 6))
    mem = TO.MemoryProfiler(clock=lambda: float(next(ticks)))
    tr, mr = TO.Tracer(), TO.MetricsRegistry()
    second = backend.execute(tiny["tg"], ts, params, tin,
                             compiled=True, warmup=False, reps=2,
                             memprof=mem, trace=tr, metrics=mr)
    assert len(started) == 1
    assert torch.equal(second.output, out1)
    # the build-time memory model, byte for byte the JAX compiled run's
    jticks = iter(range(10 ** 6))
    jmem = JO.MemoryProfiler(clock=lambda: float(next(jticks)))
    jc = J.Cluster.from_jax_devices(jax.devices()[:2], hbm_cap_gb=8.0)
    JaxBackend(jc, pre_analysis=False).execute(
        tiny["jg"], J.get_scheduler("roundrobin").schedule(tiny["jg"], jc),
        tiny["jparams"], jnp.asarray(tiny["ids"]), compiled=True, reps=2,
        memprof=jmem)
    assert mem.events == jmem.events and len(mem.events) > 5
    # one program span per node, and the compiled rung's counters
    spans = [e for e in tr.events if e.get("cat") == "program"]
    assert sorted(e["track"] for e in spans) == sorted(ts.per_node)
    assert mr.counter("compiled.launches").value == 2 * second.n_dispatches
    assert mr.counter("compiled.exchanges").value == 2 * second.transfer_edges
    want = jax_run(tiny, "roundrobin", 2)
    np.testing.assert_allclose(out1.numpy(), want["output"], rtol=RTOL,
                               atol=ATOL)
    assert (second.transfer_edges, second.transfer_bytes) == (
        want["edges"], want["bytes"])
    assert second.n_dispatches <= 2
    assert second.world["n_dispatches_sum"] == sum(
        second.world["n_dispatches_by_rank"])
    assert second.makespan_s == max(second.world["makespan_s_by_rank"])
    # the controller placed nothing, but reports the bytes each node holds
    assert second.param_bytes_placed == backend.param_bytes(
        tiny["tg"], ts, params)
    # an optimizer-like update in place: the cached world reloads it
    with torch.no_grad():
        params["ln_f_g"].mul_(1.5)
        params["h0_mlp_fc_w"].add_(0.01)
    third = backend.execute(tiny["tg"], ts, params, tin, compiled=True,
                            warmup=False)
    assert len(started) == 1
    again = backend.execute(tiny["tg"], ts, params, tin)
    assert not torch.equal(again.output, out1)
    assert torch.equal(third.output, again.output)
    (prog,) = backend._prog_cache[tiny["tg"]].values()
    assert prog.refresh() == []  # nothing changed since
    pids = prog.world.pids()
    assert len(pids) == 2
    backend.close()
    assert prog.world.closed
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def _no_world(monkeypatch):
    def refuse(self, *a, **k):
        raise AssertionError("a refused schedule started a world")

    monkeypatch.setattr(launch.World, "__init__", refuse)


def test_a_graph_without_recipe_is_refused_before_placement(tiny,
                                                            monkeypatch):
    """Task functions do not pickle: a graph with no recipe whose nodes
    span devices is refused before anything is placed or started."""
    _no_world(monkeypatch)
    graph = P.build_gpt2_dag(P.GPT2Config.tiny(), **KW).graph
    graph.recipe = None
    tc = cluster(2, ranks=2)
    ts = P.get_scheduler("roundrobin").schedule(graph, tc)
    backend = P.DeviceBackend(tc)
    placed = []
    monkeypatch.setattr(backend, "place_params",
                        lambda *a, **k: placed.append(1))
    with pytest.raises(ValueError, match="has none"):
        backend.execute(graph, ts, tiny["tparams"],
                        torch.from_numpy(tiny["ids"]), compiled=True)
    assert not placed


@pytest.mark.parametrize("platform,devices,match", [
    ("cpu", ("cpu:0", "cuda:1"), "mix cpu and cuda"),
    ("cpu", ("cuda:0", "cuda:1"), "platform seam is 'cpu'"),
    ("cuda", ("cpu:0", "cpu:1"), "platform seam is 'cuda'"),
], ids=["mixed", "cards-under-cpu", "cpu-ranks-under-cuda"])
def test_devices_of_another_type_start_no_world(tiny, monkeypatch, platform,
                                                devices, match):
    """A world runs its ranks on the platform seam's devices: a placement
    that mixes types, or names devices of another type, is refused before
    anything is placed or started (``cpu`` and ``cuda:0`` are two
    devices, not one rank)."""
    _no_world(monkeypatch)
    monkeypatch.setenv("DLS_PLATFORM", platform)
    tc = P.Cluster.from_torch_devices([torch.device(d) for d in devices],
                                      hbm_cap_gb=8.0)
    ts = P.get_scheduler("roundrobin").schedule(tiny["tg"], tc)
    backend = P.DeviceBackend(tc)
    placed = []
    monkeypatch.setattr(backend, "place_params",
                        lambda *a, **k: placed.append(1))
    with pytest.raises(ValueError, match=match):
        backend.execute(tiny["tg"], ts, tiny["tparams"],
                        torch.from_numpy(tiny["ids"]), compiled=True)
    assert not placed
    assert CW.world_devices(backend, list(ts.per_node)) == tuple(
        sorted((torch.device(d) for d in devices),
               key=lambda d: (d.type, d.index)))


@pytest.mark.parametrize("bad", [
    dict(segments=True), dict(profile=True), dict(coalesce=True),
    dict(keep_outputs=True), dict(planned=True), dict(ext_outputs={}),
], ids=lambda kw: next(iter(kw)))
def test_refused_flags_start_no_world(tiny, monkeypatch, bad):
    _no_world(monkeypatch)
    tc = cluster(2, ranks=2)
    ts = P.get_scheduler("roundrobin").schedule(tiny["tg"], tc)
    with pytest.raises(ValueError, match="incompatible with"):
        P.DeviceBackend(tc).execute(
            tiny["tg"], ts, tiny["tparams"], torch.from_numpy(tiny["ids"]),
            compiled=True, **bad)


def test_an_ordering_cycle_starts_no_world(monkeypatch):
    """COL002, as the one-device rung refuses it."""
    _no_world(monkeypatch)
    g = P.TaskGraph([
        P.Task("a", 0.1, 0.1, [], fn=lambda p, x: x + 1),
        P.Task("b", 0.1, 0.1, [], fn=lambda p, x: x + 2),
        P.Task("c", 0.1, 0.1, ["b"], fn=lambda p, x: x * 2),
        P.Task("d", 0.1, 0.1, ["a"], fn=lambda p, x: x * 3),
    ], name="cycle").freeze()
    g.recipe = ("no.such.module:build", (), {})
    s = P.Schedule(policy="hand", per_node={"n0": ["c", "a"],
                                            "n1": ["d", "b"]},
                   assignment_order=["c", "d", "a", "b"])
    c = P.Cluster([P.DeviceState(n, 1.0, torch_device=torch.device("cpu", i))
                   for i, n in enumerate(("n0", "n1"))])
    with pytest.raises(AnalysisError) as e:
        P.DeviceBackend(c).execute(g, s, {}, torch.zeros(2), compiled=True)
    assert [d.code for d in e.value.report.diagnostics] == ["COL002"]


def test_a_divergent_exchange_order_starts_no_world(tiny, monkeypatch):
    """COL001: one rank's sequence dropped its last exchange."""
    from distributed_llm_scheduler_tpu_torch.analysis import collective_pass

    _no_world(monkeypatch)
    real = collective_pass.analyze_collectives

    def divergent(ir, *a, **k):
        seq = ir.collective_sequence()
        return real({d: seq[:-1] if i == 1 else seq
                     for i, d in enumerate(ir.devices)})

    monkeypatch.setattr(collective_pass, "analyze_collectives", divergent)
    tc = cluster(2, ranks=2)
    ts = P.get_scheduler("roundrobin").schedule(tiny["tg"], tc)
    with pytest.raises(AnalysisError) as e:
        P.DeviceBackend(tc).execute(
            tiny["tg"], ts, tiny["tparams"], torch.from_numpy(tiny["ids"]),
            compiled=True)
    assert "COL001" in {d.code for d in e.value.report.diagnostics}


def test_a_malformed_exchange_starts_no_world(tiny, monkeypatch):
    """COL004: an exchange to a device outside the program."""
    from distributed_llm_scheduler_tpu_torch.sched.linearize import ProgramIR

    _no_world(monkeypatch)
    real = ProgramIR.collective_sequence

    def malformed(self):
        seq = real(self)
        prim, _perm, tid = seq[0]
        return [(prim, ((0, len(self.devices) + 1),), tid)] + seq[1:]

    monkeypatch.setattr(ProgramIR, "collective_sequence", malformed)
    tc = cluster(2, ranks=2)
    ts = P.get_scheduler("roundrobin").schedule(tiny["tg"], tc)
    with pytest.raises(AnalysisError) as e:
        P.DeviceBackend(tc).execute(
            tiny["tg"], ts, tiny["tparams"], torch.from_numpy(tiny["ids"]),
            compiled=True)
    assert "COL004" in {d.code for d in e.value.report.diagnostics}


def test_the_recipe_rebuilds_the_graph(tiny):
    """The recipe pickles and gives a graph of the same name and tasks."""
    import pickle

    from distributed_llm_scheduler_tpu_torch.core.graph import from_recipe

    again = from_recipe(pickle.loads(pickle.dumps(tiny["tg"].recipe)))
    assert again.name == tiny["tg"].name
    assert again.topo_order == tiny["tg"].topo_order
    assert again.recipe == tiny["tg"].recipe
