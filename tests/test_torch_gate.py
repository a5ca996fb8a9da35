"""The port's ``analyze``, pre-execution gate and its wiring into every
backend, against the JAX package's.

``analyze`` and ``pre_execution_gate`` must give the JAX package's
diagnostics on its own fixtures (``tests/test_analysis.py``,
``tests/test_typecheck.py``, ``tests/test_incremental.py``), raise where
it raises, and reuse a ``pre_report`` only when its schedule signature
matches.  Each port backend (the simulated replay, ``DeviceBackend.
execute`` on every rung, the compiled build and ``paged_decode_engine``)
must refuse a corrupt schedule before any task runs; ``DLS_SKIP_ANALYSIS``
and ``pre_analysis=False`` turn the gate off.  The sharding, quantization
and cost passes are not ported: ``analyze`` raises when given their
inputs.
"""

import pytest
import torch

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu import analysis as JA
from distributed_llm_scheduler_tpu.core.schedule import Schedule as JSchedule
from distributed_llm_scheduler_tpu.frontend.generators import (
    generate_llm_dag as j_llm,
)
from distributed_llm_scheduler_tpu_torch import analysis as PA
from distributed_llm_scheduler_tpu_torch.backends.compiled_schedule import (
    CompiledSchedule,
)
from distributed_llm_scheduler_tpu_torch.core.schedule import (
    Schedule as PSchedule,
)
from distributed_llm_scheduler_tpu_torch.frontend.generators import (
    generate_llm_dag as p_llm,
)

CPU = torch.device("cpu")
PKGS = ((J, JA, JSchedule), (P, PA, PSchedule))


def sched(S, per_node, order=None):
    if order is None:
        order = [t for tids in per_node.values() for t in tids]
    return S(policy="manual", per_node=per_node, assignment_order=order,
             completed=set(order))


def fields(rep):
    return [(d.code, int(d.severity), d.task, d.node, d.param, d.message,
             d.data) for d in rep.diagnostics]


def two_caps(pkg, cap=1.0):
    return pkg.Cluster([pkg.DeviceState("n0", cap),
                        pkg.DeviceState("n1", cap)])


def ab(pkg):
    return pkg.TaskGraph([pkg.Task("a", 0.1, 1.0, [], set()),
                          pkg.Task("b", 0.1, 1.0, ["a"], set())]).freeze()


def outcome(fn):
    """(raised, report fields) of one gate call."""
    try:
        rep = fn()
    except Exception as e:  # AnalysisError in both packages
        assert type(e).__name__ == "AnalysisError", e
        return "raised", fields(e.report)
    return "passed", None if rep is None else fields(rep)


GATE_CASES = {
    # name -> (per_node, order, backend)
    "sim_inversion": ({"n0": ["b", "a"]}, None, "sim"),
    "device_lenient_inversion": ({"n0": ["b", "a"]}, None, "device"),
    "device_duplicate": ({"n0": ["a"], "n1": ["a", "b"]}, None, "device"),
    "sim_duplicate": ({"n0": ["a"], "n1": ["a", "b"]}, None, "sim"),
    "unknown_node": ({"n0": ["a", "b"], "bogus": []}, None, "device"),
    "unplaced_order": ({"n0": ["a"]}, ["a", "b"], "sim"),
    "clean": ({"n0": ["a"], "n1": ["b"]}, None, "sim"),
}


@pytest.mark.parametrize("name", sorted(GATE_CASES))
def test_gate_equals_jax(name):
    per_node, order, backend = GATE_CASES[name]
    got = [
        outcome(lambda pkg=pkg, A=A, S=S: A.pre_execution_gate(
            ab(pkg), two_caps(pkg), sched(S, dict(per_node), order),
            backend=backend))
        for pkg, A, S in PKGS
    ]
    assert got[1] == got[0]


def test_gate_extras_equal_jax():
    """The donation and happens-before passes join the gate when given
    their inputs, raising as the JAX gate does."""
    bad_plan = {
        "steps": (
            {"tids": ("a",), "node_id": "d0", "arg_slots": (0,),
             "xfer_slots": (), "donate_slots": (0,), "out_slots": (1,)},
            {"tids": ("b",), "node_id": "d0", "arg_slots": (0,),
             "xfer_slots": (), "donate_slots": (), "out_slots": (2,)},
        ),
        "fence_slots": (), "final_slot": None, "keep_list": (),
        "ext_slots": (), "n_slots": 8,
    }
    dead = {"stage0": [("recv", "stage1", "b"), ("send", "stage1", "a")],
            "stage1": [("recv", "stage0", "a"), ("send", "stage0", "b")]}
    for kw in (dict(plan=bad_plan), dict(stage_programs=dead)):
        got = [outcome(lambda pkg=pkg, A=A, S=S: A.pre_execution_gate(
            ab(pkg), two_caps(pkg), sched(S, {"n0": ["a", "b"]}),
            backend="device", **kw)) for pkg, A, S in PKGS]
        assert got[1] == got[0] and got[0][0] == "raised"
    ok = [outcome(lambda pkg=pkg, A=A, S=S: A.pre_execution_gate(
        ab(pkg), two_caps(pkg), sched(S, {"n0": ["a", "b"]}),
        backend="device", stage_programs=A.stage_programs_1f1b(2, 4)))
        for pkg, A, S in PKGS]
    assert ok[1] == ok[0] and ok[0][0] == "passed"


def test_gate_accepts_every_policy_output_as_jax():
    for (pkg, A, _S), gen in zip(PKGS, (j_llm, p_llm)):
        graph = gen(num_layers=4, num_heads=4, seed=3)
        for name in sorted(pkg.ALL_SCHEDULERS):
            cluster = pkg.Cluster.heterogeneous(20.0, 4)
            s = pkg.get_scheduler(name).schedule(graph, cluster)
            for backend in ("sim", "device"):
                rep = A.pre_execution_gate(graph, cluster, s, backend=backend)
                assert rep is not None and rep.ok, (pkg.__name__, name)


ANALYZE_CASES = {
    "inversion": ({"n0": ["b", "a"]}, None),
    "cross_node": ({"n0": ["a"], "n1": ["b"]}, None),
    "duplicate": ({"n0": ["a"], "n1": ["a", "b"]}, None),
}


@pytest.mark.parametrize("name", sorted(ANALYZE_CASES))
def test_analyze_equals_jax(name):
    per_node, order = ANALYZE_CASES[name]
    reps = [A.analyze(ab(pkg), two_caps(pkg), sched(S, dict(per_node), order))
            for pkg, A, S in PKGS]
    assert fields(reps[1]) == fields(reps[0])
    assert reps[1].schedule_signature == reps[0].schedule_signature
    assert reps[1].to_json() == reps[0].to_json()


def test_analyze_on_gpt2_with_meta_params_equals_jax():
    from distributed_llm_scheduler_tpu.frontend.gpt2_dag import (
        build_gpt2_dag as jb,
    )
    from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config as JC
    from distributed_llm_scheduler_tpu_torch.frontend.gpt2_dag import (
        build_gpt2_dag as tb,
    )
    from distributed_llm_scheduler_tpu_torch.models.gpt2 import (
        GPT2Config as TC,
    )

    kw = dict(batch=2, seq_len=16, microbatches=2, vocab_shards=4)
    reps = []
    for (pkg, A, _S), dag in ((PKGS[0], jb(JC.tiny(), **kw)),
                              (PKGS[1], tb(TC.tiny(), **kw))):
        c = pkg.Cluster.uniform(4, dag.graph.total_param_gb())
        s = pkg.get_scheduler("heft").schedule(dag.graph, c)
        reps.append(A.analyze(dag.graph, c, s, params=dag.param_specs,
                              graph_input=dag.input_spec))
    assert fields(reps[1]) == fields(reps[0])
    assert reps[1].ok


def test_unported_passes_raise():
    g, c = ab(P), two_caps(P)
    s = sched(PSchedule, {"n0": ["a", "b"]})
    for kw, what in (
        (dict(param_shapes={"w": (4,)}, mesh_axes={"tp": 2}), "sharding"),
        (dict(param_specs={"w": torch.empty(4, device="meta")}),
         "quantization"),
        (dict(compiled_gb={"a": 0.1}), "cost"),
    ):
        with pytest.raises(NotImplementedError, match=f"the {what} pass"):
            PA.analyze(g, c, s, **kw)
    # the sharding pass needs both of its inputs, as in the reference
    assert PA.analyze(g, c, s, param_shapes={"w": (4,)}).ok


def test_pre_report_reused_only_on_a_matching_signature(monkeypatch):
    g, c = ab(P), two_caps(P)
    s = sched(PSchedule, {"n0": ["a"], "n1": ["b"]})
    rep = PA.analyze(g, c, s)
    calls = {"n": 0}
    real = PA.analyze_graph

    def counting(graph):
        calls["n"] += 1
        return real(graph)

    monkeypatch.setattr(PA, "analyze_graph", counting)
    sim = P.SimulatedBackend(fidelity="full")
    sim.execute(g, c, s, pre_report=rep)
    assert calls["n"] == 0
    s2 = sched(PSchedule, {"n0": ["a", "b"]})
    sim.execute(g, c, s2, pre_report=rep)  # stale: the gate runs the passes
    assert calls["n"] == 1
    # precomputed errors still raise
    bad = sched(PSchedule, {"n0": ["b", "a"]})
    with pytest.raises(PA.AnalysisError):
        sim.execute(g, c, bad, pre_report=PA.analyze(g, c, bad))


# -- the backends ------------------------------------------------------------

def counted_chain(calls, cycle=False):
    """a -> b -> c, each fn counting its runs; ``cycle`` adds c -> a (the
    graph is left unfrozen: freezing it would raise)."""
    def fn(name):
        def run(p, x):
            calls.append(name)
            return x + 1
        return run

    tasks = [P.Task("a", 0.1, 0.1, ["c"] if cycle else [], fn=fn("a")),
             P.Task("b", 0.1, 0.1, ["a"], fn=fn("b")),
             P.Task("c", 0.1, 0.1, ["b"], fn=fn("c"))]
    g = P.TaskGraph(tasks, name="chain")
    return g if cycle else g.freeze()


def cpu_cluster():
    return P.Cluster([P.DeviceState(n, 1.0, torch_device=CPU)
                      for n in ("n0", "n1")])


DUPLICATE = {"n0": ["a", "b"], "n1": ["b", "c"]}     # b on two nodes
RUNGS = {"per_task": dict(planned=False), "planned": dict(),
         "coalesce": dict(coalesce=True), "segments": dict(segments=True),
         "compiled": dict(compiled=True)}


@pytest.mark.parametrize("rung", sorted(RUNGS))
@pytest.mark.parametrize("defect", ["duplicate", "cycle"])
def test_execute_refuses_before_any_task_runs(rung, defect):
    calls = []
    g = counted_chain(calls, cycle=defect == "cycle")
    per_node = DUPLICATE if defect == "duplicate" else {
        "n0": ["a", "b"], "n1": ["c"]}
    s = sched(PSchedule, {n: list(ts) for n, ts in per_node.items()},
              ["a", "b", "c"])
    with pytest.raises(PA.AnalysisError) as e:
        P.DeviceBackend(cpu_cluster()).execute(g, s, {}, torch.zeros(2),
                                               **RUNGS[rung])
    want = "SCH003" if defect == "duplicate" else "DAG001"
    assert e.value.report.has(want)
    assert calls == []


@pytest.mark.parametrize("defect", ["duplicate", "cycle"])
def test_compiled_build_and_sim_refuse(defect):
    calls = []
    g = counted_chain(calls, cycle=defect == "cycle")
    per_node = DUPLICATE if defect == "duplicate" else {
        "n0": ["a", "b"], "n1": ["c"]}
    s = sched(PSchedule, {n: list(ts) for n, ts in per_node.items()},
              ["a", "b", "c"])
    b = P.DeviceBackend(cpu_cluster())
    with pytest.raises(PA.AnalysisError):
        CompiledSchedule.build(b, g, s, {}, torch.zeros(2))
    with pytest.raises(PA.AnalysisError):
        P.SimulatedBackend(fidelity="full").execute(g, cpu_cluster(), s)
    assert calls == []


def with_cycle(graph):
    """``graph``'s tasks (copies) with its first task waiting on its last:
    a dependency cycle, left unfrozen."""
    import dataclasses

    order = graph.topo_order
    tasks = [dataclasses.replace(t, dependencies=list(t.dependencies))
             for t in graph.tasks()]
    first = next(t for t in tasks if t.task_id == order[0])
    first.dependencies.append(order[-1])
    return P.TaskGraph(tasks, name=graph.name)


@pytest.mark.parametrize("defect", ["duplicate", "cycle"])
def test_paged_decode_engine_refuses_before_it_is_built(defect):
    from distributed_llm_scheduler_tpu_torch.models.kv_pages import PagePool

    dag = P.build_paged_decode_dag(P.GPT2Config.tiny(), slots=2, page_size=4,
                                   n_pages=8, pages_per_seq=4)
    tids = dag.graph.topo_order
    graph, per_node = dag.graph, {"n0": list(tids)}
    if defect == "duplicate":
        per_node["n1"] = [tids[-1]]
    else:
        graph = with_cycle(graph)
    s = sched(PSchedule, per_node, tids)
    with pytest.raises(PA.AnalysisError) as e:
        P.DeviceBackend(cpu_cluster()).paged_decode_engine(
            graph, s, dag.config, {}, PagePool(8), slots=2, pages_per_seq=4)
    assert e.value.report.has("SCH003" if defect == "duplicate" else "DAG001")


def test_skip_env_and_pre_analysis_turn_the_gate_off(monkeypatch):
    """The gate's own verdict goes; what the run does without it is the
    backend's (here an unknown empty node, harmless to the run)."""
    calls = []
    g = counted_chain(calls)
    s = sched(PSchedule, {"n0": ["a", "b"], "n1": ["c"], "bogus": []},
              ["a", "b", "c"])
    with pytest.raises(PA.AnalysisError):
        P.DeviceBackend(cpu_cluster()).execute(g, s, {}, torch.zeros(2))
    assert calls == []
    rep = P.DeviceBackend(cpu_cluster(), pre_analysis=False).execute(
        g, s, {}, torch.zeros(2), warmup=False)
    assert torch.equal(rep.output, torch.full((2,), 3.0))
    monkeypatch.setenv(PA.SKIP_ENV, "1")
    assert not PA.gate_enabled()
    assert PA.pre_execution_gate(g, cpu_cluster(), s, backend="device") is None
    P.DeviceBackend(cpu_cluster()).execute(g, s, {}, torch.zeros(2),
                                           compiled=True, warmup=False)
    P.SimulatedBackend(fidelity="full").execute(
        ab(P), two_caps(P), sched(PSchedule, {"n0": ["b", "a"]}))
