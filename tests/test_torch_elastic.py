"""The port's elastic recovery (``sched/elastic.py``) against the JAX
package's, on the JAX package's fixtures (``tests/test_elastic.py``).

A half-executed run of the same LLM DAG in both packages: the partitions
(``surviving_work``), the remainder graphs and the re-placed schedules
(``reschedule``) must be equal; the JAX tests' own assertions hold on the
port; and a real recovery on CPU devices reproduces the fused forward
(the JAX test's rtol=atol=2e-5), through the API and through ``execute
--inject-failure``.
"""

from __future__ import annotations

import contextlib
import io
import json

import pytest
import torch

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu.frontend import generators as JG
from distributed_llm_scheduler_tpu.sched import elastic as JE
from distributed_llm_scheduler_tpu_torch.frontend import generators as PG
from distributed_llm_scheduler_tpu_torch.sched import elastic as PE


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: several spin against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_state(pkg, gen):
    """The JAX tests' fixture: an LLM DAG scheduled by ``pack`` on 4 nodes,
    the first half of the assignment order completed, node 2 dead."""
    graph = gen.generate_llm_dag(num_layers=6, num_heads=4, seed=3)
    graph.freeze()
    cluster = pkg.Cluster.uniform(4, 16.0)
    schedule = pkg.get_scheduler("pack").schedule(graph, cluster)
    assert not schedule.failed
    order = schedule.assignment_order
    completed = set(order[: len(order) // 2])
    dead = cluster.devices[2].node_id
    return graph, schedule, completed, dead, cluster.without(dead)


@pytest.fixture
def both():
    return _run_state(J, JG), _run_state(P, PG)


def _tasks(graph):
    return [(t.task_id, t.memory_required, t.compute_time,
             list(t.dependencies), sorted(t.params_needed),
             dict(t.param_bytes), list(t.arg_tasks or []), t.group)
            for t in (graph[tid] for tid in graph.topo_order)]


def _fields(s):
    return (s.per_node, s.assignment_order, s.completed, s.failed)


@pytest.mark.parametrize("dead_kind", ["node_2", "none"])
def test_surviving_work_equals_the_jax_partition(both, dead_kind):
    (jg, js, jc, jdead, _), (pg, ps, pc, pdead, _) = both
    assert _fields(ps) == _fields(js) and (pc, pdead) == (jc, jdead)
    dead = {pdead} if dead_kind == "node_2" else set()
    assert PE.surviving_work(pg, ps, pc, dead) == \
        JE.surviving_work(jg, js, jc, dead)
    keep = sorted(pc)[::2]
    assert PE.surviving_work(pg, ps, pc, dead, have_outputs=keep) == \
        JE.surviving_work(jg, js, jc, dead, have_outputs=keep)


def test_remainder_graph_equals_the_jax_one(both):
    (jg, js, jc, jdead, _), (pg, ps, pc, pdead, _) = both
    must_run, _ = PE.surviving_work(pg, ps, pc, {pdead})
    pr, jr = PE.remainder_graph(pg, must_run), JE.remainder_graph(jg, must_run)
    assert pr.name == jr.name
    assert _tasks(pr) == _tasks(jr)


def test_reschedule_equals_the_jax_one(both):
    (jg, js, jc, jdead, jsurv), (pg, ps, pc, pdead, psurv) = both
    pout = PE.reschedule(pg, ps, pc, {pdead}, psurv, P.get_scheduler("pack"))
    jout = JE.reschedule(jg, js, jc, {jdead}, jsurv, J.get_scheduler("pack"))
    assert _fields(pout[0]) == _fields(jout[0])
    assert _tasks(pout[1]) == _tasks(jout[1])
    assert pout[2:] == jout[2:]


# -- the JAX package's own assertions, on the port ---------------------------

def test_surviving_work_partition(both):
    graph, schedule, completed, dead, _ = both[1]
    must_run, available = PE.surviving_work(graph, schedule, completed, {dead})
    all_ids = {t.task_id for t in graph.tasks()}
    assert must_run | available == all_ids and not (must_run & available)
    for t in completed:
        assert (t in must_run) == (schedule.placement[t] == dead)
    assert all(t in must_run for t in all_ids - completed)


def test_reschedule_completes_on_survivors(both):
    graph, schedule, completed, dead, survivors = both[1]
    new_s, sub, must_run, available = PE.reschedule(
        graph, schedule, completed, {dead}, survivors, P.get_scheduler("pack"))
    assert not new_s.failed and set(new_s.placement) == must_run
    assert dead not in new_s.per_node
    rep = P.SimulatedBackend(fidelity="full").execute(sub, survivors, new_s)
    assert rep.completed_tasks == len(must_run)
    assert available | set(new_s.completed) == {t.task_id for t in graph.tasks()}


def test_reschedule_rejects_dead_node_in_cluster(both):
    graph, schedule, completed, _, _ = both[1]
    bad = P.Cluster.uniform(4, 16.0)
    with pytest.raises(ValueError, match="dead nodes"):
        PE.reschedule(graph, schedule, completed, {bad.devices[2].node_id},
                      bad, P.get_scheduler("pack"))


def test_recovery_cost_bounded(both):
    graph, schedule, completed, dead, _ = both[1]
    must_run, _ = PE.surviving_work(graph, schedule, completed, {dead})
    on_dead = {t for t in completed if schedule.placement[t] == dead}
    assert must_run == ({t.task_id for t in graph.tasks()} - completed) | on_dead


@pytest.mark.parametrize("segments", [False, True])
def test_device_recovery_end_to_end(segments):
    """The JAX test's public flow on four CPU devices: keep outputs, kill
    node 2, reschedule with the report's outputs, re-execute with them
    fed in, and meet the fused forward."""
    dag = P.build_gpt2_dag(P.GPT2Config.tiny(), batch=2, seq_len=16)
    cpu = torch.device("cpu")
    params, ids = dag.init_params(device=cpu), dag.make_inputs(device=cpu)
    cluster = P.Cluster.from_torch_devices([cpu] * 4, hbm_cap_gb=8.0)
    schedule = P.get_scheduler("pack").schedule(dag.graph, cluster)
    first = P.DeviceBackend(cluster).execute(
        dag.graph, schedule, params, ids, segments=segments,
        keep_outputs=True)
    assert first.task_outputs
    completed = set(schedule.assignment_order[
        : len(schedule.assignment_order) // 2])
    dead = cluster.devices[2].node_id
    survivors = cluster.without(dead)
    new_s, remainder, must_run, available = PE.reschedule(
        dag.graph, schedule, completed, {dead}, survivors,
        P.get_scheduler("pack"), have_outputs=first.task_outputs)
    assert not new_s.failed
    rep = P.DeviceBackend(survivors).execute(
        remainder, new_s, params, ids,
        ext_outputs={t: first.task_outputs[t] for t in available},
        segments=segments)
    torch.testing.assert_close(rep.output, dag.reference_forward(params, ids),
                               rtol=2e-5, atol=2e-5)
    assert rep.n_dispatches <= len(must_run)


def _jax_recovery_counts(node_index, frac):
    """The counts the JAX CLI's ``execute --model gpt2-tiny --num-nodes 4
    --inject-failure NODE:FRAC`` reports, from the JAX package's own graph,
    cluster, policy and ``reschedule`` as its ``_injected_recovery`` calls
    them, without running the model: an uninterrupted run keeps every
    task's output."""
    from distributed_llm_scheduler_tpu.utils.config import RunConfig as JRC

    cfg = JRC(model="gpt2-tiny", num_nodes=4)
    dag = cfg.build_graph()
    cluster = cfg.build_cluster_with_devices()
    schedule = cfg.build_scheduler().schedule(dag.graph, cluster)
    node = cluster.devices[node_index].node_id
    order = schedule.assignment_order
    completed = set(order[: int(len(order) * frac)])
    _, _, must_run, available = JE.reschedule(
        dag.graph, schedule, completed, {node}, cluster.without(node),
        cfg.build_scheduler(), have_outputs=set(dag.graph.topo_order))
    return {"killed_node": node, "completed_before_failure": len(completed),
            "reused_outputs": len(available), "rerun_tasks": len(must_run)}


def test_execute_inject_failure_recovers(monkeypatch):
    """``execute --inject-failure 1:0.5`` on 4 CPU nodes: the recovered
    output matches the uninterrupted run, and the recovery's counts are
    the JAX package's on the same configuration."""
    from distributed_llm_scheduler_tpu_torch.__main__ import main

    monkeypatch.setenv("DLS_PLATFORM", "cpu")
    argv = ["execute", "--model", "gpt2-tiny", "--num-nodes", "4",
            "--inject-failure", "1:0.5"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    got = json.loads(out.getvalue())["recovery"]
    assert got["output_matches_uninterrupted"] is True
    assert set(got) == {"killed_node", "completed_before_failure",
                        "reused_outputs", "rerun_tasks",
                        "recovered_makespan_ms",
                        "output_matches_uninterrupted"}
    want = _jax_recovery_counts(1, 0.5)
    assert {k: got[k] for k in want} == want


def test_inject_failure_rejections_match_the_jax_cli(monkeypatch):
    from distributed_llm_scheduler_tpu.__main__ import main as jmain
    from distributed_llm_scheduler_tpu_torch.__main__ import main

    monkeypatch.setenv("DLS_PLATFORM", "cpu")
    for spec, nodes in (("9:0.5", "4"), ("1:1.5", "4"), ("x", "4"),
                        ("1:abc", "4"), ("0", "1")):
        errs = []
        for fn in (main, jmain):
            err = io.StringIO()
            with contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(err):
                assert fn(["execute", "--model", "gpt2-tiny", "--num-nodes",
                           nodes, "--inject-failure", spec]) == 2, spec
            errs.append(err.getvalue().strip().splitlines()[-1])
        assert errs[0] == errs[1], spec
