"""The port's rank check (``eval/rankcheck.py``), the transfer-stress DAG
(``frontend/stress_dag.py``) and the ``rankcheck`` command against the JAX
package's, on the CPU.

The rank statistics are framework-free and must equal the JAX package's,
on ``tests/test_rankcheck.py``'s inputs and on random orders.  The check
itself is a wall-clock measurement, so the JAX one is not run here (its
own test is a slow one there); the port's runs on GPT-2 tiny over 4
explicit CPU nodes and must return the JAX report's keys, and place each
policy as the JAX policies place the same graph (the port's calibrated
task times and link copied onto the JAX graph).  The stress DAG's graph
equals the JAX one; its outputs on the bridged weights are allclose to
JAX's reference forward at rtol=atol=2e-4 (``__graft_entry__.py:333``'s
rule for a placed DAG).  ``--stress`` needs 4 cards: on the CPU (one
device, however many nodes) it exits 2 with one line.
"""

from __future__ import annotations

import contextlib
import io
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu.__main__ import main as jmain
from distributed_llm_scheduler_tpu.eval import rankcheck as JR
from distributed_llm_scheduler_tpu.frontend.stress_dag import (
    build_transfer_stress_dag as jbuild_stress,
)
from distributed_llm_scheduler_tpu_torch.__main__ import main as pmain
from distributed_llm_scheduler_tpu_torch.eval import rankcheck as PR
from distributed_llm_scheduler_tpu_torch.frontend.stress_dag import (
    build_transfer_stress_dag,
)
from distributed_llm_scheduler_tpu_torch.sched import policies as PP
from distributed_llm_scheduler_tpu_torch.utils.linkmodel import calibrate_link

CPU = torch.device("cpu")

# the keys of ``run_rank_check``'s report, from
# distributed_llm_scheduler_tpu/eval/rankcheck.py (its ``report`` dict)
REPORT_KEYS = [
    "n_policies", "policies", "predicted_order", "measured_order",
    "kendall_tau", "prediction_groups", "cross_group_agreement",
    "prediction_spread", "prediction_is_tie", "tie_rtol",
    "predicted_winner", "measured_winner", "winner_agreement",
    "winner_rtol", "n_devices", "platform", "graph", "n_tasks",
    "link_provenance", "anchor_calibration", "wall_s",
]
POLICY_KEYS = ["predicted_s", "measured_s", "ratio"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: several spin against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("DLS_PLATFORM", "cpu")
    monkeypatch.delenv("DLS_FORCE_CPU", raising=False)
    monkeypatch.delenv("DLS_NATIVE", raising=False)


# -- the rank statistics -------------------------------------------------------

TAU_CASES = [
    (["a", "b", "c"], ["a", "b", "c"]),
    (["a", "b", "c"], ["c", "b", "a"]),
    (["a", "b", "c"], ["a", "c", "b"]),
    (["a"], ["a"]),
    ([], []),
    (["a", "b", "x"], ["b", "a"]),
]
GROUP_VALUES = {"a": 1.00, "b": 1.05, "c": 1.08, "d": 1.50, "e": 1.52}
AGREEMENT_CASES = [
    ([["a", "b"], ["c"]], {"a": 2.0, "b": 1.0, "c": 3.0}),
    ([["a", "b"], ["c"]], {"a": 2.0, "b": 4.0, "c": 3.0}),
    ([["a", "b", "c"]], {"a": 2.0, "b": 4.0, "c": 3.0}),
    ([["a"], ["b"], ["c"]], {"a": 1.0, "b": 1.0, "c": 0.5}),
]


def test_rank_statistics_equal_the_jax_ones():
    for a, b in TAU_CASES:
        assert PR.kendall_tau(a, b) == JR.kendall_tau(a, b)
    order = sorted(GROUP_VALUES)
    for rtol in (0.10, 0.01, 0.5, 0.0):
        assert (PR.tie_groups(order, GROUP_VALUES, rtol)
                == JR.tie_groups(order, GROUP_VALUES, rtol))
    for groups, meas in AGREEMENT_CASES:
        assert (PR.cross_group_agreement(groups, meas)
                == JR.cross_group_agreement(groups, meas))
    # test_rankcheck.py's pinned values hold for the port
    assert PR.kendall_tau(["a", "b", "c"], ["a", "c", "b"]) == pytest.approx(
        1 / 3)
    assert PR.tie_groups(order, GROUP_VALUES, 0.10) == [["a", "b", "c"],
                                                       ["d", "e"]]
    assert PR.cross_group_agreement(*AGREEMENT_CASES[1]) == 0.5


@settings(max_examples=60, deadline=None, database=None)
@given(st.permutations(list("abcdefg")), st.permutations(list("abcdefg")),
       st.lists(st.integers(1, 40), min_size=7, max_size=7),
       st.sampled_from([0.0, 0.05, 0.1, 0.3]))
def test_rank_statistics_on_random_orders(pred, meas, values, rtol):
    pred, meas = list(pred), list(meas)
    assert PR.kendall_tau(pred, meas) == JR.kendall_tau(pred, meas)
    assert PR.kendall_tau(pred[:4], meas) == JR.kendall_tau(pred[:4], meas)
    vals = dict(zip(pred, sorted(v / 10 for v in values)))
    groups = PR.tie_groups(pred, vals, rtol)
    assert groups == JR.tie_groups(pred, vals, rtol)
    measured = {p: float(values[i]) for i, p in enumerate(meas)}
    assert (PR.cross_group_agreement(groups, measured)
            == JR.cross_group_agreement(groups, measured))


# -- the link on CPU nodes -----------------------------------------------------

def test_calibrate_link_measures_cpu_nodes_passed_explicitly():
    """The rank check's CPU legs: both legs time host copies; one CPU
    node keeps the interconnect estimate."""
    cal = calibrate_link([CPU] * 4, sizes=(1 << 12, 1 << 16, 1 << 20),
                         repeats=2)
    assert cal.platform == "cpu"
    assert cal.provenance == {"param_load": "measured(host copy)",
                              "interconnect": "measured(host copy)"}
    assert cal.param_load_gbps > 0 and cal.interconnect_gbps > 0
    assert cal.latency_s >= 0 and cal.measured_at
    one = calibrate_link([CPU], sizes=(1 << 12, 1 << 16), repeats=1)
    assert one.provenance["interconnect"].startswith("estimated(")
    with pytest.raises(ValueError, match="sustained"):
        calibrate_link([CPU], sustained=True)


# -- run_rank_check on GPT-2 tiny over 4 CPU nodes ------------------------------

@pytest.fixture(scope="module")
def tiny_check():
    """The port's check on GPT-2 tiny, 4 CPU nodes, the CLI's default
    policies; every schedule it placed recorded (policy, link, placement)."""
    cfg = P.GPT2Config.tiny()
    dag = P.build_gpt2_dag(cfg, batch=2, seq_len=16)
    cluster = P.Cluster.from_torch_devices([CPU] * 4, hbm_cap_gb=4.0)
    placed = []
    orig = PP.get_scheduler

    def spy(name, **kw):
        policy = orig(name, **kw)
        inner = policy.schedule

        def schedule(graph, cl):
            s = inner(graph, cl)
            if cl is cluster:  # not the calibration's one-node greedy
                placed.append((name, kw.get("link"), dict(s.placement)))
            return s

        policy.schedule = schedule
        return policy

    mp = pytest.MonkeyPatch()
    mp.setattr(PP, "get_scheduler", spy)
    try:
        report = PR.run_rank_check(
            dag.graph, dag.init_params(device=CPU), dag.make_inputs(device=CPU),
            cluster=cluster, measure_repeats=2, log=lambda m: None,
        )
    finally:
        mp.undo()
    return dag, report, placed


def test_rank_check_report_has_the_jax_keys(tiny_check):
    dag, report, placed = tiny_check
    assert list(report) == REPORT_KEYS
    assert report["n_policies"] == 4 and report["n_devices"] == 4
    assert report["platform"] == "cpu" and report["n_tasks"] == len(dag.graph)
    for row in report["policies"].values():
        assert list(row) == POLICY_KEYS
        assert row["predicted_s"] > 0 and row["measured_s"] > 0
    assert set(report["predicted_order"]) == set(report["measured_order"])
    assert report["winner_agreement"] in (True, False)
    assert [p for p, _l, _pl in placed] == ["roundrobin", "critical",
                                           "pipeline", "pack"]


def test_rank_check_places_as_the_jax_policies(tiny_check):
    """The JAX policies on the JAX build of the same graph, given the
    port's calibrated task times and link, place every task where the
    port's did: equal placement digests."""
    from distributed_llm_scheduler_tpu.frontend.gpt2_dag import build_gpt2_dag
    from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config
    from distributed_llm_scheduler_tpu.sched.search import placement_digest

    dag, _report, placed = tiny_check
    jgraph = build_gpt2_dag(GPT2Config.tiny(), batch=2, seq_len=16).graph
    for t in dag.graph:
        jgraph[t.task_id].compute_time = t.compute_time
    jcluster = J.Cluster([J.DeviceState(f"core_{i}", 4.0, 1.0)
                          for i in range(4)])
    for name, link, placement in placed:
        jlink = J.LinkModel(param_load_gbps=link.param_load_gbps,
                            interconnect_gbps=link.interconnect_gbps,
                            latency_s=link.latency_s)
        want = J.get_scheduler(name, link=jlink).schedule(jgraph, jcluster)
        assert P.placement_digest(placement) == placement_digest(
            want.placement), name


# -- the rankcheck command ---------------------------------------------------------

def run(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


def test_rankcheck_exit_2_and_3_equal_the_jax_cli():
    """A synthetic graph cannot run (2, the same line); no policy places
    the whole graph in 10 KB nodes (3, the same line and report keys)."""
    want = run(jmain, ["rankcheck", "--model", "llm"])
    got = run(pmain, ["rankcheck", "--model", "llm"])
    assert got[0] == want[0] == 2
    assert got[2].strip().splitlines()[-1] == want[2].strip().splitlines()[-1]
    argv = ["rankcheck", "--model", "gpt2-tiny", "--num-nodes", "4",
            "--hbm-gb", "0.00001", "--measure-repeats", "1"]
    want = run(jmain, argv)
    got = run(pmain, argv)
    assert got[0] == want[0] == 3
    assert got[2].strip().splitlines()[-1] == want[2].strip().splitlines()[-1]
    assert list(json.loads(got[1])) == list(json.loads(want[1]))


def test_rankcheck_stress_needs_four_cards():
    """Nodes sharing one device copy nothing between them: on the CPU the
    transfer-bound regime cannot exist, so ``--stress`` exits 2 with one
    line before anything runs."""
    rc, out, err = run(pmain, ["rankcheck", "--stress"])
    assert rc == 2 and out == ""
    (line,) = err.strip().splitlines()
    assert line.startswith("rankcheck --stress needs >= 4 cards")


# -- the transfer-stress DAG -------------------------------------------------------

def graph_rows(graph):
    return [
        (t.task_id, list(t.dependencies), t.memory_required, t.compute_time,
         sorted(t.params_needed), dict(t.param_bytes), t.out_bytes, t.flops,
         t.group, dict(t.param_alias or {}), list(t.arg_tasks or []))
        for t in (graph[tid] for tid in graph.topo_order)
    ]


@pytest.mark.parametrize("shape", [(3, 4, 1.0), (6, 6, 8.0), (2, 3, 0.5)])
def test_stress_dag_equals_the_jax_one(shape):
    pdag = build_transfer_stress_dag(*shape)
    jdag = jbuild_stress(*shape)
    assert pdag.graph.name == jdag.graph.name
    assert graph_rows(pdag.graph) == graph_rows(jdag.graph)
    assert sorted(pdag.param_specs) == sorted(jdag.param_specs)
    assert tuple(pdag.input_spec.shape) == tuple(jdag.input_spec.shape)
    assert pdag.config.vocab_size == jdag.config.vocab_size
    with pytest.raises(ValueError, match="chains >= 1"):
        build_transfer_stress_dag(chains=0)


def test_stress_dag_executes_and_matches_the_jax_oracle():
    """Placed on 2 CPU nodes with greedy, on the JAX package's weights and
    input: the output allclose to JAX's reference forward, and to the
    port's own."""
    jdag = jbuild_stress(chains=2, length=3, edge_mb=0.5)
    jparams, jx = jdag.init_params(), jdag.make_inputs()
    want = np.asarray(jdag.reference_forward(jparams, jx))
    dag = build_transfer_stress_dag(chains=2, length=3, edge_mb=0.5)
    params = dag.model.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, CPU)
    x = torch.from_numpy(np.array(jx))
    cluster = P.Cluster.from_torch_devices([CPU] * 2, hbm_cap_gb=4.0)
    sched = P.get_scheduler("greedy").schedule(dag.graph, cluster)
    assert not sched.failed
    rep = P.DeviceBackend(cluster).execute(dag.graph, sched, params, x)
    np.testing.assert_allclose(rep.output.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        rep.output.numpy(), dag.reference_forward(params, x).numpy(),
        rtol=1e-5)
    # its own seeded weights run too
    own = dag.init_params(device=CPU)
    assert sorted(own) == sorted(jparams)
    assert all(0.5 <= float(v) < 1.5 for v in own.values())


def test_sim_predicts_separation_on_stress_dag():
    """With host-synchronous transfers the replay does not tie a
    transfer-heavy placement with a local one; both packages' replays
    give the same makespans."""
    makespans = {}
    for pkg, dag in ((P, build_transfer_stress_dag(6, 6, 8.0)),
                     (J, jbuild_stress(6, 6, 8.0))):
        g = dag.graph
        for t in g:
            t.compute_time = 5e-4
        cluster = pkg.Cluster([pkg.DeviceState(f"core_{i}", 4.0, 1.0)
                               for i in range(4)])
        link = pkg.LinkModel(param_load_gbps=2.0, interconnect_gbps=2.0,
                             latency_s=1e-4)
        sim = pkg.SimulatedBackend(
            fidelity="full", link=link, host_slots=1, dispatch_s=1e-4,
            host_synchronous_transfers=True,
        )
        makespans[pkg.__name__] = {
            name: sim.execute(g, cluster, pkg.get_scheduler(name).schedule(
                g, cluster)).makespan
            for name in ("roundrobin", "greedy")
        }
    got = makespans[P.__name__]
    assert got == makespans[J.__name__]
    assert got["roundrobin"] > 1.5 * got["greedy"], got
