"""The port's placement searches (``refine``, ``search``), its 10-policy
registry and its search bench against the JAX package's.

Both searches are seeded walks scored by the event simulation and
pre-filtered by the incremental analyzer, so the contract is equality at
the same seed and budget: per-node lists, ``assignment_order``,
``placement_digest``, the search's ``stats`` (evals, filtered, accepted,
kicks, infeasible moves, seed policy, seed and best makespans) and the
eventsim makespans, compared with ``==``.  The static pre-filter must be
on in both packages on every parity DAG, so a broken analyzer cannot hide
behind a filter that fell off.  The full search bench (budget 800) must
reproduce ``SEARCH_r15.json``; it takes minutes and is marked ``slow``.
"""

import dataclasses
import json
from pathlib import Path

import pytest

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu.eval import search_bench as JSB
from distributed_llm_scheduler_tpu.frontend import generators as JG
from distributed_llm_scheduler_tpu.sched import refine as JR
from distributed_llm_scheduler_tpu.sched import search as JS
from distributed_llm_scheduler_tpu.sched.eventsim import (
    simulate_placement as j_simulate,
)
from distributed_llm_scheduler_tpu_torch.eval import search_bench as PSB
from distributed_llm_scheduler_tpu_torch.frontend import generators as PG
from distributed_llm_scheduler_tpu_torch.sched import search as PS

ROOT = Path(__file__).resolve().parent.parent
LINK = dict(param_load_gbps=2.0, interconnect_gbps=50.0)
# the JAX package's search tests' small problem (tests/test_search.py)
SMALL_DAG_KW = dict(batch=4, seq_len=8, microbatches=2, vocab_shards=2)


def _gpt2(pkg_root, n_layer=4, **kw):
    if pkg_root is J:
        from distributed_llm_scheduler_tpu.frontend.gpt2_dag import (
            build_gpt2_dag,
        )
        from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config
    else:
        from distributed_llm_scheduler_tpu_torch.frontend.gpt2_dag import (
            build_gpt2_dag,
        )
        from distributed_llm_scheduler_tpu_torch.models.gpt2 import (
            GPT2Config,
        )
    cfg = dataclasses.replace(GPT2Config.tiny(), n_layer=n_layer)
    return build_gpt2_dag(cfg, **(kw or SMALL_DAG_KW)).graph


DAGS = {
    "llm": lambda pkg, gen: gen.generate_llm_dag(num_layers=4, seed=0),
    "random": lambda pkg, gen: gen.generate_random_dag(num_tasks=20, seed=1),
    "pipeline": lambda pkg, gen: gen.generate_pipeline_dag(
        num_stages=4, tasks_per_stage=3, seed=2),
    "gpt2_tiny": lambda pkg, gen: _gpt2(pkg),
}
POLICIES = {
    "refine": dict(max_evals=60, seed=3),
    "search": dict(budget=48, seed=5),
}


@pytest.fixture
def jax_filter_states(monkeypatch):
    """Whether each JAX search's static pre-filter ran (``enabled``)."""
    seen = []
    for cls in (JR._StaticMoveFilter, JS._TaskMoveFilter):
        orig = cls.__init__

        def rec(self, *a, _orig=orig, **k):
            _orig(self, *a, **k)
            seen.append(self.enabled)

        monkeypatch.setattr(cls, "__init__", rec)
    return seen


def _schedule(pkg, gen, dag, policy, n_nodes=4):
    simulate = j_simulate if pkg is J else P.simulate_placement
    graph = DAGS[dag](pkg, gen)
    cluster = pkg.Cluster.uniform(n_nodes, graph.total_param_gb())
    link = pkg.LinkModel(**LINK)
    sch = pkg.get_scheduler(policy, link=link, **POLICIES[policy])
    s = sch.schedule(graph, cluster)
    speeds = {d.node_id: d.compute_speed for d in cluster}
    _order, makespan, _nf = simulate(
        graph, s.placement, speeds, link, cluster.slice_ids())
    return s, sch, makespan


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("dag", sorted(DAGS))
def test_search_equals_jax(dag, policy, jax_filter_states):
    js, jsch, jm = _schedule(J, JG, dag, policy)
    ps, psch, pm = _schedule(P, PG, dag, policy)
    assert ps.per_node == js.per_node
    assert ps.assignment_order == js.assignment_order
    assert ps.failed == js.failed and not ps.failed
    assert PS.placement_digest(ps.placement) == JS.placement_digest(
        js.placement)
    assert pm == jm
    # the filter ran in both packages
    assert jax_filter_states == [True]
    assert psch.stats["static_filter"] == "on"
    if policy == "search":
        assert {k: v for k, v in psch.stats.items()
                if k != "static_filter"} == jsch.stats
        assert psch.stats["evals"] == POLICIES["search"]["budget"]
    else:
        assert 0 < psch.stats["evals"] <= POLICIES["refine"]["max_evals"]


def test_registry_and_knobs():
    assert sorted(P.ALL_SCHEDULERS) == sorted(J.ALL_SCHEDULERS)
    assert len(P.ALL_SCHEDULERS) == 10
    link = P.LinkModel(**LINK)
    sch = P.get_scheduler("search", link=link, budget=7, seed=3)
    assert isinstance(sch, P.SearchScheduler)
    assert sch.budget == 7 and sch.seed == 3 and sch.link is link
    assert sch.time_budget_s is None
    r = P.get_scheduler("refine", link=link, seed=4)
    assert isinstance(r, P.RefinedPackScheduler) and r.seed == 4
    assert r.max_evals == 400
    # knobs a policy's constructor lacks are dropped, as in the reference
    assert isinstance(P.get_scheduler("heft", budget=9), P.HEFTScheduler)
    with pytest.raises(ValueError, match="unknown scheduler"):
        P.get_scheduler("bogus")


def test_native_engine_is_refused(monkeypatch, tmp_path):
    """The native engine is ported (``tests/test_torch_native.py``); what
    is refused is a failed build: ``native:`` and the ``DLS_NATIVE=1``
    upgrade raise instead of running the Python policy."""
    from distributed_llm_scheduler_tpu_torch import native

    monkeypatch.setattr(native, "_engine", None)
    monkeypatch.setattr(native, "_load_error", None)
    monkeypatch.setattr(native, "_transient_attempts", 0)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_so_path", lambda: tmp_path / "engine.so")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="native engine build failed"):
        P.get_scheduler("native:heft").schedule(
            PG.generate_llm_dag(num_layers=2, seed=0), P.Cluster.uniform(2, 8.0))
    monkeypatch.setenv("DLS_NATIVE", "1")
    with pytest.raises(RuntimeError, match="native engine build failed"):
        P.get_scheduler("greedy")


@pytest.fixture(scope="module")
def small_problem():
    return _gpt2(P), P.Cluster.uniform(4, 8.0)


def test_filter_rejections_skip_eventsim(small_problem, monkeypatch):
    """A statically rejected candidate costs no event simulation: every
    call is the portfolio's seeds, the incumbent's and ``evals``."""
    graph, cluster = small_problem
    calls = {"n": 0}
    real_sim = PS.simulate_placement_timeline

    def counting(*a, **kw):
        calls["n"] += 1
        return real_sim(*a, **kw)

    monkeypatch.setattr(PS, "simulate_placement_timeline", counting)
    reject = {"left": 5}
    real_ok = PS._TaskMoveFilter.ok

    def forced_reject(self, cand):
        if reject["left"] > 0:
            reject["left"] -= 1
            self.rejected += 1
            return False
        return real_ok(self, cand)

    monkeypatch.setattr(PS._TaskMoveFilter, "ok", forced_reject)
    graph.reset()
    cluster.reset()
    sch = P.SearchScheduler(P.LinkModel(**LINK), budget=15, seed=1)
    s = sch.schedule(graph, cluster)
    assert not s.failed and sch.stats["filtered"] >= 5
    assert calls["n"] == len(sch.portfolio) + 1 + sch.stats["evals"]


def test_verify_filter_and_zero_budget(small_problem):
    """``verify_filter`` re-runs the whole suite after every accepted move
    and raises on any divergence of the incremental mirror; budget 0
    returns the seed."""
    graph, cluster = small_problem
    link = P.LinkModel(**LINK)
    for budget in (25, 0):
        graph.reset()
        cluster.reset()
        sch = P.SearchScheduler(link, budget=budget, seed=0,
                                verify_filter=True)
        assert not sch.schedule(graph, cluster).failed
    assert sch.stats["evals"] == 0
    assert sch.stats["best_makespan"] == sch.stats["seed_makespan"]


def test_analyzer_failure_turns_the_filter_off_and_says_why(
        small_problem, monkeypatch):
    from distributed_llm_scheduler_tpu_torch import analysis

    def broken(*a, **k):
        raise RuntimeError("analyzer broke")

    monkeypatch.setattr(analysis, "IncrementalAnalyzer", broken)
    graph, cluster = small_problem
    graph.reset()
    cluster.reset()
    link = P.LinkModel(**LINK)
    sch = P.SearchScheduler(link, budget=10, seed=0)
    assert not sch.schedule(graph, cluster).failed
    assert sch.stats["static_filter"] == "off: RuntimeError: analyzer broke"
    r = P.RefinedPackScheduler(link, max_evals=10)
    r.schedule(graph, cluster)
    assert r.stats["static_filter"] == "off: RuntimeError: analyzer broke"


def _bench_pair(monkeypatch, budget):
    """Both packages' search bench on a 6-layer GPT-2 tiny DAG over the
    bench's 8 nodes of 4 GB (the medium DAG's refine alone takes a
    minute)."""
    kw = dict(batch=8, seq_len=8, microbatches=4, vocab_shards=4)
    jg = _gpt2(J, n_layer=6, **kw)
    jc = J.Cluster([J.DeviceState(f"core_{i}", 4.0) for i in range(8)])
    pg = _gpt2(P, n_layer=6, **kw)
    pc = P.Cluster([P.DeviceState(f"core_{i}", PSB.NODE_GB)
                    for i in range(PSB.N_NODES)])
    monkeypatch.setattr(JSB, "_build_medium", lambda: (jg, jc))
    monkeypatch.setattr(PSB, "build_medium", lambda: (pg, pc))
    jrep = JSB.run_search_bench(budget=budget, seed=0)
    prep = PSB.run_search_bench(budget=budget, seed=0)
    return jrep, prep


def test_search_bench_equals_jax_at_a_reduced_budget(monkeypatch):
    jrep, prep = _bench_pair(monkeypatch, budget=40)
    walls = ("sched_wall_s", "search_wall_s")
    for key, want in jrep.items():
        if key in ("platform", "search_wall_s", "search_stats"):
            continue
        got = prep[key]
        if key == "hand":
            got = {n: {k: v for k, v in d.items() if k not in walls}
                   for n, d in got.items()}
            want = {n: {k: v for k, v in d.items() if k not in walls}
                    for n, d in want.items()}
        if key == "ici":
            got = {n: {k: v for k, v in d.items() if k not in walls}
                   for n, d in got.items()}
            want = {n: {k: v for k, v in d.items() if k not in walls}
                    for n, d in want.items()}
        assert got == want, key
    assert set(prep) == set(jrep)
    assert prep["search_stats"]["static_filter"] == "on"
    assert {k: v for k, v in prep["search_stats"].items()
            if k != "static_filter"} == jrep["search_stats"]
    assert PSB.gate_failures(prep) == JSB.gate_failures(jrep)
    assert prep["platform"] == "cpu" and prep["n_devices"] == 8


def test_search_bench_cli_writes_the_report(tmp_path, monkeypatch):
    graph = _gpt2(P, n_layer=2)
    cluster = P.Cluster([P.DeviceState(f"core_{i}", 4.0) for i in range(8)])
    monkeypatch.setattr(PSB, "build_medium", lambda: (graph, cluster))
    out = tmp_path / "search.json"
    rc = PSB.main(["--budget", "12", "--out", str(out)])
    rep = json.loads(out.read_text())
    assert rc == (0 if rep["gates"]["passed"] else 1)
    assert rep["config"] == {"budget": 12, "seed": 0}
    assert rep["gates"]["failures"] == PSB.gate_failures(rep)


@pytest.mark.slow
def test_search_bench_reproduces_search_r15():
    """The port's search bench at its defaults (budget 800, seed 0) gives
    ``SEARCH_r15.json``'s ``search.*`` values and placement digest
    exactly; several minutes of host time."""
    want = json.loads((ROOT / "SEARCH_r15.json").read_text())
    got = PSB.run_search_bench()
    for key, value in want.items():
        if key.startswith("search."):
            assert got[key] == value, key
    assert got["best_hand"] == want["best_hand"]
    assert PSB.gate_failures(got) == []
