"""The port's native C++ engine (``native/``, ``sched/native.py``) against
the JAX package's native engine and the port's Python policies.

The engine source is the JAX package's, byte for byte; the port builds it
into its own ``native/_build/``.  On the JAX package's own cases
(``tests/test_native.py``: synthetic regimes, the GPT-2 DAG, failures,
pipeline repack ties, out bytes, the refine fuzz seeds, misaligned node
ids) every schedule must be equal to the JAX engine's and to the port's
Python twin: per-node lists, assignment order, completed and failed sets.
Graphs cross between the packages through the JSON serialization, so the
two engines see the same tasks.
"""

from __future__ import annotations

import random

import pytest

from distributed_llm_scheduler_tpu.core.cluster import Cluster as JCluster
from distributed_llm_scheduler_tpu.core.cluster import DeviceState as JDevice
from distributed_llm_scheduler_tpu.core.cluster import (
    estimate_cluster_memory_needed,
)
from distributed_llm_scheduler_tpu.frontend import generators as JG
from distributed_llm_scheduler_tpu.sched.native import (
    NativeScheduler as JNative,
)
from distributed_llm_scheduler_tpu.utils.serialization import graph_to_dict
from distributed_llm_scheduler_tpu_torch import native as native_mod
from distributed_llm_scheduler_tpu_torch.core.cluster import Cluster
from distributed_llm_scheduler_tpu_torch.core.cluster import DeviceState
from distributed_llm_scheduler_tpu_torch.sched.native import NativeScheduler
from distributed_llm_scheduler_tpu_torch.sched.policies import (
    ALL_SCHEDULERS,
    get_scheduler,
)
from distributed_llm_scheduler_tpu_torch.utils.serialization import (
    graph_from_dict,
)
from test_pipeline_rebalance import flagship_shaped_graph

NATIVE_POLICIES = sorted(native_mod.POLICY_IDS)


def port_graph(jgraph):
    """The port's copy of a JAX-package graph (schedule-only fields)."""
    g = graph_from_dict(graph_to_dict(jgraph))
    for t in jgraph:
        g[t.task_id].out_bytes = t.out_bytes
    return g


def make_graphs():
    return [
        JG.generate_llm_dag(num_layers=4, num_heads=4, seed=7),
        JG.generate_llm_dag(num_layers=8, num_heads=2, seed=11),
        JG.generate_random_dag(num_tasks=60, seed=7),
        JG.generate_pipeline_dag(num_stages=5, tasks_per_stage=4, seed=7),
    ]


def fields(s):
    return (s.per_node, s.assignment_order, s.completed, s.failed)


def assert_three_equal(policy, jgraph, make_cluster, label):
    """The port's engine == the JAX engine == the port's Python policy."""
    jgraph.freeze()
    pgraph = port_graph(jgraph)
    j_cluster, p_cluster = make_cluster(JCluster, JDevice), make_cluster(
        Cluster, DeviceState)
    py = get_scheduler(policy).schedule(pgraph, p_cluster)
    nat = NativeScheduler(policy).schedule(pgraph, make_cluster(Cluster,
                                                                DeviceState))
    jnat = JNative(policy).schedule(jgraph, j_cluster)
    assert fields(nat) == fields(py), f"{label}: port engine != Python"
    assert fields(nat) == fields(jnat), f"{label}: port engine != JAX engine"
    assert nat.policy == jnat.policy == policy
    return nat


@pytest.mark.parametrize("policy", NATIVE_POLICIES)
@pytest.mark.parametrize("regime", [1.0, 0.8, 0.5])
def test_parity_synthetic(policy, regime):
    for graph in make_graphs():
        total = estimate_cluster_memory_needed(graph) * regime
        for n_nodes in (2, 4):
            assert_three_equal(
                policy, graph,
                lambda C, D: C.heterogeneous(total, n_nodes),
                f"{policy}/{graph.name}/n{n_nodes}/r{regime}",
            )


@pytest.mark.parametrize("policy", NATIVE_POLICIES)
def test_parity_gpt2(policy):
    from distributed_llm_scheduler_tpu.frontend.gpt2_dag import build_gpt2_dag
    from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config

    jgraph = build_gpt2_dag(GPT2Config.tiny(), batch=2, seq_len=64).graph
    assert_three_equal(policy, jgraph, lambda C, D: C.laptops(),
                       f"{policy}/gpt2")


def test_the_port_gpt2_dag_schedules_like_the_jax_one():
    """The port's own GPT-2 DAG (not a copy of the JAX graph) gets the
    same native schedule as the JAX DAG."""
    from distributed_llm_scheduler_tpu.frontend.gpt2_dag import (
        build_gpt2_dag as j_build,
    )
    from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config as JCfg
    from distributed_llm_scheduler_tpu_torch.frontend.gpt2_dag import (
        build_gpt2_dag as p_build,
    )
    from distributed_llm_scheduler_tpu_torch.models.gpt2 import GPT2Config

    jg = j_build(JCfg.tiny(), batch=2, seq_len=64).graph
    pg = p_build(GPT2Config.tiny(), batch=2, seq_len=64).graph
    for policy in ("heft", "mru", "pipeline"):
        nat = NativeScheduler(policy).schedule(pg, Cluster.laptops())
        jnat = JNative(policy).schedule(jg, JCluster.laptops())
        assert fields(nat) == fields(jnat), policy


def test_parity_under_failures():
    """A cluster too small for the DAG: failure handling must match too."""
    graph = JG.generate_llm_dag(num_layers=6, num_heads=4, seed=3)
    for policy in NATIVE_POLICIES:
        nat = assert_three_equal(policy, graph,
                                 lambda C, D: C.uniform(2, 1.0),
                                 f"{policy}/too-small")
        assert nat.failed, f"{policy}: fixture should trigger failures"


def test_parity_pipeline_repack_ties():
    graph = flagship_shaped_graph(n_layers=6, n_shards=2, mb=2)
    for policy in ("pipeline", "pack"):
        assert_three_equal(policy, graph, lambda C, D: C.uniform(4, 100.0),
                           f"{policy}/repack-ties")


def test_parity_with_out_bytes():
    graph = JG.generate_llm_dag(num_layers=6, num_heads=3, seed=5)
    for i, tid in enumerate(graph.task_ids()):
        graph[tid].out_bytes = (i % 7 + 1) * 1_000_000
    for policy in ("pipeline", "pack", "refine", "heft"):
        assert_three_equal(
            policy, graph,
            lambda C, D: C([D(f"core_{i}", 8.0) for i in range(4)]),
            f"{policy}+out_bytes",
        )


@pytest.mark.parametrize("seed", [3, 17, 29, 41, 53])
def test_refine_parity_fuzz(seed):
    r = random.Random(seed)
    graph = JG.generate_random_dag(num_tasks=40 + seed, seed=seed)
    spec = [(f"n{i}", 3.0 + 2.0 * r.random(), 0.7 + 0.6 * r.random())
            for i in range(r.randrange(2, 6))]
    assert_three_equal(
        "refine", graph,
        lambda C, D: C([D(n, m, compute_speed=s) for n, m, s in spec]),
        f"refine fuzz seed={seed}",
    )


def test_refine_parity_misaligned_node_ids():
    from distributed_llm_scheduler_tpu import Task, TaskGraph

    graph = TaskGraph([
        Task(
            f"t{i:02d}", 0.1, 0.5,
            params_needed={f"w{i:02d}"}, param_bytes={f"w{i:02d}": 2 << 28},
        )
        for i in range(12)
    ])
    assert_three_equal(
        "refine", graph,
        lambda C, D: C([D("n2", 4.0), D("n10", 4.0), D("n1", 4.0)]),
        "refine misaligned node ids",
    )


def test_get_scheduler_native_prefix_and_env_upgrade(monkeypatch):
    s = get_scheduler("native:mru")
    assert isinstance(s, NativeScheduler) and s.name == "native:mru"
    monkeypatch.setenv("DLS_NATIVE", "1")
    for policy in NATIVE_POLICIES:
        assert isinstance(get_scheduler(policy), NativeScheduler)
    # search has no native twin: the Python policy, as in the JAX package
    assert type(get_scheduler("search")) is ALL_SCHEDULERS["search"]
    from distributed_llm_scheduler_tpu_torch.backends.sim import (
        TieredLinkModel,
    )

    # a tiered link keeps the Python policy under the upgrade; an explicit
    # native: request with one raises
    assert type(get_scheduler("heft", link=TieredLinkModel())) is \
        ALL_SCHEDULERS["heft"]
    with pytest.raises(ValueError, match="flat LinkModel only"):
        get_scheduler("native:heft", link=TieredLinkModel())


def test_native_rejects_unknown_policy():
    with pytest.raises(ValueError, match="no native implementation"):
        NativeScheduler("no-such-policy")
    with pytest.raises(ValueError, match="no native implementation"):
        get_scheduler("native:search")


def test_the_engine_source_is_the_jax_package_one():
    from pathlib import Path

    import distributed_llm_scheduler_tpu.native as jn

    port = Path(native_mod.__file__).with_name("engine.cpp").read_bytes()
    assert port == Path(jn.__file__).with_name("engine.cpp").read_bytes()
    assert native_mod._BUILD_DIR.parent == Path(native_mod.__file__).parent


@pytest.fixture
def broken_build(monkeypatch, tmp_path):
    """A fresh loader whose compiler does not exist."""
    monkeypatch.setattr(native_mod, "_engine", None)
    monkeypatch.setattr(native_mod, "_load_error", None)
    monkeypatch.setattr(native_mod, "_transient_attempts", 0)
    monkeypatch.setattr(native_mod, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_mod, "_so_path",
                        lambda: tmp_path / "engine_missing.so")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))


def test_transient_build_failures_retry_then_stick(broken_build):
    """The JAX package's retry rule: an OS-level failure is retried on
    later calls, up to ``_MAX_TRANSIENT_ATTEMPTS``, then kept."""
    for _ in range(native_mod._MAX_TRANSIENT_ATTEMPTS):
        assert native_mod.load_error() is None
        with pytest.raises(RuntimeError):
            native_mod.load_engine()
    assert "native engine build failed" in native_mod.load_error()
    with pytest.raises(RuntimeError, match="native engine build failed"):
        native_mod.load_engine()
