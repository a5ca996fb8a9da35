"""The PyTorch port's framework-free core against the JAX package.

Graph structure, chain fusion, placements and simulated replays carry no
floating-point tensors, so the contract is equality: the port's GPT-2 DAG
(built by running task fns on meta tensors) must equal the JAX builder's
(built with ``jax.eval_shape``) field for field, and every ported policy
must place both packages' graphs identically.
"""

import jax.numpy as jnp
import pytest
import torch

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu.frontend.gpt2_dag import (
    build_gpt2_dag as jax_build,
)
from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config as JaxConfig
from distributed_llm_scheduler_tpu_torch.frontend.gpt2_dag import (
    build_gpt2_dag as torch_build,
)
from distributed_llm_scheduler_tpu_torch.models.gpt2 import (
    GPT2Config as TorchConfig,
)

POLICIES = sorted(P.ALL_SCHEDULERS)
_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def graph_fields(g):
    """Everything a policy, a replay or the device backend reads."""
    return g.name, [
        (
            t.task_id, t.dependencies, t.arg_tasks, sorted(t.params_needed),
            sorted(t.param_bytes.items()), t.memory_required, t.compute_time,
            t.flops, t.group, sorted((t.param_alias or {}).items()),
        )
        for t in g
    ]


def build_pair(mb=1, vs=1, dtype="float32", batch=2, seq=16):
    jd, td = _DTYPES[dtype]
    j = jax_build(JaxConfig.tiny(dtype=jd), batch=batch, seq_len=seq,
                  microbatches=mb, vocab_shards=vs)
    t = torch_build(TorchConfig.tiny(dtype=td), batch=batch, seq_len=seq,
                    microbatches=mb, vocab_shards=vs)
    return j, t


@pytest.mark.parametrize(
    "mb,vs,dtype",
    [(1, 1, "float32"), (2, 1, "float32"), (1, 4, "float32"),
     (2, 4, "float32"), (2, 4, "bfloat16")],
)
def test_gpt2_dag_equals_jax_builder(mb, vs, dtype):
    j, t = build_pair(mb, vs, dtype)
    assert graph_fields(t.graph) == graph_fields(j.graph)
    assert sorted(t.param_specs) == sorted(j.param_specs)
    for name, spec in j.param_specs.items():
        assert tuple(t.param_specs[name].shape) == tuple(spec.shape), name
    # the output spec of every task: shape and byte width agree
    for jt in j.graph:
        tt = t.graph[jt.task_id]
        assert tuple(tt.out_shape.shape) == tuple(jt.out_shape.shape)
        assert tt.out_shape.element_size() == jt.out_shape.dtype.itemsize


@pytest.mark.parametrize("mb,vs", [(1, 1), (2, 4)])
def test_fused_dag_equals_jax(mb, vs):
    j, t = build_pair(mb, vs)
    jf, tf = J.fuse_linear_chains(j.graph), P.fuse_linear_chains(t.graph)
    assert graph_fields(tf) == graph_fields(jf)
    assert len(tf) < len(t.graph)


def _diamond(pkg):
    """The reference's 4-task diamond (tests/conftest.py), in ``pkg``."""
    return pkg.TaskGraph(
        [
            pkg.Task("t1", 1.0, 2.0, [], {"p1"}),
            pkg.Task("t2", 1.5, 3.0, ["t1"], {"p2"}),
            pkg.Task("t3", 0.8, 1.5, ["t1"], {"p1", "p3"}),
            pkg.Task("t4", 1.2, 2.5, ["t2", "t3"], {"p2", "p3"}),
        ],
        name="diamond",
    ).freeze()


_CLUSTERS = {
    # reference provisioning profile: 35/25/25/15 split, mixed speeds
    "hetero": lambda pkg, gb: pkg.Cluster.heterogeneous(gb, 4),
    "uniform": lambda pkg, gb: pkg.Cluster.uniform(4, gb / 4),
}


def _graphs(kind):
    """(jax graph, port graph, cluster GB) for a placement fixture."""
    if kind == "diamond":
        return _diamond(J), _diamond(P), 4.0
    j, t = build_pair(mb=2, vs=4)
    # tight enough that the GPT-2 placements must spread weights
    gb = 2.5 * j.graph.total_param_gb()
    if kind == "gpt2_fused":
        return J.fuse_linear_chains(j.graph), P.fuse_linear_chains(t.graph), gb
    return j.graph, t.graph, gb


def test_registry_holds_the_ported_policies():
    assert POLICIES == ["critical", "dfs", "greedy", "heft", "mru", "pack",
                        "pipeline", "refine", "roundrobin", "search"]
    assert POLICIES == sorted(J.ALL_SCHEDULERS)


@pytest.mark.parametrize("cluster", sorted(_CLUSTERS))
@pytest.mark.parametrize("kind", ["diamond", "gpt2", "gpt2_fused"])
def test_placements_equal_jax(kind, cluster):
    jg, tg, gb = _graphs(kind)
    for name in POLICIES:
        js = J.get_scheduler(name).schedule(jg, _CLUSTERS[cluster](J, gb))
        ts = P.get_scheduler(name).schedule(tg, _CLUSTERS[cluster](P, gb))
        assert ts.per_node == js.per_node, name
        assert ts.assignment_order == js.assignment_order, name
        assert ts.completed == js.completed and ts.failed == js.failed, name


@pytest.mark.parametrize("fidelity", ["full", "reference"])
def test_simulated_backend_reports_equal_jax(fidelity):
    jg, tg, gb = _graphs("gpt2_fused")
    for name in POLICIES:
        jc, tc = _CLUSTERS["hetero"](J, gb), _CLUSTERS["hetero"](P, gb)
        js = J.get_scheduler(name).schedule(jg, jc)
        ts = P.get_scheduler(name).schedule(tg, tc)
        jr = J.SimulatedBackend(fidelity=fidelity, pre_analysis=False).execute(
            jg, jc, js, dag_type="gpt2"
        )
        tr = P.SimulatedBackend(fidelity=fidelity).execute(
            tg, tc, ts, dag_type="gpt2"
        )
        jrow, trow = jr.to_row(), tr.to_row()
        # host wall time of the scheduling call is the one unshared field
        jrow.pop("execution_time")
        trow.pop("execution_time")
        assert trow == jrow, name
        assert tr.node_utilization == jr.node_utilization, name
        assert {k: (v.node_id, v.start, v.finish) for k, v in tr.timings.items()} == {
            k: (v.node_id, v.start, v.finish) for k, v in jr.timings.items()
        }, name


def test_from_torch_devices_binds_cpu_nodes():
    c = P.Cluster.from_torch_devices([torch.device("cpu")] * 4)
    assert c.ids() == ["core_0", "core_1", "core_2", "core_3"]
    assert all(d.total_memory == 16.0 for d in c)
    assert all(d.torch_device == torch.device("cpu") for d in c)
    capped = P.Cluster.from_torch_devices(["cpu"], hbm_cap_gb=2.0)
    assert capped.devices[0].total_memory == 2.0


def test_from_torch_devices_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.Cluster.from_torch_devices()
