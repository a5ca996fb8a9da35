"""The port's GPT-2 training-step DAG against the JAX package's, on the CPU.

The port's versions of ``tests/test_train_dag.py`` at its scale (GPT-2
tiny, batch 2, seq 16, lr 1e-2), plus the backends it runs on.  Weights
come from the JAX initializer and cross the bridge; ids and targets come
from a numpy seed and go to both packages.  Structure carries no tensor
arithmetic, so names, dependencies, params, aliases, byte sizes, FLOPs
and groups must be equal.  A step: loss rtol 1e-5, params rtol 2e-4 and
atol 2e-5 (the JAX test's tolerances, DAG against its fused oracle).
Rungs of the device backend on CPU nodes against the port's own local
execution: bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
import distributed_llm_scheduler_tpu_torch.analysis  # noqa: F401
from distributed_llm_scheduler_tpu.frontend.train_dag import (
    build_gpt2_train_dag as jax_build,
)
from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config as JaxConfig
from distributed_llm_scheduler_tpu_torch.backends.dispatch_plan import DispatchPlan
from distributed_llm_scheduler_tpu_torch.frontend.gpt2_dag import execute_dag_locally
from distributed_llm_scheduler_tpu_torch.models import gpt2 as tgpt2
from distributed_llm_scheduler_tpu_torch.utils.hbm import preflight_task_memory

CPU = torch.device("cpu")
SHAPE = dict(batch=2, seq_len=16, lr=1e-2)


def graph_fields(g):
    return g.name, [
        (t.task_id, t.dependencies, t.arg_tasks, sorted(t.params_needed),
         sorted(t.param_bytes.items()), t.memory_required, t.compute_time,
         t.flops, t.group, sorted((t.param_alias or {}).items()))
        for t in g
    ]


@pytest.fixture(scope="module")
def pair():
    jdag = jax_build(JaxConfig.tiny(), **SHAPE)
    tdag = P.build_gpt2_train_dag(P.GPT2Config.tiny(), **SHAPE)
    jparams = jdag.init_params()
    tparams = P.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, CPU)
    rng = np.random.default_rng(5)
    np_in = {k: rng.integers(0, 512, (2, 16), dtype=np.int32)
             for k in ("ids", "targets")}
    tin = {k: torch.from_numpy(v) for k, v in np_in.items()}
    jin = {k: jnp.asarray(v) for k, v in np_in.items()}
    local = execute_dag_locally(tdag, tparams, tin)
    return dict(jdag=jdag, tdag=tdag, jparams=jparams, tparams=tparams,
                jin=jin, tin=tin, local=local)


def _step_close(got, want_loss, want_params):
    np.testing.assert_allclose(float(got["loss"]), float(want_loss), rtol=1e-5)
    assert set(got["params"]) == set(want_params)
    for k, w in want_params.items():
        np.testing.assert_allclose(
            got["params"][k].numpy(), np.asarray(w), rtol=2e-4, atol=2e-5,
            err_msg=k)


# -- structure ------------------------------------------------------------------

def test_structure_equal_to_jax(pair):
    g = pair["tdag"].graph
    L = pair["tdag"].config.n_layer
    assert len(g) == 3 * L + 7
    assert graph_fields(g) == graph_fields(pair["jdag"].graph)
    assert f"layer_{L - 1}_fwd" in g["head_bwd"].dependencies
    assert "layer_0_fwd" in g["layer_1_bwd"].dependencies
    assert g["layer_0_bwd"].params_needed == g["layer_0_fwd"].params_needed


def test_gpt2_small_structure_equal_to_jax():
    """config #5's own scale: 43 tasks, built on meta tensors only."""
    kw = dict(batch=8, seq_len=512)
    tg = P.build_gpt2_train_dag(P.GPT2Config.small(), **kw).graph
    jg = jax_build(JaxConfig.small(), **kw).graph
    assert len(tg) == 43 and tg.name == "gpt2_train_12l_d768_b8_t512"
    assert graph_fields(tg) == graph_fields(jg)


def test_make_inputs_takes_a_generator(pair):
    dag = pair["tdag"]
    a = dag.make_inputs(torch.Generator().manual_seed(3), device=CPU)
    b = dag.make_inputs(torch.Generator().manual_seed(3), device=CPU)
    assert set(a) == {"ids", "targets"}
    for k in a:
        assert a[k].dtype == torch.int32 and a[k].shape == (2, 16)
        assert torch.equal(a[k], b[k]) and int(a[k].max()) < 512
    assert not torch.equal(a["ids"], dag.make_inputs(device=CPU)["ids"])


# -- one step -------------------------------------------------------------------

def test_one_step_matches_jax_reference_step(pair):
    """The port's DAG step == the JAX fused value_and_grad + SGD."""
    want = jax.jit(pair["jdag"].reference_forward)(pair["jparams"], pair["jin"])
    _step_close(pair["local"], want["loss"], want["params"])
    assert not torch.equal(pair["local"]["params"]["wte"],
                           pair["tparams"]["wte"])


def test_port_reference_step_matches_jax(pair):
    want = jax.jit(pair["jdag"].reference_forward)(pair["jparams"], pair["jin"])
    got = pair["tdag"].reference_forward(pair["tparams"], pair["tin"])
    _step_close(got, want["loss"], want["params"])
    assert got["loss"].grad_fn is None


def test_dag_outputs_have_the_jax_keys(pair):
    """Every task's output: the same dict keys and shapes as the JAX
    DAG's (``loss``, ``grad_x``, ``grads``, the ``h{i}_`` names of the
    optimizer tasks, ``step_out``), from each builder's own shape run."""
    def keys(x):
        if isinstance(x, dict):
            return {k: keys(v) for k, v in x.items()}
        return tuple(x.shape), str(x.dtype).split(".")[-1]

    jg, tg = pair["jdag"].graph, pair["tdag"].graph
    for tid in tg.topo_order:
        assert keys(tg[tid].out_shape) == keys(jg[tid].out_shape), tid
    assert set(tg["step_out"].out_shape) == {"loss", "params"}
    assert set(tg["head_bwd"].out_shape) == {"loss", "grad_x", "grads"}


def test_loss_decreases_over_steps(pair):
    dag, tin = pair["tdag"], pair["tin"]
    out1 = pair["local"]
    out2 = execute_dag_locally(dag, out1["params"], tin)
    assert float(out2["loss"]) < float(out1["loss"])


@pytest.mark.parametrize("remat,scan", [(True, False), (False, True),
                                        (True, True)])
def test_loss_fn_remat_and_scan_equal_plain(pair, remat, scan):
    cfg = pair["tdag"].config
    ids, tg = pair["tin"]["ids"], pair["tin"]["targets"]

    def loss_and_grads(params, **kw):
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = tgpt2.loss_fn(p, ids, tg, cfg, **kw)
        return loss, dict(zip(p, torch.autograd.grad(loss, list(p.values()))))

    base, gbase = loss_and_grads(pair["tparams"])
    params = (tgpt2.stack_layer_params(pair["tparams"], cfg) if scan
              else pair["tparams"])
    loss, grads = loss_and_grads(params, remat=remat, scan=scan)
    torch.testing.assert_close(loss, base, rtol=1e-6, atol=0)
    if scan:
        stacked = tgpt2.stack_layer_params(gbase, cfg)
        assert set(grads) == set(stacked)
        gbase = stacked
    for k in gbase:
        torch.testing.assert_close(grads[k], gbase[k], rtol=1e-5, atol=1e-7)


def test_forward_stays_without_grad(pair):
    out = tgpt2.forward({k: v.requires_grad_() for k, v in
                         {k: v.clone() for k, v in pair["tparams"].items()}.items()},
                        pair["tin"]["ids"], pair["tdag"].config)
    assert out.grad_fn is None


# -- placement and execution --------------------------------------------------------

def test_every_policy_places_it(pair):
    g = pair["tdag"].graph
    cluster = P.Cluster([P.DeviceState(f"d{i}", 2.0) for i in range(4)])
    for name in sorted(P.ALL_SCHEDULERS):
        s = P.get_scheduler(name).schedule(g, cluster)
        assert not s.failed, (name, sorted(s.failed)[:3])


def test_placements_equal_to_jax(pair):
    tg, jg = pair["tdag"].graph, pair["jdag"].graph
    for name in ("roundrobin", "dfs", "greedy", "critical", "mru", "heft"):
        tc = P.Cluster([P.DeviceState(f"d{i}", 2.0) for i in range(4)])
        jc = J.Cluster([J.DeviceState(f"d{i}", 2.0) for i in range(4)])
        ts = P.get_scheduler(name).schedule(tg, tc)
        js = J.get_scheduler(name).schedule(jg, jc)
        assert ts.placement == js.placement and ts.per_node == js.per_node, name


def test_activation_memory_pressure_favors_mru(pair):
    g = pair["tdag"].graph
    need = g.total_param_gb()
    results = {}
    for name in ("mru", "critical", "roundrobin"):
        cluster = P.Cluster([P.DeviceState(f"d{i}", need * 0.42) for i in range(2)])
        s = P.get_scheduler(name).schedule(g, cluster)
        results[name] = len(s.completed) / len(g)
    assert results["mru"] >= max(results.values()) - 1e-9


RUNGS = [dict(planned=False), {}, dict(coalesce=True), dict(segments=True),
         dict(compiled=True)]


@pytest.mark.parametrize("policy", ["mru", "heft"])
@pytest.mark.parametrize("kw", RUNGS, ids=lambda kw: ",".join(kw) or "planned")
def test_executes_placed_on_four_nodes(pair, policy, kw):
    """The whole step through DeviceBackend on 4 CPU nodes, on every
    rung: it spreads, and the loss and every updated param equal local
    execution's bit for bit."""
    cluster = P.Cluster.from_torch_devices([CPU] * 4, hbm_cap_gb=2.0)
    s = P.get_scheduler(policy).schedule(pair["tdag"].graph, cluster)
    assert not s.failed and len(set(s.placement.values())) > 1
    rep = P.DeviceBackend(cluster).execute(
        pair["tdag"].graph, s, pair["tparams"], pair["tin"], **kw)
    assert rep.transfer_edges > 0
    local = pair["local"]
    assert torch.equal(rep.output["loss"], local["loss"])
    for k, v in local["params"].items():
        assert torch.equal(rep.output["params"][k], v), k


def test_planned_rung_keeps_forward_outputs_until_their_backward(pair):
    """The plan releases ``layer_{i}_fwd``'s value at ``layer_{i+1}_bwd``,
    its last reader, and no earlier."""
    g = pair["tdag"].graph
    cluster = P.Cluster.from_torch_devices([CPU] * 2, hbm_cap_gb=2.0)
    s = P.get_scheduler("mru").schedule(g, cluster)
    be = P.DeviceBackend(cluster)
    placed, _ = be.place_params(g, s, pair["tparams"])
    plan = DispatchPlan.build(be, g, s, be.dispatch_order(g, s), placed)
    released_at = {}
    for st in plan.steps:
        for slot in st.release:
            released_at[plan.tid_of_slot[slot]] = st.tids
    L = pair["tdag"].config.n_layer
    for i in range(L - 1):
        assert released_at[f"layer_{i}_fwd"] == (f"layer_{i + 1}_bwd",), i
    assert released_at["embedding_fwd"] == ("layer_0_bwd",)


def test_preflight_and_gate_on_meta(pair):
    """The pre-flight takes the dict input (on the CPU it sets each task's
    output bytes, which equal the builder's meta sizes) and ``analyze()``
    types every task on meta tensors with no error."""
    g = pair["tdag"].graph
    assert preflight_task_memory(g, pair["tparams"], pair["tin"]) == {}
    for t in g:
        assert t.out_bytes == round(t.memory_required * 1024**3), t.task_id
    cluster = P.Cluster.from_torch_devices([CPU] * 4, hbm_cap_gb=2.0)
    s = P.get_scheduler("heft").schedule(g, cluster)
    rep = P.analysis.analyze(g, cluster, s, params=pair["tdag"].param_specs,
                             graph_input=pair["tdag"].input_spec)
    assert rep.ok, rep.summary()
