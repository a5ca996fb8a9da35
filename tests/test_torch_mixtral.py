"""The port's Mixtral MoE forward and expert DAG against the JAX package's,
on the CPU.

The counterparts of ``tests/test_mixtral.py`` and the forward cases of
``tests/test_moe_routed.py``.  Weights come from the JAX initializer and
cross the bridge; activations and ids from numpy seeds.  The routing
metadata (``flat_e``, ``pos``, ``keep``) and every structure field must be
equal; the gates at 1e-6 (f32 roundoff of one softmax); the dense and
routed DAG outputs against the JAX forward at 2e-4 (the repo's
placed-vs-fused tolerance); routed against dense and DAG against its own
oracle at the JAX tests' 2e-5.  Placements carry no tensor arithmetic and
must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu.frontend.gpt2_dag import (
    execute_dag_locally as jax_exec,
)
from distributed_llm_scheduler_tpu.frontend.moe_dag import build_moe_dag as jax_build
from distributed_llm_scheduler_tpu.models import mixtral as jm
from distributed_llm_scheduler_tpu_torch.core.graph import is_batch0
from distributed_llm_scheduler_tpu_torch.frontend.gpt2_dag import execute_dag_locally
from distributed_llm_scheduler_tpu_torch.frontend.moe_dag import build_moe_dag
from distributed_llm_scheduler_tpu_torch.models import mixtral as tm

CPU = torch.device("cpu")
TOL = 2e-4   # DAG / forward against the JAX forward
EXACT = 2e-5  # the JAX tests' routed-vs-dense and DAG-vs-oracle tolerance


def graph_fields(g):
    return g.name, [
        (t.task_id, t.dependencies, t.arg_tasks, sorted(t.params_needed),
         sorted(t.param_bytes.items()), t.memory_required, t.compute_time,
         t.flops, t.group, sorted((t.param_alias or {}).items()))
        for t in g
    ]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def weights():
    """JAX tiny weights and their bridge, and numpy ids (2, 16) and (4, 16)."""
    jcfg, tcfg = jm.MixtralConfig.tiny(), tm.MixtralConfig.tiny()
    jparams = jax_build(jcfg, batch=2, seq_len=16).init_params()
    tparams = P.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, CPU)
    rng = np.random.default_rng(7)
    ids2 = rng.integers(0, 512, (2, 16), dtype=np.int32)
    ids4 = rng.integers(0, 512, (4, 16), dtype=np.int32)
    return jcfg, tcfg, jparams, tparams, ids2, ids4


def _block(params, cfg, layer=0):
    return {k: params[f"l{layer}_{k}"] for k in tm._layer_keys(cfg)}


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# -- the model ------------------------------------------------------------------

def test_param_counts_equal_jax():
    big_j, big_t = jm.MixtralConfig.mixtral_8x7b(), tm.MixtralConfig.mixtral_8x7b()
    assert tm.num_params(big_t) == jm.num_params(big_j) == 46_702_792_704
    assert tm.num_active_params(big_t) == jm.num_active_params(big_j)
    assert abs(tm.num_active_params(big_t) - 12.9e9) < 0.5e9
    js, ts = jm.param_shapes(jm.MixtralConfig.tiny()), tm.param_shapes(
        tm.MixtralConfig.tiny())
    assert sorted(ts) == sorted(js)
    assert all(tuple(ts[k][0]) == tuple(v[0]) for k, v in js.items())


def test_init_scales():
    cfg = tm.MixtralConfig.tiny()
    p = tm.init_params_numpy(cfg, seed=0)
    assert (p["l0_attn_norm_g"] == 1).all()
    assert abs(p["l0_router"].std() - 0.02) < 0.005
    assert abs(p["l0_e0_w_down"].std() - 0.01) < 0.003  # 0.02 / sqrt(4)
    t = tm.init_params_torch(cfg, seed=0, device=CPU)
    assert set(t) == set(p) and t["lm_head"].shape == p["lm_head"].shape


def test_router_weights_equal_jax(weights):
    jcfg, tcfg, *_ = weights
    x, w = _x(0, (2, 8, 64)), 0.1 * _x(1, (64, 4))
    want = np.asarray(jm.router_weights(jnp.asarray(x), jnp.asarray(w), 2))
    got = tm.router_weights(torch.from_numpy(x), torch.from_numpy(w), 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert ((got > 0).sum(-1) == 2).all()
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("cf", [0.5, 0.75, 2.0])
def test_route_topk_metadata_equal_jax(cf):
    """flat_e, pos and keep equal to the JAX values, drops included."""
    N, D, E, k = 32, 64, 4, 2
    xf, w = _x(2, (N, D)), 0.1 * _x(3, (D, E))
    C = tm.moe_capacity(N, E, k, cf)
    assert C == jm.moe_capacity(N, E, k, cf)
    want = jm.route_topk(jnp.asarray(xf), jnp.asarray(w), k, C, jnp.float32)
    got = tm.route_topk(torch.from_numpy(xf), torch.from_numpy(w), k, C,
                        torch.float32)
    for key in ("flat_e", "pos", "keep"):
        assert np.array_equal(_np(got[key]), np.asarray(want[key])), key
    np.testing.assert_allclose(_np(got["top_w"]), np.asarray(want["top_w"]),
                               rtol=1e-5, atol=1e-6)
    if cf < 1:
        assert not _np(got["keep"]).all()  # something dropped


def test_ties_break_to_the_lower_expert():
    """Equal logits: the lower expert index first, as jax.lax.top_k.  The
    tied experts come in both orders across the two columns' layouts."""
    xf = np.ones((6, 8), np.float32)
    w = np.zeros((8, 4), np.float32)
    w[:, 1] = w[:, 3] = 0.5  # experts 1 and 3 tie above 0 and 2
    w[:, 2] = 0.25
    want = jm.route_topk(jnp.asarray(xf), jnp.asarray(w), 2, 3, jnp.float32)
    got = tm.route_topk(torch.from_numpy(xf), torch.from_numpy(w), 2, 3,
                        torch.float32)
    assert _np(got["flat_e"]).tolist() == [1, 3] * 6
    for key in ("flat_e", "pos", "keep"):
        assert np.array_equal(_np(got[key]), np.asarray(want[key])), key


def test_routed_primitives_equal_jax():
    N, D, E, k = 32, 64, 4, 2
    xf, w, ob = _x(4, (N, D)), 0.1 * _x(5, (D, E)), _x(6, (E, 12, D))
    C = 12
    jr = jm.route_topk(jnp.asarray(xf), jnp.asarray(w), k, C, jnp.float32)
    tr = tm.route_topk(torch.from_numpy(xf), torch.from_numpy(w), k, C,
                       torch.float32)
    pairs = [
        (jm.routed_dispatch(jnp.asarray(xf), jr, E, C),
         tm.routed_dispatch(torch.from_numpy(xf), tr, E, C)),
        (jm.routed_expert_buffer(jnp.asarray(xf), jr, 2, C),
         tm.routed_expert_buffer(torch.from_numpy(xf), tr, 2, C)),
        (jm.routed_collect(jnp.asarray(ob), jr, N),
         tm.routed_collect(torch.from_numpy(ob), tr, N)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    js, ts = jm.route_stats(jr, C), tm.route_stats(tr, C)
    assert int(ts["dropped_slots"]) == int(js["dropped_slots"]) > 0
    assert ts["capacity"] == js["capacity"] and ts["total_slots"] == js["total_slots"]


@pytest.mark.parametrize("cf", [0.5, 2.0])
def test_moe_routed_equal_jax(weights, cf):
    jcfg, tcfg, jparams, tparams, *_ = weights
    x = _x(8, (2, 16, 64))
    want, wst = jm.moe_routed(_block(jparams, jcfg), jnp.asarray(x), jcfg,
                              capacity_factor=cf, with_stats=True)
    got, gst = tm.moe_routed(_block(tparams, tcfg), torch.from_numpy(x), tcfg,
                             capacity_factor=cf, with_stats=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert int(gst["dropped_slots"]) == int(wst["dropped_slots"])


def test_routed_at_full_capacity_equals_dense(weights):
    _, tcfg, _, tparams, ids2, _ = weights
    bp = _block(tparams, tcfg)
    x = torch.from_numpy(_x(9, (2, 16, 64)))
    routed, stats = tm.moe_routed(bp, x, tcfg, capacity_factor=2.0,
                                  with_stats=True)
    assert int(stats["dropped_slots"]) == 0
    torch.testing.assert_close(routed, tm._moe(bp, x, tcfg), rtol=EXACT, atol=EXACT)
    ids = torch.from_numpy(ids2)
    torch.testing.assert_close(
        tm.forward(tparams, ids, tcfg, routed=True, capacity_factor=2.0),
        tm.forward(tparams, ids, tcfg), rtol=EXACT, atol=EXACT)


def test_forward_equal_jax_and_causal(weights):
    jcfg, tcfg, jparams, tparams, ids2, _ = weights
    want = np.asarray(jm.forward(jparams, jnp.asarray(ids2), jcfg))
    got = tm.forward(tparams, torch.from_numpy(ids2), tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    ids = ids2.copy()
    ids[0, -1] = (ids[0, -1] + 1) % 512
    got2 = tm.forward(tparams, torch.from_numpy(ids), tcfg)
    torch.testing.assert_close(got2[0, :-1], got[0, :-1], rtol=1e-4, atol=1e-5)


# -- the DAG ----------------------------------------------------------------------

DAG_CASES = [
    dict(batch=2, seq_len=16),
    dict(batch=2, seq_len=16, routed=True, capacity_factor=0.75),
    dict(batch=4, seq_len=16, microbatches=2, vocab_shards=2),
    dict(batch=4, seq_len=16, microbatches=2, routed=True, capacity_factor=0.75),
]


@pytest.mark.parametrize("kw", DAG_CASES, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_dag_structure_and_output_equal_jax(weights, kw):
    """Structure equal field for field; the DAG's output (run task by
    task) against the JAX DAG's at 2e-4, and against the port's own
    oracle (per-microbatch when routed) at 2e-5."""
    jcfg, tcfg, _, tparams, ids2, ids4 = weights
    jdag, tdag = jax_build(jcfg, **kw), build_moe_dag(tcfg, **kw)
    assert graph_fields(tdag.graph) == graph_fields(jdag.graph)
    ids = ids4 if kw["batch"] == 4 else ids2
    tp = tdag.derive_params(tparams)  # with the vocab shards, if any
    jp = {n: jnp.asarray(_np(v)) for n, v in tp.items()}  # the same numbers
    want = np.asarray(jax_exec(jdag, jp, jnp.asarray(ids)))
    got = execute_dag_locally(tdag, tp, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    oracle = tdag.reference_forward(tp, torch.from_numpy(ids))
    torch.testing.assert_close(got, oracle, rtol=EXACT, atol=EXACT)


def test_full_width_dag_structure_and_name():
    """Mixtral-8x7B at full width, 4 layers, bf16, batch 1, seq 512: the
    63-task graph, equal to the JAX build (meta tensors, no weights)."""
    kw = dict(batch=1, seq_len=512)
    tg = build_moe_dag(tm.MixtralConfig.mixtral_8x7b(
        n_layers=4, dtype=torch.bfloat16), **kw).graph
    jg = jax_build(jm.MixtralConfig.mixtral_8x7b(
        n_layers=4, dtype=jnp.bfloat16), **kw).graph
    assert tg.name == "mixtral_4l_d4096_e8_b1_t512_bfloat16" and len(tg) == 63
    assert graph_fields(tg) == graph_fields(jg)


def test_routed_dag_drops_and_differs_from_dense_and_whole_batch(weights):
    _, tcfg, _, tparams, _, ids4 = weights
    dag = build_moe_dag(tcfg, batch=4, seq_len=16, microbatches=2, routed=True,
                        capacity_factor=0.75)
    ids = torch.from_numpy(ids4)
    got = execute_dag_locally(dag, tparams, ids)
    dense = tm.forward(tparams, ids, tcfg)
    whole = tm.forward(tparams, ids, tcfg, routed=True, capacity_factor=0.75)
    assert not torch.allclose(got, dense, rtol=EXACT, atol=EXACT)
    assert not torch.allclose(got, whole, rtol=EXACT, atol=EXACT)


def test_one_fn_per_expert_across_layers_and_microbatches(weights):
    tcfg = weights[1]
    g = build_moe_dag(tcfg, batch=4, seq_len=16, microbatches=2, routed=True,
                      capacity_factor=1.0).graph
    E, L = tcfg.n_experts, tcfg.n_layers
    for e in range(E):
        fns = {id(g[f"mb{m}_layer_{i}_expert_{e}"].fn)
               for m in range(2) for i in range(L)}
        assert len(fns) == 1
    assert len({id(g[f"mb0_layer_0_expert_{e}"].fn) for e in range(E)}) == E
    dense = build_moe_dag(tcfg, batch=4, seq_len=16, microbatches=2).graph
    assert is_batch0(dense["mb0_layer_0_expert_0"].fn)
    assert not is_batch0(g["mb0_layer_0_expert_0"].fn)
    # routed tasks carry ~top_k/E of the dense per-expert work
    assert g["mb0_layer_0_expert_0"].flops < 0.7 * (
        dense["mb0_layer_0_expert_0"].flops * E / tcfg.top_k)


# -- placement ---------------------------------------------------------------------

def _homes(s):
    return {n for n, tids in s.per_node.items() if any("expert" in t for t in tids)}


def test_expert_placement_under_hbm_limits(weights):
    """Per-node memory below the model: mru, greedy and heft complete with
    experts on at least two nodes, placing exactly as the JAX policies."""
    jcfg, tcfg, *_ = weights
    tg = build_moe_dag(tcfg, batch=2, seq_len=16).graph
    jg = jax_build(jcfg, batch=2, seq_len=16).graph
    total = tg.total_param_gb()
    for name in ("mru", "greedy", "heft"):
        ts = P.get_scheduler(name).schedule(
            tg, P.Cluster([P.DeviceState(f"d{i}", total * 0.45) for i in range(4)]))
        js = J.get_scheduler(name).schedule(
            jg, J.Cluster([J.DeviceState(f"d{i}", total * 0.45) for i in range(4)]))
        assert not ts.failed, name
        assert len(_homes(ts)) >= 2, name
        assert ts.per_node == js.per_node, name


def test_expert_locality_across_microbatches(weights):
    tcfg = weights[1]
    g = build_moe_dag(tcfg, batch=4, seq_len=16, microbatches=2).graph
    cluster = P.Cluster([P.DeviceState(f"d{i}", g.total_param_gb(), 1.0)
                         for i in range(4)])
    s = P.get_scheduler("greedy").schedule(g, cluster)
    assert not s.failed
    homes = {}
    for node, tids in s.per_node.items():
        for t in tids:
            if "expert" in t:
                homes.setdefault(t.split("_", 1)[1], set()).add(node)
    assert not {k: v for k, v in homes.items() if len(v) > 1}


def test_vocab_sharding_drops_the_full_tables(weights):
    tcfg = weights[1]
    g = build_moe_dag(tcfg, batch=2, seq_len=16, vocab_shards=2).graph
    assert "tok_emb" not in g.unique_params()
    assert {"tok_emb_shard_0", "lm_head_shard_1"} <= g.unique_params()


def test_config4_placement_at_full_width():
    """BASELINE.json config #4 as the JAX package's own test runs it: 8x7B
    at full width, 4 layers, bf16, 8 nodes at 0.3x the params each under
    mru (meta tensors, no weights): complete, valid, experts spread, and
    the placement equal to the JAX package's."""
    kw = dict(batch=2, seq_len=128)
    tg = build_moe_dag(tm.MixtralConfig.mixtral_8x7b(
        n_layers=4, dtype=torch.bfloat16), **kw).graph
    jg = jax_build(jm.MixtralConfig.mixtral_8x7b(
        n_layers=4, dtype=jnp.bfloat16), **kw).graph
    total = tg.total_param_gb()
    assert abs(total - 11.3) < 0.05  # 4 of 32 layers + both tables, bf16
    ts = P.get_scheduler("mru").schedule(tg, P.Cluster.uniform(8, total * 0.3))
    js = J.get_scheduler("mru").schedule(jg, J.Cluster.uniform(8, total * 0.3))
    assert not ts.failed and ts.per_node == js.per_node
    assert P.validate_schedule(tg, P.Cluster.uniform(8, total * 0.3), ts).ok
    assert len(_homes(ts)) >= 2


def test_routed_dag_placed_on_cpu_nodes(weights):
    """The routed, microbatched DAG through DeviceBackend on 4 CPU nodes,
    planned and compiled: bit-equal to its local execution."""
    _, tcfg, _, tparams, _, ids4 = weights
    dag = build_moe_dag(tcfg, batch=4, seq_len=16, microbatches=2, routed=True,
                        capacity_factor=0.75)
    ids = torch.from_numpy(ids4)
    local = execute_dag_locally(dag, tparams, ids)
    total = dag.graph.total_param_gb()
    cluster = P.Cluster.from_torch_devices([CPU] * 4, hbm_cap_gb=total * 0.45)
    s = P.get_scheduler("mru").schedule(dag.graph, cluster)
    assert not s.failed and len(_homes(s)) >= 2
    for kw in ({}, dict(compiled=True)):
        rep = P.DeviceBackend(cluster).execute(dag.graph, s, tparams, ids, **kw)
        assert torch.equal(rep.output, local), kw
