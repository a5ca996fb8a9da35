"""The port's Llama-3 forward, DAG and pipeline-stage policy against the JAX
package, on the CPU.

Float outputs: the ops at the JAX package's own tolerances
(``tests/test_llama.py``: GQA at 1e-5, a DAG against the fused forward at
2e-4; RoPE tables at 1e-6, f32 roundoff of the same formula); the fused
forward on bridged weights at rtol = atol = 2e-4, the repo's placed-vs-
fused tolerance (``__graft_entry__.py:333``).  Structure, placements,
per-node orders and simulated times carry no tensor arithmetic, so they
must be equal.  Weights come from the JAX initializer and cross the
bridge, or from one numpy seed fed to both packages; inputs from numpy
seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu.frontend.llama_dag import (
    build_llama_dag as jax_build,
)
from distributed_llm_scheduler_tpu.models import llama as jllama
from distributed_llm_scheduler_tpu.sched import eventsim as jsim
from distributed_llm_scheduler_tpu_torch.frontend.llama_dag import (
    build_llama_dag as torch_build,
)
from distributed_llm_scheduler_tpu_torch.models import llama as tllama
from distributed_llm_scheduler_tpu_torch.sched import eventsim as tsim

CPU = torch.device("cpu")
RTOL = ATOL = 2e-4


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


def _configs(dtype="float32", **kw):
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jllama.LlamaConfig.tiny(dtype=jd, **kw), tllama.LlamaConfig.tiny(
        dtype=td, **kw)


def _pair(jcfg, tcfg, **kw):
    return jax_build(jcfg, **kw), torch_build(tcfg, **kw)


def _bridge(jparams):
    return P.params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, CPU)


@pytest.fixture(scope="module")
def tiny_mb():
    """Tiny f32 Llama, batch 4 x seq 16, 2 microbatches, 3 vocab shards,
    with the JAX package's weights bridged to the port."""
    kw = dict(batch=4, seq_len=16, microbatches=2, vocab_shards=3)
    jdag, tdag = _pair(*_configs(), **kw)
    jparams = jdag.init_params()
    ids = np.random.default_rng(11).integers(0, 512, (4, 16), dtype=np.int32)
    return jdag, tdag, jparams, _bridge(jparams), ids


@pytest.fixture(scope="module")
def llama8b_fused():
    """The flagship build of both packages, Llama-3 8B bf16, batch 8, seq
    512, 8 microbatches, 8 vocab shards, linear chains fused (no weights)."""
    kw = dict(batch=8, seq_len=512, microbatches=8, vocab_shards=8)
    jdag = jax_build(jllama.LlamaConfig.llama3_8b(dtype=jnp.bfloat16), **kw)
    tdag = torch_build(tllama.LlamaConfig.llama3_8b(dtype=torch.bfloat16), **kw)
    return J.fuse_linear_chains(jdag.graph), P.fuse_linear_chains(tdag.graph)


# -- the model ------------------------------------------------------------------

def test_num_params_equal_jax():
    n = tllama.num_params(tllama.LlamaConfig.llama3_8b())
    assert n == jllama.num_params(jllama.LlamaConfig.llama3_8b()) == 8_030_261_248
    jshapes = jllama.param_shapes(jllama.LlamaConfig.tiny())
    tshapes = tllama.param_shapes(tllama.LlamaConfig.tiny())
    assert sorted(tshapes) == sorted(jshapes)
    assert all(tuple(tshapes[k][0]) == tuple(v[0]) for k, v in jshapes.items())


@pytest.mark.parametrize("T,hd,theta", [(16, 32, 1e4), (512, 128, 5e5)])
def test_rope_matches_jax(T, hd, theta):
    jc, js = jllama.rope_tables(T, hd, theta)
    tc, ts = tllama.rope_tables(T, hd, theta, device="cpu")
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    x = np.random.default_rng(T).standard_normal((1, 2, T, hd)).astype(np.float32)
    want = np.asarray(jllama.apply_rope(jnp.asarray(x), jc, js))
    got = tllama.apply_rope(torch.from_numpy(x), tc, ts).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_kv", [2, 4])
def test_gqa_attention_matches_jax(n_kv):
    jcfg, tcfg = _configs(n_kv_heads=n_kv)
    D, nh, hd = tcfg.d_model, tcfg.n_heads, tcfg.head_dim
    rng = np.random.default_rng(n_kv)
    x = rng.standard_normal((2, 8, D)).astype(np.float32)
    ws = [(0.02 * rng.standard_normal(s)).astype(np.float32)
          for s in ((D, nh * hd), (D, n_kv * hd), (D, n_kv * hd), (nh * hd, D))]
    want = np.asarray(jllama.gqa_attention(
        jnp.asarray(x), *map(jnp.asarray, ws), nh, n_kv, jcfg.rope_theta))
    got = tllama.gqa_attention(
        torch.from_numpy(x), *map(torch.from_numpy, ws), nh, n_kv,
        tcfg.rope_theta).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_forward_matches_jax_on_bridged_weights(tiny_mb):
    jdag, tdag, jparams, tparams, ids = tiny_mb
    want = np.asarray(jllama.forward(jparams, jnp.asarray(ids), jdag.config))
    got = tllama.forward(tparams, torch.from_numpy(ids), tdag.config).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_numpy_init_feeds_both_packages():
    jcfg, tcfg = _configs()
    np_params = tllama.init_params_numpy(tcfg, seed=5)
    assert sorted(np_params) == sorted(jllama.param_shapes(jcfg))
    assert np_params["l1_wo"].std() < np_params["l1_wq"].std() / 1.5
    assert np.all(np_params["final_norm_g"] == 1.0)
    ids = np.random.default_rng(1).integers(0, 512, (2, 16), dtype=np.int32)
    want = np.asarray(jllama.forward(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(ids), jcfg))
    got = tllama.forward(P.params_from_numpy(np_params, CPU),
                         torch.from_numpy(ids), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_torch_init_draws_at_the_numpy_scales():
    cfg = tllama.LlamaConfig.tiny(n_layers=4, dtype=torch.bfloat16)
    p = tllama.init_params_torch(cfg, seed=3, device=CPU)
    assert list(p) == list(tllama.param_shapes(cfg))
    assert all(t.dtype == torch.bfloat16 for t in p.values())
    assert torch.equal(p["l0_attn_norm_g"], torch.ones(cfg.d_model, dtype=torch.bfloat16))
    std = {k: p[k].float().std().item() for k in ("tok_emb", "l2_w_up", "l2_w_down")}
    assert abs(std["tok_emb"] - 0.02) < 1e-3 and abs(std["l2_w_up"] - 0.02) < 1e-3
    assert abs(std["l2_w_down"] - 0.02 / np.sqrt(8)) < 5e-4
    again = tllama.init_params_torch(cfg, seed=3, device=CPU)
    assert all(torch.equal(p[k], again[k]) for k in p)


# -- the DAG --------------------------------------------------------------------

@pytest.mark.parametrize(
    "dtype,kw",
    [("float32", dict(batch=2, seq_len=16)),
     ("float32", dict(batch=4, seq_len=16, microbatches=2, vocab_shards=3)),
     ("bfloat16", dict(batch=4, seq_len=16, microbatches=2, vocab_shards=3))],
)
def test_llama_dag_equals_jax_builder(dtype, kw):
    jdag, tdag = _pair(*_configs(dtype), **kw)
    assert graph_fields(tdag.graph) == graph_fields(jdag.graph)
    assert sorted(tdag.param_specs) == sorted(jdag.param_specs)
    for jt in jdag.graph:
        tt = tdag.graph[jt.task_id]
        assert tuple(tt.out_shape.shape) == tuple(jt.out_shape.shape)
        assert tt.out_shape.element_size() == jt.out_shape.dtype.itemsize
    jf, tf = J.fuse_linear_chains(jdag.graph), P.fuse_linear_chains(tdag.graph)
    assert graph_fields(tf) == graph_fields(jf)


def test_llama3_8b_dag_equals_jax_builder():
    """Full width and depth, batch 1 x seq 512: 291 tasks, no weights."""
    kw = dict(batch=1, seq_len=512)
    jdag = jax_build(jllama.LlamaConfig.llama3_8b(dtype=jnp.bfloat16), **kw)
    tdag = torch_build(tllama.LlamaConfig.llama3_8b(dtype=torch.bfloat16), **kw)
    assert len(tdag.graph) == 291
    assert graph_fields(tdag.graph) == graph_fields(jdag.graph)
    assert tdag.graph.total_param_gb() == jdag.graph.total_param_gb()


def test_flagship_build_equals_jax(llama8b_fused):
    jg, tg = llama8b_fused
    assert len(tg) == 1945
    assert graph_fields(tg) == graph_fields(jg)


def test_vocab_shards_are_contiguous_and_exact(tiny_mb):
    _, tdag, _, tparams, ids = tiny_mb
    full = tdag.derive_params(tparams)
    for k in range(3):
        assert full[f"lm_head_shard_{k}"].is_contiguous()
        assert full[f"tok_emb_shard_{k}"].is_contiguous()
    assert "tok_emb" not in tdag.graph.unique_params()
    init = tdag.init_params(seed=4, device=CPU)
    assert set(init) == set(tdag.param_specs)
    assert all(init[k].is_contiguous() for k in init)


@pytest.mark.parametrize("policy", ["pipeline", "greedy", "heft"])
def test_placed_dag_matches_fused_forward(tiny_mb, policy):
    _, tdag, _, tparams, ids = tiny_mb
    params = tdag.derive_params(tparams)
    graph = P.fuse_linear_chains(tdag.graph)
    cluster = P.Cluster.from_torch_devices([CPU] * 4)
    sched = P.get_scheduler(policy).schedule(graph, cluster)
    assert not sched.failed and len(sched.completed) == len(graph)
    rep = P.DeviceBackend(cluster).execute(
        graph, sched, params, torch.from_numpy(ids), reps=1)
    fused = tdag.reference_forward(tparams, torch.from_numpy(ids))
    np.testing.assert_allclose(rep.output.numpy(), fused.numpy(),
                               rtol=RTOL, atol=ATOL)


# -- the pipeline policy and the event simulation -----------------------------------

def _clusters(kind, graph_gb):
    """test_llama.py's clusters, built in package ``pkg``."""
    return {
        "4x4": lambda pkg: pkg.Cluster([pkg.DeviceState(f"d{i}", 4.0) for i in range(4)]),
        "4xhalf": lambda pkg: pkg.Cluster(
            [pkg.DeviceState(f"d{i}", graph_gb * 0.55) for i in range(4)]),
        "tiny": lambda pkg: pkg.Cluster([pkg.DeviceState("d0", 0.001)]),
        "8x9.5": lambda pkg: pkg.Cluster.uniform(8, 9.5),
    }[kind]


def _assert_same_pipeline(jg, tg, kind):
    mk = _clusters(kind, jg.total_param_gb())
    jc, tc = mk(J), mk(P)
    js = J.get_scheduler("pipeline").schedule(jg, jc)
    ts = P.get_scheduler("pipeline").schedule(tg, tc)
    assert ts.per_node == js.per_node
    assert ts.assignment_order == js.assignment_order
    assert ts.completed == js.completed and ts.failed == js.failed
    # the event simulation on this placement: order, makespan, node
    # finishes and per-task times
    placement = js.placement
    speeds = {d.node_id: d.compute_speed for d in jc}
    link_j, link_t = J.LinkModel(), P.LinkModel()
    assert (tsim.dependency_aware_order(tg, placement, speeds, link_t)
            == jsim.dependency_aware_order(jg, placement, speeds, link_j))
    assert (tsim.simulate_placement(tg, placement, speeds, link_t)
            == jsim.simulate_placement(jg, placement, speeds, link_j))
    jt = jsim.simulate_placement_timeline(jg, placement, speeds, link_j)
    tt = tsim.simulate_placement_timeline(tg, placement, speeds, link_t)
    assert (tt.start_at, tt.finish) == (jt.start_at, jt.finish)
    return ts


@pytest.mark.parametrize(
    "kw,cluster,fails",
    [(dict(batch=2, seq_len=16), "4x4", False),
     (dict(batch=4, seq_len=16, microbatches=2), "4x4", False),
     (dict(batch=2, seq_len=16, n_layers=4), "4xhalf", False),
     (dict(batch=2, seq_len=16), "tiny", True)],
)
def test_pipeline_placements_equal_jax(kw, cluster, fails):
    cfg_kw = {k: kw.pop(k) for k in ("n_layers",) if k in kw}
    jdag, tdag = _pair(*_configs(**cfg_kw), **kw)
    ts = _assert_same_pipeline(jdag.graph, tdag.graph, cluster)
    assert bool(ts.failed) == fails


def test_pipeline_places_the_flagship_equal_to_jax(llama8b_fused):
    jg, tg = llama8b_fused
    ts = _assert_same_pipeline(jg, tg, "8x9.5")
    assert not ts.failed and len(ts.completed) == 1945
    assert sum(1 for lst in ts.per_node.values() if lst) == 8


def test_pipeline_is_registered_and_link_aware():
    assert P.ALL_SCHEDULERS["pipeline"] is P.PipelineStageScheduler
    link = P.LinkModel(param_load_gbps=2.0)
    assert P.get_scheduler("pipeline", link=link).link is link
