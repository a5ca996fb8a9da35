"""The port's dense decode-step DAGs and K-step loop against the JAX
package's, on the CPU.

The counterparts of ``tests/test_decode_dag.py``'s dense cases for the
three families.  Graph structure (task ids, dependencies, aliases, param
and cache-slab bytes, output bytes, FLOPs, groups, names) must be equal;
prefill-DAG logits are held against JAX ``forward_cached`` at rtol = atol
= 2e-4; multi-step generation through ``DeviceBackend`` with
``apply_cache_updates``, and through ``build_decode_loop``, must give the
JAX package's greedy tokens exactly (the f32 tiny configs).  Weights come
from the port's numpy initializer (seed 0) and go to both packages; each
JAX generation runs once per family.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_scheduler_tpu.frontend import decode_dag as JD
from distributed_llm_scheduler_tpu.models import gpt2 as jgpt2
from distributed_llm_scheduler_tpu.models import llama as jllama
from distributed_llm_scheduler_tpu.models import mixtral as jmixtral
from distributed_llm_scheduler_tpu_torch import Cluster, DeviceBackend, get_scheduler
from distributed_llm_scheduler_tpu_torch.backends.decode_loop import (
    build_decode_loop,
    compose_step_fn,
    split_cache_params,
)
from distributed_llm_scheduler_tpu_torch.frontend.decode_dag import (
    apply_cache_updates,
    build_decode_dag,
    build_decode_dag_any,
    decode_inputs,
)
from distributed_llm_scheduler_tpu_torch.models import gpt2 as tgpt2
from distributed_llm_scheduler_tpu_torch.models import llama as tllama
from distributed_llm_scheduler_tpu_torch.models import mixtral as tmixtral

CPU = torch.device("cpu")
TOL = 2e-4
FAMILIES = {
    "gpt2": (jgpt2, tgpt2, jgpt2.GPT2Config.tiny(), tgpt2.GPT2Config.tiny()),
    "llama": (jllama, tllama, jllama.LlamaConfig.tiny(),
              tllama.LlamaConfig.tiny()),
    "mixtral": (jmixtral, tmixtral, jmixtral.MixtralConfig.tiny(),
                tmixtral.MixtralConfig.tiny()),
}
B, P, M, NEW = 2, 6, 16, 5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: several spin against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def families():
    """Per family, built once: weights in both packages, the prompt, and
    the JAX package's greedy generation of ``NEW`` tokens."""
    built = {}

    def get(name):
        if name not in built:
            jmod, tmod, jcfg, tcfg = FAMILIES[name]
            np_w = tmod.init_params_numpy(tcfg, 0)
            jw = {k: jnp.asarray(v) for k, v in np_w.items()}
            ids = np.random.default_rng(3).integers(0, tcfg.vocab_size, (B, P),
                                                    dtype=np.int32)
            want = np.asarray(jmod.generate(jw, jnp.asarray(ids), jcfg,
                                            max_new_tokens=NEW))[:, P:]
            built[name] = dict(jmod=jmod, tmod=tmod, jcfg=jcfg, tcfg=tcfg,
                               jw=jw, tw=tmod.params_from_numpy(np_w, CPU),
                               ids=ids, want=want)
        return built[name]

    return get


@pytest.fixture(params=sorted(FAMILIES))
def fam(request, families):
    return families(request.param)


def graph_fields(g):
    return g.name, [
        (t.task_id, t.dependencies, t.arg_tasks, sorted(t.params_needed),
         sorted(t.param_bytes.items()), t.memory_required, t.compute_time,
         t.flops, t.group, sorted((t.param_alias or {}).items()))
        for t in g
    ]


def _one_node():
    cluster = Cluster.from_torch_devices([CPU])
    return cluster, DeviceBackend(cluster)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step_len", [1, P])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_graphs_equal_the_jax_builders(family, step_len, dtype):
    _, _, jcfg, tcfg = FAMILIES[family]
    jcfg = type(jcfg)(**{**jcfg.__dict__, "dtype": getattr(jnp, dtype)})
    tcfg = type(tcfg)(**{**tcfg.__dict__, "dtype": getattr(torch, dtype)})
    j = JD.build_decode_dag_any(jcfg, batch=B, step_len=step_len, max_len=M)
    t = build_decode_dag_any(tcfg, batch=B, step_len=step_len, max_len=M)
    assert graph_fields(t.graph) == graph_fields(j.graph)
    assert sorted(t.param_specs) == sorted(j.param_specs)
    for name, spec in t.param_specs.items():
        assert tuple(spec.shape) == tuple(j.param_specs[name].shape), name


def test_position_bounds_checked():
    with pytest.raises(ValueError, match="exceeds"):
        build_decode_dag(tgpt2.GPT2Config.tiny(), batch=1, step_len=8, pos=30,
                         max_len=32)
    ids = torch.zeros((1, 1), dtype=torch.int32)
    decode_inputs(ids, 31, max_len=32)  # fits
    with pytest.raises(ValueError, match="exceeds"):
        decode_inputs(ids, 32, max_len=32)
    with pytest.raises(ValueError, match="exceeds"):
        decode_inputs(torch.zeros((1, 8), dtype=torch.int32), 25, max_len=32)
    inp = decode_inputs(ids, 7)
    assert inp["pos"].dtype == torch.int32 and inp["pos"].shape == ()


def test_prefill_dag_logits_match_jax(fam):
    f = fam
    cluster, backend = _one_node()
    dag = build_decode_dag_any(f["tcfg"], batch=B, step_len=P, max_len=M)
    params = dag.derive_params(f["tw"])
    sched = get_scheduler("greedy").schedule(dag.graph, cluster)
    rep = backend.execute(dag.graph, sched, params,
                          decode_inputs(torch.from_numpy(f["ids"]), 0))
    # jitted: its eager ops would compile one by one
    jl, _ = jax.jit(lambda w, ids, c: f["jmod"].forward_cached(
        w, ids, c, 0, f["jcfg"]))(f["jw"], jnp.asarray(f["ids"]),
                                  f["jmod"].init_cache(f["jcfg"], B, M))
    np.testing.assert_allclose(rep.output.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)


def test_multistep_tokens_through_the_backend_equal_jax(fam):
    """Prefill DAG, then single-token step DAGs (one graph reused for
    every position), each run folded into the slabs in place by
    ``apply_cache_updates``: the JAX package's greedy tokens exactly, and
    each step's logits equal to the DAG's own oracle."""
    f = fam
    cluster, backend = _one_node()
    dag = build_decode_dag_any(f["tcfg"], batch=B, step_len=P, max_len=M)
    params = dag.derive_params(f["tw"])
    slabs = {k: v.data_ptr() for k, v in params.items()
             if k.startswith("cache_")}
    sched = get_scheduler("greedy").schedule(dag.graph, cluster)
    rep = backend.execute(dag.graph, sched, params,
                          decode_inputs(torch.from_numpy(f["ids"]), 0),
                          keep_outputs=True)
    assert apply_cache_updates(params, rep.task_outputs, f["tcfg"], 0) is params
    tok = rep.output[:, -1].argmax(-1).to(torch.int32)
    got = [tok]
    ddag = build_decode_dag_any(f["tcfg"], batch=B, step_len=1, max_len=M)
    dsched = get_scheduler("greedy").schedule(ddag.graph, cluster)
    for s in range(1, NEW):
        pos = P + s - 1
        inp = decode_inputs(tok[:, None], pos, max_len=M)
        drep = backend.execute(ddag.graph, dsched, params, inp,
                               keep_outputs=True)
        ref = ddag.reference_forward(params, inp)
        torch.testing.assert_close(drep.output, ref, rtol=2e-5, atol=2e-5)
        apply_cache_updates(params, drep.task_outputs, f["tcfg"], pos)
        tok = drep.output[:, -1].argmax(-1).to(torch.int32)
        got.append(tok)
    np.testing.assert_array_equal(torch.stack(got, 1).numpy(), f["want"])
    # the slabs were written in place: the same tensors at the same places
    assert slabs == {k: v.data_ptr() for k, v in params.items()
                     if k.startswith("cache_")}


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_decode_loop_is_token_exact_and_chains(families, family):
    """``build_decode_loop`` from a DAG prefill reproduces the JAX greedy
    tokens exactly, and two chained calls (the caches fed back) equal
    one longer call."""
    f = families(family)
    cluster, backend = _one_node()
    pdag = build_decode_dag_any(f["tcfg"], batch=B, step_len=P, max_len=M)
    ddag = build_decode_dag_any(f["tcfg"], batch=B, step_len=1, max_len=M)
    dsched = get_scheduler("greedy").schedule(ddag.graph, cluster)
    runs = []
    for chunks in ((NEW - 1,), (2, NEW - 3)):
        params = pdag.derive_params(f["tw"])
        rep = backend.execute(
            pdag.graph, get_scheduler("greedy").schedule(pdag.graph, cluster),
            params, decode_inputs(torch.from_numpy(f["ids"]), 0),
            keep_outputs=True)
        apply_cache_updates(params, rep.task_outputs, f["tcfg"], 0)
        tok = rep.output[:, -1].argmax(-1).to(torch.int32)[:, None]
        weights, caches = split_cache_params(params)
        toks, pos = [tok], P
        for n in chunks:
            loop = build_decode_loop(ddag.graph, dsched, f["tcfg"], steps=n)
            out, caches = loop(weights, caches, toks[-1][:, -1:], pos)
            toks.append(out)
            pos += n
        runs.append(torch.cat(toks, dim=1))
    np.testing.assert_array_equal(runs[0].numpy(), f["want"])
    assert torch.equal(runs[0], runs[1])


def test_multi_node_placements_are_refused():
    """The dense loop, like the JAX one, composes a single-node placement
    only: a multi-node step goes through per-task dispatch."""
    cfg = tgpt2.GPT2Config.tiny()
    ddag = build_decode_dag_any(cfg, batch=B, step_len=1, max_len=M)
    cluster = Cluster.from_torch_devices([CPU, CPU])
    sched = get_scheduler("roundrobin").schedule(ddag.graph, cluster)
    assert len(set(sched.placement.values())) > 1
    for build in (lambda: compose_step_fn(ddag.graph, sched, cfg),
                  lambda: build_decode_loop(ddag.graph, sched, cfg, steps=2)):
        with pytest.raises(ValueError, match="single-node placement"):
            build()


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_every_layer_task_runs_on_meta_with_a_meta_position(family):
    """Each task fn of a decode-step DAG runs with meta params and a meta
    0-d position.  ``int()`` and ``.item()`` of a meta tensor raise, so no
    task reads the position (or anything else) back to the host."""
    cfg = FAMILIES[family][3]
    ddag = build_decode_dag_any(cfg, batch=B, step_len=1, max_len=M)
    pos = torch.empty((), dtype=torch.int32, device="meta")
    with pytest.raises(Exception):
        int(pos)
    outs = {}
    inputs = {"ids": torch.empty((B, 1), dtype=torch.int32, device="meta"),
              "pos": pos}
    for tid in ddag.graph.topo_order:
        task = ddag.graph[tid]
        p = {loc: ddag.param_specs[glob]
             for loc, glob in task.param_alias.items()}
        args = [outs[d] for d in task.arg_tasks] if task.dependencies else [inputs]
        outs[tid] = task.fn(p, *args)
    for i in range(cfg.n_layer if family == "gpt2" else cfg.n_layers):
        o = outs[f"layer_{i}"]
        assert o["pos"] is pos
        assert all(v.device.type == "meta" for v in o.values())
        assert o["k_new"].shape[2] == 1
    assert tuple(outs["logits"].shape) == (B, 1, cfg.vocab_size)
