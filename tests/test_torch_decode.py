"""The port's decode path against the JAX package's, on the CPU.

Weights come from one numpy seed (the port's ``init_params_numpy``) and go
to both packages; token ids come from numpy seeds.  Logits are held at
rtol = atol = 2e-4, the repo's tolerance for a placed DAG against the
fused forward (``__graft_entry__.py:333``).  Greedy tokens on the f32
tiny config, graph structure, placements and page books carry no
roundoff that matters and must be equal.  The engine runs
``eval/decode_bench.measure_paged_decode``'s workload: tiny f32, 12
requests of two prompt lengths with a skewed generation mix, 4 slots,
page size 16, 8 pages per slot, 64 pages, 8-step segments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu.backends.device import (
    DeviceBackend as JaxBackend,
)
from distributed_llm_scheduler_tpu.frontend.decode_dag import (
    build_paged_decode_dag as jax_build,
)
from distributed_llm_scheduler_tpu.models import gpt2 as jgpt2
from distributed_llm_scheduler_tpu.models.kv_pages import PagePool as JaxPool
from distributed_llm_scheduler_tpu_torch.backends.decode_loop import (
    compose_paged_step_fn,
)
from distributed_llm_scheduler_tpu_torch.frontend.decode_dag import (
    build_paged_decode_dag as torch_build,
)
from distributed_llm_scheduler_tpu_torch.models import decode as tdecode
from distributed_llm_scheduler_tpu_torch.models import gpt2 as tgpt2

CPU = torch.device("cpu")
RTOL = ATOL = 2e-4
GEOM = dict(slots=4, page_size=16, n_pages=64, pages_per_seq=8)


@pytest.fixture(scope="module")
def weights():
    """Tiny f32 GPT-2 weights from numpy seed 0, in both packages."""
    np_w = tgpt2.init_params_numpy(tgpt2.GPT2Config.tiny(), 0)
    return ({k: jnp.asarray(v) for k, v in np_w.items()},
            tgpt2.params_from_numpy(np_w, CPU))


def graph_fields(g):
    return g.name, [
        (
            t.task_id, t.dependencies, t.arg_tasks, sorted(t.params_needed),
            sorted(t.param_bytes.items()), t.memory_required, t.compute_time,
            t.flops, t.group, sorted((t.param_alias or {}).items()),
        )
        for t in g
    ]


def test_forward_cached_matches_jax(weights):
    """Prefill of 8 tokens, then 3 single-token decode steps, each step's
    logits allclose to JAX's; the updated cache too."""
    jw, tw = weights
    jcfg, tcfg = jgpt2.GPT2Config.tiny(), tgpt2.GPT2Config.tiny()
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 512, size=(2, 8), dtype=np.int32)
    steps = rng.integers(0, 512, size=(3, 2, 1), dtype=np.int32)
    jc = jgpt2.init_cache(jcfg, 2, 16)
    tc = tgpt2.init_cache(tcfg, 2, 16, device=CPU)
    feeds = [(ids, 0)] + [(steps[i], 8 + i) for i in range(3)]
    for x, pos in feeds:
        jl, jc = jgpt2.forward_cached(jw, jnp.asarray(x), jc, pos, jcfg)
        tl, tc = tgpt2.forward_cached(tw, torch.from_numpy(x), tc, pos, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    for kind in ("k", "v"):
        np.testing.assert_allclose(tc[kind].numpy(), np.asarray(jc[kind]),
                                   rtol=RTOL, atol=ATOL)


def test_forward_cached_prefill_matches_forward(weights):
    _, tw = weights
    cfg = tgpt2.GPT2Config.tiny()
    ids = torch.from_numpy(
        np.random.default_rng(12).integers(0, 512, (2, 10), dtype=np.int32))
    cached, _ = tgpt2.forward_cached(
        tw, ids, tgpt2.init_cache(cfg, 2, 32, device=CPU), 0, cfg)
    np.testing.assert_allclose(cached.numpy(), tgpt2.forward(tw, ids, cfg).numpy(),
                               rtol=RTOL, atol=ATOL)


def test_generate_tokens_equal_jax(weights):
    jw, tw = weights
    ids = np.random.default_rng(13).integers(0, 512, size=(2, 8), dtype=np.int32)
    want = np.asarray(jgpt2.generate(
        jw, jnp.asarray(ids), jgpt2.GPT2Config.tiny(), 12, max_len=32))
    got = tgpt2.generate(tw, torch.from_numpy(ids), tgpt2.GPT2Config.tiny(), 12,
                         max_len=32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_validates_and_samples():
    cfg = tgpt2.GPT2Config.tiny()
    w = tgpt2.params_from_numpy(tgpt2.init_params_numpy(cfg, 1), CPU)
    ids = torch.zeros((1, 4), dtype=torch.int32)
    assert tgpt2.generate(w, ids, cfg, 0) is ids
    with pytest.raises(ValueError, match="max_len"):
        tgpt2.generate(w, ids, cfg, 8, max_len=6)
    with pytest.raises(ValueError, match="position limit"):
        tgpt2.generate(w, ids, cfg, 200, max_len=300)
    with pytest.raises(ValueError, match="torch.Generator"):
        tgpt2.generate(w, ids, cfg, 2, temperature=1.0)
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    a = tgpt2.generate(w, ids, cfg, 6, temperature=0.8, top_k=5, generator=g1)
    b = tgpt2.generate(w, ids, cfg, 6, temperature=0.8, top_k=5, generator=g2)
    assert torch.equal(a, b) and a.shape == (1, 10)
    logits = torch.tensor([[0.0, 3.0, 3.0, -1.0]])
    assert tdecode.sample_token(logits, None, 0.0).tolist() == [1]  # first max


@pytest.mark.parametrize("size,tdt,jdt", [
    ("tiny", torch.float32, jnp.float32),
    ("small", torch.bfloat16, jnp.bfloat16),
])
def test_paged_dag_structure_equals_jax(size, tdt, jdt):
    geom = dict(GEOM) if size == "tiny" else dict(
        slots=8, page_size=16, n_pages=257, pages_per_seq=32)
    j = jax_build(getattr(jgpt2.GPT2Config, size)(dtype=jdt), **geom)
    t = torch_build(getattr(tgpt2.GPT2Config, size)(dtype=tdt), **geom)
    assert graph_fields(t.graph) == graph_fields(j.graph)
    assert sorted(t.param_specs) == sorted(j.param_specs)
    for name, spec in j.param_specs.items():
        assert tuple(t.param_specs[name].shape) == tuple(spec.shape), name
    assert (t.slots, t.page_size, t.pages_per_seq) == (
        j.slots, j.page_size, j.pages_per_seq)


def test_paged_dag_names_its_impl_and_refuses_unknown_ones():
    t = torch_build(tgpt2.GPT2Config.tiny(), attention_impl="plain", **GEOM)
    assert t.graph.name.endswith("_attplain")
    assert t.graph.attention_impl == "plain"
    with pytest.raises(ValueError, match="unknown paged attention impl"):
        torch_build(tgpt2.GPT2Config.tiny(), attention_impl="pallas", **GEOM)
    with pytest.raises(ValueError, match="n_pages"):
        torch_build(tgpt2.GPT2Config.tiny(), slots=1, n_pages=1)


def test_greedy_placement_equals_jax():
    j = jax_build(jgpt2.GPT2Config.tiny(), **GEOM)
    t = torch_build(tgpt2.GPT2Config.tiny(), **GEOM)
    for pkg, g in ((J, j.graph), (P, t.graph)):
        g.sched = pkg.get_scheduler("greedy").schedule(
            g, pkg.Cluster.uniform(2, g.total_param_gb()))
    assert t.graph.sched.per_node == j.graph.sched.per_node
    assert t.graph.sched.assignment_order == j.graph.sched.assignment_order


@pytest.fixture(scope="module")
def paged_state(weights):
    """Random pool contents, a page table and ragged lengths, bridged."""
    jw, _ = weights
    cfg = tgpt2.GPT2Config.tiny()
    rng = np.random.default_rng(21)
    state = {k: np.asarray(v) for k, v in jw.items()}
    for i in range(cfg.n_layer):
        for kind in ("k", "v"):
            state[f"cache_{kind}_{i}"] = rng.standard_normal(
                (64, 16, cfg.n_head, cfg.head_dim)).astype(np.float32) * 0.5
    pt = np.zeros((4, 8), np.int32)
    lengths = np.array([0, 7, 16, 40], np.int32)
    page = 1
    for s, L in enumerate(lengths):
        for jp in range(L // 16 + 1):
            pt[s, jp] = page
            page += 1
    state["page_table"] = pt
    ids = rng.integers(0, 512, (4, 1), dtype=np.int32)
    return state, ids, lengths


def test_reference_forward_matches_jax(paged_state):
    state, ids, lengths = paged_state
    j = jax_build(jgpt2.GPT2Config.tiny(), **GEOM)
    t = torch_build(tgpt2.GPT2Config.tiny(), **GEOM)
    want = np.asarray(j.reference_forward(
        {k: jnp.asarray(v) for k, v in state.items()},
        {"ids": jnp.asarray(ids), "lengths": jnp.asarray(lengths)}))
    tstate = tgpt2.params_from_numpy(state, CPU)
    assert tstate["page_table"].dtype == torch.int32
    got = t.reference_forward(
        tstate, {"ids": torch.from_numpy(ids), "lengths": torch.from_numpy(lengths)})
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_placed_step_matches_reference_forward(paged_state):
    """The composed placed step (plain paged attention on the CPU) against
    the per-slot dense oracle, and its pool writes at each slot's length."""
    state, ids, lengths = paged_state
    t = torch_build(tgpt2.GPT2Config.tiny(), **GEOM)
    tstate = tgpt2.params_from_numpy(state, CPU)
    cluster = P.Cluster.from_torch_devices([CPU])
    sched = P.get_scheduler("greedy").schedule(t.graph, cluster)
    step = compose_paged_step_fn(t.graph, sched, t.config)
    pools = {k: v.clone() for k, v in tstate.items() if k.startswith("cache_")}
    active = torch.tensor([True, True, False, True])
    with torch.no_grad():
        logits, pools = step(tstate, pools, tstate["page_table"],
                             torch.from_numpy(ids), torch.from_numpy(lengths), active)
    want = t.reference_forward(
        tstate, {"ids": torch.from_numpy(ids), "lengths": torch.from_numpy(lengths)})
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    pt = state["page_table"]
    for s in (0, 1, 3):
        L = int(lengths[s])
        assert not torch.equal(pools["cache_k_0"][pt[s, L // 16], L % 16],
                               tstate["cache_k_0"][pt[s, L // 16], L % 16])
    L = int(lengths[2])  # inactive: its row is left alone
    assert torch.equal(pools["cache_k_1"][pt[2, L // 16], L % 16],
                       tstate["cache_k_1"][pt[2, L // 16], L % 16])


def workload(vocab, capacity, n_requests=12):
    """``measure_paged_decode``'s requests: prompts of 16 then 24 tokens,
    one long generation per three short, numpy RandomState(7)."""
    rng = np.random.RandomState(7)
    gen_pattern = [capacity - 24, 8, 8, 8]
    reqs = []
    for i in range(n_requests):
        Pn = 16 if i < n_requests // 2 else 24
        gen = min(gen_pattern[i % 4], capacity - Pn)
        reqs.append((f"r{i}", rng.randint(0, vocab, (1, Pn)).astype(np.int32), gen))
    return reqs


@pytest.fixture(scope="module")
def engines(weights):
    """The JAX engine and the port's, both drained once on the workload."""
    jw, tw = weights
    reqs = workload(512, GEOM["pages_per_seq"] * GEOM["page_size"])
    jd = jax_build(jgpt2.GPT2Config.tiny(), **GEOM)
    jc = J.Cluster.from_jax_devices(jax.devices()[:1])
    jpool = JaxPool(n_pages=GEOM["n_pages"], page_size=GEOM["page_size"])
    jeng = JaxBackend(jc).paged_decode_engine(
        jd.graph, J.get_scheduler("greedy").schedule(jd.graph, jc),
        jd.config, jw, jpool, slots=4, pages_per_seq=8, seg_steps=8)
    td = torch_build(tgpt2.GPT2Config.tiny(), **GEOM)
    tc = P.Cluster.from_torch_devices([CPU])
    tpool = P.PagePool(n_pages=GEOM["n_pages"], page_size=GEOM["page_size"])
    teng = P.DeviceBackend(tc).paged_decode_engine(
        td.graph, P.get_scheduler("greedy").schedule(td.graph, tc),
        td.config, tw, tpool, slots=4, pages_per_seq=8, seg_steps=8)
    out = {}
    for name, eng in (("jax", jeng), ("torch", teng)):
        for rid, ids, gen in reqs:
            eng.submit(rid, ids, gen)
        out[name] = {k: np.asarray(v) for k, v in eng.run().items()}
    return reqs, jeng, teng, out


def test_engine_tokens_equal_jax(engines):
    reqs, jeng, teng, out = engines
    assert sorted(out["torch"]) == sorted(out["jax"])
    for rid, _, gen in reqs:
        assert out["torch"][rid].shape == (gen,)
        np.testing.assert_array_equal(out["torch"][rid], out["jax"][rid], err_msg=rid)
    assert teng.segments_run == jeng.segments_run


def test_engine_books_and_metrics(engines):
    reqs, jeng, teng, _ = engines
    assert teng.pool.free_pages == teng.pool.n_pages - 1
    snap, jsnap = teng.metrics.snapshot(), jeng.metrics.snapshot()
    assert snap["gauges"]["decode.pages_leaked"]["value"] == 0
    for name in ("decode.requests_submitted", "decode.requests_completed",
                 "decode.segments_run", "decode.tokens_delivered",
                 "decode.admission_waves"):
        assert snap["counters"][name]["value"] == jsnap["counters"][name]["value"], name
    # decode steps deliver every token but each request's first, which
    # its prefill produced
    assert snap["counters"]["decode.tokens_delivered"]["value"] == sum(
        g - 1 for _, _, g in reqs)
    for name in ("decode.ttft_s", "decode.tpot_s"):
        assert snap["histograms"][name]["count"] == jsnap["histograms"][name]["count"]
    # one prefill time per admission wave
    assert (snap["histograms"]["decode.prefill_s"]["count"]
            == snap["counters"]["decode.admission_waves"]["value"])
    assert (snap["gauges"]["decode.page_pool_occupancy_pages"]["max"]
            == jsnap["gauges"]["decode.page_pool_occupancy_pages"]["max"])
    summ = teng.summary()
    assert summ["completed"] == len(reqs) and summ["free_slots"] == 4
    assert summ["attention_impl"] == "auto"
    assert summ["page_occupancy"] == jeng.summary()["page_occupancy"]


def test_engine_reset_replays_the_workload(engines):
    reqs, _, teng, out = engines
    before = teng.metrics
    teng.reset(fresh_metrics=True)
    assert teng.metrics is not before
    assert teng.segments_run == 0 and teng.free_slots == 4
    for rid, ids, gen in reqs[:5]:
        teng.submit(rid, ids, gen)
    got = teng.run()
    for rid, _, _ in reqs[:5]:
        np.testing.assert_array_equal(got[rid], out["torch"][rid])
    snap = teng.metrics.snapshot()  # this run's alone
    assert snap["counters"]["decode.requests_submitted"]["value"] == 5
    assert snap["histograms"]["decode.ttft_s"]["count"] == 5


def test_submit_errors_match_jax(engines):
    _, jeng, teng, _ = engines
    cases = [
        ("r0", np.zeros((1, 4), np.int32), 4),     # already retired
        ("x1", np.zeros((4,), np.int32), 4),       # not (1, P)
        ("x2", np.zeros((2, 4), np.int32), 4),
        ("x3", np.zeros((1, 4), np.int32), 0),     # max_new < 1
        ("x4", np.zeros((1, 100), np.int32), 29),  # past capacity 128
    ]
    for rid, ids, gen in cases:
        with pytest.raises(ValueError) as jerr:
            jeng.submit(rid, ids, gen)
        with pytest.raises(ValueError) as terr:
            teng.submit(rid, ids, gen)
        assert str(terr.value) == str(jerr.value), rid
    teng.submit("dup", np.zeros((1, 4), np.int32), 2)
    with pytest.raises(ValueError, match="already queued"):
        teng.submit("dup", np.zeros((1, 4), np.int32), 2)
    teng.reset()


def test_unported_engine_features_raise(weights):
    _, tw = weights
    td = torch_build(tgpt2.GPT2Config.tiny(), **GEOM)
    tc = P.Cluster.from_torch_devices([CPU])
    sched = P.get_scheduler("greedy").schedule(td.graph, tc)
    backend = P.DeviceBackend(tc)

    def make(pool=None, **kw):
        pool = pool or P.PagePool(n_pages=64, page_size=16)
        return backend.paged_decode_engine(
            td.graph, sched, td.config, tw, pool, slots=4, pages_per_seq=8, **kw)

    with pytest.raises(NotImplementedError, match="prefix sharing"):
        make(P.PagePool(n_pages=64, page_size=16, sharing=True))
    with pytest.raises(NotImplementedError, match="chunk_tokens"):
        make(chunk_tokens=8)
    for hook in ("trace", "memprof", "flight"):
        with pytest.raises(NotImplementedError):
            make(**{hook: object()})
    # the graph's layer tasks choose the attention path; the engine takes
    # no impl of its own and reports the graph's
    with pytest.raises(TypeError, match="attention_impl"):
        make(attention_impl="plain")
    eng = make()
    with pytest.raises(NotImplementedError, match="preempt"):
        eng.preempt("r0")
    with pytest.raises(NotImplementedError, match="drain"):
        eng.begin_drain()


def test_engine_reports_the_graphs_attention_impl(weights):
    _, tw = weights
    td = torch_build(tgpt2.GPT2Config.tiny(), attention_impl="plain", **GEOM)
    tc = P.Cluster.from_torch_devices([CPU])
    eng = P.DeviceBackend(tc).paged_decode_engine(
        td.graph, P.get_scheduler("greedy").schedule(td.graph, tc), td.config,
        tw, P.PagePool(n_pages=64, page_size=16), slots=4, pages_per_seq=8)
    assert eng.summary()["attention_impl"] == "plain"


def test_engine_backpressure_and_stall():
    cfg = tgpt2.GPT2Config.tiny()
    td = torch_build(cfg, slots=2, page_size=16, n_pages=4, pages_per_seq=8)
    tc = P.Cluster.from_torch_devices([CPU])
    sched = P.get_scheduler("greedy").schedule(td.graph, tc)
    w = tgpt2.params_from_numpy(tgpt2.init_params_numpy(cfg, 2), CPU)
    eng = P.DeviceBackend(tc).paged_decode_engine(
        td.graph, sched, cfg, w, P.PagePool(n_pages=4, page_size=16),
        slots=2, pages_per_seq=8)
    # two requests of 2 pages each with 3 allocatable pages: the second
    # waits for the first to retire, then runs
    eng.submit("a", np.ones((1, 20), np.int32), 8)
    eng.submit("b", np.ones((1, 20), np.int32), 8)
    eng.step_segment()
    assert eng.summary()["queued"] == 1
    got = eng.run()
    assert sorted(got) == ["a", "b"] and np.array_equal(got["a"], got["b"])
    eng.reset()
    eng.submit("big", np.ones((1, 40), np.int32), 20)  # needs 4 of 3 pages
    with pytest.raises(RuntimeError, match="engine stalled"):
        eng.run()
