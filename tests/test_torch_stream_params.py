"""Parameter streaming in the port (``execute(stream_params=True)`` and
``DeviceBackend._ParamStreamer``) against the JAX package's.

Mirrors ``tests/test_stream_params.py``.  Every host-side decision of the
streamer is framework-free, so on the same DAG, schedule and budget the
counters must be *equal* to the JAX run's: ``param_loads``,
``param_load_calls``, ``param_load_bytes``, ``param_evictions`` and
``peak_param_bytes`` on the per-task and the segmented rung (and
``demand_misses`` in the direct streamer tests), with the budget-split
segments equal to JAX's ``build_segments(max_union_gb, param_gb)``.
Outputs match the JAX run's at rtol = atol = 2e-5 in f32.  On the CPU a
load is ``Tensor.to("cpu")`` (the caller's tensor itself); the card's
copy stream, events and deferred frees run in ``tests/test_torch_cuda.py``.
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
from distributed_llm_scheduler_tpu.frontend.gpt2_dag import (
    build_gpt2_dag as jax_build,
)
from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config as JaxConfig
from distributed_llm_scheduler_tpu.utils.quantize import (
    quantize_dag as jax_quantize_dag,
)
from distributed_llm_scheduler_tpu_torch.utils.quantize import quantize_dag

CPU = torch.device("cpu")
RTOL = ATOL = 2e-5
COUNTERS = ("param_loads", "param_load_calls", "param_load_bytes",
            "param_evictions", "peak_param_bytes", "n_dispatches")


@pytest.fixture(scope="module")
def setup():
    jdag = jax_build(JaxConfig.tiny(), batch=1, seq_len=16)
    tdag = P.build_gpt2_dag(P.GPT2Config.tiny(), batch=1, seq_len=16)
    jparams = jdag.init_params()
    tparams = P.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, CPU)
    ids = np.array(jdag.make_inputs())
    return dict(jdag=jdag, tdag=tdag, jparams=jparams, tparams=tparams,
                ids=ids)


def _clusters(setup, n, fraction):
    """Budget = fraction of total param bytes, on both packages."""
    total_gb = setup["jdag"].graph.total_param_gb()
    return (J.Cluster.from_jax_devices(jax.devices()[:n],
                                       hbm_cap_gb=total_gb * fraction),
            P.Cluster.from_torch_devices([CPU] * n,
                                         hbm_cap_gb=total_gb * fraction))


def _run_both(setup, policy, n, fraction, **kw):
    jc, tc = _clusters(setup, n, fraction)
    js = J.get_scheduler(policy).schedule(setup["jdag"].graph, jc)
    ts = P.get_scheduler(policy).schedule(setup["tdag"].graph, tc)
    assert ts.per_node == js.per_node and not ts.failed
    jrep = JaxBackend(jc, pre_analysis=False).execute(
        setup["jdag"].graph, js, setup["jparams"], jnp.asarray(setup["ids"]),
        stream_params=True, **kw)
    trep = P.DeviceBackend(tc).execute(
        setup["tdag"].graph, ts, setup["tparams"],
        torch.from_numpy(setup["ids"]), stream_params=True, **kw)
    for name in COUNTERS:
        assert getattr(trep, name) == getattr(jrep, name), name
    assert trep.streamed and jrep.streamed
    np.testing.assert_allclose(trep.output.numpy(), np.asarray(jrep.output),
                               rtol=RTOL, atol=ATOL)
    fused = setup["tdag"].reference_forward(
        setup["tparams"], torch.from_numpy(setup["ids"]))
    np.testing.assert_allclose(trep.output.numpy(), fused.numpy(),
                               rtol=RTOL, atol=ATOL)
    return trep, tc


def test_oversubscribed_single_device_executes(setup):
    """Weights ~3x the budget: streaming evicts and stays exact."""
    rep, tc = _run_both(setup, "mru", 1, 0.35)
    assert rep.param_evictions > 0
    assert rep.param_loads > len(setup["tdag"].graph.unique_params())
    budget = int(tc.devices[0].total_memory * 1024**3)
    assert max(rep.peak_param_bytes.values()) <= budget * 1.5
    assert rep.param_bytes_placed == {"core_0": 0}
    assert not rep.planned


def test_fits_in_budget_no_evictions(setup):
    rep, _ = _run_both(setup, "greedy", 1, 4.0)
    assert rep.param_evictions == 0
    assert rep.param_loads == len(setup["tdag"].graph.unique_params())


def test_streaming_multi_device(setup):
    _run_both(setup, "mru", 4, 0.2)


def test_segmented_streaming_single_device_exact(setup):
    """Streaming composes with segments: the oversubscribed single node
    budget-splits into several segments, one batched load each."""
    rep, tc = _run_both(setup, "mru", 1, 0.35, segments=True)
    assert 1 < rep.n_dispatches < len(setup["tdag"].graph)
    assert rep.param_load_calls <= rep.n_dispatches + 1
    budget = int(tc.devices[0].total_memory * 1024**3)
    assert max(rep.peak_param_bytes.values()) <= budget * 1.02
    assert rep.captured_launches == {}


def test_segmented_streaming_multi_device_evicts(setup):
    rep, _ = _run_both(setup, "mru", 4, 0.3, segments=True)
    assert rep.n_dispatches > 1
    assert rep.param_load_calls <= rep.n_dispatches
    assert rep.param_loads >= len(setup["tdag"].graph.unique_params())


@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("policy,n,fraction", [("greedy", 1, 0.3),
                                               ("mru", 1, 0.35),
                                               ("heft", 4, 0.3)])
def test_int8_streaming_counts_equal_jax(setup, policy, n, fraction, segments):
    """Int8 weights stream leaf by leaf (q and scale) and count the JAX
    run's bytes; placed on an uncapped cluster, then capped, as the stream
    bench does."""
    kw = dict(batch=4, seq_len=16, microbatches=2, vocab_shards=4)
    jdag = jax_quantize_dag(jax_build(JaxConfig.tiny(), **kw))
    tdag = quantize_dag(P.build_gpt2_dag(P.GPT2Config.tiny(), **kw))
    jfp = jax_build(JaxConfig.tiny(), **kw).init_params()
    jparams = jdag.init_params()
    tparams = tdag.derive_params(P.params_from_numpy(
        {k: np.asarray(v) for k, v in jfp.items() if "_shard_" not in k}, CPU))
    ids = np.random.default_rng(3).integers(0, 512, (4, 16), dtype=np.int32)
    jc = J.Cluster.from_jax_devices(jax.devices()[:n], hbm_cap_gb=4.0)
    tc = P.Cluster.from_torch_devices([CPU] * n, hbm_cap_gb=4.0)
    js = J.get_scheduler(policy).schedule(jdag.graph, jc)
    ts = P.get_scheduler(policy).schedule(tdag.graph, tc)
    assert ts.per_node == js.per_node and not ts.failed
    for d in list(jc) + list(tc):
        d.total_memory = jdag.graph.total_param_gb() * fraction
    jrep = JaxBackend(jc, pre_analysis=False).execute(
        jdag.graph, js, jparams, jnp.asarray(ids), stream_params=True,
        segments=segments)
    trep = P.DeviceBackend(tc).execute(
        tdag.graph, ts, tparams, torch.from_numpy(ids), stream_params=True,
        segments=segments)
    for name in COUNTERS:
        assert getattr(trep, name) == getattr(jrep, name), name
    assert trep.param_evictions > 0
    np.testing.assert_allclose(trep.output.numpy(), np.asarray(jrep.output),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fraction", [0.1, 0.35, 1.0])
@pytest.mark.parametrize("policy,n", [("mru", 1), ("heft", 4)])
def test_budget_split_segments_equal_jax(setup, policy, n, fraction):
    """``build_segments(max_union_gb, param_gb)`` and the streamer's
    segment plan equal the JAX package's."""
    jc, tc = _clusters(setup, n, fraction)
    js = J.get_scheduler(policy).schedule(setup["jdag"].graph, jc)
    ts = P.get_scheduler(policy).schedule(setup["tdag"].graph, tc)
    tg, jg = setup["tdag"].graph, setup["jdag"].graph
    tb = P.DeviceBackend(tc)
    jb = JaxBackend(jc, pre_analysis=False)
    order = tb.dispatch_order(tg, ts)
    assert order == jb.dispatch_order(jg, js)
    sizes = {g: v.numel() * v.element_size() / 1024**3
             for g, v in setup["tparams"].items()}
    caps = tb._stream_segment_caps()
    assert caps == jb._stream_segment_caps()
    segs = tb.build_segments(tg, ts, order, max_union_gb=caps, param_gb=sizes)
    assert segs == jb.build_segments(jg, js, order, max_union_gb=caps,
                                     param_gb=sizes)
    assert tb.segment_stream_plan(tg, segs) == jb.segment_stream_plan(jg, segs)
    assert [t for _n, tids, _e in segs for t in tids] == order


def test_streaming_stats_in_summary(setup):
    rep, _ = _run_both(setup, "mru", 1, 0.35)
    s = rep.summary()
    assert s["param_loads"] == rep.param_loads
    assert s["param_evictions"] == rep.param_evictions
    assert s["peak_param_gb"]
    # an unstreamed run's summary carries none of them
    assert "param_loads" not in P.DeviceReport(
        "p", 1.0, None, 1, 0, 0, {}, 0.0).summary()


def test_batched_loads_and_bytes(setup):
    """A task's missing params go up in one call: call count strictly
    below the per-param load count, bytes ledger populated."""
    rep, _ = _run_both(setup, "mru", 1, 0.35)
    assert 0 < rep.param_load_calls < rep.param_loads
    assert rep.param_load_bytes > 0
    s = rep.summary()
    assert s["param_load_calls"] == rep.param_load_calls
    assert s["param_load_mb"] > 0


def test_stream_flag_rules_match_jax(setup):
    """planned=True and reps > 1 are refused with streaming; planned turns
    off by default; profile mode runs streamed and times each task."""
    jc, tc = _clusters(setup, 1, 0.35)
    ts = P.get_scheduler("mru").schedule(setup["tdag"].graph, tc)
    args = (setup["tdag"].graph, ts, setup["tparams"],
            torch.from_numpy(setup["ids"]))
    backend = P.DeviceBackend(tc)
    with pytest.raises(ValueError, match="stream_params"):
        backend.execute(*args, stream_params=True, planned=True)
    with pytest.raises(ValueError, match="start cold"):
        backend.execute(*args, stream_params=True, reps=2)
    rep = backend.execute(*args, stream_params=True, profile=True)
    assert rep.streamed and not rep.planned
    assert len(rep.timings) == len(setup["tdag"].graph)


# -- the streamer alone, against the JAX package's on the same plan ----------

STREAMER_STATS = ("loads", "load_calls", "load_bytes", "evictions",
                  "demand_misses", "peak", "bytes")


def _mk_streamers(params, budget_gb, seq, lookahead=2):
    """The JAX and the port streamer over one node with the same plan (or
    none, the planless LRU mode): numpy params for JAX, torch for the
    port."""
    plan_j = plan_t = None
    jc = J.Cluster.from_jax_devices(jax.devices()[:1], hbm_cap_gb=budget_gb)
    tc = P.Cluster.from_torch_devices([CPU], hbm_cap_gb=budget_gb)
    node = tc.devices[0].node_id
    if seq is not None:
        plan_j, plan_t = {node: seq}, {node: seq}
    js = JaxBackend._ParamStreamer(jc, params, plan=plan_j, lookahead=lookahead)
    ts = P.DeviceBackend._ParamStreamer(
        tc, {k: torch.from_numpy(v) for k, v in params.items()}, plan=plan_t,
        lookahead=lookahead)
    return js, ts, node


def _walk(js, ts, node, seq):
    for tid, globs in seq:
        jpd = js.get_task(tid, node, [(g, g) for g in globs])
        js.note_task(node, globs, jpd[globs[0]] + 1.0)
        ts.get_task(tid, node, [(g, g) for g in globs])
        ts.note_task(node, globs)


def _same(js, ts, node):
    for name in STREAMER_STATS:
        assert getattr(ts, name) == getattr(js, name), name
    assert sorted(ts.resident[node]) == sorted(js.resident[node])


def _scan():
    params = {k: np.ones((256, 256), np.float32) for k in ("a", "b", "c")}
    per = params["a"].nbytes
    budget_gb = (2 * per + per // 2) / 1024**3  # fits exactly 2
    seq = [("t%d" % i, (k,)) for i, k in enumerate("abc" * 4)]
    return params, budget_gb, seq


def test_belady_beats_lru_on_scan_pattern():
    """Cyclic scan over 3 params with room for 2 (lookahead 0): LRU
    thrashes on every access, Belady keeps the soonest-needed resident;
    both equal the JAX streamer's counts."""
    params, budget_gb, seq = _scan()
    js, ts, node = _mk_streamers(params, budget_gb, seq, lookahead=0)
    _walk(js, ts, node, seq)
    _same(js, ts, node)
    js2, ts2, node2 = _mk_streamers(params, budget_gb, None, lookahead=0)
    _walk(js2, ts2, node2, seq)
    _same(js2, ts2, node2)
    assert ts.loads < ts2.loads == len(seq)


def test_prefetch_eliminates_demand_stalls():
    params, budget_gb, seq = _scan()
    js, ts, node = _mk_streamers(params, budget_gb, seq, lookahead=2)
    _walk(js, ts, node, seq)
    _same(js, ts, node)
    assert ts.demand_misses <= 1  # only the very first access can stall
    assert ts.loads >= len(params)


def test_prefetch_loads_ahead_of_use():
    """With budget for everything, the first get_task prefetches the
    lookahead window's params in the same pass."""
    params = {k: np.ones((64, 64), np.float32) for k in "abcd"}
    seq = [("t%d" % i, (k,)) for i, k in enumerate("abcd")]
    js, ts, node = _mk_streamers(params, 1.0, seq, lookahead=3)
    js.get_task("t0", node, [("a", "a")])
    ts.get_task("t0", node, [("a", "a")])
    assert set(ts.resident[node]) == {"a", "b", "c", "d"}
    assert ts.loads == 4 and ts.load_calls <= 4
    _same(js, ts, node)


def test_streamer_ledger_counts_graveyard():
    """Evicted-but-not-dropped tensors stay on the byte ledger until the
    flush drops them."""
    params = {k: np.ones((128, 128), np.float32) for k in "ab"}
    per = params["a"].nbytes
    seq = [("t0", ("a",)), ("t1", ("b",))]
    js, ts, node = _mk_streamers(params, 1.0, seq, lookahead=0)
    for st in (js, ts):
        pd = st.get_task("t0", node, [("a", "a")])
        if st is js:
            st.note_task(node, ("a",), pd["a"] + 1.0)
        else:
            st.note_task(node, ("a",))
        st.get_task("t1", node, [("b", "b")])
        assert st.bytes[node] == 2 * per
        assert st._evict_one(node, set(), None) == per
        assert st._evict_one(node, set(), None) == per
        assert st.evictions == 2
        assert st.bytes[node] == 2 * per, "graveyard bytes left the ledger"
        st._flush(node, 1)
        assert st.bytes[node] == per
        st._flush(node, per)
        assert st.bytes[node] == 0
    _same(js, ts, node)


def test_prefetch_never_overshoots_budget():
    """A prefetch with everything pinned is skipped, never loaded past the
    cap: the over-budget escape is for a task's own params only."""
    params = {k: np.ones((128, 128), np.float32) for k in "ab"}
    per = params["a"].nbytes
    budget_gb = (per + per // 2) / 1024**3  # fits exactly 1
    seq = [("t0", ("a",)), ("t1", ("b",))]
    js, ts, node = _mk_streamers(params, budget_gb, seq, lookahead=1)
    js.get_task("t0", node, [("a", "a")])
    ts.get_task("t0", node, [("a", "a")])
    assert set(ts.resident[node]) == {"a"}
    assert ts.peak[node] <= int(budget_gb * 1024**3)
    _same(js, ts, node)


def test_duplicate_global_loads_once():
    """Two local names aliasing one global load and count it once."""
    params = {"w": np.ones((64, 64), np.float32)}
    seq = [("t0", ("w", "w"))]
    js, ts, node = _mk_streamers(params, 1.0, seq, lookahead=0)
    js.get_task("t0", node, [("a", "w"), ("b", "w")])
    pd = ts.get_task("t0", node, [("a", "w"), ("b", "w")])
    assert pd["a"] is pd["b"]
    assert ts.loads == 1
    assert ts.bytes[node] == params["w"].nbytes
    _same(js, ts, node)


def test_streamer_counts_qparam_leaves_as_jax():
    """An int8 QParam loads as one unit and counts its int8 values plus
    its float32 scales, as the JAX streamer counts the pytree's leaves."""
    from distributed_llm_scheduler_tpu.utils.quantize import (
        quantize_array as jq,
    )
    from distributed_llm_scheduler_tpu_torch.utils.quantize import (
        quantize_array as tq,
    )

    w = np.random.default_rng(0).standard_normal((64, 96)).astype(np.float32)
    seq = [("t0", ("w",))]
    jc = J.Cluster.from_jax_devices(jax.devices()[:1], hbm_cap_gb=1.0)
    tc = P.Cluster.from_torch_devices([CPU], hbm_cap_gb=1.0)
    node = tc.devices[0].node_id
    js = JaxBackend._ParamStreamer(jc, {"w": jq(w)}, plan={node: seq})
    ts = P.DeviceBackend._ParamStreamer(tc, {"w": tq(torch.from_numpy(w))},
                                        plan={node: seq})
    js.get_task("t0", node, [("w", "w")])
    ts.get_task("t0", node, [("w", "w")])
    assert ts.load_bytes == js.load_bytes == 64 * 96 + 96 * 4
    _same(js, ts, node)


@pytest.mark.parametrize("shape,failed", [
    (dict(batch=8, seq_len=512, microbatches=8, vocab_shards=8),
     ["output_concat"]),
    (dict(batch=1, seq_len=512, vocab_shards=8), []),
], ids=["batch8", "batch1"])
def test_mru_headline_fails_as_jax(shape, failed):
    """chip_smoke.py's mru headline (GPT-2 small bf16, fused chains, one
    node at 0.35 of the params): at batch 8 both packages' ``mru`` fail
    the same task, the 0.41 GB ``output_concat`` of the microbatches'
    logits, which no budget of 0.35 of the params holds; at batch 1 both
    place every task, on the same order."""
    from distributed_llm_scheduler_tpu.core.fusion import (
        fuse_linear_chains as jax_fuse,
    )

    jg = jax_fuse(jax_build(JaxConfig.small(dtype=jnp.bfloat16),
                            **shape).graph)
    tg = P.fuse_linear_chains(P.build_gpt2_dag(
        P.GPT2Config.small(dtype=torch.bfloat16), **shape).graph)
    cap = 0.35 * tg.total_param_gb()
    js = J.get_scheduler("mru").schedule(
        jg, J.Cluster.from_jax_devices(jax.devices()[:1], hbm_cap_gb=cap))
    ts = P.get_scheduler("mru").schedule(
        tg, P.Cluster.from_torch_devices([CPU], hbm_cap_gb=cap))
    assert sorted(ts.failed) == sorted(js.failed) == failed
    assert ts.per_node == js.per_node
