"""Segment-fused execution of the port (``execute(segments=True)``) against
the JAX package's.

``build_segments`` is pure Python: its (node, tids, exports) triples must
be *equal* to the JAX package's on equal schedules.  The segmented output
is held against the port's fused forward at 2e-4, the repo's placed-vs-
fused tolerance (``__graft_entry__.py:336-342``); it makes at most as many
host calls as the per-task path, and counts the transfers the JAX
segmented run counts (cross-segment inputs deduplicated per segment).  On
the CPU a segment runs eagerly; on a card it is a captured CUDA graph
(``tests/test_torch_cuda.py``).
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

CPU = torch.device("cpu")
RTOL = ATOL = 2e-4
KW = dict(batch=4, seq_len=32, microbatches=2, vocab_shards=4)


@pytest.fixture(scope="module")
def tiny():
    jdag = jax_build(JaxConfig.tiny(), **KW)
    tdag = P.build_gpt2_dag(P.GPT2Config.tiny(), **KW)
    jparams = jdag.init_params()
    tparams = P.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, CPU)
    ids = np.random.default_rng(3).integers(0, 512, (4, 32), dtype=np.int32)
    return dict(
        jdag=jdag, tdag=tdag, jparams=jparams, tparams=tparams, ids=ids,
        jg=J.fuse_linear_chains(jdag.graph),
        tg=P.fuse_linear_chains(tdag.graph),
    )


def placed(tiny, policy, n, fused=True):
    jg, tg = (tiny["jg"], tiny["tg"]) if fused else (
        tiny["jdag"].graph, tiny["tdag"].graph)
    jc = J.Cluster.from_jax_devices(jax.devices()[:n], hbm_cap_gb=4.0)
    tc = P.Cluster.from_torch_devices([CPU] * n, hbm_cap_gb=4.0)
    js = J.get_scheduler(policy).schedule(jg, jc)
    ts = P.get_scheduler(policy).schedule(tg, tc)
    assert ts.per_node == js.per_node and not ts.failed
    return jg, tg, jc, tc, js, ts


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("policy,n", [("greedy", 1), ("roundrobin", 8),
                                      ("pipeline", 4), ("heft", 8),
                                      ("pack", 8)])
def test_build_segments_equals_jax(tiny, policy, n, fused):
    jg, tg, _, _, js, ts = placed(tiny, policy, n, fused)
    order = P.DeviceBackend.dispatch_order(tg, ts)
    assert order == JaxBackend.dispatch_order(jg, js)
    segs = P.DeviceBackend.build_segments(tg, ts, order)
    assert segs == JaxBackend.build_segments(jg, js, order)
    assert [t for _n, tids, _e in segs for t in tids] == order
    if n == 1:
        assert len(segs) == 1


@pytest.mark.parametrize("rebatch", [True, False])
@pytest.mark.parametrize("policy,n", [("greedy", 1), ("roundrobin", 8),
                                      ("pipeline", 4), ("heft", 8)])
def test_segmented_meets_fused_and_counts_as_jax(tiny, policy, n, rebatch):
    jg, tg, jc, tc, js, ts = placed(tiny, policy, n)
    tin = torch.from_numpy(tiny["ids"])
    backend = P.DeviceBackend(tc)
    rep = backend.execute(tg, ts, tiny["tparams"], tin, segments=True,
                          rebatch=rebatch)
    per_task = backend.execute(tg, ts, tiny["tparams"], tin, planned=False)
    fused = tiny["tdag"].reference_forward(tiny["tparams"], tin).numpy()
    np.testing.assert_allclose(rep.output.numpy(), fused, rtol=RTOL, atol=ATOL)
    assert rep.n_dispatches <= per_task.n_dispatches
    assert not rep.planned and not rep.compiled
    assert rep.captured_launches == {}  # the CPU captures nothing
    jrep = JaxBackend(jc, pre_analysis=False).execute(
        jg, js, tiny["jparams"], jnp.asarray(tiny["ids"]), segments=True,
        rebatch=rebatch)
    assert (rep.transfer_edges, rep.transfer_bytes, rep.n_dispatches) == (
        jrep.transfer_edges, jrep.transfer_bytes, jrep.n_dispatches)
    assert rep.transfer_edges <= per_task.transfer_edges
    if n == 1:
        assert rep.n_dispatches == 1


def test_segments_keep_their_exports(tiny):
    jg, tg, jc, tc, js, ts = placed(tiny, "roundrobin", 8)
    tin = torch.from_numpy(tiny["ids"])
    rep = P.DeviceBackend(tc).execute(tg, ts, tiny["tparams"], tin,
                                      segments=True, keep_outputs=True)
    jrep = JaxBackend(jc, pre_analysis=False).execute(
        jg, js, tiny["jparams"], jnp.asarray(tiny["ids"]), segments=True,
        keep_outputs=True)
    assert sorted(rep.task_outputs) == sorted(jrep.task_outputs)


def test_segments_refuse_profile(tiny):
    _, tg, _, tc, _, ts = placed(tiny, "greedy", 1)
    with pytest.raises(ValueError, match="needs per-task dispatch"):
        P.DeviceBackend(tc).execute(tg, ts, tiny["tparams"],
                                    torch.from_numpy(tiny["ids"]),
                                    segments=True, profile=True)


@pytest.mark.parametrize("rebatch", [True, False])
def test_segment_programs_are_cached_whole_and_match_each_segment(tiny, rebatch):
    """On the CPU each segment's program is its plain function, and the
    list is cached as one entry per (graph, segments, rebatch, params):
    on a card the programs of one node share a memory pool, which is safe
    only while they replay together in capture order."""
    _, tg, _, tc, _, ts = placed(tiny, "heft", 8)
    backend = P.DeviceBackend(tc)
    placed_params, _ = backend.place_params(tg, ts, tiny["tparams"])
    segs = backend.build_segments(tg, ts, backend.dispatch_order(tg, ts))
    fns = backend._segment_programs(tg, segs, rebatch, placed_params)
    assert len(fns) == len(segs) > 1
    assert backend._segment_programs(tg, segs, rebatch, placed_params) is fns
    assert len(backend._seg_cache[tg]) == 1
    # each program alone gives its exports as the planned run computes them
    keep = backend.execute(tg, ts, tiny["tparams"],
                           torch.from_numpy(tiny["ids"]), keep_outputs=True)
    vals = dict(keep.task_outputs, __input__=torch.from_numpy(tiny["ids"]))
    for (node, tids, exports), fn in zip(segs, fns):
        union = {g: placed_params[(g, node)]
                 for t in tids for _, g in tg[t].param_items()}
        ext = {d: vals[d] for t in tids
               for d in (tg[t].arg_tasks or tg[t].dependencies)
               if d not in tids}
        if any(not (tg[t].arg_tasks or tg[t].dependencies) for t in tids):
            ext["__input__"] = vals["__input__"]
        out = fn(union, ext)
        assert sorted(out) == sorted(exports)
        for t in exports:
            np.testing.assert_allclose(out[t].numpy(), vals[t].numpy(),
                                       rtol=RTOL, atol=ATOL)
