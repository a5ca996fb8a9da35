"""The port's segment re-batching (``backends/rebatch.py``) against the JAX
package's.

The plan is pure Python over equal graphs, so ``plan_rebatch``'s units,
classes, argument sources, passthrough marks and sizes must be *equal* to
the JAX plan's, segment by segment, on one node and on placements over
several.  The rebatched segment output is held at ``tests/
test_rebatch.py``'s tolerance (2e-5) against the JAX segmented run, the
port's fused forward and the port's unbatched segment.  Eager PyTorch does
not elide a concat of slices, so a class argument marked as a producer
class's members in order must reach the fn without a ``torch.cat``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu.backends import rebatch as JR
from distributed_llm_scheduler_tpu.backends.device import (
    DeviceBackend as JaxBackend,
)
from distributed_llm_scheduler_tpu.frontend.gpt2_dag import (
    build_gpt2_dag as jax_build,
)
from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config as JaxConfig
from distributed_llm_scheduler_tpu_torch.backends import rebatch as TR

CPU = torch.device("cpu")
TOL = 2e-5
KW = dict(batch=8, seq_len=32, microbatches=8, vocab_shards=4)


@pytest.fixture(scope="module")
def mb():
    jdag = jax_build(JaxConfig.tiny(), **KW)
    tdag = P.build_gpt2_dag(P.GPT2Config.tiny(), **KW)
    jg = J.fuse_linear_chains(jdag.graph)
    tg = P.fuse_linear_chains(tdag.graph)
    jparams = jdag.init_params()
    tparams = P.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, CPU)
    ids = np.random.default_rng(11).integers(0, 512, (8, 32), dtype=np.int32)
    return dict(jdag=jdag, tdag=tdag, jg=jg, tg=tg, jparams=jparams,
                tparams=tparams, ids=ids)


def segments(mb, policy, n):
    jc = J.Cluster.from_jax_devices(jax.devices()[:n], hbm_cap_gb=4.0)
    tc = P.Cluster.from_torch_devices([CPU] * n, hbm_cap_gb=4.0)
    js = J.get_scheduler(policy).schedule(mb["jg"], jc)
    ts = P.get_scheduler(policy).schedule(mb["tg"], tc)
    assert ts.per_node == js.per_node and not ts.failed
    jsegs = JaxBackend.build_segments(
        mb["jg"], js, JaxBackend.dispatch_order(mb["jg"], js))
    tsegs = P.DeviceBackend.build_segments(
        mb["tg"], ts, P.DeviceBackend.dispatch_order(mb["tg"], ts))
    assert tsegs == jsegs
    return jc, tc, js, ts, tsegs


def plan_fields(plan):
    return (plan.units, plan.classes, plan.arg_sources, plan.arg_class,
            plan.sizes, plan.n_batched_tasks)


@pytest.mark.parametrize("policy,n", [("greedy", 1), ("pipeline", 4),
                                      ("roundrobin", 4), ("heft", 4)])
def test_plans_equal_jax_segment_by_segment(mb, policy, n):
    *_, segs = segments(mb, policy, n)
    batched = 0
    for _node, tids, _exports in segs:
        tplan = TR.plan_rebatch(mb["tg"], tids)
        assert plan_fields(tplan) == plan_fields(
            JR.plan_rebatch(mb["jg"], tids))
        batched += tplan.n_batched_tasks
    if n == 1:
        assert batched >= len(mb["tg"]) * 2 // 3
        assert all(len(c) == 8 for c in tplan.classes)


def test_extract_steps_equal_jax(mb):
    tids = mb["tg"].topo_order[:12]
    strip = lambda steps: [(t, pitems, aids) for t, _fn, pitems, aids in steps]
    assert strip(TR.extract_steps(mb["tg"], tids)) == strip(
        JR.extract_steps(mb["jg"], tids))


@pytest.mark.parametrize("policy,n", [("greedy", 1), ("pipeline", 4),
                                      ("roundrobin", 4)])
def test_rebatched_segments_close_to_jax_and_fused(mb, policy, n):
    jc, tc, js, ts, _ = segments(mb, policy, n)
    tin = torch.from_numpy(mb["ids"])
    tb = P.DeviceBackend(tc)
    rep = tb.execute(mb["tg"], ts, mb["tparams"], tin, segments=True)
    jrep = JaxBackend(jc, pre_analysis=False).execute(
        mb["jg"], js, mb["jparams"], jnp.asarray(mb["ids"]), segments=True)
    got = rep.output.numpy()
    np.testing.assert_allclose(got, np.asarray(jrep.output), rtol=TOL, atol=TOL)
    fused = mb["tdag"].reference_forward(mb["tparams"], tin).numpy()
    np.testing.assert_allclose(got, fused, rtol=TOL, atol=TOL)
    rep0 = tb.execute(mb["tg"], ts, mb["tparams"], tin, segments=True,
                      rebatch=False)
    np.testing.assert_allclose(got, rep0.output.numpy(), rtol=TOL, atol=TOL)
    assert rep.n_dispatches == jrep.n_dispatches


def test_batched_arguments_pass_straight_through(mb, monkeypatch):
    """One segment on one node: every class argument the plan marks as a
    producer class's members (``arg_class``) reaches the fn as the batched
    tensor itself; only the unmarked ones, and the concat tasks that are
    not a class's members in order, concatenate along axis 0."""
    *_, segs = segments(mb, "greedy", 1)
    (node, tids, exports), = segs
    plan = TR.plan_rebatch(mb["tg"], tids)
    marked = sum(c is not None for row in plan.arg_class for c in row)
    unmarked = sum(c is None for ci, row in enumerate(plan.arg_class)
                   for c in row if plan.arg_sources[ci])
    assert marked > 0
    fn = TR.build_rebatched_seg_fn(mb["tg"], tids, exports, plan)
    union = {g: mb["tparams"][g] for t in tids
             for _, g in mb["tg"][t].param_items()}
    ext = {"__input__": torch.from_numpy(mb["ids"])}
    cats = []
    real_cat = torch.cat

    def counting_cat(tensors, dim=0, **kw):
        if dim == 0:
            cats.append(len(tensors))
        return real_cat(tensors, dim=dim, **kw)

    monkeypatch.setattr(torch, "cat", counting_cat)
    with torch.no_grad():
        out = fn(union, ext)
    monkeypatch.setattr(torch, "cat", real_cat)
    # the output concat of the 8 microbatches is a passthrough too
    assert len(cats) == unmarked
    want = mb["tdag"].reference_forward(mb["tparams"], ext["__input__"])
    np.testing.assert_allclose(out[mb["tg"].topo_order[-1]].numpy(),
                               want.numpy(), rtol=TOL, atol=TOL)


def test_no_siblings_degrade_to_the_linear_program():
    kw = dict(batch=2, seq_len=16)
    tg = P.fuse_linear_chains(P.build_gpt2_dag(P.GPT2Config.tiny(), **kw).graph)
    jg = J.fuse_linear_chains(jax_build(JaxConfig.tiny(), **kw).graph)
    tids = tuple(tg.topo_order)
    assert TR.plan_rebatch(tg, tids).classes == ()
    assert plan_fields(TR.plan_rebatch(tg, tids)) == plan_fields(
        JR.plan_rebatch(jg, tids))
