"""The port's planned dispatch (``backends/dispatch_plan.py``) against the
JAX package's.

On the tiny GPT-2 DAG (2 microbatches, 2 vocab shards) placed round-robin
on 8 nodes (8 CPU nodes in the port, the 8-device CPU mesh in JAX):

* the plan's steps, slots and transfer count, and the coalesced order, are
  *equal* to the JAX plan's (the same ``_relinearize``);
* fail-and-continue drops the same tasks;
* planned and coalesced outputs are equal bit for bit to the port's own
  per-task path, and allclose at 2e-4 (the repo's placed-vs-fused
  tolerance) to the JAX planned run;
* every value the JAX plan donates is released by the port's plan at the
  same step (release after the last consumer is the port's counterpart of
  donation), and nothing the run still needs is released;
* ``keep_outputs`` and ``ext_outputs`` behave as the JAX ones do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu.backends import dispatch_plan as JD
from distributed_llm_scheduler_tpu.backends.device import (
    DeviceBackend as JaxBackend,
)
from distributed_llm_scheduler_tpu.frontend.gpt2_dag import (
    build_gpt2_dag as jax_build,
)
from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config as JaxConfig
from distributed_llm_scheduler_tpu_torch.backends import dispatch_plan as TD

CPU = torch.device("cpu")
RTOL = ATOL = 2e-4
KW = dict(batch=2, seq_len=16, microbatches=2, vocab_shards=2)


@pytest.fixture(scope="module", params=[("roundrobin", 8), ("heft", 2)],
                ids=["roundrobin-x8", "heft-x2"])
def pair(request):
    policy, n = request.param
    jdag = jax_build(JaxConfig.tiny(), **KW)
    tdag = P.build_gpt2_dag(P.GPT2Config.tiny(), **KW)
    jg, tg = jdag.graph.freeze(), tdag.graph.freeze()
    jparams = jdag.init_params()
    tparams = P.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, CPU)
    ids = np.random.default_rng(5).integers(0, 512, (2, 16), dtype=np.int32)
    jc = J.Cluster.from_jax_devices(jax.devices()[:n], hbm_cap_gb=4.0)
    tc = P.Cluster.from_torch_devices([CPU] * n, hbm_cap_gb=4.0)
    js = J.get_scheduler(policy).schedule(jg, jc)
    ts = P.get_scheduler(policy).schedule(tg, tc)
    assert ts.per_node == js.per_node and not ts.failed
    return dict(jg=jg, tg=tg, jparams=jparams, tparams=tparams, ids=ids,
                jb=JaxBackend(jc, pre_analysis=False), tb=P.DeviceBackend(tc),
                js=js, ts=ts, policy=policy)


def plans(pair, js=None, ts=None, ext=(), **kw):
    js, ts = js or pair["js"], ts or pair["ts"]
    jb, tb = pair["jb"], pair["tb"]
    jplaced, _ = jb.place_params(pair["jg"], js, pair["jparams"])
    tplaced, _ = tb.place_params(pair["tg"], ts, pair["tparams"])
    jplan = JD.DispatchPlan.build(
        jb, pair["jg"], js, jb.dispatch_order(pair["jg"], js), jplaced,
        ext_keys=ext, **kw)
    tkw = {k: v for k, v in kw.items() if k != "donate"}
    tplan = TD.DispatchPlan.build(
        tb, pair["tg"], ts, tb.dispatch_order(pair["tg"], ts), tplaced,
        ext_keys=ext, **tkw)
    return jplan, tplan


def layout(plan):
    edges = lambda st: (len(st.xfer_pos) if isinstance(st, TD.PlanStep)
                        else st.n_edges)
    return (
        [(st.tids, st.node_id, st.arg_slots, st.out_slots, edges(st))
         for st in plan.steps],
        plan.n_slots, plan.ext_slots, plan.final_slot, plan.keep_list,
        tuple((n, s) for n, _d, s in plan.input_slots), plan.transfer_edges,
    )


@pytest.mark.parametrize("kw", [dict(), dict(coalesce=True),
                                dict(keep_outputs=True),
                                dict(coalesce=True, keep_outputs=True)],
                         ids=["plain", "coalesce", "keep", "coalesce-keep"])
def test_plan_layout_equals_jax(pair, kw):
    jplan, tplan = plans(pair, **kw)
    assert layout(tplan) == layout(jplan)
    assert tplan.n_launches == jplan.n_launches
    if kw.get("coalesce"):
        assert tplan.n_launches < len(pair["tg"])


def test_coalesced_order_equals_jax_relinearize(pair):
    tg, ts = pair["tg"], pair["ts"]
    alive = P.DeviceBackend.dispatch_order(tg, ts)
    got = TD._relinearize(tg, ts, alive, set())
    assert got == JD._relinearize(pair["jg"], pair["js"], alive, set())
    assert sorted(got) == sorted(alive) and got != alive
    _, tplan = plans(pair, coalesce=True)
    assert [t for st in tplan.steps for t in st.tids] == got


def without(s, victim):
    per_node = {n: [t for t in lst if t != victim]
                for n, lst in s.per_node.items()}
    return type(s)(policy=s.policy, per_node=per_node,
                   assignment_order=[t for t in s.assignment_order
                                     if t != victim])


def test_fail_and_continue_drops_the_same_tasks(pair):
    victim = "mb1_layer_0_ln1"
    js, ts = without(pair["js"], victim), without(pair["ts"], victim)
    jplan, tplan = plans(pair, js=js, ts=ts)
    assert layout(tplan) == layout(jplan)
    ran = {t for st in tplan.steps for t in st.tids}
    tg = pair["tg"]
    lost = {victim}
    for t in tg.topo_order:
        if any(d in lost for d in tg[t].dependencies):
            lost.add(t)
    assert ran == set(tg.task_ids()) - lost
    assert any(t.startswith("mb1_") for t in ran) and len(lost) > 10
    assert tplan.final_slot is None  # the concat lost its second input


def test_release_covers_every_jax_donation(pair):
    jplan, tplan = plans(pair, donate=True)
    donated = [(st.tids, t) for st in jplan.steps for t in st.donate_tids]
    # round-robin puts nearly every edge across nodes, and the reference
    # donates a dying value only to a consumer on its own device
    if pair["policy"] == "heft":
        assert donated, "the JAX plan donates nothing: the test is vacuous"
    table = tplan.donation_table()
    released = {(st["tids"], tplan.tid_of_slot[s]) for st in table["steps"]
                for s in st["donate_slots"]}
    assert set(donated) <= released


@pytest.mark.parametrize("kw", [dict(), dict(coalesce=True)],
                         ids=["plain", "coalesce"])
def test_release_never_drops_a_value_still_needed(pair, kw):
    _, tplan = plans(pair, **kw)
    table = tplan.donation_table()
    protected = ({table["final_slot"]} | {s for _k, s in table["ext_slots"]}
                 | {s for _n, s in table["input_slots"]})
    steps = table["steps"]
    gone = set()
    for i, st in enumerate(steps):
        assert not set(st["arg_slots"]) & gone, i
        for s in st["donate_slots"]:
            assert s not in protected
            assert all(s not in later["arg_slots"] for later in steps[i + 1:])
        gone |= set(st["donate_slots"])
    # every exported value but the final output is released
    outs = {s for st in steps for s in st["out_slots"]}
    assert gone == outs - {table["final_slot"]}


@pytest.mark.parametrize("kw", [dict(), dict(coalesce=True)],
                         ids=["plain", "coalesce"])
def test_a_release_of_a_value_still_read_is_refused(pair, kw):
    """The donation pass reads what the plan drops: the plan's own releases
    pass, and a value moved to be dropped at the step that writes it is
    refused at every later read (DON003 where the read is a transfer from
    another node, DON001 else)."""
    from distributed_llm_scheduler_tpu_torch.analysis import analyze_donation

    _, tplan = plans(pair, **kw)
    assert analyze_donation(tplan).diagnostics == []
    producer = {s: i for i, st in enumerate(tplan.steps) for s in st.out_slots}
    gi, s = next((i, s) for i, st in enumerate(tplan.steps)
                 for s in st.release if producer[s] != i)
    pi = producer[s]
    readers = [i for i, st in enumerate(tplan.steps)
               if i > pi and s in st.arg_slots]
    assert readers and readers[-1] == gi
    tplan.steps[gi].release = tuple(x for x in tplan.steps[gi].release
                                    if x != s)
    tplan.steps[pi].release += (s,)
    rep = analyze_donation(tplan)
    want = ["DON003" if s in {tplan.steps[i].arg_slots[p]
                              for p in tplan.steps[i].xfer_pos}
            and tplan.steps[i].node_id != tplan.steps[pi].node_id
            else "DON001" for i in readers]
    assert [d.code for d in rep.diagnostics] == want
    assert [d.data["reader"] for d in rep.diagnostics] == readers
    assert not rep.ok


@pytest.fixture(scope="module")
def runs(pair):
    tb, jb = pair["tb"], pair["jb"]
    tin = torch.from_numpy(pair["ids"])
    out = {}
    out["per_task"] = tb.execute(pair["tg"], pair["ts"], pair["tparams"], tin,
                                 planned=False)
    for name, kw in (("planned", {}), ("coalesce", dict(coalesce=True))):
        out[name] = tb.execute(pair["tg"], pair["ts"], pair["tparams"], tin,
                               **kw)
    out["jax"] = jb.execute(pair["jg"], pair["js"], pair["jparams"],
                            jnp.asarray(pair["ids"]))
    return out


@pytest.mark.parametrize("name", ["planned", "coalesce"])
def test_planned_outputs_bit_equal_per_task_and_close_to_jax(runs, name):
    rep, base, jrep = runs[name], runs["per_task"], runs["jax"]
    assert rep.planned and not base.planned and jrep.planned
    assert torch.equal(rep.output, base.output)
    np.testing.assert_allclose(rep.output.numpy(), np.asarray(jrep.output),
                               rtol=RTOL, atol=ATOL)
    assert rep.transfer_edges == base.transfer_edges == jrep.transfer_edges
    assert rep.transfer_bytes == base.transfer_bytes == jrep.transfer_bytes
    assert rep.n_dispatches == jrep.n_dispatches or name == "coalesce"


def test_keep_outputs_keys_equal_jax(pair):
    tin = torch.from_numpy(pair["ids"])
    for planned in (False, True):
        rep = pair["tb"].execute(pair["tg"], pair["ts"], pair["tparams"], tin,
                                 planned=planned, keep_outputs=True)
        jrep = pair["jb"].execute(pair["jg"], pair["js"], pair["jparams"],
                                  jnp.asarray(pair["ids"]), planned=planned,
                                  keep_outputs=True)
        assert sorted(rep.task_outputs) == sorted(jrep.task_outputs)
        assert len(rep.task_outputs) == len(pair["tg"])
        for t, v in rep.task_outputs.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jrep.task_outputs[t]),
                                       rtol=RTOL, atol=ATOL)
    plain = pair["tb"].execute(pair["tg"], pair["ts"], pair["tparams"], tin)
    assert plain.task_outputs == {}


@pytest.mark.parametrize("planned", [False, True])
def test_ext_outputs_seed_a_remainder_as_jax(pair, planned):
    """The elastic-recovery shape: a task that already ran is taken out of
    the schedule and its output passed in; consumers read it as a
    transfer."""
    victim = "mb0_layer_1_attention"
    tin = torch.from_numpy(pair["ids"])
    full = pair["tb"].execute(pair["tg"], pair["ts"], pair["tparams"], tin,
                              keep_outputs=True)
    js, ts = without(pair["js"], victim), without(pair["ts"], victim)
    tval = full.task_outputs[victim]
    rep = pair["tb"].execute(pair["tg"], ts, pair["tparams"], tin,
                             planned=planned, ext_outputs={victim: tval})
    jrep = pair["jb"].execute(pair["jg"], js, pair["jparams"],
                              jnp.asarray(pair["ids"]), planned=planned,
                              ext_outputs={victim: jnp.asarray(tval.numpy())})
    assert torch.equal(rep.output, full.output)
    np.testing.assert_allclose(rep.output.numpy(), np.asarray(jrep.output),
                               rtol=RTOL, atol=ATOL)
    assert (rep.transfer_edges, rep.transfer_bytes) == (
        jrep.transfer_edges, jrep.transfer_bytes)
    assert rep.n_dispatches == jrep.n_dispatches == len(pair["tg"]) - 1


def test_plan_is_deterministic(pair):
    a, b = plans(pair, coalesce=True)[1], plans(pair, coalesce=True)[1]
    assert a.donation_table() == b.donation_table()
    assert layout(a) == layout(b)


def test_flag_validation_matches_jax(pair):
    tin = torch.from_numpy(pair["ids"])
    args = (pair["tg"], pair["ts"], pair["tparams"], tin)
    with pytest.raises(ValueError, match="coalesce=True requires"):
        pair["tb"].execute(*args, planned=False, coalesce=True)
    with pytest.raises(ValueError, match="incompatible with profile"):
        pair["tb"].execute(*args, planned=True, profile=True)
    with pytest.raises(ValueError, match="incompatible with profile"):
        pair["tb"].execute(*args, planned=True, segments=True)
    with pytest.raises(ValueError, match="incompatible with profile"):
        pair["tb"].execute(*args, planned=True, stream_params=True)
    # stream_params turns the plan off, as in JAX
    assert not pair["tb"].execute(*args, stream_params=True).planned
    # profile turns the plan off, as in JAX
    assert not pair["tb"].execute(*args, profile=True).planned
