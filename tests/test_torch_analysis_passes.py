"""The port's graph, pipeline, decode, collective, donation, happens-before
and typecheck passes against the JAX package's, on the JAX package's own
fixtures (``tests/test_analysis.py``, ``tests/test_typecheck.py``).

Each fixture is built once per package from the same description and run
through both packages' pass; the contract is equality of the diagnostics,
compared as (code, severity, task, node, param, message, data).  Two
differences are by design and pinned on their own: TYP001's message ends
with the first line of the framework's own error (JAX's text there,
torch's here), and DEC005/DEC006 quote the port's kernel rules
(``ops.attention.paged_kernel_constraints`` of the Hopper kernels).
"""

import types

import jax
import jax.numpy as jnp
import pytest
import torch

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu import analysis as JA
from distributed_llm_scheduler_tpu.analysis import typecheck_pass as JT
from distributed_llm_scheduler_tpu.core.schedule import Schedule as JSchedule
from distributed_llm_scheduler_tpu.sched import linearize as JL
from distributed_llm_scheduler_tpu.utils.quantize import QParam as JQ
from distributed_llm_scheduler_tpu_torch import analysis as PA
from distributed_llm_scheduler_tpu_torch.analysis import typecheck_pass as PT
from distributed_llm_scheduler_tpu_torch.core.schedule import Schedule as PSchedule
from distributed_llm_scheduler_tpu_torch.sched import linearize as PL
from distributed_llm_scheduler_tpu_torch.utils.quantize import QParam as PQ

_JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8,
       "int32": jnp.int32}
_PD = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "int8": torch.int8, "int32": torch.int32}


def _ns(pkg, A, T, L, Sched, Q, spec, ones):
    return types.SimpleNamespace(
        Task=pkg.Task, TaskGraph=pkg.TaskGraph, Cluster=pkg.Cluster,
        DeviceState=pkg.DeviceState, A=A, T=T, L=L, Q=Q, spec=spec,
        ones=ones, get_scheduler=pkg.get_scheduler,
        sched=lambda per_node, order=None, completed=None: Sched(
            policy="manual", per_node=per_node,
            assignment_order=(order if order is not None else
                              [t for ts in per_node.values() for t in ts]),
            completed=(completed if completed is not None else
                       set(t for ts in per_node.values() for t in ts))),
    )


JNS = _ns(J, JA, JT, JL, JSchedule, JQ,
          lambda shape, dt="float32": jax.ShapeDtypeStruct(shape, _JD[dt]),
          lambda x, shape: jnp.ones(shape, jnp.float32))
PNS = _ns(P, PA, PT, PL, PSchedule, PQ,
          lambda shape, dt="float32": torch.empty(
              shape, dtype=_PD[dt], device="meta"),
          lambda x, shape: torch.ones(shape, device=x.device))


def fields(rep):
    return [
        (d.code, int(d.severity), d.task, d.node, d.param, d.message,
         d.data)
        for d in rep.diagnostics
    ]


def two_caps(ns, cap0=1.0, cap1=1.0):
    return ns.Cluster([ns.DeviceState("n0", cap0), ns.DeviceState("n1", cap1)])


# -- the fixtures: name -> (pkg namespace -> list of reports) ----------------

def graph_cycle(ns):
    g = ns.TaskGraph([
        ns.Task("a", 1.0, 1.0, ["c"], set()),
        ns.Task("b", 1.0, 1.0, ["a"], set()),
        ns.Task("c", 1.0, 1.0, ["b"], set()),
        ns.Task("waiter", 1.0, 1.0, ["c"], set()),
    ])
    return [ns.A.analyze_graph(g)]


def graph_dangling_duplicate_negative(ns):
    g = ns.TaskGraph([
        ns.Task("a", -1.0, 1.0, ["ghost"], set()),
        ns.Task("b", 1.0, 1.0, ["a", "a"], set()),
    ])
    return [ns.A.analyze_graph(g)]


def graph_param_sizes(ns):
    g = ns.TaskGraph([
        ns.Task("a", 1.0, 1.0, [], {"p", "q"}, param_bytes={"p": 100}),
        ns.Task("b", 1.0, 1.0, ["a"], {"p"}, param_bytes={"p": 200}),
    ])
    clean = ns.TaskGraph([ns.Task("a", 1.0, 1.0, [], {"p"})])
    return [ns.A.analyze_graph(g), ns.A.analyze_graph(clean)]


def chain4(ns):
    return ns.TaskGraph([
        ns.Task("t1", 0.1, 1.0, [], set()),
        ns.Task("t2", 0.1, 1.0, ["t1"], set()),
        ns.Task("t3", 0.1, 1.0, [], set()),
        ns.Task("t4", 0.1, 1.0, ["t3"], set()),
    ]).freeze()


def pipeline_cases(ns):
    return [
        ns.A.analyze_pipeline(chain4(ns), ns.sched(per_node))
        for per_node in (
            {"n0": ["t4", "t1"], "n1": ["t2", "t3"]},   # PIP002 deadlock
            {"n0": ["t2", "t1"], "n1": ["t3", "t4"]},   # PIP001 inversion
            {"n0": ["t1", "t3"], "n1": ["t2", "t4"]},   # wrapped: clean
        )
    ]


def decode_graph(ns, pool_bytes_1=1024):
    pb = {"page_table": 64}
    return ns.TaskGraph([
        ns.Task("embed", 0.1, 1.0, [], set()),
        ns.Task("l0", 0.1, 1.0, ["embed"], {"cache_k_0", "page_table"},
                param_bytes={"cache_k_0": 1024, **pb}),
        ns.Task("l1", 0.1, 1.0, ["l0"], {"cache_k_1", "page_table"},
                param_bytes={"cache_k_1": pool_bytes_1, **pb}),
        ns.Task("logits", 0.1, 1.0, ["l1"], set()),
    ])


def decode_cases(ns):
    alias = ns.TaskGraph([
        ns.Task("l0", 0.1, 1.0, [], {"cache_k_0"},
                param_bytes={"cache_k_0": 1024}),
        ns.Task("l1", 0.1, 1.0, ["l0"], {"cache_k_0"},
                param_bytes={"cache_k_0": 1024}),
    ])
    wiring = ns.TaskGraph([
        ns.Task("l0", 0.1, 1.0, [], {"cache_k_0"}),
        ns.Task("l1", 0.1, 1.0, ["l0"], {"page_table"}),
    ])
    return [
        ns.A.analyze_decode(ns.TaskGraph([ns.Task("a", 0.1, 1.0, [], {"w"})]),
                            two_caps(ns), ns.sched({"n0": ["a"]})),
        ns.A.analyze_decode(decode_graph(ns), two_caps(ns),
                            ns.sched({"n0": ["embed", "l0", "l1", "logits"]})),
        ns.A.analyze_decode(alias, two_caps(ns),
                            ns.sched({"n0": ["l0"], "n1": ["l1"]})),
        ns.A.analyze_decode(decode_graph(ns), two_caps(ns), ns.sched(
            {"n0": ["embed", "l0"], "n1": ["l1", "logits"]})),
        ns.A.analyze_decode(wiring),
        ns.A.analyze_decode(decode_graph(ns, pool_bytes_1=2048)),
    ]


def paged_dag_one_node(ns):
    if ns is JNS:
        from distributed_llm_scheduler_tpu.frontend.decode_dag import (
            build_paged_decode_dag,
        )
        from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config
    else:
        from distributed_llm_scheduler_tpu_torch.frontend.decode_dag import (
            build_paged_decode_dag,
        )
        from distributed_llm_scheduler_tpu_torch.models.gpt2 import GPT2Config
    dag = build_paged_decode_dag(GPT2Config.tiny(), slots=2, page_size=4,
                                 n_pages=8, pages_per_seq=4)
    cluster = ns.Cluster([ns.DeviceState("n0", 64.0)])
    s = ns.get_scheduler("greedy").schedule(dag.graph, cluster)
    return [ns.A.analyze_decode(dag.graph, cluster, s)]


def hb_cases(ns):
    A = ns.A
    reps = [A.analyze_happens_before(A.stage_programs_1f1b(S, M))
            for S, M in ((1, 2), (2, 4), (3, 6), (4, 8))]
    reps.append(A.analyze_happens_before({
        "stage0": [A.StageOp("recv", "stage1", "b"),
                   A.StageOp("compute", None, "x"),
                   A.StageOp("send", "stage1", "a")],
        "stage1": [A.StageOp("recv", "stage0", "a"),
                   A.StageOp("compute", None, "y"),
                   A.StageOp("send", "stage0", "b")],
    }))
    reps.append(A.analyze_happens_before({
        "stage0": [("send", "stage1", "a"), ("recv", "stage1", "b")],
        "stage1": [("send", "stage0", "b"), ("recv", "stage0", "a")],
    }))
    reps.append(A.analyze_happens_before({
        "stage0": [("send", "stage1", "f0"), ("send", "stage1", "f1")],
        "stage1": [("recv", "stage0", "f0")],
    }))
    reps.append(A.analyze_happens_before({
        "stage0": [("send", "stage1", "f0")],
        "stage1": [("recv", "stage0", "g0")],
    }))
    reps.append(A.analyze_happens_before({
        "stage0": [("collective", None, "ar1"), ("collective", None, "ar2")],
        "stage1": [("collective", None, "ar2"), ("collective", None, "ar1")],
    }))
    s0, s1 = [], []
    for m in range(4):
        s0 += [("compute", None, f"f{m}"), ("send", "stage1", f"f{m}"),
               ("recv", "stage1", f"g{m}"), ("compute", None, f"g{m}")]
        s1 += [("recv", "stage0", f"f{m}"), ("compute", None, f"f{m}"),
               ("compute", None, f"g{m}"), ("send", "stage0", f"g{m}")]
    reps.append(A.analyze_happens_before({"stage0": s0, "stage1": s1}))
    return reps


def _table(steps, **kw):
    base = {"steps": tuple(steps), "fence_slots": (), "final_slot": None,
            "keep_list": (), "ext_slots": (), "n_slots": 8}
    base.update(kw)
    return base


def _step(tid, node="d0", arg_slots=(), xfer_slots=(), donate_slots=(),
          out_slots=()):
    return {"tids": (tid,), "node_id": node, "arg_slots": tuple(arg_slots),
            "xfer_slots": tuple(xfer_slots),
            "donate_slots": tuple(donate_slots),
            "out_slots": tuple(out_slots)}


def donation_cases(ns):
    D = ns.A.analyze_donation
    one = [_step("a", arg_slots=(0,), donate_slots=(0,), out_slots=(1,))]
    clean = {"path": "mesh", "param_argnums": (0,),
             "input_argnums": (1, 2), "donated_argnums": (1, 2)}
    return [
        D(_table(one + [_step("b", arg_slots=(0, 1), out_slots=(2,))],
                 final_slot=2)),
        D(_table(one + [_step("b", arg_slots=(2,), donate_slots=(0,),
                              out_slots=(3,))])),
        D(_table([_step("a", arg_slots=(0,), donate_slots=(0, 0),
                        out_slots=(1,))])),
        D(_table([_step("a", node="d0", arg_slots=(0,), donate_slots=(0,),
                        out_slots=(1,)),
                  _step("b", node="d1", arg_slots=(0,), xfer_slots=(0,),
                        out_slots=(2,))])),
        D(_table(one, final_slot=0)),
        D(_table(one, fence_slots=(("d1", 0),))),
        D(_table(one, keep_list=(("t0", 0),))),
        D(_table(one, ext_slots=(("x", 0),))),
        D(_table([_step("a", arg_slots=(0, 0), donate_slots=(0,),
                        out_slots=(1,))])),
        D(_table(one + [_step("b", arg_slots=(1,), donate_slots=(1,),
                              out_slots=(2,))], final_slot=2)),
        D(clean),
        D({**clean, "donated_argnums": (0, 1)}),
        D({**clean, "donated_argnums": (1, 5)}),
    ]


def collective_cases(ns):
    C = ns.A.analyze_collectives
    return [
        C({"d0": [("ppermute", ((0, 1),), "a")],
           "d1": [("ppermute", ((1, 0),), "a")]}),
        C({"d0": [("ppermute", ((0, 1),), "a")], "d1": []}),
        C({"d0": [("ppermute", ((0, 1), (0, 1)), "v")],
           "d1": [("ppermute", ((0, 1), (0, 1)), "v")]}),
        C({"d0": [("ppermute", ((0, 3),), "v")],
           "d1": [("ppermute", ((0, 3),), "v")]}),
    ]


def _cycle_schedule(ns):
    g = ns.TaskGraph([
        ns.Task("a", 0.1, 0.1, []), ns.Task("b", 0.1, 0.1, []),
        ns.Task("c", 0.1, 0.1, ["b"]), ns.Task("d", 0.1, 0.1, ["a"]),
    ], name="cycle").freeze()
    s = ns.sched({"n0": ["c", "a"], "n1": ["d", "b"]},
                 order=["c", "d", "a", "b"])
    return g, s


def lowerability_cases(ns):
    g, s = _cycle_schedule(ns)
    rep, ir = ns.A.analyze_schedule_lowerability(g, s)
    assert ir is None
    return [rep]


def tf32(ns, *shape):
    return ns.spec(shape)


def typ001_cases(ns):
    T = ns.T
    g2 = ns.TaskGraph([
        ns.Task("a", 0.0, 1.0, [], set(), out_shape=tf32(ns, 4, 4)),
        ns.Task("b", 0.0, 1.0, ["a"], set(),
                fn=lambda p, x: x, out_shape=tf32(ns, 2, 2)),
    ]).freeze()
    g3 = ns.TaskGraph([
        ns.Task("a", 0.0, 1.0, [], set()),
        ns.Task("b", 0.0, 1.0, ["a"], set(), fn=lambda p, x: x),
        ns.Task("c", 0.0, 1.0, ["b"], set(), fn=lambda p, x: x),
    ]).freeze()
    return [T.analyze_typecheck(g2), T.analyze_typecheck(g3)]


def _qspec(ns, shape=(8, 8)):
    return ns.Q(ns.spec(shape, "int8"), ns.spec(shape[:-1] + (1,)))


def typ002_cases(ns):
    T = ns.T
    g1 = ns.TaskGraph([
        ns.Task("qt", 0.0, 1.0, [], {"w"}, out_shape=ns.spec((8, 8), "int8")),
        ns.Task("c", 0.0, 1.0, ["qt"], set()),
    ]).freeze()
    g2 = ns.TaskGraph([
        ns.Task("src", 0.0, 1.0, [], set(), out_shape=tf32(ns, 4)),
        ns.Task("qt", 0.0, 1.0, ["src"], {"w"},
                out_shape=ns.spec((4,), "bfloat16")),
    ]).freeze()
    g3 = ns.TaskGraph([
        ns.Task("ids", 0.0, 1.0, [], set(), out_shape=ns.spec((4,), "int32")),
        ns.Task("qt", 0.0, 1.0, ["ids"], {"w"},
                out_shape=ns.spec((4,), "bfloat16")),
    ]).freeze()
    q = {"w": _qspec(ns)}
    return [T.analyze_typecheck(g1, param_specs=q), T.analyze_typecheck(g1),
            T.analyze_typecheck(g2, param_specs=q),
            T.analyze_typecheck(g3, param_specs=q)]


def typ003_cases(ns):
    T = ns.T
    g = ns.TaskGraph([
        ns.Task("a", 1.0, 1.0, [], set(), out_shape=tf32(ns, 4, 4)),
        ns.Task("b", 0.0, 1.0, ["a"], set()),
    ]).freeze()
    s = ns.sched({"n0": ["a"], "n1": ["b"]})
    g2 = ns.TaskGraph([
        ns.Task("a", 1.0, 1.0, [], set(), out_shape=tf32(ns, 4, 4),
                out_bytes=64),
        ns.Task("b", 0.0, 1.0, ["a"], set()),
    ]).freeze()
    caps = two_caps(ns, 4.0, 4.0)
    return [T.analyze_typecheck(g, caps, s),
            T.analyze_typecheck(g, caps, ns.sched({"n0": ["a", "b"]})),
            T.analyze_typecheck(g2, caps, s)]


def typ004_cases(ns):
    L, T = ns.L, ns.T
    g = ns.TaskGraph([
        ns.Task("a", 0.0, 1.0, [], set()),
        ns.Task("b", 0.0, 1.0, ["a"], set()),
    ]).freeze()
    missing = L.ProgramIR(devices=("n0", "n1"), order=("a", "b"), phases=(
        L.Phase(0, {"n0": ("a",), "n1": ()}, ()),
        L.Phase(1, {"n0": (), "n1": ("b",)}, ()),
    ))
    g1 = ns.TaskGraph([ns.Task("a", 0.0, 1.0, [], set())]).freeze()
    ghost = L.ProgramIR(devices=("n0", "n1"), order=("a",), phases=(
        L.Phase(0, {"n0": ("a",), "n1": ()},
                (L.Exchange("ghost", "n0", "n1"),)),
    ))
    early = L.ProgramIR(devices=("n0", "n1"), order=("a", "b"), phases=(
        L.Phase(0, {"n0": (), "n1": ()}, (L.Exchange("a", "n0", "n1"),)),
        L.Phase(1, {"n0": ("a",), "n1": ("b",)}, ()),
    ))
    return [T.check_program_arity(g, missing),
            T.check_program_arity(g1, ghost),
            T.check_program_arity(g, early),
            T.analyze_typecheck(g, two_caps(ns, 4.0, 4.0),
                                ns.sched({"n0": ["a"], "n1": ["b"]}))]


FIXTURES = {
    "graph_cycle": (graph_cycle, {"DAG001", "DAG004"}),
    "graph_dangling_duplicate_negative": (
        graph_dangling_duplicate_negative, {"DAG002", "DAG003", "DAG005"}),
    "graph_param_sizes": (graph_param_sizes, {"DAG006", "DAG007"}),
    "pipeline": (pipeline_cases, {"PIP001", "PIP002"}),
    "decode": (decode_cases, {"DEC001", "DEC002", "DEC003", "DEC004"}),
    "paged_dag_one_node": (paged_dag_one_node, {"DEC004"}),
    "happens_before": (hb_cases, {"COL005", "COL006", "COL007"}),
    "donation": (donation_cases, {"DON001", "DON002", "DON003"}),
    "collective": (collective_cases, {"COL001", "COL004"}),
    "lowerability": (lowerability_cases, {"COL002"}),
    "typ001": (typ001_cases, {"TYP001"}),
    "typ002": (typ002_cases, {"TYP002"}),
    "typ003": (typ003_cases, {"TYP003"}),
    "typ004": (typ004_cases, {"TYP004"}),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_pass_diagnostics_equal_jax(name):
    build, codes = FIXTURES[name]
    jreps, preps = build(JNS), build(PNS)
    assert len(preps) == len(jreps)
    for i, (jr, pr) in enumerate(zip(jreps, preps)):
        assert fields(pr) == fields(jr), (name, i)
        assert pr.exit_code == jr.exit_code
    # the fixture exercises what it is named for
    assert codes <= {d.code for r in jreps for d in r.diagnostics}


def _rejecting_fn(ns):
    return lambda p, x: x @ ns.ones(x, (5, 5))


def test_typ001_rejected_edge_names_the_framework_error():
    """TYP001 when the fn refuses its input edge: the same diagnostic but
    for the message's tail, which is the framework's own error text."""
    reps = []
    for ns in (JNS, PNS):
        g = ns.TaskGraph([
            ns.Task("a", 0.0, 1.0, [], set(), out_shape=tf32(ns, 4, 4)),
            ns.Task("b", 0.0, 1.0, ["a"], set(), fn=_rejecting_fn(ns)),
        ]).freeze()
        reps.append(ns.T.analyze_typecheck(g))
    (jd,), (pd,) = (r.by_code("TYP001") for r in reps)
    head = "'b' does not typecheck against its input edges (a: float32[4, 4]): "
    assert jd.message.startswith(head) and pd.message.startswith(head)
    assert (pd.task, pd.severity, pd.data) == (jd.task, jd.severity, jd.data)
    assert "5" in pd.message[len(head):]


def test_collective_sequence_of_a_lowered_schedule_equals_jax():
    """The port's IR issues the JAX IR's exchange sequence (its primitive
    named ``exchange``); both are clean, and both packages' COL004 check
    reads the port's name as the JAX one."""
    from distributed_llm_scheduler_tpu_torch.frontend.generators import (
        generate_llm_dag as p_llm,
    )
    from distributed_llm_scheduler_tpu.frontend.generators import (
        generate_llm_dag as j_llm,
    )

    out = []
    for ns, gen in ((JNS, j_llm), (PNS, p_llm)):
        g = gen(num_layers=3, seed=2)
        c = ns.Cluster.uniform(4, g.total_param_gb())
        s = ns.get_scheduler("heft").schedule(g, c)
        ir = ns.L.linearize(g, s, device_order=[d.node_id for d in c])
        assert ns.A.analyze_collectives(ir).diagnostics == []
        out.append(ir.collective_sequence())
    jseq, pseq = out
    assert jseq, "no exchange: the test is vacuous"
    assert [("ppermute",) + x[1:] for x in pseq] == jseq
    bad = {"d0": [("exchange", ((0, 1), (0, 1)), "v")],
           "d1": [("exchange", ((0, 1), (0, 1)), "v")]}
    ref = {k: [("ppermute",) + x[1:] for x in v] for k, v in bad.items()}
    assert fields(PA.analyze_collectives(bad)) == fields(
        JA.analyze_collectives(ref))


def _pool_graph(ns, shape, dtype):
    specs = {"cache_k_0": ns.spec(shape, dtype),
             "page_table": ns.spec((2, 4), "int32")}
    g = ns.TaskGraph([
        ns.Task("l0", 0.1, 1.0, [], {"cache_k_0", "page_table"},
                param_bytes={"cache_k_0": 1024, "page_table": 32}),
    ])
    return g, specs


def test_dec005_dec006_quote_the_port_kernel_rules():
    from distributed_llm_scheduler_tpu_torch.ops.attention import (
        paged_kernel_constraints,
    )

    # head dim 24: no instance of the Hopper paged kernels takes it
    g, specs = _pool_graph(PNS, (8, 4, 2, 24), "bfloat16")
    rep = PA.analyze_decode(g, param_specs=specs, chunk_tokens=64,
                            decode_budget=16)
    (d5,) = rep.by_code("DEC005")
    rules = paged_kernel_constraints(4, 24, 2, dtype=torch.bfloat16)
    assert rules and d5.message.endswith("; ".join(rules))
    assert d5.data == {"page_size": 4, "head_dim": 24, "n_kv_heads": 2,
                       "dtype": "bfloat16", "constraints": rules}
    (d6,) = rep.by_code("DEC006")
    assert d6.data["decode_budget"] == 16 and d6.data["constraints"] == rules
    # an eligible geometry: no DEC005, and a chunk within budget no DEC006
    g, specs = _pool_graph(PNS, (8, 4, 2, 64), "bfloat16")
    rep = PA.analyze_decode(g, param_specs=specs, chunk_tokens=8,
                            decode_budget=16)
    assert not rep.has("DEC005") and not rep.has("DEC006")


@pytest.mark.parametrize("policy", ["greedy", "heft"])
def test_gpt2_and_paged_builders_typecheck_as_jax(policy):
    """The builders' graphs with their param and input specs: the same
    typecheck diagnostics (none of them errors) in both packages."""
    from distributed_llm_scheduler_tpu.frontend.gpt2_dag import (
        build_gpt2_dag as jb,
    )
    from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config as JC
    from distributed_llm_scheduler_tpu_torch.frontend.gpt2_dag import (
        build_gpt2_dag as tb,
    )
    from distributed_llm_scheduler_tpu_torch.models.gpt2 import (
        GPT2Config as TC,
    )

    kw = dict(batch=2, seq_len=16, microbatches=2, vocab_shards=4)
    reps = []
    for ns, build, cfg in ((JNS, jb, JC), (PNS, tb, TC)):
        dag = build(cfg.tiny(), **kw)
        c = ns.Cluster.uniform(4, 2 * dag.graph.total_param_gb())
        s = ns.get_scheduler(policy).schedule(dag.graph, c)
        reps.append(ns.T.analyze_typecheck(
            dag.graph, c, s, params=dag.param_specs,
            graph_input=dag.input_spec))
    assert fields(reps[1]) == fields(reps[0])
    assert reps[1].ok
