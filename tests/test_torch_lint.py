"""The port's sharding, quantization, cost and determinism passes, the
``lint --fix`` fixers and the ``lint`` command against the JAX package's.

Each fixture of ``tests/test_analysis.py`` is built once per package from
the same description and run through both packages' pass; the contract is
equality of the diagnostics, compared as (code, severity, task, node,
param, message, data).  Both CLIs' ``main(argv)`` run in this process
under ``DLS_PLATFORM=cpu`` on the argv of ``test_lint_cli_clean_on_every_
builder`` and more: equal exit codes, equal ``--json`` stdout and equal
last stderr lines on refusals.  Two differences are by design and pinned
on their own: ``lint --parallel`` runs each strategy's probe on a world
of simulated ranks where the JAX package traces a jaxpr (its stdout and
exit code are equal at 8 ranks against 8 devices), and ``--preflight``
reads the allocator's peak on a card where the JAX package reads XLA's
compiled memory, so on the CPU it measures nothing; given the same
numbers the cost pass is equal.
"""

from __future__ import annotations

import contextlib
import io
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu import analysis as JA
from distributed_llm_scheduler_tpu.__main__ import main as jmain
from distributed_llm_scheduler_tpu.core.schedule import Schedule as JSchedule
from distributed_llm_scheduler_tpu.utils import quantize as JQ
from distributed_llm_scheduler_tpu.utils.config import RunConfig as JRunConfig
from distributed_llm_scheduler_tpu_torch import analysis as PA
from distributed_llm_scheduler_tpu_torch.__main__ import main as pmain
from distributed_llm_scheduler_tpu_torch.core.schedule import Schedule as PSchedule
from distributed_llm_scheduler_tpu_torch.utils import quantize as PQ
from distributed_llm_scheduler_tpu_torch.utils.config import RunConfig

FIXTURES = Path(__file__).parent / "fixtures" / "determinism"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: several spin against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("DLS_PLATFORM", "cpu")
    monkeypatch.delenv("DLS_FORCE_CPU", raising=False)
    monkeypatch.delenv("DLS_NATIVE", raising=False)


def _ns(pkg, A, Sched, Q, array):
    return types.SimpleNamespace(
        Task=pkg.Task, TaskGraph=pkg.TaskGraph, Cluster=pkg.Cluster,
        DeviceState=pkg.DeviceState, A=A, Q=Q, array=array,
        sched=lambda per_node, order=None: Sched(
            policy="manual", per_node=per_node,
            assignment_order=(order if order is not None else
                              [t for ts in per_node.values() for t in ts]),
            completed=set(t for ts in per_node.values() for t in ts)),
    )


_TD = {"float32": torch.float32, "int8": torch.int8}
JNS = _ns(J, JA, JSchedule, JQ, lambda shape, dt: np.zeros(shape, dt))
PNS = _ns(P, PA, PSchedule, PQ,
          lambda shape, dt: torch.zeros(shape, dtype=_TD[dt]))


def fields(rep):
    return [
        (d.code, int(d.severity), d.task, d.node, d.param, d.message,
         d.data)
        for d in rep.diagnostics
    ]


# -- the fixtures: name -> (pkg namespace -> list of reports) ----------------

MESH = {"dp": 2, "tp": 4, "sp": 1}


def sharding_cases(ns):
    A = ns.A
    return [
        A.analyze_sharding({"attn_qkv_w": (768,)}, MESH, family="gpt2"),
        A.analyze_sharding({"attn_qkv_w": (768, 2304)}, {"dp": 2},
                           family="gpt2"),
        A.analyze_sharding({"attn_qkv_w": (768, 2306)}, MESH, family="gpt2"),
        A.analyze_sharding({"attn_qkv_w": (768, 2304), "ln_f_g": (768,)},
                           MESH, family="gpt2"),
        A.analyze_sharding({"attn_qkv_w": (768, 2304)}, MESH, family="gpt2",
                           batch_spec=("tp", None)),
        # the Llama rules, the stacked-layer shift and seq-parallel specs
        A.analyze_sharding({"l0_wk": (64, 30), "layers_wq": (2, 64, 64),
                            "lm_head": (64, 250), "tok_emb": (250, 64),
                            "l0_e1_w_down": (90, 64)},
                           MESH, family="llama", seq_parallel=True),
        A.analyze_sharding({"layers_attn_qkv_w": (2, 768, 2304),
                            "x": (3,)}, {"dp": 2, "tp": 3, "sp": 2},
                           family="gpt2", seq_parallel=True),
    ]


def qgraph(ns, nbytes):
    return ns.TaskGraph([
        ns.Task("a", 0.1, 1.0, [], {"w"}, param_bytes={"w": nbytes}),
    ]).freeze()


def quant_cases(ns):
    A, QP, arr = ns.A, ns.Q.QParam, ns.array
    q = arr((128, 64), "int8")
    tiny = QP(q=arr((4, 4), "int8"), scale=arr((1, 4), "float32"))
    spec = {"w": QP(q=q, scale=arr((1, 64), "float32"))}
    return [
        A.analyze_quantization(qgraph(ns, 1), {"w": QP(
            q=arr((128, 64), "float32"), scale=arr((1, 64), "float32"))}),
        A.analyze_quantization(qgraph(ns, 1), {"w": QP(
            q=arr((128, 64), "int8"), scale=arr((7, 7), "float32"))}),
        A.analyze_quantization(qgraph(ns, ns.Q.qparam_bytes(q)), spec),
        A.analyze_quantization(qgraph(ns, 128 * 64 * 4), spec),
        A.analyze_quantization(qgraph(ns, ns.Q.qparam_bytes(tiny.q)),
                               {"w": tiny}),
        # rowwise and grouped layouts, and a plain (unquantized) entry
        A.analyze_quantization(qgraph(ns, 1), {
            "w": QP(q=q, scale=arr((128, 1), "float32")),
            "v": QP(q=q, scale=arr((4, 1, 64), "float32")),
            "u": arr((8, 8), "float32")}),
    ]


def cost_cases(ns):
    A, T, G = ns.A, ns.Task, ns.TaskGraph
    g = G([
        T("under", 1.0, 1.0, [], set()),
        T("over", 8.0, 1.0, ["under"], set()),
        T("fine", 1.0, 1.0, ["under"], set()),
        T("unmeasured", 1.0, 1.0, ["over"], set()),
    ])
    raised = G([T("t", 3.0, 1.0, [], set())])
    tiny = G([T("s", 1e-6, 1.0, [], set())])
    g2 = G([T("t", 1.0, 1.0, [], set())])
    return [
        A.analyze_cost(g, {"under": 3.0, "over": 2.0, "fine": 1.5}),
        A.analyze_cost(g, {"under": 3.0}, memory_report={"under": 2**30}),
        A.analyze_cost(raised, {"t": 3.0}, analytic_gb={"t": 1.0}),
        A.analyze_cost(raised, {"t": 3.0}),
        A.analyze_cost(tiny, {"s": 5e-4}),
        A.analyze_cost(tiny, {}),
        A.analyze_cost(g2, {"t": 2.5}),
        A.analyze_cost(g2, {"t": 2.5}, factor=3.0),
        A.analyze(g2, compiled_gb={"t": 5.0}, analytic_gb={"t": 1.0}),
    ]


def determinism_cases(ns):
    names = ("det001_clock.py", "serve/det002_rng.py", "det003_setiter.py",
             "det004_idkey.py", "det005_env.py", "markered_clean.py")
    return [ns.A.analyze_determinism(paths=[FIXTURES / n]) for n in names] + [
        ns.A.analyze_determinism(paths=[FIXTURES / n for n in names])]


def analyze_cases(ns):
    """``analyze`` runs the sharding pass beside the base passes
    (``test_analyze_runs_applicable_passes``)."""
    g = ns.TaskGraph([
        ns.Task("a", 0.1, 1.0, [], set()),
        ns.Task("b", 0.1, 1.0, ["a"], set()),
    ]).freeze()
    cl = ns.Cluster([ns.DeviceState("n0", 1.0), ns.DeviceState("n1", 1.0)])
    return [ns.A.analyze(g, cl, ns.sched({"n0": ["b", "a"]}),
                         param_shapes={"attn_qkv_w": (768,)},
                         mesh_axes=MESH, family="gpt2")]


CASES = {f.__name__: f for f in (sharding_cases, quant_cases, cost_cases,
                                  determinism_cases, analyze_cases)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_diagnostics_equal_the_jax_ones(name):
    want = [fields(r) for r in CASES[name](JNS)]
    got = [fields(r) for r in CASES[name](PNS)]
    assert got == want
    assert any(want)  # not vacuous: each family of cases reports something


def test_analyze_runs_the_ported_passes():
    """``_UNPORTED`` is gone: the sharding, quantization and cost passes'
    inputs run them (they used to raise ``NotImplementedError``)."""
    assert not hasattr(PA, "_UNPORTED")
    (rep,) = analyze_cases(PNS)
    assert rep.has("SCH009") and rep.has("SHD002") and rep.has("MEM001")
    assert {d.code for d in rep.diagnostics} <= set(PA.CODES)
    q = PQ.QParam(q=torch.zeros(128, 64, dtype=torch.int8),
                  scale=torch.zeros(1, 64))
    assert PA.analyze(qgraph(PNS, 1), param_specs={"w": q}).has("QNT004")
    assert PA.analyze(qgraph(PNS, 1), compiled_gb={}).has("CST003")
    assert not PA.analyze(qgraph(PNS, 1)).diagnostics


def test_quantize_dag_output_lints_clean():
    dag = RunConfig(model="gpt2-tiny", quantize="int8").build_graph()
    assert any(isinstance(s, PQ.QParam) for s in dag.param_specs.values())
    rep = PA.analyze_quantization(dag.graph, dag.param_specs)
    assert rep.ok, rep.render()


def test_spec_shapes_and_param_specs_equal_the_jax_ones():
    """What ``lint`` feeds the sharding pass: the shapes of every spec,
    the QParams' int8 payloads, and the rules' specs (plain tuples where
    the JAX package has ``PartitionSpec``)."""
    from distributed_llm_scheduler_tpu.parallel import sharding as JS
    from distributed_llm_scheduler_tpu.parallel.mesh import (
        factorize_mesh as jfactorize,
    )
    from distributed_llm_scheduler_tpu_torch.parallel import sharding as PS
    from distributed_llm_scheduler_tpu_torch.parallel.mesh import (
        factorize_mesh,
    )

    for model in ("gpt2-tiny", "llama-tiny", "mixtral-tiny"):
        for quant in ("none", "int8"):
            pdag = RunConfig(model=model, quantize=quant).build_graph()
            jdag = JRunConfig(model=model, quantize=quant).build_graph()
            shapes = PA._spec_shapes(pdag.param_specs)
            assert shapes == JA._spec_shapes(jdag.param_specs)
            family = model.split("-")[0]
            for name in shapes:
                assert PS.param_spec(name, family) == tuple(
                    JS.param_spec(name, family)), name
                assert PS.param_spec(f"layers_{name}", family) == tuple(
                    JS.param_spec(f"layers_{name}", family))
    for n in range(1, 17):
        for prefer in (1, 2, 4, 8):
            assert factorize_mesh(n, prefer) == jfactorize(n, prefer)


# -- fixers ------------------------------------------------------------------

def fix_cases(ns):
    """``tests/test_analysis.py``'s fixer fixtures: what each fixer
    returns and the graph or schedule it leaves."""
    T, G, A = ns.Task, ns.TaskGraph, ns.A
    out = []
    g = G([T("a", 0.1, 1.0, [], set()), T("b", 0.1, 1.0, ["a", "a"], set())])
    out.append(A.fix_duplicate_dependencies(g))
    out.append((g["b"].dependencies, g["b"].arg_tasks,
                fields(A.analyze_graph(g)), A.fix_duplicate_dependencies(g)))
    g = G([T("a", 0.1, 1.0, [], set()), T("b", 0.1, 1.0, ["a", "a"], set()),
           T("c", 0.1, 1.0, ["b"], set())]).freeze()
    out.append((A.fix_duplicate_dependencies(g), g.topo_order,
                g.dependents("a")))
    g = G([T("a", 0.1, 1.0, [], set()), T("b", 0.1, 1.0, ["a"], set()),
           T("c", 0.1, 1.0, ["b"], set())]).freeze()
    s = ns.sched({"n0": ["b", "a"], "n1": ["c"]})
    out.append((A.fix_per_node_order(g, s), s.per_node, s.assignment_order,
                s.placement, A.fix_per_node_order(g, s)))
    cyc = G([T("a", 0.1, 1.0, ["b"], set()), T("b", 0.1, 1.0, ["a"], set())])
    s = ns.sched({"n0": ["b", "a"]})
    out.append((A.fix_per_node_order(cyc, s), s.per_node,
                s.assignment_order))
    g = G([T("x", 0.1, 1.0, [], set()), T("y", 0.1, 1.0, [], set()),
           T("z", 0.1, 1.0, ["y"], set())])
    s = ns.sched({"n0": ["z", "x", "y"]})
    out.append((A.fix_per_node_order(g, s), s.per_node))
    # only the global order out of step (SCH005 across nodes)
    g = G([T("p", 0.1, 1.0, [], set()), T("q", 0.1, 1.0, [], set())])
    s = ns.sched({"n0": ["p"], "n1": ["q"]}, order=["q", "p"])
    s.per_node["n0"] = ["p"]
    out.append((A.fix_per_node_order(g, s), s.assignment_order))
    return out


def test_fixers_equal_the_jax_ones():
    want = fix_cases(JNS)
    assert fix_cases(PNS) == want
    assert want[0] == ["b"] and want[3][0] == ["n0"] and want[4][0] is None


# -- the port's own tree -------------------------------------------------------

def test_determinism_port_tree_is_clean():
    """The port's counterpart of ``test_determinism_repo_tree_is_clean``:
    every wall-clock/RNG/env/set-order hazard in the port's package is
    either fixed or carries an inline justification."""
    rep = PA.analyze_determinism()
    assert rep.diagnostics == [], [d.render() for d in rep.diagnostics]


def test_determinism_seams_are_the_ports():
    """DET005 exempts the port's env seam (``utils/env.py``) beside
    ``utils/config.py``; the DET001 seam and the DET002 scope are the JAX
    package's; no argument walks the port's package, not the JAX one."""
    from distributed_llm_scheduler_tpu.analysis import determinism_pass as JD
    from distributed_llm_scheduler_tpu_torch.analysis import (
        determinism_pass as PD,
    )

    assert PD._SEAM_FILES == {"DET001": ("obs/clockutil.py",),
                              "DET005": ("utils/config.py", "utils/env.py")}
    assert PD._SEAM_FILES["DET001"] == JD._SEAM_FILES["DET001"]
    assert PD._RNG_SCOPED_DIRS == JD._RNG_SCOPED_DIRS
    env = Path(P.__file__).parent / "utils" / "env.py"
    # the JAX package's seams leave the port's env reads flagged
    assert [d.code for d in JD.analyze_determinism(paths=[env]).diagnostics
            ] == ["DET005", "DET005"]
    assert PD.analyze_determinism(paths=[env]).diagnostics == []


# -- the lint command ------------------------------------------------------------

def run(fn, argv):
    """``fn(argv)`` in process: (exit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


LINT_ARGV = [
    ["lint", "--model", "gpt2-tiny"],
    ["lint", "--model", "gpt2-tiny", "--train-step"],
    ["lint", "--model", "gpt2-tiny", "--decode"],
    ["lint", "--model", "gpt2-tiny", "--quantize", "int8"],
    ["lint", "--model", "llama-tiny"],
    ["lint", "--model", "mixtral-tiny"],
    ["lint", "--model", "mixtral-tiny", "--routed"],
    ["lint", "--model", "llm"],
    ["lint", "--model", "random"],
    ["lint", "--model", "pipeline", "--scheduler", "pipeline"],
    ["lint", "--model", "gpt2-tiny", "--quantize", "int8", "--decode"],
    ["lint", "--model", "gpt2-tiny", "--paged", "--batch", "4",
     "--chunk-tokens", "48", "--seg-steps", "8"],
    ["lint", "--model", "gpt2-tiny", "--paged", "--chunk-tokens", "8"],
    ["lint", "--model", "gpt2-tiny", "--fix"],
    ["lint", "--model", "llm", "--hbm-gb", "0.05", "--num-nodes", "2",
     "--strict"],
    ["lint", "--model", "gpt2", "--verbose"],
    ["lint", "--model", "llama-8b", "--num-layers", "2"],
    ["lint", "--model", "gpt2", "--quantize", "int8", "--num-nodes", "6"],
]


def _label(argv):
    return " ".join(argv[1:])


@pytest.mark.parametrize("argv", LINT_ARGV, ids=_label)
def test_lint_equals_the_jax_cli(argv):
    """Equal exit codes and equal ``--json`` stdout (schema dls.lint/1);
    rendered (the first three), the same stdout too."""
    extras = (["--json"], []) if argv in LINT_ARGV[:3] else (["--json"],)
    for extra in extras:
        want = run(jmain, argv + extra)
        got = run(pmain, argv + extra)
        assert got[:2] == want[:2]
        if extra:
            assert json.loads(got[1])["schema"] == "dls.lint/1"


REFUSED = [
    ["lint", "--serving", "--decode"],
    ["lint", "--serving", "--fix"],
    ["lint", "--serving", "--inject-underflow"],
    ["lint", "--serving", "--inject-leak", "0"],
    ["lint", "--inject-leak", "3"],
    ["lint", "--prefix"],
    ["lint", "--model", "llm", "--decode"],
    ["lint", "--model", "llama-tiny", "--paged"],
]


@pytest.mark.parametrize("argv", REFUSED, ids=_label)
def test_lint_refusals_equal_the_jax_cli(argv):
    want = run(jmain, argv)
    got = run(pmain, argv)
    assert got[0] == want[0] == 2
    assert got[2].strip().splitlines()[-1] == want[2].strip().splitlines()[-1]


def test_lint_refusals_the_jax_cli_leaves_as_tracebacks():
    """An unknown model is a traceback in the JAX CLI; the port exits 2
    with one line (ROADMAP.md C, "CLI errors ...")."""
    for model in ("bert", "gpt2-huge"):
        with pytest.raises(ValueError):
            run(jmain, ["lint", "--model", model])
        rc, _out, err = run(pmain, ["lint", "--model", model])
        assert rc == 2 and len(err.strip().splitlines()) == 1


PARALLEL = [["lint", "--parallel"], ["lint", "--parallel", "--json"],
            ["lint", "--parallel", "--verbose"]]


@pytest.mark.parametrize("argv", PARALLEL, ids=_label)
def test_lint_parallel_equals_the_jax_cli(argv, monkeypatch):
    """The collective sweep over every strategy's probe and the
    happens-before self-check: on a world of 8 simulated ranks
    (``DLS_CPU_WORLD=8``) the same stdout and exit code as the JAX CLI on
    its 8-device CPU mesh."""
    monkeypatch.setenv("DLS_CPU_WORLD", "8")
    want = run(jmain, argv)
    got = run(pmain, argv)
    assert got[0] == want[0] == 0
    assert got[1] == want[1]


def test_lint_parallel_refusal_equals_the_jax_cli(monkeypatch):
    monkeypatch.setenv("DLS_CPU_WORLD", "8")
    argv = ["lint", "--parallel", "--decode"]
    want, got = run(jmain, argv), run(pmain, argv)
    assert got[0] == want[0] == 2 and got[1] == want[1] == ""
    assert got[2].strip().splitlines()[-1] == want[2].strip().splitlines()[-1]


def test_lint_preflight_on_the_cpu():
    """``--preflight`` measures on a card; on the CPU shapes propagate
    only, nothing is measured, and every task above the floor is CST003
    (info).  Its refusal of a synthetic graph names the port's preflight."""
    rc, out, _err = run(pmain, ["lint", "--model", "gpt2", "--num-layers",
                                "1", "--preflight", "--json"])
    assert rc == 0
    codes = {(d["code"], d["severity"]) for d in json.loads(out)["diagnostics"]
             if d["code"].startswith("CST")}
    assert codes == {("CST003", "info")}
    rc, _out, err = run(pmain, ["lint", "--model", "llm", "--preflight"])
    assert rc == 2
    assert err.strip() == ("--preflight needs a model DAG (gpt2*/llama*/"
                           "mixtral*): the preflight runs the real task fns")


SERVING = [
    (["lint", "--serving"], 0, set()),
    (["lint", "--serving", "--inject-leak", "4"], 1, {"PGL001"}),
    (["lint", "--serving", "--prefix", "--inject-underflow"], 1,
     {"PGL006"}),
]


@pytest.mark.parametrize("argv,rc,must", SERVING, ids=lambda a: str(a))
def test_serving_lint_equals_the_jax_cli(argv, rc, must):
    """The serve bench's scenario through both engines: the same exit
    code and the same PGL/LCY/DET diagnostics (the determinism pass walks
    each package's own tree, both clean)."""
    want = run(jmain, argv + ["--json"])
    got = run(pmain, argv + ["--json"])
    assert got[:2] == want[:2]
    assert got[0] == rc
    codes = {d["code"] for d in json.loads(got[1])["diagnostics"]}
    assert must <= codes
    assert not any(c.startswith(("LCY", "DET")) for c in codes)
