"""The port's stream-safety pass (``analysis/stream_pass.py``) against the
JAX package's, and the device backend's compiled-rung decision on it.

Mirrors the stream half of ``tests/test_typecheck.py``.  The pass is
framework-free, so on the same graph, cluster and schedule its
diagnostics (codes, severities, nodes, tasks, messages and data) must be
*equal* to JAX's; ``execute(compiled=True, stream_params=True)`` runs the
compiled rung where the verdict is ``compilable`` (on the CPU the program
runs eagerly) and raises ``AnalysisError`` with the STR002/STR003
diagnosis otherwise, as the JAX backend does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu import analysis as JA
from distributed_llm_scheduler_tpu.backends.device import (
    DeviceBackend as JaxBackend,
)
from distributed_llm_scheduler_tpu.core.schedule import Schedule as JSchedule
from distributed_llm_scheduler_tpu.frontend.gpt2_dag import (
    build_gpt2_dag as jax_build,
)
from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config as JaxConfig
from distributed_llm_scheduler_tpu_torch import analysis as TA
from distributed_llm_scheduler_tpu_torch.core.schedule import Schedule as TSchedule

CPU = torch.device("cpu")
GB = 1 << 30


def _diag(report):
    return [(d.code, int(d.severity), d.node, d.task, d.param, d.message,
             dict(d.data)) for d in report.diagnostics]


def _fixture(pkg, schedule_cls, cap_gb, *sizes_gb):
    """A chain of tasks t0, t1, ... each needing its own param of the
    given size, all on node n0 of a one-node cluster."""
    tasks, prev = [], []
    for i, s in enumerate(sizes_gb):
        tasks.append(pkg.Task(
            f"t{i}", 0.0, 1.0, list(prev), {f"p{i}"},
            param_bytes={f"p{i}": int(s * GB)},
        ))
        prev = [f"t{i}"]
    g = pkg.TaskGraph(tasks).freeze()
    cluster = pkg.Cluster([pkg.DeviceState("n0", cap_gb)])
    order = [t.task_id for t in tasks]
    sched = schedule_cls(policy="manual", per_node={"n0": order},
                         assignment_order=order, completed=set(order))
    return g, cluster, sched


@pytest.mark.parametrize("cap,sizes,code,verdict", [
    (1.0, (0.3, 0.3), "STR001", "compilable"),
    (1.0, (0.6, 0.6), "STR002", "pinned-prefix"),
    (1.0, (1.5, 0.2), "STR003", "interpreter-only"),
    (1.0, (1.5,), "STR003", "interpreter-only"),
    (2.0, (0.5, 0.5, 0.5, 0.6), "STR002", "pinned-prefix"),
])
def test_diagnostics_equal_jax(cap, sizes, code, verdict):
    jrep = JA.analyze_streaming(*_fixture(J, JSchedule, cap, *sizes))
    trep = TA.analyze_streaming(*_fixture(P, TSchedule, cap, *sizes))
    assert _diag(trep) == _diag(jrep)
    (d,) = trep.by_code(code)
    assert TA.stream_verdict(trep) == JA.stream_verdict(jrep) == verdict
    if code == "STR002":
        assert d.data["prefix_tasks"] >= 1 and d.task is not None
    refusal = TA.compiled_stream_refusal(trep)
    assert _diag(refusal) == _diag(JA.compiled_stream_refusal(jrep))
    if code == "STR001":
        assert refusal.exit_code == 0 and not refusal.diagnostics
    else:
        assert refusal.exit_code == 1
        assert refusal.by_code(code)[0].severity == TA.Severity.ERROR
        with pytest.raises(TA.AnalysisError):
            refusal.raise_if_errors()
    assert trep.exit_code == 0  # warnings only in general analysis


def test_str002_pinned_prefix_payload():
    rep = TA.analyze_streaming(*_fixture(P, TSchedule, 1.0, 0.6, 0.6))
    (d,) = rep.by_code("STR002")
    assert d.severity == TA.Severity.WARNING and d.task == "t1"
    assert d.data["prefix_tasks"] == 1
    assert d.data["prefix_gb"] == pytest.approx(0.6)


@pytest.fixture(scope="module")
def tiny():
    kw = dict(batch=4, seq_len=32, microbatches=2, vocab_shards=4)
    jdag = jax_build(JaxConfig.tiny(), **kw)
    tdag = P.build_gpt2_dag(P.GPT2Config.tiny(), **kw)
    jparams = jdag.init_params()
    tparams = P.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, CPU)
    ids = np.random.default_rng(3).integers(0, 512, (4, 32), dtype=np.int32)
    return dict(jdag=jdag, tdag=tdag, jparams=jparams, tparams=tparams,
                ids=ids)


def _placed(tiny, policy, n, fraction):
    total = tiny["jdag"].graph.total_param_gb()
    jc = J.Cluster.from_jax_devices(jax.devices()[:n],
                                    hbm_cap_gb=total * fraction)
    tc = P.Cluster.from_torch_devices([CPU] * n, hbm_cap_gb=total * fraction)
    js = J.get_scheduler(policy).schedule(tiny["jdag"].graph, jc)
    ts = P.get_scheduler(policy).schedule(tiny["tdag"].graph, tc)
    # a budget below a task's own params fails it on both sides alike
    assert ts.per_node == js.per_node and ts.failed == js.failed
    return jc, tc, js, ts


@pytest.mark.parametrize("fraction", [0.1, 0.35, 0.7, 4.0])
@pytest.mark.parametrize("policy,n", [("mru", 1), ("greedy", 1),
                                      ("heft", 4), ("pipeline", 4)])
def test_gpt2_schedules_diagnose_as_jax(tiny, policy, n, fraction):
    jc, tc, js, ts = _placed(tiny, policy, n, fraction)
    jrep = JA.analyze_streaming(tiny["jdag"].graph, jc, js)
    trep = TA.analyze_streaming(tiny["tdag"].graph, tc, ts)
    assert _diag(trep) == _diag(jrep)
    assert TA.stream_verdict(trep) == JA.stream_verdict(jrep)


def test_compiled_stream_accepts_when_the_pass_clears(tiny):
    """Every node's union fits: the compiled rung runs, every param
    resident, and gives the unstreamed compiled output."""
    _, tc, _, ts = _placed(tiny, "greedy", 1, 4.0)
    backend = P.DeviceBackend(tc)
    ids = torch.from_numpy(tiny["ids"])
    rep = backend.execute(tiny["tdag"].graph, ts, tiny["tparams"], ids,
                          stream_params=True, compiled=True)
    assert rep.compiled and not rep.streamed
    base = backend.execute(tiny["tdag"].graph, ts, tiny["tparams"], ids,
                           compiled=True)
    assert torch.equal(rep.output, base.output)
    fused = tiny["tdag"].reference_forward(tiny["tparams"], ids)
    np.testing.assert_allclose(rep.output.numpy(), fused.numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("policy,n,fraction", [("mru", 1, 0.35),
                                               ("mru", 4, 0.2)])
def test_compiled_stream_refuses_with_the_jax_diagnosis(tiny, policy, n,
                                                        fraction):
    jc, tc, js, ts = _placed(tiny, policy, n, fraction)
    with pytest.raises(TA.AnalysisError) as te:
        P.DeviceBackend(tc).execute(
            tiny["tdag"].graph, ts, tiny["tparams"],
            torch.from_numpy(tiny["ids"]), stream_params=True, compiled=True)
    with pytest.raises(JA.AnalysisError) as je:
        JaxBackend(jc, pre_analysis=False).execute(
            tiny["jdag"].graph, js, tiny["jparams"], jnp.asarray(tiny["ids"]),
            stream_params=True, compiled=True)
    assert _diag(te.value.report) == _diag(je.value.report)
    assert {d.code for d in te.value.report.diagnostics} & {"STR002", "STR003"}
