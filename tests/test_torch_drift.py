"""The port's ``obs/drift.py`` and ``obs/memdrift.py`` against the JAX
package's, on the JAX tests' own fixtures (``tests/test_obs.py``'s
two-task chain, ``tests/test_memprof.py``'s scheduled tiny GPT-2).

Both reports are framework-free: given the same graph, schedule, cost
model and profiler events, every summary value must be equal.
"""

import math

import jax
import pytest

from distributed_llm_scheduler_tpu import Cluster as JCluster
from distributed_llm_scheduler_tpu import Task as JTask
from distributed_llm_scheduler_tpu import TaskGraph as JGraph
from distributed_llm_scheduler_tpu import get_scheduler as jsched
from distributed_llm_scheduler_tpu.core.schedule import Schedule as JSchedule
from distributed_llm_scheduler_tpu.core.schedule import TaskTiming as JTiming
from distributed_llm_scheduler_tpu.frontend.gpt2_dag import build_gpt2_dag as jbuild
from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config as JConfig
from distributed_llm_scheduler_tpu.obs import drift as JD
from distributed_llm_scheduler_tpu.obs import memdrift as JM
from distributed_llm_scheduler_tpu.obs.memprof import MemoryProfiler as JProf
from distributed_llm_scheduler_tpu.utils.costmodel import CostModel as JCost
from distributed_llm_scheduler_tpu_torch import Cluster, Task, TaskGraph, get_scheduler
from distributed_llm_scheduler_tpu_torch import obs as PO
from distributed_llm_scheduler_tpu_torch.core.schedule import Schedule, TaskTiming
from distributed_llm_scheduler_tpu_torch.frontend.gpt2_dag import build_gpt2_dag
from distributed_llm_scheduler_tpu_torch.models.gpt2 import GPT2Config
from distributed_llm_scheduler_tpu_torch.obs import drift as PD
from distributed_llm_scheduler_tpu_torch.obs import memdrift as PM
from distributed_llm_scheduler_tpu_torch.obs.memprof import MemoryProfiler
from distributed_llm_scheduler_tpu_torch.utils.costmodel import CostModel


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _chain(Task_, Graph, Sched, Timing):
    g = Graph([Task_("a", 0.1, 1.0, [], set()),
               Task_("b", 0.1, 2.0, ["a"], set())])
    s = Sched(policy="manual", per_node={"n0": ["a", "b"]},
              assignment_order=["a", "b"], completed={"a", "b"})
    s.timings = {"a": Timing("a", "n0", 0.0, 2.0),
                 "b": Timing("b", "n0", 2.0, 3.0)}
    return g, s


@pytest.mark.parametrize("seconds", [None, {"a": 4.0, "b": 1.0},
                                     {"a": 0.0, "b": 1.0},
                                     {"a": 3.0, "missing": 1.0}],
                         ids=["compute_time", "profile", "skip", "unknown"])
def test_drift_report_equals_jax(seconds):
    jg, js = _chain(JTask, JGraph, JSchedule, JTiming)
    pg, ps = _chain(Task, TaskGraph, Schedule, TaskTiming)
    jcm = pcm = None
    if seconds is not None:
        jcm = JCost(graph_name="fixture", platform="cpu",
                    task_seconds=dict(seconds), method="profile")
        pcm = CostModel(graph_name="fixture", platform="cpu",
                        task_seconds=dict(seconds), method="profile")
    jr, pr = JD.compute_drift(jg, js, jcm), PD.compute_drift(pg, ps, pcm)
    assert pr.summary() == jr.summary()
    assert pr.worst_ratio() == jr.worst_ratio()
    for t in (None, 1.5, 2.0, 2.5):
        assert pr.exceeds(t) == jr.exceeds(t)
    assert [t.compute_time for t in pg.tasks()] == [1.0, 2.0]


@pytest.mark.parametrize("tid", ["mb3_layer_7_attention", "mb0_embedding_shard_2",
                                 "layer_11_mlp", "final_ln", "lm_head_shard_0"])
def test_task_class_equals_jax(tid):
    from distributed_llm_scheduler_tpu.eval.benchlib import task_class

    assert PD.task_class(tid) == task_class(tid)


def _dev(mod, nid, pred, meas):
    return mod.DeviceMemDrift(node_id=nid, predicted_bytes=pred,
                              measured_bytes=meas)


def test_mem_drift_ratio_and_gate_equal_jax():
    for devs in ([("a", 100, 25), ("b", 100, 300)], [("a", 100, 200)], []):
        jr = JM.MemDriftReport(devices=[_dev(JM, *d) for d in devs])
        pr = PM.MemDriftReport(devices=[_dev(PM, *d) for d in devs])
        assert pr.worst_ratio() == jr.worst_ratio()
        for t in (None, 1.0, 1.999, 2.0, 4.0):
            assert pr.exceeds(t) == jr.exceeds(t)
        assert pr.summary() == jr.summary()


@pytest.mark.parametrize("cap_gb", [4.0, 0.001], ids=["fits", "near_oom"])
def test_compute_mem_drift_equals_jax(cap_gb):
    """The JAX test's scheduled tiny GPT-2 with synthetic profiler peaks
    (2x, 4x and a 3x task output; at a ~1 MB budget, the near-OOM
    warning): equal predicted peaks and equal reports."""
    jdag = jbuild(JConfig.tiny(), batch=1, seq_len=8)
    pdag = build_gpt2_dag(GPT2Config.tiny(), batch=1, seq_len=8)
    n = 2 if cap_gb > 0.01 else 1
    jc = JCluster.from_jax_devices(jax.devices()[:n], hbm_cap_gb=cap_gb)
    import torch

    pc = Cluster.from_torch_devices([torch.device("cpu")] * n,
                                    hbm_cap_gb=cap_gb)
    policy = "roundrobin" if n == 2 else "greedy"
    js = jsched(policy).schedule(jdag.graph, jc)
    ps = get_scheduler(policy).schedule(pdag.graph, pc)
    jpred = JM.predicted_node_peak_bytes(jdag.graph, jc, js)
    ppred = PM.predicted_node_peak_bytes(pdag.graph, pc, ps)
    assert sorted(ppred.values()) == sorted(jpred.values())
    assert all(v > 0 for v in ppred.values())
    jmem, pmem = JProf(clock=FakeClock()), MemoryProfiler(clock=FakeClock())
    jn, pn = sorted(jpred), sorted(ppred)
    tid = next(iter(pdag.graph.task_ids()))
    want = int(round(pdag.graph[tid].memory_required * (1024 ** 3)))
    for mem, nids, pred in ((jmem, jn, jpred), (pmem, pn, ppred)):
        if n == 2:
            mem.alloc(nids[0], "a", 2 * pred[nids[0]])
            mem.alloc(nids[1], "b", 4 * pred[nids[1]])
            mem.alloc(nids[0], f"out:{tid}", 3 * max(want, 1), "activations")
        else:
            mem.alloc(nids[0], "a", int(0.95 * cap_gb * (1024 ** 3)))
    jr = JM.compute_mem_drift(jdag.graph, jc, js, jmem)
    pr = PM.compute_mem_drift(pdag.graph, pc, ps, pmem)
    rename = dict(zip(jn, pn))  # JAX and torch node ids of the same node

    def normal(summ, names=None):
        out = dict(summ)
        out["devices"] = [dict(d, node=(names or {}).get(d["node"], d["node"]))
                          for d in summ["devices"]]
        out["headroom"] = {(names or {}).get(k, k): v
                           for k, v in summ["headroom"].items()}
        out["warnings"] = [w.split(":", 1)[1] for w in summ["warnings"]]
        return out

    assert normal(pr.summary()) == normal(jr.summary(), rename)
    assert pr.worst_ratio() == jr.worst_ratio()
    if n == 2:
        assert math.isclose(
            {d.node_id: d.ratio for d in pr.devices}[pn[1]], 4.0)
    else:
        assert pr.warnings and "near OOM" in pr.warnings[0]


def test_obs_exports_the_drift_modules():
    for name in ("DriftReport", "TaskDrift", "compute_drift", "MemDriftReport",
                 "DeviceMemDrift", "TaskMemDrift", "compute_mem_drift",
                 "predicted_node_peak_bytes"):
        assert name in PO.__all__ and getattr(PO, name) is not None
