"""The cost model's saved calibration, against the JAX package's.

A calibration file is the JAX package's JSON fields, so a file saved by
either package loads in the other with the same fields, and each
package's ``calibrate_cached`` replays the other's file for the same
graph.  ``calibrate_cached`` measures once, then hits; ``refresh``
re-measures and overwrites.  The port's bench replays a saved calibration
(``cache_hit``) to the same ``value`` and ``vs_baseline`` as the JAX
package's replay under the same task times and link, and
``DLS_RECALIBRATE`` makes it refuse the file.
"""

import json

import jax
import numpy as np
import pytest
import torch

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu.eval import benchlib as JB
from distributed_llm_scheduler_tpu.frontend.gpt2_dag import build_gpt2_dag as jax_build
from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config as JaxConfig
from distributed_llm_scheduler_tpu.utils import costmodel as JC
from distributed_llm_scheduler_tpu_torch.eval import bench
from distributed_llm_scheduler_tpu_torch.utils import costmodel as TC

_, _, SHAPE = bench.CONFIGS["tiny"]
LINK = dict(param_load_gbps=20.0, interconnect_gbps=300.0, latency_s=8e-6)
SMALL = dict(batch=1, seq_len=8, microbatches=1, vocab_shards=1)
FIELDS = ("graph_name", "platform", "task_seconds", "dispatch_s", "method",
          "measured_at")


def _fields(cm):
    return {f: getattr(cm, f) for f in FIELDS}


def test_port_file_loads_in_jax(tmp_path):
    cm = TC.CostModel("g", "cuda", {"a": 1.25e-4, "b": 3e-5}, dispatch_s=2e-6,
                      method="profile", measured_at="2026-01-02T03:04:05+00:00")
    path = cm.save(str(tmp_path / "g_cuda.json"))
    assert _fields(JC.CostModel.load(path)) == _fields(cm)
    assert sorted(json.loads(open(path).read())) == sorted(FIELDS)


def test_jax_file_loads_in_port(tmp_path):
    jm = JC.CostModel("g", "tpu", {"x": 7e-4}, 1e-6, "amortized",
                      "2025-12-31T00:00:00+00:00")
    path = jm.save(str(tmp_path / "g_tpu.json"))
    tm = TC.CostModel.load(path)
    assert _fields(tm) == _fields(jm)
    assert tm.cache_hit is False


@pytest.fixture(scope="module")
def small_dag():
    dag = P.build_gpt2_dag(P.GPT2Config.tiny(), **SMALL)
    return (dag, dag.init_params(seed=0, device="cpu"),
            dag.make_inputs(seed=1, device="cpu"))


def test_calibrate_cached_hits_then_refreshes(small_dag, tmp_path):
    dag, params, ids = small_dag
    d = str(tmp_path)
    first = TC.calibrate_cached(dag.graph, params, ids, d, device="cpu",
                                repeats=1)
    path = TC.calibration_path(d, dag.graph.name, "cpu")
    assert first.cache_hit is False and first.method == "profile"
    assert set(first.task_seconds) == set(dag.graph.task_ids())
    again = TC.calibrate_cached(dag.graph, params, ids, d, device="cpu",
                                repeats=1)
    assert again.cache_hit is True
    assert _fields(again) == _fields(first)
    # a marked file: refresh re-measures and overwrites it
    marked = TC.CostModel.load(path)
    marked.task_seconds = {t: 9.0 for t in marked.task_seconds}
    marked.save(path)
    assert TC.calibrate_cached(dag.graph, params, ids, d, device="cpu",
                               repeats=1).task_seconds == marked.task_seconds
    fresh = TC.calibrate_cached(dag.graph, params, ids, d, device="cpu",
                                repeats=1, refresh=True)
    assert fresh.cache_hit is False
    assert all(v != 9.0 for v in TC.CostModel.load(path).task_seconds.values())


def test_each_package_replays_the_others_file(small_dag, tmp_path):
    """The port's file for a graph is the JAX package's file for the same
    graph (same name, same task ids): the JAX ``calibrate_cached`` hits it
    without measuring, and a task set that differs is refused by both."""
    dag, params, ids = small_dag
    d = str(tmp_path)
    port = TC.calibrate_cached(dag.graph, params, ids, d, device="cpu",
                               repeats=1)
    jdag = jax_build(JaxConfig.tiny(), **SMALL)
    assert jdag.graph.name == dag.graph.name
    hit = JC.calibrate_cached(jdag.graph, None, None, d)
    assert hit.cache_hit is True
    assert hit.task_seconds == port.task_seconds
    # a file missing a task, or from before the method field, is refused
    path = TC.calibration_path(d, dag.graph.name, "cpu")
    stale = TC.CostModel.load(path)
    stale.task_seconds.pop(next(iter(stale.task_seconds)))
    stale.save(path)
    assert TC.load_cached(path, dag.graph) is None
    TC.CostModel("g", "cpu", port.task_seconds).save(path)
    assert TC.load_cached(path, dag.graph) is None


def test_cache_age_and_recalibrate_knob(monkeypatch):
    assert TC.cache_age_days("") is None and TC.cache_age_days("junk") is None
    assert TC.cache_age_days("2099-01-01T00:00:00") == 0.0
    assert TC.cache_age_days("2020-01-01T00:00:00+00:00") > 365
    for value, want in (("", False), ("0", False), ("off", False),
                        ("1", True), ("yes", True)):
        monkeypatch.setenv("DLS_RECALIBRATE", value)
        assert TC.recalibrate_requested() is want
        assert JC.recalibrate_requested() is want
    monkeypatch.delenv("DLS_RECALIBRATE")
    assert TC.recalibrate_requested() is False


def _jax_best(secs, node_gb):
    """The JAX bench's replay under ``secs`` and LINK: best policy, its
    makespan and round-robin's (the port's pre-flight sets each task's
    output bytes on the CPU; the same is set here)."""
    jdag = jax_build(JaxConfig.tiny(), **SHAPE)
    jg = J.fuse_linear_chains(jdag.graph)
    JC.CostModel(jg.name, "x", secs).apply(jg)
    params, ids = jdag.init_params(), jdag.make_inputs()
    specs = {}
    for tid in jg.topo_order:
        t = jg[tid]
        pd = {loc: params[glob] for loc, glob in t.param_items()}
        args = [specs[d] for d in (t.arg_tasks or t.dependencies)] or [ids]
        specs[tid] = jax.eval_shape(t.fn, pd, *args)
        t.out_bytes = int(np.prod(specs[tid].shape)) * specs[tid].dtype.itemsize
    link = J.LinkModel(**LINK)
    sim = J.SimulatedBackend(fidelity="full", link=link)
    cluster = J.Cluster([J.DeviceState(f"core_{i}", node_gb) for i in range(8)])
    makespans = {}
    for name in sorted(P.ALL_SCHEDULERS):
        s = J.get_scheduler(name, link=link,
                            **bench.policy_kwargs(name)).schedule(jg, cluster)
        r = sim.execute(jg, cluster, s, dag_type="gpt2_tiny")
        makespans[name] = (r.makespan, r.completed_tasks / r.num_tasks)
    return JB.pick_best(makespans)


def test_bench_replays_a_saved_calibration_as_jax(tmp_path, monkeypatch):
    """A calibration saved by the JAX package, replayed by the port's
    bench from the file (``cache_hit``), gives the JAX replay's best
    policy, ``value`` and ``vs_baseline``; under ``DLS_RECALIBRATE`` (or
    ``refresh=True``) the bench refuses the file and, off the card, has
    nothing to measure with."""
    monkeypatch.delenv("DLS_RECALIBRATE", raising=False)
    tg = P.fuse_linear_chains(P.build_gpt2_dag(P.GPT2Config.tiny(), **SHAPE).graph)
    secs = {t.task_id: 1e-4 * (1 + (5 * i) % 13) for i, t in enumerate(tg)}
    d = str(tmp_path)
    JC.CostModel(tg.name, "cpu", secs, method="profile",
                 measured_at="2026-01-01T00:00:00+00:00").save(
        TC.calibration_path(d, tg.name, "cpu"))
    result = bench.run("tiny", "cpu", dtype=torch.float32,
                       link=P.LinkModel(**LINK), reps=1, cache_dir=d)
    assert result.cache_hit is True
    assert result.calibration_age_days > 0
    assert result.calibration_runs is None
    name, best, rr = _jax_best(secs, result.node_hbm_gb)
    assert (result.best_policy, result.best_makespan_s,
            result.baseline_makespan_s) == (name, best, rr)
    line = result.to_json()
    assert line["cache_hit"] is True
    assert line["value"] == round(best * 1e3, 4)
    assert line["vs_baseline"] == round(rr / best, 4)
    assert "link_model" not in line
    monkeypatch.setenv("DLS_RECALIBRATE", "1")
    with pytest.raises(ValueError, match="saved calibration"):
        bench.run("tiny", "cpu", dtype=torch.float32,
                  link=P.LinkModel(**LINK), reps=1, cache_dir=d)
    monkeypatch.delenv("DLS_RECALIBRATE")
    with pytest.raises(ValueError, match="saved calibration"):
        bench.run("tiny", "cpu", dtype=torch.float32, link=P.LinkModel(**LINK),
                  reps=1, cache_dir=d, refresh=True)
