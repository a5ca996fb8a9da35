"""The port's interconnect probe (``eval/ici_probe.py``) against the JAX
package's: the same re-scheduling sweep over a tier's scales on the tiny
Llama DAG over a modeled 2 x 4 multislice, the tie band, ``run_probe``'s
structure and the usage exit.  Host-only on both sides: the policies and
the simulator, no device."""

from __future__ import annotations

import functools
import runpy
import sys

import pytest

from distributed_llm_scheduler_tpu.backends.sim import TieredLinkModel as JLink
from distributed_llm_scheduler_tpu.core.cluster import Cluster as JCluster
from distributed_llm_scheduler_tpu.eval import ici_probe as JI
from distributed_llm_scheduler_tpu.frontend.llama_dag import build_llama_dag as jbuild
from distributed_llm_scheduler_tpu.models.llama import LlamaConfig as JLlama
from distributed_llm_scheduler_tpu_torch.backends.sim import TieredLinkModel as PLink
from distributed_llm_scheduler_tpu_torch.core.cluster import Cluster as PCluster
from distributed_llm_scheduler_tpu_torch.eval import ici_probe as PI
from distributed_llm_scheduler_tpu_torch.frontend.llama_dag import build_llama_dag as pbuild
from distributed_llm_scheduler_tpu_torch.models.llama import LlamaConfig as PLlama

SCALES = (0.25, 1.0, 4.0)
QUIET = dict(log=lambda m: None)


def _setup(build, cfg, cluster):
    dag = build(cfg.tiny(), batch=4, seq_len=32, microbatches=4)
    return dag.graph, cluster.multislice(2, 4, dag.graph.total_param_gb())


@pytest.fixture(scope="module")
def graphs():
    return (_setup(jbuild, JLlama, JCluster), _setup(pbuild, PLlama, PCluster))


@pytest.fixture(scope="module")
def ici_sweeps(graphs):
    """The ici tier swept over the nine policies by each package."""
    (jg, jc), (pg, pc) = graphs
    return (JI.sweep_interconnect("ici", SCALES, jg, jc, JLink(), **QUIET),
            PI.sweep_interconnect("ici", SCALES, pg, pc, PLink(), **QUIET))


@pytest.fixture(scope="module")
def dcn_sweeps(graphs, ici_sweeps):
    """The dcn tier swept by each package, its x1.0 row shared with the
    ici sweep's as ``run_probe`` shares it."""
    (jg, jc), (pg, pc) = graphs
    jbase, pbase = (s["scales"]["x1.0"] for s in ici_sweeps)
    return (JI.sweep_interconnect("dcn", SCALES, jg, jc, JLink(), base_row=jbase,
                                  **QUIET),
            PI.sweep_interconnect("dcn", SCALES, pg, pc, PLink(), base_row=pbase,
                                  **QUIET))


def test_policies_equal_the_jax_nine():
    assert PI.POLICIES == JI.POLICIES and len(PI.POLICIES) == 9


def _assert_sweeps_equal(want, got):
    assert set(got["scales"]) == set(want["scales"]) == {"x0.25", "x1.0", "x4.0"}
    for key, w in want["scales"].items():
        g = got["scales"][key]
        assert g["winner"] == w["winner"], key
        assert g["winner_cross_slice_edges"] == w["winner_cross_slice_edges"], key
        assert g["incomplete"] == w["incomplete"], key
        assert set(g["makespans_ms"]) == set(w["makespans_ms"]), key
        for pol, m in w["makespans_ms"].items():
            assert g["makespans_ms"][pol] == pytest.approx(m, rel=1e-9), (key, pol)
        assert g["best_makespan_ms"] == pytest.approx(w["best_makespan_ms"], rel=1e-9)
    assert got["winner_flips"] == want["winner_flips"]
    for k in ("max_best_makespan_movement", "max_any_policy_movement"):
        assert got[k] == pytest.approx(want[k], rel=1e-9), k


def test_sweep_equals_the_jax_sweep(ici_sweeps):
    _assert_sweeps_equal(*ici_sweeps)


def test_dcn_sweep_equals_the_jax_sweep(dcn_sweeps):
    """The tier with leverage in the 8B probe: every policy re-scheduled
    at DCN x0.25 and x4.0, held to the JAX sweep as the ici tier is."""
    _assert_sweeps_equal(*dcn_sweeps)


def test_tie_band_suppresses_noise_flips(graphs):
    """The JAX test's case: two policies within 2% trading first place is a
    tie, not a flip; the port's sweep makes the same claim."""
    (jg, jc), (pg, pc) = graphs
    pols = ("roundrobin", "heft")
    want = JI.sweep_interconnect("ici", SCALES, jg, jc, JLink(), policies=pols, **QUIET)
    out = PI.sweep_interconnect("ici", SCALES, pg, pc, PLink(), policies=pols, **QUIET)
    assert out["winner_flips"] == want["winner_flips"]
    if out["winner_flips"]:
        rows = out["scales"]
        base = rows["x1.0"]
        changed = [r for r in rows.values() if r["winner"] != base["winner"]]
        assert any(r["best_makespan_ms"] < r["makespans_ms"][base["winner"]] * 0.98
                   for r in changed)


def test_a_free_tier_is_skipped(graphs):
    _, (pg, pc) = graphs
    out = PI.sweep_interconnect("dcn", SCALES, pg, pc, PLink(dcn_gbps=None), **QUIET)
    assert out["skipped"].startswith("dcn tier is None") and out["scales"] == {}


def test_run_probe_tiny_structure(monkeypatch):
    """``run_probe("tiny")`` end to end with ``refine`` left out of the
    sweep (it takes most of the time and adds no key)."""
    fast = tuple(p for p in PI.POLICIES if p != "refine")
    monkeypatch.setattr(PI, "sweep_interconnect", functools.partial(
        PI.sweep_interconnect, policies=fast))
    res = PI.run_probe("tiny", **QUIET)
    assert res["n_tasks"] > 10 and res["policies"] == list(PI.POLICIES)
    assert res["cluster"] == "8 cores / 2 slices"
    for tier in ("ici", "dcn"):
        sweep = res[tier]
        assert set(sweep["scales"]) == {"x0.25", "x1.0", "x4.0"}
        for row in sweep["scales"].values():
            assert row["winner"] is not None
            assert row["best_makespan_ms"] > 0
            assert row["winner_cross_slice_edges"] is not None
        assert sweep["max_best_makespan_movement"] is not None
        assert sweep["max_any_policy_movement"] is not None
    # the x1.0 row is computed once and shared by both tiers
    assert res["ici"]["scales"]["x1.0"] is res["dcn"]["scales"]["x1.0"]
    assert set(res["conclusion"]) == {
        "ici_moves_best_makespan_over_5pct",
        "dcn_moves_best_makespan_over_5pct",
        "any_winner_flip",
    }
    assert res["wall_s"] >= 0


def test_usage_exit(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["ici_probe", "70b"])
    with pytest.raises(SystemExit) as ei:
        runpy.run_module("distributed_llm_scheduler_tpu_torch.eval.ici_probe",
                         run_name="__main__")
    assert str(ei.value) == "usage: ici_probe.py [8b|tiny], got '70b'"
