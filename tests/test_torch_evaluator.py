"""The port's evaluator (``eval/evaluator.py``, the paper's sweep) against
the JAX package's.

Over a small grid at fixed seeds (the three small sweep workloads, 2 and 4
nodes, regimes 1.0 and 0.8, every policy but ``search``), single-slice at
seed 0 and multislice at seed 1, every ``to_row()`` must be equal but for
``execution_time`` (the scheduling wall, a host timing).  ``search``, the
annealer that costs more than every other policy together, is held on one
workload and node count in both topologies.  The CSV, written without pandas, must
have the JAX CSV's header and rows that parse to equal values; the
summary must name the same best policies with the same means; the PNG
must be written.
"""

from __future__ import annotations

import contextlib
import csv
import io

import pytest

from distributed_llm_scheduler_tpu.eval.evaluator import Evaluator as JEvaluator
from distributed_llm_scheduler_tpu.frontend import generators as JG
from distributed_llm_scheduler_tpu_torch.eval.evaluator import Evaluator
from distributed_llm_scheduler_tpu_torch.frontend import generators as PG
from distributed_llm_scheduler_tpu_torch.sched.policies import ALL_SCHEDULERS

SMALL = ("llm_small", "random_small", "pipeline_small")
GRID = dict(node_counts=(2, 4), memory_regimes=(1.0, 0.8))
TIMED = "execution_time"
POLICIES = [n for n in sorted(ALL_SCHEDULERS) if n != "search"]


def _sweep(E, gen, slices, seed, workloads=SMALL, schedulers=POLICIES,
           grid=GRID):
    ev = E(schedulers=schedulers,
           workloads={k: gen.SWEEP_WORKLOADS[k] for k in workloads},
           slices=slices, **grid)
    ev.run_experiments(num_runs=1, seed=seed)
    return ev


@pytest.fixture(scope="module", params=[(1, 0), (2, 1)],
                ids=["single_slice", "multislice"])
def sweeps(request):
    slices, seed = request.param
    return _sweep(Evaluator, PG, slices, seed), _sweep(JEvaluator, JG, slices,
                                                       seed)


def _untimed(row):
    return {k: v for k, v in row.items() if k != TIMED}


def test_rows_equal(sweeps):
    port, ref = sweeps
    assert len(port.reports) == len(ref.reports) > 0
    for p, j in zip(port.reports, ref.reports):
        assert list(p.to_row()) == list(j.to_row())
        assert _untimed(p.to_row()) == _untimed(j.to_row())


@pytest.mark.parametrize("slices,seed", [(1, 0), (2, 1)],
                         ids=["single_slice", "multislice"])
def test_search_rows_equal(slices, seed):
    kw = dict(workloads=("llm_small",), schedulers=["search"],
              grid=dict(node_counts=(4,), memory_regimes=(1.0, 0.8)))
    port = _sweep(Evaluator, PG, slices, seed, **kw)
    ref = _sweep(JEvaluator, JG, slices, seed, **kw)
    assert len(port.reports) == len(ref.reports) == 2
    for p, j in zip(port.reports, ref.reports):
        assert _untimed(p.to_row()) == _untimed(j.to_row())


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _cell(s: str):
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    return s


def test_csv_equal(sweeps, tmp_path):
    port, ref = sweeps
    got = _read(port.write_csv(str(tmp_path / "p" / "raw_results.csv")))
    want = _read(ref.write_csv(str(tmp_path / "j" / "raw_results.csv")))
    assert got[0] == want[0]  # the header, in the JAX column order
    assert len(got) == len(want)
    t = got[0].index(TIMED)
    for g, w in zip(got[1:], want[1:]):
        assert [_cell(c) for i, c in enumerate(g) if i != t] == \
               [_cell(c) for i, c in enumerate(w) if i != t]
        float(g[t])


def test_summary_equal(sweeps):
    port, ref = sweeps
    got, want = port.summarize(), ref.summarize()
    assert set(got) == set(want)
    for k in ("best_completion", "best_makespan", "best_load_balance"):
        assert got[k] == want[k], k
    assert list(got["mean_metrics"]) == list(want["mean_metrics"])
    for name, metrics in want["mean_metrics"].items():
        assert got["mean_metrics"][name] == pytest.approx(metrics, rel=1e-12)
    assert got.get("llm_cache_hit_rate") == pytest.approx(
        want.get("llm_cache_hit_rate"), rel=1e-12)
    texts = []
    for ev in (port, ref):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            ev.print_summary()
        texts.append(out.getvalue())
    assert texts[0] == texts[1]


def test_png_written(sweeps, tmp_path):
    path = sweeps[0].write_plots(str(tmp_path / "scheduler_performance.png"))
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_multislice_refusals_match():
    from distributed_llm_scheduler_tpu.backends.sim import (
        SimulatedBackend as JSim,
    )
    from distributed_llm_scheduler_tpu_torch.backends.sim import SimulatedBackend

    for E, Sim in ((Evaluator, SimulatedBackend), (JEvaluator, JSim)):
        with pytest.raises(ValueError, match="TieredLinkModel"):
            E(slices=2, backend=Sim())
        with pytest.raises(ValueError, match="divisible by slices=4"):
            E(slices=4, node_counts=(2, 6))
