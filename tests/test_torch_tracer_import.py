"""The port's reference-pickle importer and ``torch.fx`` tracer against the
JAX package's.

``frontend/reference_import.py`` is a framework-free copy: on
``tests/test_reference_import.py``'s pickles the graphs are equal, and the
same artifacts are refused with the same errors.  ``frontend/tracer.py``
traces ATen ops where the JAX tracer traces ``lax`` primitives, so the
task lists differ (ROADMAP.md C); on the same bridged GPT-2 tiny weights
its contract is structural: a linear chain, ``total_param_gb`` equal to
the JAX tracer's, every weight the JAX tracer charges to a matmul charged
to one here (a weight read only through a transpose included), and more
than ``4 x n_layer`` tasks.
"""

from __future__ import annotations

import io
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu.frontend import reference_import as JI
from distributed_llm_scheduler_tpu.frontend.tracer import (
    trace_to_chain as jtrace,
)
from distributed_llm_scheduler_tpu_torch.frontend import reference_import as PI
from distributed_llm_scheduler_tpu_torch.frontend.tracer import trace_to_chain
from distributed_llm_scheduler_tpu_torch.models import gpt2 as pgpt2
from test_reference_import import make_reference_pickle

MATMULS = ("mm", "addmm", "bmm")


def rows(graph):
    return [
        (t.task_id, list(t.dependencies), t.memory_required, t.compute_time,
         sorted(t.params_needed), dict(t.param_bytes))
        for t in (graph[tid] for tid in graph.topo_order)
    ]


# -- reference import ------------------------------------------------------------

def test_imported_graph_equals_the_jax_one(tmp_path):
    data = make_reference_pickle()
    assert "schedulers" not in sys.modules
    want = JI.load_reference_pickle(data)
    path = tmp_path / "gpt2_dag.pkl"
    path.write_bytes(data)
    for source in (data, str(path), io.BytesIO(data)):
        got = PI.load_reference_pickle(source)
        assert (got.name, rows(got)) == (want.name, rows(want))
        assert got.param_size_gb("p1") == want.param_size_gb("p1") == 0.5
    s = P.get_scheduler("mru").schedule(got, P.Cluster.uniform(2, 4.0))
    assert len(s.completed) == 4 and not s.failed


REFUSED = [
    pickle.dumps(print),                         # builtins.print
    pickle.dumps({"not": "a list"}),             # not a list of Tasks
    pickle.dumps([1, 2]),                        # entries are not Tasks
    pickle.dumps([{"id": "t1"}]),                # a dict has no __dict__
]


@pytest.mark.parametrize("data", REFUSED, ids=range(len(REFUSED)))
def test_refusals_equal_the_jax_ones(data):
    with pytest.raises(Exception) as want:
        JI.load_reference_pickle(data)
    with pytest.raises(Exception) as got:
        PI.load_reference_pickle(data)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)
    assert type(got.value) in (pickle.UnpicklingError, ValueError)


# -- the tracer ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def traced():
    """Both tracers over GPT-2 tiny's forward, on the JAX package's
    weights and ids bridged into the port."""
    from distributed_llm_scheduler_tpu.frontend.gpt2_dag import build_gpt2_dag
    from distributed_llm_scheduler_tpu.models import gpt2 as jgpt2

    jdag = build_gpt2_dag(jgpt2.GPT2Config.tiny(), batch=2, seq_len=16)
    jparams = jdag.init_params()
    ids = np.asarray(jdag.make_inputs())
    cfg = P.GPT2Config.tiny()
    params = P.params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                                 torch.device("cpu"))
    jg = jtrace(lambda i: jgpt2.forward(jparams, i, jdag.config),
                jnp.asarray(ids), name="gpt2")
    g = trace_to_chain(lambda i: pgpt2.forward(params, i, cfg),
                       torch.from_numpy(ids.copy()), name="gpt2")
    return cfg, jg, g


def test_tracer_is_a_linear_chain(traced):
    cfg, _jg, g = traced
    assert len(g) > cfg.n_layer * 4
    order = g.topo_order
    for i, tid in enumerate(order):
        assert g[tid].dependencies == ([] if i == 0 else [order[i - 1]])
        assert tid.startswith("gpt2_op")


def test_tracer_charges_the_jax_tracers_params(traced):
    """``total_param_gb`` equal to the JAX tracer's; the weights the JAX
    tracer charges to ``dot_general`` tasks, by size, are the ones this
    tracer charges to its matmul tasks; every closed-over weight reaches
    some task."""
    _cfg, jg, g = traced
    assert g.total_param_gb() == jg.total_param_gb() > 0
    assert len(g.unique_params()) == len(jg.unique_params())
    jm = {p for t in jg if t.group == "dot_general" for p in t.params_needed}
    pm = {p for t in g if t.group in MATMULS for p in t.params_needed}
    assert len(pm) == len(jm) > 0
    assert (sorted(g.param_size_gb(p) for p in pm)
            == sorted(jg.param_size_gb(p) for p in jm))


def test_tracer_tracks_params_through_trivial_ops():
    """A weight consumed only through a transpose (and a cast) still
    charges the matmul (``tests/test_gpt2_dag.py:146-155``)."""
    w = torch.ones(64, 32, dtype=torch.float64)
    g = trace_to_chain(lambda x: x @ w.float().T, torch.ones(8, 32), name="tw")
    assert g.total_param_gb() == 64 * 32 * 8 / 1024**3
    (task,) = [t for t in g if t.group in MATMULS]
    assert task.params_needed == {"tw_const_0"}
    jw = jnp.ones((64, 32), jnp.float32)
    jg = jtrace(lambda x: x @ jw.T, jnp.ones((8, 32)), name="tw")
    ((jt,),) = [[t for t in jg if "dot_general" in t.task_id]]
    assert len(g) == len(jg) == 1 and task.memory_required == jt.memory_required


def test_tracer_min_task_bytes_folds_small_ops():
    """Ops whose outputs are under ``min_task_bytes`` fold into the next
    task, which carries their params; seed times grow with what folded."""
    w = torch.ones(16, 16)
    fn = lambda x: torch.relu(x @ w).sum()  # noqa: E731
    full = trace_to_chain(fn, torch.ones(4, 16), name="f")
    folded = trace_to_chain(fn, torch.ones(4, 16), name="f",
                            min_task_bytes=64)
    assert [t.group for t in full] == ["mm", "relu", "sum"]
    assert [t.group for t in folded] == ["mm", "relu"]
    assert folded.total_param_gb() == full.total_param_gb()


def test_tracer_runs_on_meta_tensors():
    """The card's path: weights and ids on ``meta`` (no FLOPs spent, no
    kernel launched), the same graph as on the CPU."""
    cfg = P.GPT2Config.tiny()
    params = P.params_from_numpy(pgpt2.init_params_numpy(cfg, 0),
                                 torch.device("cpu"))
    ids = torch.zeros(2, 16, dtype=torch.int32)
    cpu = trace_to_chain(lambda i: pgpt2.forward(params, i, cfg), ids)
    meta = {k: v.to("meta") for k, v in params.items()}
    on_meta = trace_to_chain(lambda i: pgpt2.forward(meta, i, cfg),
                             ids.to("meta"))
    assert rows(on_meta) == rows(cpu)
