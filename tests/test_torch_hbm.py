"""The port's pre-flight memory accounting against the JAX package's.

On the CPU the port propagates shapes on the ``meta`` device and sets each
task's ``out_bytes``; the JAX package reads XLA's compiled
``output_size_in_bytes``.  For a task whose fn returns one array the two
must be equal.  XLA counts a tuple's index table as well, so a task that
returns more than one array would be left out of the comparison: no task
of the tiny f32 GPT-2 DAG (as built or with chains fused) or of the tiny
f32 Llama DAG does (the test checks that with ``jax.eval_shape``).  On the
CPU the port reads no allocator peak, so ``memory_required`` must stay as
it was; measuring on the card is in ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu.frontend.gpt2_dag import (
    build_gpt2_dag as jax_gpt2,
)
from distributed_llm_scheduler_tpu.frontend.llama_dag import (
    build_llama_dag as jax_llama,
)
from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config as JGPT2
from distributed_llm_scheduler_tpu.models.llama import LlamaConfig as JLlama
from distributed_llm_scheduler_tpu.utils.hbm import (
    _spec_of,
    preflight_task_memory as jax_preflight,
)
from distributed_llm_scheduler_tpu_torch.frontend.gpt2_dag import (
    build_gpt2_dag as torch_gpt2,
)
from distributed_llm_scheduler_tpu_torch.frontend.llama_dag import (
    build_llama_dag as torch_llama,
)
from distributed_llm_scheduler_tpu_torch.models.gpt2 import GPT2Config as TGPT2
from distributed_llm_scheduler_tpu_torch.models.llama import (
    LlamaConfig as TLlama,
)
from distributed_llm_scheduler_tpu_torch.utils.hbm import preflight_task_memory

CPU = torch.device("cpu")


def _dags(kind):
    if kind == "llama":
        kw = dict(batch=4, seq_len=16, microbatches=2, vocab_shards=3)
        return (jax_llama(JLlama.tiny(dtype=jnp.float32), **kw),
                torch_llama(TLlama.tiny(dtype=torch.float32), **kw))
    kw = dict(batch=4, seq_len=32, microbatches=2, vocab_shards=4)
    return jax_gpt2(JGPT2.tiny(), **kw), torch_gpt2(TGPT2.tiny(), **kw)


def _multi_array_tasks(graph, params, ids):
    """Tasks whose JAX fn returns more than one array."""
    specs, multi = {}, []
    for tid in graph.topo_order:
        t = graph[tid]
        pd = {loc: _spec_of(params[glob]) for loc, glob in t.param_items()}
        arg_ids = t.arg_tasks or t.dependencies
        args = tuple(specs[d] for d in arg_ids) if arg_ids else (_spec_of(ids),)
        specs[tid] = jax.eval_shape(t.fn, pd, *args)
        if len(jax.tree_util.tree_leaves(specs[tid])) != 1:
            multi.append(tid)
    return multi


@pytest.mark.parametrize("kind,fused", [("gpt2", False), ("gpt2", True),
                                        ("llama", True)])
def test_out_bytes_equal_jax(kind, fused):
    jdag, tdag = _dags(kind)
    jg, tg = jdag.graph, tdag.graph
    if fused:
        jg, tg = J.fuse_linear_chains(jg), P.fuse_linear_chains(tg)
    jparams, jids = jdag.init_params(), jdag.make_inputs()
    tparams = tdag.init_params(device=CPU)
    tids = torch.from_numpy(np.array(jids))
    before = {t.task_id: t.memory_required for t in tg}

    assert _multi_array_tasks(jg, jparams, jids) == []
    jax_preflight(jg, jparams, jids)
    assert preflight_task_memory(tg, tparams, tids) == {}
    for t in tg:
        assert t.out_bytes == jg[t.task_id].out_bytes, t.task_id
        assert t.memory_required == before[t.task_id], t.task_id


def test_never_lowers_and_leaves_estimates_on_the_cpu():
    _, tdag = _dags("gpt2")
    tg = tdag.graph
    big = next(iter(tg))
    big.memory_required = 5.0
    preflight_task_memory(tg, tdag.init_params(device=CPU),
                          tdag.make_inputs(device=CPU))
    assert big.memory_required == 5.0
    assert all(t.out_bytes > 0 for t in tg)


def test_each_distinct_fn_and_shapes_runs_once(monkeypatch):
    """Tasks with the same fn and input shapes share one entry: the
    pre-flight sizes each distinct (fn, param and input shapes) once, the
    count the card would run."""
    from distributed_llm_scheduler_tpu_torch.utils import hbm

    _, tdag = _dags("gpt2")
    tg = P.fuse_linear_chains(tdag.graph)
    params = tdag.init_params(device=CPU)
    ids = tdag.make_inputs(device=CPU)
    sized = []
    real = hbm._nbytes
    monkeypatch.setattr(hbm, "_nbytes", lambda x: sized.append(1) or real(x))
    preflight_task_memory(tg, params, ids)

    def shapes(t):
        deps = t.arg_tasks or t.dependencies
        ins = [tuple(tg[d].out_shape.shape) for d in deps] or [tuple(ids.shape)]
        return (id(t.fn),
                tuple(tuple(params[g].shape) for _, g in t.param_items()),
                tuple(ins))

    assert len(sized) == len({shapes(t) for t in tg}) < len(tg)


def test_schedule_only_graphs_are_left_alone():
    g = P.TaskGraph([P.Task("a", 0.5, 1.0, [])], name="sched_only").freeze()
    assert preflight_task_memory(g, {}, None) == {}
    assert g["a"].memory_required == 0.5 and g["a"].out_bytes is None
