"""The port's schedule and memory passes and ``validate_schedule`` against
the JAX package's.

Diagnostics carry no floating-point tensors, so the contract is equality:
the same graph placed by the same policy on the same cluster gives the
same ``ok``, codes, severities, messages, provenance and data payloads in
both packages, and the same per-node no-evict peaks.  The clusters are a
roomy one, where every policy completes, and a memory-tight one (each of
4 nodes holds 30% of the params), the reference's MRU scenario: MRU
completes by evicting while the other policies fail tasks.  A corrupted
schedule covers the error codes.
"""

import copy
import json

import pytest
import torch  # noqa: F401

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu.analysis import (
    analyze_memory as j_memory,
    analyze_schedule as j_schedule,
)
from distributed_llm_scheduler_tpu.frontend.gpt2_dag import (
    build_gpt2_dag as jax_build,
)
from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config as JaxConfig
from distributed_llm_scheduler_tpu_torch.analysis import (
    AnalysisReport,
    Diagnostic,
    Severity,
    analyze_memory as t_memory,
    analyze_schedule as t_schedule,
)
from distributed_llm_scheduler_tpu_torch.frontend.gpt2_dag import (
    build_gpt2_dag as torch_build,
)
from distributed_llm_scheduler_tpu_torch.models.gpt2 import (
    GPT2Config as TorchConfig,
)

POLICIES = sorted(P.ALL_SCHEDULERS)
KW = dict(batch=2, seq_len=16, microbatches=2, vocab_shards=4)
# node budget as a fraction of the graph's param GB, 4 nodes
CLUSTERS = {"roomy": 4.0, "tight": 0.3}


@pytest.fixture(scope="module")
def graphs():
    j = J.fuse_linear_chains(jax_build(JaxConfig.tiny(), **KW).graph)
    t = P.fuse_linear_chains(torch_build(TorchConfig.tiny(), **KW).graph)
    return j, t


@pytest.fixture(scope="module")
def placed(graphs):
    """(cluster, policy) -> (jax cluster, jax schedule, port cluster, port
    schedule), scheduled once per module."""
    jg, tg = graphs
    out = {}
    for cname, frac in CLUSTERS.items():
        gb = frac * jg.total_param_gb()
        for name in POLICIES:
            jc, tc = J.Cluster.uniform(4, gb), P.Cluster.uniform(4, gb)
            out[cname, name] = (
                jc, J.get_scheduler(name).schedule(jg, jc),
                tc, P.get_scheduler(name).schedule(tg, tc),
            )
    return out


def corrupt(schedule):
    """The same damage in either package: a list on an unknown node, a task
    on two nodes, the global order reversed, a placed task not completed."""
    nodes = [n for n, lst in schedule.per_node.items() if lst]
    first = schedule.per_node[nodes[0]][0]
    schedule.per_node["ghost"] = [first]
    other = [n for n in schedule.per_node if n not in (nodes[0], "ghost")][0]
    schedule.per_node[other].append(first)
    schedule.assignment_order.reverse()
    schedule.completed.discard(schedule.per_node[nodes[-1]][-1])
    return schedule


def fields(rep):
    return [
        (d.code, str(d.severity), d.message, d.task, d.node, d.param,
         json.dumps(d.data, sort_keys=True))
        for d in rep.diagnostics
    ]


def test_tight_cluster_is_the_mru_scenario(graphs, placed):
    """MRU completes by evicting; every other policy fails tasks there."""
    jg, _ = graphs
    for name in POLICIES:
        jc, js, _, _ = placed["tight", name]
        if name == "mru":
            assert not js.failed
            assert J.validate_schedule(jg, jc, js).requires_eviction
        else:
            assert js.failed, name


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
@pytest.mark.parametrize("policy", POLICIES)
def test_analyze_schedule_equals_jax(graphs, placed, cluster, policy):
    jg, tg = graphs
    jc, js, tc, ts = placed[cluster, policy]
    j, t = j_schedule(jg, jc, js), t_schedule(tg, tc, ts)
    assert t.ok == j.ok
    assert fields(t) == fields(j)


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
@pytest.mark.parametrize("policy", POLICIES)
def test_analyze_memory_equals_jax(graphs, placed, cluster, policy):
    jg, tg = graphs
    jc, js, tc, ts = placed[cluster, policy]
    for strict in (False, True):
        j = j_memory(jg, jc, js, strict=strict)
        t = t_memory(tg, tc, ts, strict=strict)
        assert t.ok == j.ok
        assert fields(t) == fields(j)


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
@pytest.mark.parametrize("policy", POLICIES)
def test_validate_schedule_equals_jax(graphs, placed, cluster, policy):
    jg, tg = graphs
    jc, js, tc, ts = placed[cluster, policy]
    j, t = J.validate_schedule(jg, jc, js), P.validate_schedule(tg, tc, ts)
    assert (t.ok, t.violations, t.requires_eviction, t.summary()) == (
        j.ok, j.violations, j.requires_eviction, j.summary())
    assert t.peak_no_evict_gb == j.peak_no_evict_gb


def test_corrupted_schedule_gives_jax_errors(graphs, placed):
    jg, tg = graphs
    jc, js, tc, ts = placed["roomy", "greedy"]
    js, ts = corrupt(copy.deepcopy(js)), corrupt(copy.deepcopy(ts))
    j, t = j_schedule(jg, jc, js), t_schedule(tg, tc, ts)
    assert not t.ok and fields(t) == fields(j)
    assert {"SCH001", "SCH003", "SCH005", "SCH008", "SCH009"} <= {
        d.code for d in t.diagnostics}
    jv, tv = J.validate_schedule(jg, jc, js), P.validate_schedule(tg, tc, ts)
    assert tv.violations == jv.violations and not tv.ok


def test_report_json_round_trips_equal(graphs, placed):
    """``to_json`` of the port's report equals the JAX one's, survives a
    JSON round trip, and rebuilds diagnostics that compare equal."""
    jg, tg = graphs
    jc, js, tc, ts = placed["tight", "mru"]
    j = j_memory(jg, jc, js).extend(j_schedule(jg, jc, js))
    t = t_memory(tg, tc, ts).extend(t_schedule(tg, tc, ts))
    assert t.has("MEM002") and t.has("MEM001")
    doc = json.loads(json.dumps(t.to_json()))
    assert doc == json.loads(json.dumps(j.to_json()))
    back = AnalysisReport([
        Diagnostic(d["code"], Severity[d["severity"].upper()], d["message"],
                   task=d["task"], node=d["node"], param=d["param"],
                   data=d["data"])
        for d in doc["diagnostics"]
    ])
    assert back.diagnostics == t.diagnostics
    assert back.to_json() == doc
    assert t.render() == j.render()
    assert t.dedupe().render() == j.dedupe().render()
