"""The port's incremental analyzer against the JAX package's.

Both analyzers start from the same placed schedule and take the same
moves; the contract is equality: the same ``exact_fast_path``, the same
``AnalysisDelta.added``/``removed`` (compared as diagnostics: code,
severity, task, node, param, message) and recomputed slices per
``move_task``, the same error counts, and ``verify()`` clean after every
move.  The fixtures are the JAX package's own (``tests/test_incremental.
py``) plus a random walk on a GPT-2 tiny DAG with its param and input
specs.
"""

import random

import pytest

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu.analysis import (
    IncrementalAnalyzer as JInc,
)
from distributed_llm_scheduler_tpu.core.schedule import Schedule as JSchedule
from distributed_llm_scheduler_tpu_torch.analysis import (
    IncrementalAnalyzer as PInc,
)
from distributed_llm_scheduler_tpu_torch.core.schedule import (
    Schedule as PSchedule,
)

GB = 1 << 30
PKGS = ((J, JInc, JSchedule), (P, PInc, PSchedule))


def sched(S, per_node, order=None):
    if order is None:
        order = [t for tids in per_node.values() for t in tids]
    return S(policy="manual", per_node=per_node, assignment_order=order,
             completed=set(order))


def chain_graph(pkg, sizes_gb):
    tasks, prev = [], []
    for i, s in enumerate(sizes_gb):
        tasks.append(pkg.Task(
            f"t{i}", 0.05, 1.0, list(prev), {f"p{i}"},
            param_bytes={f"p{i}": int(s * GB)},
        ))
        prev = [f"t{i}"]
    return pkg.TaskGraph(tasks).freeze()


def two_caps(pkg, cap0=4.0, cap1=4.0):
    return pkg.Cluster([pkg.DeviceState("n0", cap0),
                        pkg.DeviceState("n1", cap1)])


def diag(d):
    return (d.code, int(d.severity), d.task, d.node, d.param, d.message)


def delta(d):
    return (d.tid, d.src, d.dst, [diag(x) for x in d.added],
            [diag(x) for x in d.removed], d.recomputed, d.ok)


CHAINS = {
    # (sizes, caps, per_node, order, moves)
    "overcommit_and_undo": (
        (0.1, 0.8, 0.1, 0.1), (0.5, 4.0),
        {"n0": ["t0"], "n1": ["t1", "t2", "t3"]}, None,
        [("t1", "n0"), ("t1", "n1"), ("t3", "n0"), ("t0", "n1")]),
    "noop_move": ((0.1, 0.1), (4.0, 4.0), {"n0": ["t0", "t1"]}, None,
                  [("t0", "n0"), ("t1", "n1")]),
    "dirty_baseline": (
        (0.1, 0.1, 0.1), (4.0, 4.0), {"n0": ["t1", "t0", "t2"]},
        ["t1", "t0", "t2"], [("t2", "n1"), ("t0", "n1")]),
    "strict_memory": (
        (0.6, 0.6, 0.2), (1.0, 1.0), {"n0": ["t0", "t1", "t2"]}, None,
        [("t2", "n1"), ("t1", "n1"), ("t1", "n0")]),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_moves_equal_jax(name):
    sizes, caps, per_node, order, moves = CHAINS[name]
    incs = []
    for pkg, Inc, S in PKGS:
        g = chain_graph(pkg, sizes)
        incs.append(Inc(g, two_caps(pkg, *caps),
                        sched(S, {n: list(ts) for n, ts in per_node.items()},
                              order),
                        strict=name == "strict_memory"))
    ji, pi = incs
    assert pi.exact_fast_path == ji.exact_fast_path
    assert pi.error_count() == ji.error_count()
    assert [diag(d) for d in pi.report.diagnostics] == [
        diag(d) for d in ji.report.diagnostics]
    for tid, dst in moves:
        jd, pd = ji.move_task(tid, dst), pi.move_task(tid, dst)
        assert delta(pd) == delta(jd), (tid, dst)
        assert pi.error_count() == ji.error_count()
        assert pi.placement == ji.placement
        assert pi.schedule.per_node == ji.schedule.per_node
        assert [diag(d) for d in pi.verify().diagnostics] == [
            diag(d) for d in ji.verify().diagnostics]
    assert pi.report.schedule_signature == ji.report.schedule_signature


def test_bad_moves_raise_and_the_caller_schedule_stays():
    g = chain_graph(P, (0.1, 0.1, 0.1))
    s = sched(PSchedule, {"n0": ["t0", "t1", "t2"]})
    snap = s.signature()
    inc = PInc(g, two_caps(P), s)
    with pytest.raises(KeyError):
        inc.move_task("t0", "bogus")
    with pytest.raises(KeyError):
        inc.move_task("ghost", "n1")
    inc.move_task("t1", "n1")
    assert s.signature() == snap and inc.placement["t1"] == "n1"


@pytest.fixture(scope="module")
def gpt2_pair():
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

    kw = dict(batch=2, seq_len=8, microbatches=2, vocab_shards=4)
    return jb(JC.tiny(), **kw), tb(TC.tiny(), **kw)


@pytest.mark.parametrize("frac", [0.3, 4.0])
def test_random_walk_on_gpt2_equals_jax(gpt2_pair, frac):
    """60 random moves from pack's placement on the reference's
    heterogeneous split (35/25/25/15% of ``frac`` times the params), at a
    budget where moves onto the small node overcommit it and at a roomy
    one: every delta equal, and ``verify()`` clean after every move in
    both packages."""
    incs = []
    for (pkg, Inc, _S), dag in zip(PKGS, gpt2_pair):
        c = pkg.Cluster.heterogeneous(frac * dag.graph.total_param_gb(), 4)
        s = pkg.GroupPackScheduler().schedule(dag.graph, c)
        incs.append(Inc(dag.graph, c, s, params=dag.param_specs,
                        graph_input=dag.input_spec))
    ji, pi = incs
    assert pi.exact_fast_path == ji.exact_fast_path
    rng = random.Random(1234)
    tids = sorted(pi.placement)
    nodes = sorted(set(pi.schedule.per_node))
    errors = 0
    for _ in range(60):
        tid = rng.choice(tids)
        dst = rng.choice([n for n in nodes if n != pi.placement[tid]])
        jd, pd = ji.move_task(tid, dst), pi.move_task(tid, dst)
        assert delta(pd) == delta(jd), (tid, dst)
        pi.verify()
        errors += pi.error_count()
    assert pi.moves == ji.moves == 60
    assert [diag(d) for d in pi.verify().diagnostics] == [
        diag(d) for d in ji.verify().diagnostics]
    if frac < 1.0:
        assert errors, "no move overcommitted a node: the walk is vacuous"
