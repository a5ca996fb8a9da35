"""The port's collective sweep (``analysis/parallel_sweep``, the
``collective_probe`` hooks, ``parallel/simworld``) against the JAX
package's.

The JAX sweep traces each probe into a jaxpr and walks it; the port runs
each probe on every rank of a simulated world (a thread a rank) and
checks what the ranks issued.  Held here: the registry, a clean sweep at
1 and 8 ranks (the JAX sweep's 8-device CPU mesh), COL008 for a missing
probe, COL003 and COL004 on seeded faults with the JAX walk's code and
severity on its counterpart fault, the hops' permutations of the ring
and pipeline probes equal to the ``ppermute`` perms of the JAX probes'
jaxprs, and the simulated collectives' results equal to the unsharded
computation.
"""

from __future__ import annotations

import contextlib
import io
import time

import numpy as np
import pytest
import torch

from distributed_llm_scheduler_tpu import parallel as JP
from distributed_llm_scheduler_tpu.analysis import AnalysisReport as JReport
from distributed_llm_scheduler_tpu.analysis import collective_pass as JC
from distributed_llm_scheduler_tpu.analysis import sweep_parallel_collectives as jsweep
from distributed_llm_scheduler_tpu_torch import parallel as PP
from distributed_llm_scheduler_tpu_torch.__main__ import main as pmain
from distributed_llm_scheduler_tpu_torch.analysis import (
    analyze_collectives_ranks,
    sweep_parallel_collectives,
)
from distributed_llm_scheduler_tpu_torch.parallel import simworld
from distributed_llm_scheduler_tpu_torch.parallel.collectives import all_reduce_, dist
from distributed_llm_scheduler_tpu_torch.parallel.mesh import make_axes_mesh

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("DLS_PLATFORM", "cpu")
    monkeypatch.delenv("DLS_FORCE_CPU", raising=False)


@pytest.fixture(scope="module")
def swept():
    """The port's sweep at 8 ranks: (report, each probe's sequences)."""
    traces = {}
    rep = sweep_parallel_collectives(devices=CPU8, traces=traces)
    return rep, traces


def _fields(rep):
    return sorted((d.code, d.severity.name, d.task) for d in rep.diagnostics)


def _codes(rep):
    return {(d.code, d.severity.name) for d in rep.diagnostics}


def test_registry_equals_the_jax_tuple():
    assert PP.COLLECTIVE_ENTRY_POINTS == JP.COLLECTIVE_ENTRY_POINTS


@pytest.mark.parametrize("ranks", [1, 8])
def test_sweep_is_clean(ranks, swept):
    rep = swept[0] if ranks == 8 else sweep_parallel_collectives(
        devices=[torch.device("cpu")] * ranks)
    assert rep.ok and rep.diagnostics == [], [d.render() for d in rep.diagnostics]


def test_sweep_defaults_to_the_cpu_world(monkeypatch):
    """Without ``devices`` the world is ``DLS_CPU_WORLD`` ranks, as the
    JAX sweep's is ``jax.devices()``."""
    monkeypatch.setenv("DLS_CPU_WORLD", "4")
    traces = {}
    assert sweep_parallel_collectives(entries=("ring_attention",),
                                      traces=traces).ok
    assert sorted(traces["ring_attention"]) == [0, 1, 2, 3]


def test_missing_probe_is_col008_as_in_jax():
    want = jsweep(entries=("no_such_module",))
    got = sweep_parallel_collectives(entries=("no_such_module",), devices=CPU8)
    assert _fields(got) == _fields(want) == [("COL008", "ERROR", "no_such_module")]
    # the same message but the package's name in the import error
    assert got.diagnostics[0].message == want.diagnostics[0].message.replace(
        "distributed_llm_scheduler_tpu.", "distributed_llm_scheduler_tpu_torch.")


@pytest.mark.parametrize("entry", list(PP.COLLECTIVE_ENTRY_POINTS))
def test_each_probe_records_collectives_at_8_ranks(entry, swept):
    seqs = swept[1][entry]
    assert sorted(seqs) == list(range(8))
    busy = [r for r, s in seqs.items() if s]
    assert busy, entry
    # the ranks of one group issue the same sequence
    for r in busy:
        for c in seqs[r]:
            for other in c.group:
                assert c in seqs[other]


def _jax_perms(entry):
    """The ``ppermute`` perms of the JAX probe's jaxpr (8 CPU devices)."""
    import importlib

    import jax

    mod = importlib.import_module(f"distributed_llm_scheduler_tpu.parallel.{entry}")
    fn, args = mod.collective_probe()
    jaxpr = jax.make_jaxpr(fn)(*args)
    seq = JC._walk_jaxpr(jaxpr.jaxpr, JReport(), entry)
    return {tuple(tuple(int(i) for i in p) for p in perm)
            for name, _axes, perm in seq if name == "ppermute" and perm}


@pytest.mark.parametrize("entry", ["ring_attention", "pipeline_pp"])
def test_hop_perms_equal_the_jax_ppermutes(entry, swept):
    got = {c.perm for s in swept[1][entry].values() for c in s
           if c.perm is not None}
    want = _jax_perms(entry)
    assert got == want and got


# -- seeded faults, against the JAX walk's -------------------------------------

def _two_rank_mesh():
    """A mesh of the world's first two ranks: (mesh, group, index), the
    index None on the ranks beyond it."""
    mesh = make_axes_mesh(x=2)
    return mesh, mesh.group("x"), (mesh.coords or {}).get("x")


def _skips_an_all_reduce():
    _, g, me = _two_rank_mesh()
    if me is None:
        return None
    t = torch.ones(4)
    all_reduce_(t, g)
    if me == 0:  # rank 1 skips the second sum
        all_reduce_(t, g)
    return t


def _other_shape():
    _, g, me = _two_rank_mesh()
    return all_reduce_(torch.ones(4 + me), g)


def _other_op():
    _, g, me = _two_rank_mesh()
    t = torch.ones(4)
    if me == 0:
        all_reduce_(t, g)
    else:
        dist.broadcast(t, src=0, group=g)
    return t


def _jax_col003():
    import jax
    import jax.numpy as jnp

    def bad(x):
        return jax.lax.cond(x.sum() > 0, lambda v: jax.lax.psum(v, "dev"),
                            lambda v: v * 2.0, x)

    return JC.analyze_collectives_jaxpr(
        jax.make_jaxpr(bad, axis_env=[("dev", 2)])(jnp.ones((4,), jnp.float32)))


@pytest.mark.parametrize("fault", [_skips_an_all_reduce, _other_shape, _other_op],
                         ids=lambda f: f.__name__)
def test_ranks_that_diverge_are_col003_as_in_jax(fault):
    t0 = time.perf_counter()
    got = analyze_collectives_ranks(simworld.run_ranks(fault, (), 2), where="fault")
    assert time.perf_counter() - t0 < simworld.RENDEZVOUS_TIMEOUT
    assert _codes(got) == _codes(_jax_col003()) == {("COL003", "ERROR")}
    assert "diverge at its collective #1" in got.diagnostics[0].message \
        or "diverge at its collective #0" in got.diagnostics[0].message


def test_a_skipped_collective_names_both_ranks():
    rep = analyze_collectives_ranks(simworld.run_ranks(_skips_an_all_reduce, (), 2),
                                    where="fault")
    (d,) = rep.diagnostics
    assert "rank 0 issues all_reduce[(4,) float32] SUM" in d.message
    assert f"rank 1 issues {simworld.END}" in d.message


def _repeated_destination():
    """Every rank of a 4-rank group sends to group rank 0, which receives
    from all: a hop whose perm repeats a destination."""
    mesh = make_axes_mesh(x=4)
    if not mesh.contains:
        return None
    g, me = mesh.group("x"), mesh.coords["x"]
    x = torch.full((2,), float(me))
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(g, 0), g)]
    bufs = []
    if me == 0:
        bufs = [torch.empty(2) for _ in range(4)]
        ops += [dist.P2POp(dist.irecv, b, dist.get_global_rank(g, r), g)
                for r, b in enumerate(bufs)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [float(b[0]) for b in bufs]


def _jax_col004():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from distributed_llm_scheduler_tpu.parallel.compat import shard_map

    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))

    @jax.custom_vjp
    def rotate(v):
        return jax.lax.ppermute(v, "x", [(0, 0), (1, 0)])  # repeated dst

    rotate.defvjp(lambda v: (rotate(v), None), lambda _res, g: (g,))
    fn = shard_map(rotate, mesh=mesh, in_specs=(P("x"),), out_specs=P("x"),
                   check_vma=False)
    return JC.analyze_collectives_jaxpr(
        fn, jax.ShapeDtypeStruct((2,), jnp.float32), where="t")


def test_repeated_destination_is_col004_as_in_jax():
    run = simworld.run_ranks(_repeated_destination, (), 4)
    assert run.results[0] == [0.0, 1.0, 2.0, 3.0]  # the hop really ran
    got = analyze_collectives_ranks(run, where="fault")
    assert _codes(got) == _codes(_jax_col004()) == {("COL004", "ERROR")}
    assert "repeated destination" in got.diagnostics[0].message


def test_a_rank_that_raises_is_col008():
    def broken():
        _, g, me = _two_rank_mesh()
        if me == 1:
            raise ValueError("probe drifted")
        return all_reduce_(torch.ones(2), g)

    with pytest.raises(ValueError, match="probe drifted"):
        analyze_collectives_ranks(simworld.run_ranks(broken, (), 2))


@pytest.mark.parametrize("code", ["COL003", "COL004", "COL008"])
def test_lint_parallel_exits_1_naming_a_seeded_fault(code, monkeypatch):
    from distributed_llm_scheduler_tpu_torch.parallel import ring_attention

    monkeypatch.setenv("DLS_CPU_WORLD", "8")
    if code == "COL008":
        monkeypatch.setattr(PP, "COLLECTIVE_ENTRY_POINTS",
                            PP.COLLECTIVE_ENTRY_POINTS + ("no_such_module",))
    else:
        fault = _skips_an_all_reduce if code == "COL003" else _repeated_destination
        monkeypatch.setattr(ring_attention, "collective_probe",
                            lambda devices=None: (fault, ()))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = pmain(["lint", "--parallel"])
    assert rc == 1 and code in out.getvalue()


# -- the simulated world computes the collectives' real results -----------------

def test_ring_probe_output_equals_unsharded_attention():
    from distributed_llm_scheduler_tpu_torch.parallel.ring_attention import (
        collective_probe,
        reference_causal_attention,
    )

    fn, args = collective_probe(devices=[torch.device("cpu")] * 4)
    run = simworld.run_ranks(fn, args, 4)
    got = torch.cat([run.results[r] for r in range(4)], dim=2)
    want = reference_causal_attention(*(torch.from_numpy(a) for a in args))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_expert_probe_equals_one_device():
    """dp 2 x ep 2 routed MoE on simulated ranks against the whole
    experts on one device: the gathered counts place the tokens as the
    global view does."""
    from distributed_llm_scheduler_tpu_torch.models.mixtral import MixtralConfig
    from distributed_llm_scheduler_tpu_torch.parallel.expert import (
        collective_probe,
        moe_routed_stacked,
    )

    fn, (bp, x) = collective_probe(devices=[torch.device("cpu")] * 4)
    run = simworld.run_ranks(fn, (bp, x), 4)
    # ranks (dp, ep): 0 = (0, 0), 2 = (1, 0); each holds its dp rows' output
    got = torch.cat([run.results[0], run.results[2]])
    want = moe_routed_stacked({k: torch.from_numpy(v) for k, v in bp.items()},
                              torch.from_numpy(x), MixtralConfig.tiny())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(run.results[1], run.results[0])


def test_pipeline_probe_equals_the_plain_forward():
    from distributed_llm_scheduler_tpu_torch.models import gpt2
    from distributed_llm_scheduler_tpu_torch.parallel.pipeline_pp import (
        collective_probe,
    )

    fn, (ids,) = collective_probe(devices=[torch.device("cpu")] * 2)
    run = simworld.run_ranks(fn, (ids,), 2)
    cfg = gpt2.GPT2Config.tiny()
    params = gpt2.params_from_numpy(gpt2.init_params_numpy(cfg, 0), "cpu", cfg.dtype)
    with torch.no_grad():
        want = gpt2.forward(params, torch.from_numpy(ids), cfg)
    for r in (0, 1):
        torch.testing.assert_close(run.results[r].detach(), want,
                                   rtol=1e-5, atol=1e-5)


def test_many_ranks_many_rendezvous_stay_exact():
    """More ranks than cores, a short switch interval: every sum of 300
    all-reduces is exact on every rank and every rank records all of
    them (a lost update at a rendezvous would break either)."""
    import sys

    def body():
        rank = dist.get_rank()
        out = []
        for i in range(300):
            t = torch.tensor([float(rank + i)], dtype=torch.float64)
            all_reduce_(t, dist.group.WORLD)
            out.append(float(t))
        return out

    n = 16
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.perf_counter()
        run = simworld.run_ranks(body, (), n, timeout=30.0)
        assert time.perf_counter() - t0 < 30.0
    finally:
        sys.setswitchinterval(prev)
    assert run.error is None and run.divergences == []
    want = [float(sum(range(n)) + n * i) for i in range(300)]
    assert all(run.results[r] == want for r in range(n))
    assert all(len(run.sequences[r]) == 300 for r in range(n))
