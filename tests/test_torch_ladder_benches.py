"""The execution ladder's two benches of the port on the CPU
(``eval/dispatch_bench.py``, ``eval/compiled_bench.py``) against the JAX
package's (``distributed_llm_scheduler_tpu/eval/``), at a small size
(one layer, batch 2 in 2 microbatches, 2 vocab shards, one sample).

Both reports carry the JAX reports' keys, the legs included (the
compiled report one more, ``stand_ins``), and their bit-identity checks
hold: the compiled bench's compiled leg runs in a gloo world of 2 ranks
(``DLS_CPU_WORLD=2``); its timed segmented leg is the reference's,
re-batched, and the bit-identity check reads an untimed run of it without
re-batching, which the record says.  Each ``main`` takes the JAX
one's flags with its defaults, evaluates its gates into the same
``gates`` keys and exits 0 or 1 on them; with no card and no
``DLS_PLATFORM=cpu`` it exits 2.  The dispatch bench's
``coalesce_nodonate`` leg is a stand-in (the port has no donation to turn
off): it runs the flags of ``coalesce``, and the record says so.
"""

import contextlib
import io
import json

import numpy as np
import pytest

from distributed_llm_scheduler_tpu.eval import compiled_bench as JCB
from distributed_llm_scheduler_tpu.eval import dispatch_bench as JDB
from distributed_llm_scheduler_tpu_torch.eval import compiled_bench as CB
from distributed_llm_scheduler_tpu_torch.eval import dispatch_bench as DB

SMALL = dict(n_layer=1, batch=2, microbatches=2, vocab_shards=2, samples=1,
             reps=1)


@pytest.fixture(scope="module")
def reports():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DLS_PLATFORM", "cpu")
        mp.setenv("DLS_CPU_WORLD", "2")
        return dict(
            dispatch=(DB.run_dispatch_bench(**SMALL),
                      JDB.run_dispatch_bench(**SMALL)),
            compiled=(CB.run_compiled_bench(**SMALL),
                      JCB.run_compiled_bench(**SMALL)),
        )


@pytest.mark.parametrize("bench", ["dispatch", "compiled"])
def test_report_keys_equal_the_jax_bench(reports, bench):
    port, ref = reports[bench]
    assert set(port) - set(ref) == (
        {"stand_ins"} if bench == "compiled" else set())
    assert set(ref) <= set(port)
    assert set(port["legs"]) == set(ref["legs"])
    for leg in ref["legs"]:
        assert set(port["legs"][leg]) == set(ref["legs"][leg]), leg
    assert port["config"] == ref["config"]
    assert (port["n_tasks"], port["policy"], port["bench"]) == (
        ref["n_tasks"], ref["policy"], ref["bench"])


@pytest.mark.parametrize("bench", ["dispatch", "compiled"])
def test_outputs_are_bit_identical(reports, bench):
    assert reports[bench][0]["bit_identical"] is True


def test_the_compiled_leg_ran_in_a_world(reports):
    port, ref = reports["compiled"]
    assert port["n_devices"] == 2
    legs = port["legs"]
    # one eager call per rank on the CPU; the reference's bound holds
    assert legs["compiled"]["n_dispatches"] <= port["n_input_leaves"] + 1
    assert legs["compiled"]["n_dispatches"] < legs["planned"]["n_dispatches"]
    assert legs["compiled"]["transfer_edges"] > 0


def test_the_segmented_leg_is_the_reference_s(reports):
    """The makespan gate reads the re-batched segmented leg; bit identity
    reads an untimed run without re-batching (a re-batched segment is
    allclose to planned on a card, not bit-equal), and the re-batched
    output is held to planned at the reference's cross-path tolerance."""
    port, _ref = reports["compiled"]
    seg = port["stand_ins"]["segmented"]
    assert seg["timed_flags"] == dict(segments=True, planned=False)
    assert seg["bit_identity_flags"] == dict(segments=True, planned=False,
                                             rebatch=False)
    assert seg["rebatched_allclose"] is True
    assert seg["rebatched_max_abs_err"] <= seg["atol"] == 2e-4
    bad = json.loads(json.dumps(port))
    bad["stand_ins"]["segmented"]["rebatched_allclose"] = False
    assert CB.evaluate_gates(bad, *CB.GATES, lambda m: None) is False


def test_coalesce_nodonate_is_the_coalesce_leg(reports):
    port, _ref = reports["dispatch"]
    legs = port["legs"]
    assert legs["coalesce_nodonate"]["n_dispatches"] == \
        legs["coalesce"]["n_dispatches"] < legs["legacy"]["n_dispatches"]
    assert set(DB.STAND_INS) == {"coalesce_nodonate"}


def _flags(parser_main, run_name, module, argv, report):
    """The keyword arguments ``main(argv)`` passes its run function, and
    its exit code, with the run replaced by one returning ``report``."""
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return report

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, run_name, fake)
        mp.setenv("DLS_PLATFORM", "cpu")
        code = parser_main(argv)
    seen.pop("log", None)
    return seen, code


def _passing(report, bench):
    out = {k: v for k, v in report.items() if k != "gates"}
    legs = {k: dict(v) for k, v in out["legs"].items()}
    if bench == "dispatch":
        for name in ("planned", "coalesce", "coalesce_nodonate"):
            legs[name]["reduction_vs_legacy"] = 0.5
    else:
        legs["planned"]["dispatch_overhead_ms"] = 10.0
        legs["compiled"]["dispatch_overhead_ms"] = 1.0
        legs["segmented"]["makespan_ms"] = 2.0
        legs["compiled"]["makespan_ms"] = 1.0
        legs["compiled"]["n_dispatches"] = 1
    out["legs"] = legs
    out["bit_identical"] = True
    return out


@pytest.mark.parametrize("bench,argv", [
    ("dispatch", []),
    ("dispatch", ["--samples", "2", "--reps", "1", "--policy", "heft",
                  "--n-layer", "3", "--seq-len", "4"]),
    ("compiled", []),
    ("compiled", ["--samples", "2", "--reps", "2", "--policy", "heft",
                  "--n-layer", "3", "--seq-len", "4"]),
])
def test_main_has_the_jax_flags_and_exit_codes(reports, bench, argv,
                                               capsys):
    port_mod, jax_mod, run = {
        "dispatch": (DB, JDB, "run_dispatch_bench"),
        "compiled": (CB, JCB, "run_compiled_bench"),
    }[bench]
    good = _passing(reports[bench][1], bench)
    pk, pc = _flags(port_mod.main, run, port_mod, argv, dict(good))
    jk, jc = _flags(jax_mod.main, run, jax_mod, argv, dict(good))
    assert pk == jk and pc == jc == 0
    bad = dict(good, bit_identical=False)
    _, pc = _flags(port_mod.main, run, port_mod, argv, dict(bad))
    _, jc = _flags(jax_mod.main, run, jax_mod, argv, dict(bad))
    assert pc == jc == 1
    capsys.readouterr()


@pytest.mark.parametrize("module", [DB, CB], ids=["dispatch", "compiled"])
def test_main_without_a_device_exits_2(module, monkeypatch, capsys):
    monkeypatch.delenv("DLS_PLATFORM", raising=False)
    monkeypatch.delenv("DLS_FORCE_CPU", raising=False)
    monkeypatch.setattr("torch.cuda.device_count", lambda: 0)
    assert module.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_gates_keys_equal_the_jax_gates(reports):
    for bench, (port_mod, jax_mod, run) in {
        "dispatch": (DB, JDB, "run_dispatch_bench"),
        "compiled": (CB, JCB, "run_compiled_bench"),
    }.items():
        good = _passing(reports[bench][1], bench)
        outs = []
        for mod in (port_mod, jax_mod):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(mod, run, lambda **kw: dict(good))
                mp.setenv("DLS_PLATFORM", "cpu")
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf), \
                        contextlib.redirect_stderr(io.StringIO()):
                    mod.main([])
                outs.append(json.loads(buf.getvalue()))
        port, ref = outs
        assert set(port["gates"]) == set(ref["gates"])
        # the compiled report's stand_ins come from its run, which both
        # mains were handed here; the dispatch main adds its own
        extra = set(port) - set(ref)
        assert extra == ({"stand_ins"} if bench == "dispatch" else set())
        np.testing.assert_equal(port["gates"], ref["gates"])
