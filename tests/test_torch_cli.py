"""The port's command line (``__main__.py``), ``RunConfig`` and JSON
serialization against the JAX package's.

Both ``main(argv)`` run in this process under ``DLS_PLATFORM=cpu`` (the
JAX package on its 8 forced host devices, the port on CPU devices), on
the tiny configs.  Framework-free outputs must be equal: graphs built
from every accepted model and flag combination, the errors of every
rejected one, the saved graph and schedule JSON, ``schedule``'s report,
``execute``'s summary values that are not timings, and ``generate``'s
greedy tokens from one shared ``--weights`` file in all three families,
plain, with ``--kv-int8`` and through ``--task-graph``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from distributed_llm_scheduler_tpu.__main__ import main as jmain
from distributed_llm_scheduler_tpu.utils import serialization as JS
from distributed_llm_scheduler_tpu.utils.config import RunConfig as JRunConfig
from distributed_llm_scheduler_tpu_torch.__main__ import build_parser, main
from distributed_llm_scheduler_tpu_torch.utils import config as C
from distributed_llm_scheduler_tpu_torch.utils import serialization as PS
from distributed_llm_scheduler_tpu_torch.utils.config import RunConfig
from test_torch_pretrained import saved_weights

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: several spin against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("DLS_PLATFORM", "cpu")
    monkeypatch.delenv("DLS_FORCE_CPU", raising=False)
    monkeypatch.delenv("DLS_NATIVE", raising=False)


def run(fn, argv):
    """``fn(argv)`` in process: (exit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


def graph_rows(graph):
    return [
        (t.task_id, list(t.dependencies), t.memory_required, t.compute_time,
         sorted(t.params_needed), dict(t.param_bytes), t.flops, t.group,
         list(t.arg_tasks or []))
        for t in (graph[tid] for tid in graph.topo_order)
    ]


# -- RunConfig ----------------------------------------------------------------

ACCEPTED = [
    ("gpt2", dict(num_layers=2, seq_len=64)),
    ("gpt2-medium", dict(num_layers=1, seq_len=32)),
    ("gpt2-tiny", {}),
    ("gpt2-tiny", dict(seq_len=4096)),  # clamped to n_positions
    ("gpt2-tiny", dict(batch=4, microbatches=2, vocab_shards=2)),
    ("gpt2-tiny", dict(fuse=True)),
    ("gpt2-tiny", dict(quantize="int8")),
    ("gpt2-tiny", dict(train_step=True, batch=2, seq_len=16)),
    ("llama", dict(num_layers=1, seq_len=32)),
    ("llama-8b", dict(num_layers=1, seq_len=32, quantize="int8")),
    ("llama-tiny", dict(batch=4, microbatches=2, vocab_shards=2, fuse=True)),
    ("mixtral", dict(num_layers=1, seq_len=16)),
    ("mixtral-8x7b", dict(num_layers=1, seq_len=16, routed=True,
                          capacity_factor=1.5)),
    ("mixtral-tiny", dict(routed=True)),
    ("mixtral-tiny", dict(quantize="int8", fuse=True)),
    ("llm", dict(num_layers=3, seed=2)),
    ("random", dict(num_layers=2, seed=5)),
    ("pipeline", dict(num_layers=3, fuse=True)),
]


def _label(case):
    model, kw = case
    return "-".join([model] + [f"{k}={v}" for k, v in kw.items()])


@pytest.mark.parametrize("case", ACCEPTED, ids=_label)
def test_build_graph_equals_the_jax_one(case):
    model, kw = case
    pdag = RunConfig(model=model, **kw).build_graph()
    jdag = JRunConfig(model=model, **kw).build_graph()
    pg, jg = getattr(pdag, "graph", pdag), getattr(jdag, "graph", jdag)
    assert pg.name == jg.name
    assert graph_rows(pg) == graph_rows(jg)
    if hasattr(jdag, "param_specs"):
        assert sorted(pdag.param_specs) == sorted(jdag.param_specs)


REJECTED = [
    ("gpt2-huge", {}),
    ("llama-70b", {}),
    ("mixtral-2x", {}),
    ("bert", {}),
    ("llama-tiny", dict(train_step=True)),
    ("gpt2-tiny", dict(train_step=True, microbatches=2)),
    ("gpt2-tiny", dict(train_step=True, vocab_shards=2)),
    ("gpt2-tiny", dict(train_step=True, fuse=True)),
    ("gpt2-tiny", dict(quantize="int4")),
    ("gpt2-tiny", dict(routed=True)),
    ("gpt2-tiny", dict(train_step=True, quantize="int8")),
    ("llm", dict(quantize="int8")),
]


@pytest.mark.parametrize("case", REJECTED, ids=_label)
def test_build_graph_rejections_equal_the_jax_ones(case):
    model, kw = case
    with pytest.raises(Exception) as pe:
        RunConfig(model=model, **kw).build_graph()
    with pytest.raises(Exception) as je:
        JRunConfig(model=model, **kw).build_graph()
    assert type(pe.value) is type(je.value) is ValueError
    assert str(pe.value) == str(je.value)


def test_fields_and_cluster_builds_match():
    jfields = [f.name for f in dataclasses.fields(JRunConfig)]
    pfields = [f.name for f in dataclasses.fields(RunConfig)]
    # live devices bind through build_cluster_with_devices alone: the
    # JAX package's use_jax_devices switch has no counterpart
    assert pfields == [f for f in jfields if f != "use_jax_devices"]
    for kw in (dict(), dict(num_nodes=4, hbm_gb=2.0, memory_regime=0.5),
               dict(num_nodes=8, slices=2)):
        pc, jc = RunConfig(**kw).build_cluster(), JRunConfig(**kw).build_cluster()
        assert [(d.node_id, d.total_memory, d.compute_speed, d.slice_id)
                for d in pc] == [(d.node_id, d.total_memory, d.compute_speed,
                                  d.slice_id) for d in jc]
        assert type(RunConfig(**kw).build_link()).__name__ == \
            type(JRunConfig(**kw).build_link()).__name__
    for cfgs in ((RunConfig(num_nodes=6, slices=4), JRunConfig(num_nodes=6,
                                                               slices=4)),):
        msgs = []
        for c in cfgs:
            with pytest.raises(ValueError) as e:
                c.build_cluster()
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for c in (RunConfig(backend="bogus"), JRunConfig(backend="bogus")):
        with pytest.raises(ValueError, match="unknown backend 'bogus'"):
            c.build_backend()
    s = RunConfig(scheduler="search", search_budget=7,
                  search_seed=3).build_scheduler()
    assert (s.budget, s.seed) == (7, 3)


def test_platform_seam(monkeypatch):
    assert C.env_str is C.__dict__["env_str"]  # re-exported for native/
    cl = RunConfig(num_nodes=3, hbm_gb=2.0).build_cluster_with_devices()
    assert [(d.node_id, d.total_memory, d.torch_device.type) for d in cl] == [
        (f"core_{i}", 2.0, "cpu") for i in range(3)]
    monkeypatch.delenv("DLS_PLATFORM")
    monkeypatch.setenv("DLS_FORCE_CPU", "1")
    assert C.platform() == "cpu"
    monkeypatch.delenv("DLS_FORCE_CPU")
    assert C.platform() == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(C.ConfigError, match="no CUDA device visible"):
            RunConfig().build_cluster_with_devices()
    monkeypatch.setenv("DLS_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="DLS_PLATFORM='tpu'"):
        RunConfig().build_cluster_with_devices()


def test_execute_without_a_card_fails_with_a_message(monkeypatch):
    """No card and no ``DLS_PLATFORM=cpu``: exit 2 with one line, nothing
    run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.delenv("DLS_PLATFORM")
    rc, out, err = run(main, ["execute", "--model", "gpt2-tiny"])
    assert rc == 2 and out == ""
    assert err.strip().splitlines() == [
        "execute: no CUDA device visible; set DLS_PLATFORM=cpu to run on "
        "the CPU"]


def test_a_fault_on_the_card_keeps_its_traceback(monkeypatch):
    """Only configuration errors become exit 2: a RuntimeError raised while
    running (a launch failure, an illegal address) propagates."""
    import distributed_llm_scheduler_tpu_torch.__main__ as M

    def fault(args):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(M, "cmd_execute", fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        run(main, ["execute", "--model", "gpt2-tiny"])


# -- serialization --------------------------------------------------------------

def _scheduled(pkg_config):
    cfg = pkg_config(model="gpt2-tiny", batch=4, microbatches=2,
                     vocab_shards=2, num_nodes=4)
    graph = cfg.build_graph().graph
    cluster = cfg.build_cluster()
    sched = cfg.build_scheduler().schedule(graph, cluster)
    cfg.build_backend().execute(graph, cluster, sched)  # fills timings
    return graph, sched


def test_serialization_equals_the_jax_json(tmp_path):
    pg, ps = _scheduled(RunConfig)
    jg, js = _scheduled(JRunConfig)
    assert PS.graph_to_dict(pg) == JS.graph_to_dict(jg)
    pd, jd = PS.schedule_to_dict(ps), JS.schedule_to_dict(js)
    assert pd.pop("scheduling_wall_s") >= 0 and jd.pop("scheduling_wall_s") >= 0
    assert pd == jd
    # round trips load equal objects, and read the JAX package's files
    g2 = PS.load_graph(PS.save_graph(pg, str(tmp_path / "a" / "g.json")))
    assert graph_rows(g2) == [r[:8] + ([],) for r in graph_rows(pg)]
    s2 = PS.load_schedule(PS.save_schedule(ps, str(tmp_path / "s.json")))
    assert PS.schedule_to_dict(s2) == PS.schedule_to_dict(ps)
    s3 = PS.load_schedule(JS.save_schedule(js, str(tmp_path / "js.json")))
    assert (s3.per_node, s3.assignment_order, s3.completed) == (
        ps.per_node, ps.assignment_order, ps.completed)
    with pytest.raises(ValueError, match="unsupported graph format 2"):
        PS.graph_from_dict(dict(PS.graph_to_dict(pg), format_version=2))


# -- commands -------------------------------------------------------------------

def test_schedule_prints_the_jax_report(tmp_path):
    argv = ["schedule", "--model", "gpt2", "--scheduler", "mru", "--save",
            "--validate"]
    outs = []
    for fn, d in ((main, "p"), (jmain, "j")):
        rc, out, err = run(fn, argv + ["--out-dir", str(tmp_path / d)])
        assert rc == 0, err
        outs.append(json.loads(out[:out.rindex("}") + 1]))
        assert "validator: " in err
    for o in outs:
        o["schedule"].pop("scheduling_wall_s")
    assert outs[0] == outs[1]
    for name in ("gpt2_12l_d768_b1_t512.graph.json",
                 "gpt2_12l_d768_b1_t512.mru.schedule.json"):
        p, j = (json.loads((tmp_path / d / name).read_text()) for d in "pj")
        p.pop("scheduling_wall_s", None), j.pop("scheduling_wall_s", None)
        assert p == j, name


def test_schedule_native_digest_equals_python(tmp_path):
    from distributed_llm_scheduler_tpu_torch.sched.search import (
        placement_digest,
    )

    cfgs = [RunConfig(model="llama-tiny", scheduler=s) for s in
            ("native:heft", "heft")]
    digests = []
    for cfg in cfgs:
        graph = cfg.build_graph().graph
        cluster = cfg.build_cluster()
        digests.append(placement_digest(
            cfg.build_scheduler().schedule(graph, cluster).placement))
    assert digests[0] == digests[1]
    rc, out, _ = run(main, ["schedule", "--model", "llama-tiny",
                            "--scheduler", "native:heft"])
    assert rc == 0 and json.loads(out)["schedule"]["policy"] == "heft"


def test_execute_prints_every_jax_key():
    argv = ["execute", "--model", "gpt2-tiny", "--num-nodes", "4"]
    (prc, pout, perr), (jrc, jout, _) = run(main, argv), run(jmain, argv)
    assert prc == jrc == 0, perr
    got, want = json.loads(pout), json.loads(jout)
    assert set(want) <= set(got)
    for k in ("policy", "n_devices", "transfer_edges", "transfer_mb",
              "param_gb_placed", "n_dispatches", "planned", "compiled",
              "peak_hbm_gb"):
        assert got[k] == want[k], k
    assert set(got["dispatch_phases_ms"]) <= set(want["dispatch_phases_ms"])


def test_execute_modes_and_refusals(tmp_path):
    seg = ["execute", "--model", "gpt2-tiny", "--num-nodes", "2",
           "--segments"]
    (rc, out, err), (_, jout, _) = run(main, seg), run(jmain, seg)
    assert rc == 0, err
    assert json.loads(out)["n_dispatches"] == json.loads(jout)["n_dispatches"]
    trace = tmp_path / "t.json"
    rc, out, err = run(main, ["execute", "--model", "gpt2-tiny", "--num-nodes",
                              "2", "--profile", "--trace", str(trace)])
    assert rc == 0 and json.loads(trace.read_text())["traceEvents"]
    for argv, jargv_ok in (
        (["--profile", "--segments"], True),
        (["--trace", "x.json"], True),
        (["--slices", "2"], True),
        (["--model", "llm"], True),
        (["--model", "llm", "--weights", "w.pt"], True),
    ):
        full = ["execute", "--model", "gpt2-tiny", *argv]
        (prc, pout, perr), (jrc, _, jerr) = run(main, full), run(jmain, full)
        assert prc == jrc == 2 and pout == "", argv
        assert perr.strip().splitlines()[-1] == jerr.strip().splitlines()[-1]
    # an unknown model or policy: one line, no traceback (the JAX CLI
    # raises there)
    for argv in (["execute", "--model", "bert"],
                 ["schedule", "--scheduler", "bogus"]):
        rc, out, err = run(main, argv)
        assert rc == 2 and len(err.strip().splitlines()) == 1, argv


GEN_FAMILIES = ("gpt2-tiny", "llama-tiny", "mixtral-tiny")
GEN_MODES = {"plain": [], "kv_int8": ["--kv-int8"],
             "task_graph": ["--task-graph"]}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("w")
    return {m: saved_weights(tmp, m.split("-")[0]) for m in GEN_FAMILIES}


def _generate_argv(weights, model, mode):
    return ["generate", "--model", model, "--weights", weights[model],
            "--prompt-ids", "5,17,3,42", "--max-new-tokens", "6",
            *GEN_MODES[mode]]


@pytest.fixture(scope="module")
def jax_generate(weights):
    """The JAX CLI's ``generate`` output, once per (model, mode), shared by
    the parametrizations that compare against it."""
    cache = {}

    def get(model, mode):
        if (model, mode) not in cache:
            rc, out, err = run(jmain, _generate_argv(weights, model, mode))
            assert rc == 0, err
            cache[model, mode] = json.loads(out)
        return cache[model, mode]

    return get


@pytest.mark.parametrize("mode", sorted(GEN_MODES))
@pytest.mark.parametrize("model", GEN_FAMILIES)
def test_generate_tokens_equal_the_jax_cli(weights, jax_generate, model, mode,
                                           monkeypatch):
    monkeypatch.setenv("DLS_PLATFORM", "cpu")
    prc, pout, perr = run(main, _generate_argv(weights, model, mode))
    assert prc == 0, perr
    got = json.loads(pout)
    if mode == "task_graph":
        # --task-graph must give the whole model's greedy tokens: the JAX
        # whole-model run is the oracle, with the keys the JAX CLI prints
        # in this mode
        plain = jax_generate(model, "plain")
        want = {**{k: plain[k] for k in ("model", "prompt_ids",
                                         "generated_ids")},
                "task_graph": True, "scheduler": "heft"}
    else:
        want = jax_generate(model, mode)
    assert got == want
    assert len(set(got["generated_ids"])) > 1  # the weights are not degenerate


def test_generate_refusals_equal_the_jax_cli():
    for argv in (["--scheduler", "heft"], ["--loop-steps", "2"],
                 ["--task-graph", "--temperature", "0.5"],
                 ["--task-graph", "--kv-int8"],
                 ["--task-graph", "--loop-steps", "0"],
                 ["--prompt-ids", "5,x"], ["--prompt-ids", "99999"],
                 ["--model", "llm"], ["--model", "gpt2-huge"],
                 ["--weights", "/nonexistent.pt"],
                 ["--max-new-tokens", "200"]):
        full = ["generate", *argv]
        (prc, pout, perr), (jrc, _, jerr) = run(main, full), run(jmain, full)
        assert prc == jrc == 2 and pout == "", argv
        assert perr.strip().splitlines()[-1] == jerr.strip().splitlines()[-1]


def test_generate_loop_steps_and_int8_weights(weights):
    base = ["generate", "--model", "llama-tiny", "--weights",
            weights["llama-tiny"], "--max-new-tokens", "7"]
    toks = json.loads(run(main, base + ["--task-graph"])[1])["generated_ids"]
    rc, out, _ = run(main, base + ["--task-graph", "--loop-steps", "3"])
    assert rc == 0 and json.loads(out)["generated_ids"] == toks
    for mode in (["--quantize", "int8"], ["--task-graph", "--quantize", "int8"]):
        rc, out, _ = run(main, base + mode)
        assert rc == 0 and json.loads(out)["weights"] == "int8"


def test_trace_and_metrics_commands(tmp_path):
    from distributed_llm_scheduler_tpu_torch.obs.export import validate_trace
    from distributed_llm_scheduler_tpu_torch.obs.metrics import (
        validate_snapshot,
    )

    out_path = tmp_path / "trace.json"
    rc, out, err = run(main, ["trace", "--model", "gpt2-tiny", "--num-nodes",
                              "2", "--out", str(out_path)])
    assert rc == 0, err
    assert validate_trace(str(out_path)) == []
    assert "decode" in json.loads(out)["rows"]
    # the measured gantt of that trace
    rc, out, err = run(main, ["visualize", "--from-trace", str(out_path),
                              "--out-dir", str(tmp_path)])
    assert rc == 0, err
    assert (tmp_path / "trace.gantt.png").read_bytes()[:4] == b"\x89PNG"
    rc, out, err = run(main, ["metrics", "--model", "gpt2-tiny",
                              "--num-nodes", "2", "--out",
                              str(tmp_path / "m.json")])
    assert rc == 0, err
    snap = json.loads(out)
    assert validate_snapshot(snap) == [] and snap["schema"] == "dls.metrics/1"
    assert snap["counters"]["decode.admission_waves"]["value"] > 0
    rc, _, err = run(main, ["metrics", "--model", "llama-tiny", "--num-nodes",
                            "1"])
    assert rc == 0 and "decode leg skipped" in err


def test_visualize_writes_its_pngs(tmp_path):
    rc, out, err = run(main, ["visualize", "--model", "llm", "--out-dir",
                              str(tmp_path), "--detailed"])
    assert rc == 0, err
    for name in ("llm_4l.dag.png", "llm_4l.heft.gantt.png"):
        assert (tmp_path / name).read_bytes()[:4] == b"\x89PNG"
    rc, out, err = run(main, ["visualize", "--from-trace", str(tmp_path /
                                                               "missing.json"),
                              "--out-dir", str(tmp_path)])
    assert rc == 2 and "missing.json" in err


def test_sweep_command_writes_csv_png_and_summary(tmp_path, monkeypatch):
    from distributed_llm_scheduler_tpu_torch.eval import evaluator

    monkeypatch.setattr(evaluator, "SWEEP_WORKLOADS", {
        "llm_small": evaluator.SWEEP_WORKLOADS["llm_small"]})
    # the annealer's rows are held in test_torch_evaluator.py
    monkeypatch.setattr(evaluator, "ALL_SCHEDULERS", {
        k: v for k, v in evaluator.ALL_SCHEDULERS.items() if k != "search"})
    rc, out, err = run(main, ["sweep", "--num-runs", "1", "--out-dir",
                              str(tmp_path)])
    assert rc == 0, err
    assert "=== Scheduler evaluation summary ===" in out
    assert (tmp_path / "raw_results.csv").read_text().startswith(
        "scheduler,dag_type,num_nodes,memory_regime,total_tasks")
    assert (tmp_path / "scheduler_performance.png").exists()


def test_bench_forwards_to_the_port_bench(monkeypatch):
    from distributed_llm_scheduler_tpu_torch.eval import bench

    calls = []
    monkeypatch.setattr(bench, "main", lambda argv: calls.append(argv) or 0)
    assert main(["bench"]) == 0 and main(["bench", "medium"]) == 0
    assert calls == [["small"], ["medium"]]


@pytest.mark.parametrize("cmd", ["lint", "train", "rankcheck", "metrics-diff"])
def test_unported_commands_are_refused(cmd, capsys, monkeypatch):
    """``metrics-diff`` is ``metrics diff``: argparse refuses it.
    ``lint``, ``train`` and ``rankcheck`` are ported; what of them cannot
    run refuses with exit 2 and one line: ``lint --parallel --decode``
    (the sweep combines only with ``--json``/``--verbose``, as the JAX
    CLI's), ``train --pp 2`` on one CPU rank (the JAX CLI's refusal of
    more stages than devices) and ``rankcheck --stress`` on fewer than 4
    cards (here: the CPU)."""
    monkeypatch.setenv("DLS_PLATFORM", "cpu")
    if cmd in ("lint", "train", "rankcheck"):
        flag = {"lint": ["--parallel", "--decode"], "train": ["--pp", "2"],
                "rankcheck": ["--stress"]}[cmd]
        assert main([cmd, *flag]) == 2
        out = capsys.readouterr()
        assert out.out == "" and len(out.err.strip().splitlines()) == 1
        return
    with pytest.raises(SystemExit) as e:
        main([cmd])
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def test_parser_keeps_the_jax_flags():
    """Every flag of a ported command has the JAX CLI's name and default."""
    import argparse

    from distributed_llm_scheduler_tpu import __main__ as J

    captured = {}
    orig = argparse.ArgumentParser.parse_args

    def grab(self, argv=None, namespace=None):
        captured["parser"] = self
        raise SystemExit(0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(SystemExit):
            J.main([])
    jparser = captured["parser"]
    assert argparse.ArgumentParser.parse_args is orig

    def flags(parser, prefix=""):
        """{command: its flags}, nested commands (``metrics diff``) too."""
        sub = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction))
        out = {}
        for name, p in sub.choices.items():
            out[prefix + name] = {
                (tuple(a.option_strings), a.dest, a.default)
                for a in p._actions
                if not isinstance(a, argparse._SubParsersAction)}
            if any(isinstance(a, argparse._SubParsersAction)
                   for a in p._actions):
                out.update(flags(p, prefix + name + " "))
        return out

    pf, jf = flags(build_parser()), flags(jparser)
    assert "metrics diff" in pf
    for name in pf:
        assert pf[name] == jf[name], name


def test_module_entry_point():
    """``python -m distributed_llm_scheduler_tpu_torch``: the one
    subprocess test of this file."""
    env = dict(os.environ, DLS_PLATFORM="cpu", PYTHONPATH=str(ROOT))
    r = subprocess.run(
        [sys.executable, "-m", "distributed_llm_scheduler_tpu_torch",
         "schedule", "--model", "llm", "--scheduler", "native:heft"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout)["schedule"]["policy"] == "heft"
