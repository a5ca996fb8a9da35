"""The port's serving commands (``slo``, ``serve``, ``soak``, ``doctor`` in
every mode, ``metrics diff``, ``regress``) against the JAX CLI's.

Both ``main(argv)`` run in this process under ``DLS_PLATFORM=cpu`` (the
JAX package on its 8 forced host devices, the port on CPU devices), on the
tiny configs and the JAX tests' own calls and files.  Equal: exit codes,
the last stderr line, and every output value that does not come from a
clock or a framework's random weights (virtual-clock request rows,
``breached``, ``pages_leaked``, ``soak.*``, ``fleet.*``, the offline
doctors' reports, the diff and regress reports).  Live runs on the host
clock are held to what they count (requests, tokens, tasks).
"""

from __future__ import annotations

import contextlib
import io
import json
import re
from pathlib import Path

import pytest
import torch

from distributed_llm_scheduler_tpu.__main__ import main as jmain
from distributed_llm_scheduler_tpu_torch.__main__ import main as pmain

ROOT = Path(__file__).resolve().parent.parent
SERVE_ART = str(ROOT / "SERVE_r18.json")


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
    monkeypatch.delenv("DLS_TRACE", raising=False)
    monkeypatch.delenv("DLS_FLIGHT", raising=False)


def run(fn, argv):
    """``fn(argv)`` in process: (exit code, stdout, last stderr line)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(list(argv))
    lines = err.getvalue().strip().splitlines()
    return rc, out.getvalue(), lines[-1] if lines else ""


def both(argv):
    """(JAX CLI's, port's) results of one argv."""
    return run(jmain, argv), run(pmain, argv)


def assert_same(argv, json_out=True):
    """Equal exit codes, last stderr lines and stdout JSON; returns the
    port's (rc, parsed stdout)."""
    (jrc, jout, jerr), (prc, pout, perr) = both(argv)
    assert (prc, perr) == (jrc, jerr), argv
    if json_out:
        assert json.loads(pout) == json.loads(jout), argv
        return prc, json.loads(pout)
    assert pout == jout, argv
    return prc, pout


NUM = re.compile(r"[-+]?\d+\.?\d*(e[-+]?\d+)?")


def masked(line: str) -> str:
    """A stderr line with its measured numbers masked."""
    return NUM.sub("#", line)


# -- slo ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def request_log(tmp_path_factory):
    """A dls.requests/1 snapshot from the port's live slo leg (host
    clock), written where both CLIs read it."""
    path = tmp_path_factory.mktemp("slo") / "requests.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DLS_PLATFORM", "cpu")
        from distributed_llm_scheduler_tpu_torch.__main__ import (
            _slo_live_requests, build_parser)

        args = build_parser().parse_args(["slo", "--model", "gpt2-tiny"])
        rc, snap = _slo_live_requests(args, None)
    assert rc == 0
    path.write_text(json.dumps(snap))
    return str(path)


def test_slo_live_runs_the_jax_legs_requests():
    (jrc, jout, jerr), (prc, pout, perr) = both(
        ["slo", "--model", "gpt2-tiny", "--ttft", "100", "--n-requests", "5"])
    assert (prc, perr) == (jrc, jerr) == (0, "")
    j, p = json.loads(jout), json.loads(pout)
    assert set(p) == set(j) == {"requests", "slo"}
    for key in ("n_requests", "n_finished", "states", "tokens_generated"):
        if key in j["requests"]:
            assert p["requests"][key] == j["requests"][key], key
    assert p["slo"]["breached"] == j["slo"]["breached"] is False


@pytest.mark.parametrize("case", [
    ["--ttft", "100"],                       # 0: generous
    ["--ttft", "0.000000001", "--window", "0.5"],   # 1: breach
    ["--tpot", "100", "--percentile", "p99"],
    [],                                      # 2: no target
    ["--window", "0", "--ttft", "1"],        # 2: bad window
])
def test_slo_offline_equals_the_jax_cli(request_log, case):
    rc, _ = assert_same(["slo", "--requests", request_log, *case],
                        json_out=bool(case) and case[:2] != ["--window", "0"])


def test_slo_refusals_equal_the_jax_cli(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text('{"schema": "nope"}')
    lst = tmp_path / "list.json"
    lst.write_text("[1]")
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"schema": "dls.requests/1", "requests": []}))
    for argv in (["--requests", str(bad)], ["--requests", str(lst)],
                 ["--requests", str(tmp_path / "no.json")],
                 ["--requests", str(empty)],
                 ["--model", "llama-tiny"]):
        (jrc, jout, jerr), (prc, pout, perr) = both(["slo", "--ttft", "1", *argv])
        assert prc == jrc == 2 and perr == jerr, argv


# -- serve -------------------------------------------------------------------

def test_serve_report_equals_the_jax_cli(tmp_path):
    """The JAX test's calls (``tests/test_serve.py``): the virtual-clock
    report, rows included, is equal; so are the breach and refusals."""
    jt, pt = str(tmp_path / "jt.json"), str(tmp_path / "pt.json")
    jo, po = str(tmp_path / "jo.json"), str(tmp_path / "po.json")
    base = ["serve", "--model", "gpt2-tiny", "--requests", "8", "--seed", "7"]
    jr = run(jmain, base + ["--save-trace", jt, "--out", jo])
    pr = run(pmain, base + ["--save-trace", pt, "--out", po])
    assert pr[0] == jr[0] == 0
    assert json.loads(pr[1]) == json.loads(jr[1])
    jrep, prep = json.load(open(jo)), json.load(open(po))
    assert prep == jrep
    assert prep["breached"] is False and prep["pages_leaked"] == 0
    assert json.load(open(pt)) == json.load(open(jt))

    fj, fp = tmp_path / "fj", tmp_path / "fp"
    breach = ["serve", "--model", "gpt2-tiny", "--trace", jt, "--admission",
              "fifo", "--ttft", "0.000001", "--window", "0.2", "--flight-dir"]
    jr, pr = run(jmain, breach + [str(fj)]), run(pmain, breach + [str(fp)])
    assert pr[0] == jr[0] == 1 and pr[2] == jr[2]
    jd, pd = json.loads(jr[1]), json.loads(pr[1])
    jd.pop("flight_dump"), pd.pop("flight_dump")
    assert pd == jd
    dump = json.load(open(fp / "flight_requests.json"))
    assert dump["request_log"]["requests"]

    bad = tmp_path / "bad.json"
    bad.write_text('{"schema": "nope"}')
    big = tmp_path / "big.json"
    big.write_text(json.dumps({
        "schema": "dls.arrivals/1",
        "arrivals": [{"rid": "x", "t": 0.0, "prompt_len": 100,
                      "max_new_tokens": 8, "priority": 0}]}))
    for argv in (["--trace", str(bad)], ["--window", "0"], ["--trace", str(big)],
                 ["--ttft", "0", "--admission", "slo"]):
        (jrc, _, jerr), (prc, _, perr) = both(
            ["serve", "--model", "gpt2-tiny", *argv])
        assert (prc, perr) == (jrc, jerr) and prc == 2, argv
    (jrc, _, jerr), (prc, _, perr) = both(["serve", "--model", "llama-tiny"])
    assert (prc, perr) == (jrc, jerr) == (2, "serve: needs a gpt2-family "
                                             "model (paged decode)")


# -- soak and the offline doctors over its artifact ---------------------------

# the series store and flight dumps hold host-clock stamps; the frontend
# digest hashes the tokens, which follow each framework's seeded weights
# (``tests/test_torch_soak.py`` holds it equal on shared numpy weights)
SOAK_VOLATILE = ("timeseries", "flight_dumps", "digest")


@pytest.fixture(scope="module")
def soaks(tmp_path_factory):
    """The JAX test's soaks (``tests/test_soak.py``) through both CLIs:
    {name: ((rc, stdout, err), artifact path) per CLI}."""
    d = tmp_path_factory.mktemp("soak")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DLS_PLATFORM", "cpu")
        for name, argv in (("ok", []),
                           ("leak", ["--inject-leak", "2", "--flight-dir"]),
                           ("churn", ["--inject-jit-churn"])):
            for cli, fn in (("jax", jmain), ("torch", pmain)):
                path = str(d / f"{name}_{cli}.json")
                a = list(argv)
                if a and a[-1] == "--flight-dir":
                    a.append(str(d / f"flight_{cli}"))
                out[name, cli] = (run(fn, ["soak", *a, "--out", path]), path)
    return out


@pytest.mark.parametrize("name,rc", [("ok", 0), ("leak", 1), ("churn", 1)])
def test_soak_equals_the_jax_cli(soaks, name, rc):
    (jrc, jout, jerr), jpath = soaks[name, "jax"]
    (prc, pout, perr), ppath = soaks[name, "torch"]
    assert (prc, perr) == (jrc, jerr) and prc == rc
    ja, pa = json.load(open(jpath)), json.load(open(ppath))
    for k in SOAK_VOLATILE:
        ja.pop(k), pa.pop(k)
    assert pa == ja
    soak_keys = [k for k in pa if k.startswith("soak.")]
    assert len(soak_keys) == 7


def test_soak_refusals_equal_the_jax_cli():
    for argv in (["--duration", "-1"], ["--warmup", "9", "--duration", "4"],
                 ["--inject-leak", "0"]):
        (jrc, _, jerr), (prc, _, perr) = both(["soak", *argv])
        assert (prc, perr) == (jrc, jerr) and prc == 2, argv


@pytest.mark.parametrize("name,rc", [("ok", 0), ("leak", 1)])
def test_doctor_soak_and_serve_equal_the_jax_cli(soaks, name, rc):
    """``doctor --soak`` and ``doctor --serve`` re-gate both CLIs' soak
    artifacts offline with equal reports."""
    for cli in ("jax", "torch"):
        path = soaks[name, cli][1]
        assert assert_same(["doctor", "--soak", path])[0] == rc
        assert_same(["doctor", "--serve", path])


def test_doctor_serve_and_soak_refusals(tmp_path):
    assert assert_same(["doctor", "--serve", SERVE_ART])[0] == 0
    bad = tmp_path / "bad.json"
    bad.write_text('{"schema": "nope"}')
    for argv in (["--soak", str(bad)], ["--serve", str(bad)],
                 ["--serve", str(tmp_path / "no.json")]):
        (jrc, _, jerr), (prc, _, perr) = both(["doctor", *argv])
        assert (prc, perr) == (jrc, jerr) and prc == 2, argv


def test_metrics_diff_equals_the_jax_cli(soaks, tmp_path):
    ok = soaks["ok", "jax"][1]
    assert_same(["metrics", "diff", ok, "--at", "0", "--vs", "-1"])
    from distributed_llm_scheduler_tpu_torch.obs.metrics import (
        MetricsRegistry)

    def snap(runs, lat):
        reg = MetricsRegistry()
        reg.counter("runs").inc(runs)
        reg.gauge("depth").set(runs * 2)
        for v in lat:
            reg.histogram("lat").observe(v)
        return reg.snapshot()

    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    pa.write_text(json.dumps(snap(1, [1.0, 2.0])))
    pb.write_text(json.dumps(snap(4, [2.0, 3.0, 4.0])))
    _, out = assert_same(["metrics", "diff", str(pa), str(pb)])
    assert out["counters"]["runs"]["value_delta"] == 3
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(dict(snap(1, []), schema="dls.metrics/2")))
    for argv in ([ok, "--at", "0"], [ok, ok, "--at", "0", "--vs", "1"],
                 [ok, "--at", "9999", "--vs", "-1"], [str(pa)],
                 [str(pa), str(bad)], [str(pa), str(tmp_path / "no.json")]):
        (jrc, _, jerr), (prc, _, perr) = both(["metrics", "diff", *argv])
        assert (prc, perr) == (jrc, jerr) and prc == 2, argv


# -- doctor: live run, --trace, --memory, --slo -------------------------------

def test_doctor_live_run_equals_the_jax_cli_in_what_it_counts():
    argv = ["doctor", "--model", "gpt2-tiny", "--num-nodes", "2"]
    (jrc, jout, jerr), (prc, pout, perr) = both(argv)
    assert (prc, perr) == (jrc, jerr) == (0, "")
    j, p = json.loads(jout), json.loads(pout)
    assert set(p) == set(j) == {"attribution", "drift"}
    jd, pd = j["drift"], p["drift"]
    for key in ("n_tasks", "source"):
        assert pd[key] == jd[key], key
    assert set(pd["per_class"]) == set(jd["per_class"])
    assert pd["predicted_makespan_s"] == pytest.approx(
        jd["predicted_makespan_s"], rel=1e-9)
    assert p["attribution"]["critical_path"]
    # an impossible gate trips both; the message differs only in the ratio
    gate = argv + ["--drift-threshold", "1.0000001"]
    (jrc, _, jerr), (prc, _, perr) = both(gate)
    assert prc == jrc == 1 and masked(perr) == masked(jerr)
    (jrc, _, jerr), (prc, _, perr) = both(["doctor", "--model", "llm"])
    assert (prc, perr) == (jrc, jerr) and prc == 2


def test_doctor_trace_equals_the_jax_cli(tmp_path):
    """``doctor --trace`` attributes one exported trace identically."""
    path = str(tmp_path / "t.json")
    assert run(pmain, ["trace", "--model", "gpt2-tiny", "--num-nodes", "2",
                       "--skip-decode", "--out", path])[0] == 0
    assert assert_same(["doctor", "--trace", path])[0] == 0
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    for p in (str(bad), str(tmp_path / "no.json")):
        (jrc, _, jerr), (prc, _, perr) = both(["doctor", "--trace", p])
        assert (prc, perr) == (jrc, jerr) and prc == 2


def test_doctor_memory_equals_the_jax_cli():
    """The JAX test's calls (``tests/test_memprof.py``): the predicted
    side of the drift report equals the JAX one; the measured side is each
    framework's own tensors."""
    argv = ["doctor", "--memory", "--model", "gpt2-tiny", "--num-nodes", "2"]
    (jrc, jout, jerr), (prc, pout, perr) = both(argv)
    assert prc == jrc == 0
    j, p = json.loads(jout), json.loads(pout)
    assert p["memory"]["devices"]
    for entry in p["memory"]["devices"].values():
        assert entry["n_events"] > 0
        assert sum(entry["watermark"]["buckets"].values()) == entry["peak_bytes"]
    jdev = {d["node"]: d for d in j["mem_drift"]["devices"]}
    pdev = {d["node"]: d for d in p["mem_drift"]["devices"]}
    assert set(pdev) == set(jdev)
    for nid in pdev:
        assert pdev[nid]["predicted_bytes"] == jdev[nid]["predicted_bytes"]
    assert p["mem_drift"]["n_tasks"] == j["mem_drift"]["n_tasks"]
    (jrc, _, jerr), (prc, _, perr) = both(
        argv + ["--mem-drift-threshold", "1.0000001"])
    assert prc == jrc == 1 and masked(perr) == masked(jerr)
    (jrc, _, jerr), (prc, _, perr) = both(["doctor", "--memory", "--model",
                                           "llm"])
    assert (prc, perr) == (jrc, jerr) and prc == 2


def test_doctor_slo_equals_the_jax_cli():
    argv = ["doctor", "--slo", "--model", "gpt2-tiny"]
    (jrc, _, jerr), (prc, _, perr) = both(argv)
    assert (prc, perr) == (jrc, jerr) and prc == 2  # no target
    (jrc, jout, jerr), (prc, pout, perr) = both(argv + ["--slo-ttft", "100"])
    assert (prc, perr) == (jrc, jerr) == (0, "")
    assert set(json.loads(pout)) == set(json.loads(jout)) == {"requests", "slo"}
    (jrc, _, jerr), (prc, _, perr) = both(argv + ["--slo-ttft", "1e-12"])
    assert prc == jrc == 1 and masked(perr) == masked(jerr)


# -- doctor --fleet, --requests -----------------------------------------------

def test_doctor_fleet_equals_the_jax_cli(tmp_path):
    """The live chaos leg (virtual clock) gives the JAX CLI's report; the
    offline gate (``tests/test_fleet.py``'s files) too."""
    rc, out = assert_same(["doctor", "--fleet"])
    assert rc == 0 and out["fleet"]["pages_leaked"] == 0
    health = out["fleet_health"]
    ok = tmp_path / "fleet_ok.json"
    ok.write_text(json.dumps({"schema": "dls.fleet/1", "fleet_health": health}))
    assert assert_same(["doctor", "--fleet", str(ok)])[0] == 0
    sick = json.loads(json.dumps(health))
    finding = dict(sick["replicas"]["n0"]["findings"][0])
    finding.update(severity="error", slope=1.0, threshold=0.05)
    sick["replicas"]["n0"]["findings"] = [finding]
    bad = tmp_path / "fleet_bad.json"
    bad.write_text(json.dumps(sick))
    assert assert_same(["doctor", "--fleet", str(bad)])[0] == 1
    junk = tmp_path / "junk.json"
    junk.write_text('{"schema": "dls.fleet/1"}')
    for p in (str(junk), str(tmp_path / "missing.json")):
        (jrc, _, jerr), (prc, _, perr) = both(["doctor", "--fleet", p])
        assert (prc, perr) == (jrc, jerr) and prc == 2


def test_doctor_requests_equals_the_jax_cli(tmp_path):
    """Live (the serve bench's scenario on a virtual clock) and offline
    over the committed artifact (``tests/test_reqtrace.py``'s calls)."""
    assert_same(["doctor", "--requests"])
    rc, out = assert_same(["doctor", "--requests", SERVE_ART])
    assert rc == 1 and set(out["interference"]) == {"fifo_admit_all",
                                                    "slo_preempt"}
    assert assert_same(["doctor", "--requests", SERVE_ART,
                        "--dominant-threshold", "2.0"])[0] == 0
    bad = tmp_path / "bad.json"
    bad.write_text('{"schema": "nope"}')
    lst = tmp_path / "list.json"
    lst.write_text("[1, 2]")
    for p in (str(bad), str(tmp_path / "nope.json"), str(lst)):
        (jrc, _, jerr), (prc, _, perr) = both(["doctor", "--requests", p])
        assert (prc, perr) == (jrc, jerr) and prc == 2


# -- regress -------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--fresh", "BENCH_MEDIUM_r05.json", "--baseline", "BENCH_MEDIUM_r05.json"],
    ["--fresh", "BENCH_MEDIUM_r07.json", "--baseline", "BENCH_MEDIUM_r03.json"],
    ["--fresh", "BENCH_MEDIUM_r07.json", "--baseline", "BENCH_MEDIUM_r03.json",
     "--json", "--default-tolerance", "0.5"],
    ["--fresh", "BENCH_r05.json", "--baseline", "BENCH_r04.json",
     "--tolerance", "value=0.25", "--metrics", "value,vs_baseline"],
    ["--fresh", "BENCH_r05.json", "--baseline", "BENCH_r04.json",
     "--tolerance", "value"],
    ["--fresh", "missing.json", "--baseline", "BENCH_r04.json"],
], ids=["same", "r07_vs_r03", "json", "tolerances", "bad_tolerance",
        "missing"])
def test_regress_equals_the_jax_cli(argv, monkeypatch):
    monkeypatch.chdir(ROOT)
    (jrc, jout, jerr), (prc, pout, perr) = both(["regress", *argv])
    assert (prc, pout, perr) == (jrc, jout, jerr)
