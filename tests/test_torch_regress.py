"""The port's regression gate against the JAX package's.

The gate is host arithmetic over JSON, so its verdicts must be equal.  The
inputs are the TPU-era artifacts the repo already banks, compared in both
directions; they are only inputs here, none of their numbers is a result
of the port.
"""

from pathlib import Path

import pytest

from distributed_llm_scheduler_tpu.eval import regress as J
from distributed_llm_scheduler_tpu_torch.eval import regress as T

ROOT = Path(__file__).resolve().parent.parent
SERIES = [
    [f"BENCH_r0{i}.json" for i in range(1, 6)],
    [f"BENCH_MEDIUM_r0{i}.json" for i in range(3, 8)],
    ["SERVE_r17.json", "SERVE_r18.json"],
]
PAIRS = [
    (fresh, base)
    for files in SERIES
    for a, b in zip(files, files[1:])
    for fresh, base in ((b, a), (a, b))
] + [("BENCH_r05.json", "BENCH_r05.json"),
     ("BENCH_MEDIUM_r07.json", "BENCH_r05.json")]


def verdict(mod, fresh, base, **kw):
    v = mod.compare_artifacts(ROOT / fresh, ROOT / base, **kw)
    return (v.ok, v.exit_code, v.to_json(), v.render(),
            [c.metric for c in v.failures()])


@pytest.mark.parametrize("fresh,base", PAIRS, ids=lambda p: p)
def test_compare_artifacts_equals_jax(fresh, base):
    assert verdict(T, fresh, base) == verdict(J, fresh, base)


@pytest.mark.parametrize("kw", [
    dict(tolerances={"value": 0.5, "vs_baseline": 0.0}),
    dict(default_tolerance=0.01),
    dict(metrics=["value", "fence_rtt_ms", "singlechip_replay_ms",
                  "not_a_metric"]),
], ids=["tolerances", "default_tolerance", "metrics"])
def test_compare_artifacts_options_equal_jax(kw):
    for fresh, base in PAIRS[:4]:
        assert verdict(T, fresh, base, **kw) == verdict(J, fresh, base, **kw)


def test_missing_metric_and_capture_wrapper_equal_jax():
    base = T.load_artifact(ROOT / "BENCH_MEDIUM_r07.json")
    fresh = {"parsed": {k: v for k, v in base.items() if k != "value"}}
    t = T.compare_artifacts(fresh, base)
    j = J.compare_artifacts(fresh, base)
    assert t.to_json() == j.to_json()
    assert [c.metric for c in t.failures()] == ["value"]
    assert t.failures()[0].status == "missing"


@pytest.mark.parametrize("specs", [
    [], ["value=0.2"], ["value=0.2", " vs_baseline = 0.05 "], ["a.b=1e-3"],
])
def test_parse_tolerances_equals_jax(specs):
    assert T.parse_tolerances(specs) == J.parse_tolerances(specs)


@pytest.mark.parametrize("specs", [["value"], ["value=x"]])
def test_parse_tolerances_errors_equal_jax(specs):
    with pytest.raises(ValueError) as jerr:
        J.parse_tolerances(specs)
    with pytest.raises(ValueError) as terr:
        T.parse_tolerances(specs)
    assert str(terr.value) == str(jerr.value)


def test_tables_equal_jax():
    for name in T.__all__:
        if name.isupper():
            assert getattr(T, name) == getattr(J, name), name


def test_the_ports_banked_line_gates_against_itself():
    """The port's bench line (``BENCH_TORCH_r08.json``, from an H100) passes
    the gate against itself in both packages: the legs it has not measured
    are left out of the line, not written as nulls the gate would count
    as missing."""
    t = T.compare_artifacts(ROOT / "BENCH_TORCH_r08.json",
                            ROOT / "BENCH_TORCH_r08.json")
    j = J.compare_artifacts(ROOT / "BENCH_TORCH_r08.json",
                            ROOT / "BENCH_TORCH_r08.json")
    assert t.ok and t.to_json() == j.to_json()
    assert {"value", "vs_baseline", "oracle_ok", "mfu_single_chip"} <= {
        c.metric for c in t.checks}


def test_non_object_artifact_is_refused():
    with pytest.raises(ValueError, match="JSON object"):
        T.load_artifact([1, 2])
