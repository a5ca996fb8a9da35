"""The port's link model against the JAX package's, and its H100 estimates.

The affine fit and the degraded-window guard are host arithmetic, so the
contract is equality on the same inputs.  Measuring needs a card
(``tests/test_torch_cuda.py``); here a measurement off CUDA must raise,
never turn into the estimate.
"""

import math

import pytest
import torch

from distributed_llm_scheduler_tpu.utils import linkmodel as J
from distributed_llm_scheduler_tpu_torch.backends.sim import LinkModel
from distributed_llm_scheduler_tpu_torch.utils import linkmodel as T

SAMPLES = {
    # clean affine: 5 us + bytes / 12 GiB/s
    "affine": [(s, 5e-6 + s / (12 * 1024**3)) for s in T._SIZES],
    # noisy and non-monotonic (the 4 MB sample faster than the 256 KB one)
    "non_monotonic": [(1 << 10, 2e-5), (1 << 18, 9e-4), (1 << 22, 3e-4),
                      (1 << 25, 1e-4), (1 << 26, 1.5e-4)],
    "flat": [(1 << 10, 1e-5), (1 << 20, 1e-5), (1 << 26, 1e-5)],
    "one_size": [(1 << 20, 1e-4), (1 << 20, 2e-4)],
    "measured_on_a_card_like": [(1024, 1.1e-5), (16384, 1.2e-5),
                                (262144, 2.6e-5), (4194304, 2.3e-4),
                                (33554432, 1.8e-3), (67108864, 3.5e-3)],
    # a pageable host copy: the 64 MB copy runs slower than the 32 MB
    # one's rate, which pulls the least-squares intercept below 0
    "pageable_host_copy": [(1024, 1.0e-5), (16384, 1.1e-5),
                           (262144, 4.6e-5), (4194304, 5.6e-4),
                           (33554432, 4.3e-3), (67108864, 8.9e-3)],
}


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_fit_affine_equals_jax(name):
    got, want = T._fit_affine(SAMPLES[name]), J._fit_affine(SAMPLES[name])
    assert got == want
    lat, gbps = got
    assert lat >= 0 and gbps > 0


def _pair(**kw):
    """The same calibration in both packages."""
    return J.LinkCalibration(**kw), T.LinkCalibration(**kw)


MEASURED = {"param_load": "measured", "interconnect": "estimated"}
PAIRS = {
    "no_prior": (None, dict(platform="x", param_load_gbps=1.0)),
    "tenfold_slower": (
        dict(platform="x", param_load_gbps=10.0, provenance=MEASURED),
        dict(platform="x", param_load_gbps=1.0)),
    "fivefold_slower": (
        dict(platform="x", param_load_gbps=10.0, provenance=MEASURED),
        dict(platform="x", param_load_gbps=2.0)),
    "baseline_survives_a_degraded_save": (
        dict(platform="x", param_load_gbps=0.5, baseline_gbps=20.0,
             provenance={"param_load": "measured-degraded(cache was 20.00GB/s)"}),
        dict(platform="x", param_load_gbps=2.0)),
    "estimated_prior_is_no_baseline": (
        dict(platform="x", param_load_gbps=50.0,
             provenance={"param_load": "estimated"}),
        dict(platform="x", param_load_gbps=0.1)),
    "zero_fresh_rate": (
        dict(platform="x", param_load_gbps=10.0, provenance=MEASURED),
        dict(platform="x", param_load_gbps=0.0)),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_degraded_guard_decides_as_jax(name):
    prior_kw, fresh_kw = PAIRS[name]
    jp, tp = _pair(**prior_kw) if prior_kw else (None, None)
    jf, tf = _pair(**fresh_kw)
    assert T._healthy_baseline(tp) == J._healthy_baseline(jp)
    assert T._looks_degraded(tf, tp) == J._looks_degraded(jf, jp)


def test_degraded_guard_trips_where_expected():
    decided = {}
    for name, (prior_kw, fresh_kw) in PAIRS.items():
        prior = T.LinkCalibration(**prior_kw) if prior_kw else None
        decided[name] = T._looks_degraded(T.LinkCalibration(**fresh_kw), prior)
    assert {n for n, d in decided.items() if d} == {
        "tenfold_slower", "baseline_survives_a_degraded_save"}


def test_calibration_round_trips_through_save_and_load(tmp_path):
    cal = T.LinkCalibration(
        platform="cuda", param_load_gbps=23.5, latency_s=8.5e-6,
        baseline_gbps=23.5,
        provenance={"param_load": "measured", "interconnect": T.EST_ICI},
        samples={"param_load": [[1024, 1e-5], [1 << 26, 3e-3]]},
        measured_at="2026-01-01T00:00:00+00:00",
    )
    back = T.LinkCalibration.load(cal.save(str(tmp_path / "link_cuda.json")))
    assert back == cal
    assert back.to_link_model() == LinkModel(
        param_load_gbps=23.5, interconnect_gbps=T.EST_ICI_GBPS,
        latency_s=8.5e-6)


def test_estimates_are_the_h100s():
    """NVLink 4 at 450 GB/s and PCIe Gen5 x16 at 64 GB/s each way, in the
    package's 2**30-byte GB; nothing of the JAX package's v5e figures."""
    assert math.isclose(T.EST_ICI_GBPS * 1024**3, 450e9)
    assert math.isclose(T.EST_HOST_GBPS * 1024**3, 64e9)
    assert (T.EST_ICI_GBPS, T.EST_HOST_GBPS) != (J.EST_ICI_GBPS, J.EST_HOST_GBPS)
    cal = T.LinkCalibration(platform="cuda")
    assert cal.provenance == {"param_load": T.EST_HOST,
                              "interconnect": T.EST_ICI}
    for prov in cal.provenance.values():
        assert prov.startswith("estimated(h100 ") and "v5e" not in prov


def test_measuring_off_cuda_raises():
    with pytest.raises(RuntimeError, match="CUDA devices only"):
        T.calibrate_link([torch.device("cpu")])


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_latency_is_the_smallest_copys_best_time(name):
    """The latency is measured, never the fit's intercept: the best time
    of the sweep's smallest copies."""
    samples = SAMPLES[name]
    smallest = min(b for b, _ in samples)
    assert T._fixed_cost(samples) == min(t for b, t in samples if b == smallest)


def test_latency_survives_where_the_fit_clamps_it():
    """Least squares over the pageable sweep's 1 KB-64 MB puts the
    intercept at 0; the 1 KB copy took 10 us."""
    samples = SAMPLES["pageable_host_copy"]
    assert T._fit_affine(samples)[0] == 0.0
    assert T._fixed_cost(samples) == 1.0e-5


def _fake_measurements(monkeypatch, rates):
    """calibrate_link replaced by calibrations at ``rates`` GB/s, in turn;
    returns the list of the calls it saw."""
    calls = []

    def measure(devices, repeats=5):
        calls.append(list(devices))
        return T.LinkCalibration(
            platform="cuda", param_load_gbps=rates[len(calls) - 1],
            latency_s=1e-5, provenance={"param_load": "measured",
                                        "interconnect": T.EST_ICI})

    monkeypatch.setattr(T, "calibrate_link", measure)
    monkeypatch.setattr(T.time, "sleep", lambda s: None)
    return calls


def test_cached_calibration_always_measures(tmp_path, monkeypatch):
    """A saved calibration is only a baseline: the link is measured again
    and the new calibration, with its own rate as the baseline, is saved."""
    T.LinkCalibration(platform="cuda", param_load_gbps=20.0,
                      provenance={"param_load": "measured",
                                  "interconnect": T.EST_ICI},
                      ).save(str(tmp_path / "link_cuda.json"))
    calls = _fake_measurements(monkeypatch, [7.5])
    got = T.calibrate_link_cached(str(tmp_path),
                                  devices=[torch.device("cuda", 0)])
    assert len(calls) == 1
    assert (got.param_load_gbps, got.baseline_gbps) == (7.5, 7.5)
    assert got.provenance["param_load"] == "measured"
    assert T.LinkCalibration.load(str(tmp_path / "link_cuda.json")) == got


def test_degraded_measurement_keeps_the_saved_baseline(tmp_path, monkeypatch):
    """Ten times slower than the saved rate: measured once more, kept
    with its provenance saying so, and the old baseline carried on."""
    T.LinkCalibration(platform="cuda", param_load_gbps=20.0,
                      provenance={"param_load": "measured",
                                  "interconnect": T.EST_ICI},
                      ).save(str(tmp_path / "link_cuda.json"))
    calls = _fake_measurements(monkeypatch, [2.0, 1.5])
    got = T.calibrate_link_cached(str(tmp_path),
                                  devices=[torch.device("cuda", 0)])
    assert len(calls) == 2
    assert got.param_load_gbps == 2.0 and got.baseline_gbps == 20.0
    assert got.provenance["param_load"] == "measured-degraded(cache was 20.00GB/s)"
