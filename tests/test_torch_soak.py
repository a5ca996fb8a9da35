"""The port's soak doctor against the JAX package's, on the CPU: time
series, Theil–Sen trends, the HLT001–HLT006 detectors and
``serve/soak.py``.

* ``theil_sen_slope``, bounded ``Series`` decimation, the store's
  snapshot and ``snapshot_at``, and the detector battery's findings on
  the same series equal the JAX package's;
* the port's soak of ``SOAK_r17.json``'s config on a virtual clock
  reproduces all seven banked ``soak.*`` values exactly, and its
  frontend digest equals a JAX soak's over an engine built from the same
  numpy weights (the banked digest predates a change to what the
  frontend digests);
* an injected page leak trips HLT001 and an injected compile-class churn
  HLT003, with the JAX soak's findings word for word, and the leak's
  flight dump validates;
* an instrumented soak and a bare one serve bit-identical tokens and
  rows; a same-seed repeat is equal; a short real-clock soak is well
  formed.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_llm_scheduler_tpu as J
from distributed_llm_scheduler_tpu import obs as JO
from distributed_llm_scheduler_tpu.backends.device import (
    DeviceBackend as JaxBackend,
)
from distributed_llm_scheduler_tpu.frontend.decode_dag import (
    build_paged_decode_dag as jax_decode_build,
)
from distributed_llm_scheduler_tpu.models import gpt2 as jgpt2
from distributed_llm_scheduler_tpu.models.kv_pages import PagePool as JPool
from distributed_llm_scheduler_tpu.serve import frontend as JF
from distributed_llm_scheduler_tpu.serve import soak as JS
from distributed_llm_scheduler_tpu_torch import obs as TO
from distributed_llm_scheduler_tpu_torch.eval import serve_bench as SB
from distributed_llm_scheduler_tpu_torch.models import gpt2 as tgpt2
from distributed_llm_scheduler_tpu_torch.obs.export import validate_trace
from distributed_llm_scheduler_tpu_torch.serve import frontend as TF
from distributed_llm_scheduler_tpu_torch.serve import soak as TS

BANKED = json.loads(
    (Path(__file__).resolve().parents[1] / "SOAK_r17.json").read_text())
GEOM = {k: SB.SCENARIO[k] for k in ("slots", "page_size", "n_pages",
                                    "pages_per_seq", "seg_steps")}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: its tensors are tiny, and the
    test run's workers share the host's cores, where many threads per
    worker spin more than they compute."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- time series and detectors, same inputs through both -------------------
def test_theil_sen_equal_jax():
    rng = np.random.default_rng(3)
    cases = [
        ([0.1 * i for i in range(20)], [0.2 * i for i in range(20)]),
        ([float(i) for i in range(21)],
         [3.0 * i if i != 10 else 1e6 for i in range(21)]),
        (sorted(rng.random(40).tolist()), rng.normal(size=40).tolist()),
        ([1.0, 1.0], [2.0, 3.0]),
        ([1.0], [2.0]),
        ([], []),
    ]
    for ts, vs in cases:
        assert TO.theil_sen_slope(ts, vs) == JO.theil_sen_slope(ts, vs)
    assert TO.theil_sen_slope([0.1 * i for i in range(20)],
                              [0.2 * i for i in range(20)]) == 2.0
    with pytest.raises(ValueError):
        TO.theil_sen_slope([1.0, 2.0], [1.0])


def _store(O, cap=16, n=200):
    store = O.TimeSeriesStore(capacity=cap)
    for i in range(n):
        t = 0.05 * i
        store.record("pool.orphan_pages", 2.0 * t if i > 60 else 0.0, t=t,
                     unit="pages")
        store.record("hbm.live_bytes", 1000.0 + 5.0 * (i % 7), t=t,
                     unit="bytes")
        store.record("throughput.tok_s", 100.0 - 3.0 * t, t=t)
        store.record("jit.prefill_entries", float(min(i, 9)), t=t)
    return store


def test_series_store_and_snapshot_at_equal_jax(tmp_path):
    js, ts = _store(JO), _store(TO)
    snap = ts.snapshot()
    assert snap == js.snapshot()
    assert TO.validate_timeseries(snap) == []
    for i in (0, 3, -1, 99):
        assert TO.snapshot_at(snap, i) == JO.snapshot_at(snap, i)
    s = TO.Series("x", capacity=16)
    for i in range(200):
        s.append(float(i), float(i))
    assert s.vs == [float(i) for i in range(200) if i % s.stride == 0]
    assert len(s) <= 16 and s.slope() == 1.0
    path = str(tmp_path / "ts.json")
    TO.save_timeseries(ts, path)
    assert TO.load_timeseries(path) == json.loads(json.dumps(snap))
    with pytest.raises(ValueError):
        TO.Series("x", capacity=1)


def test_detector_goldens_equal_jax():
    for warm in (0.0, 1.0, 5.0):
        jr = JO.HealthMonitor(warmup_s=warm).evaluate(_store(JO, cap=64))
        tr = TO.HealthMonitor(warmup_s=warm).evaluate(_store(TO, cap=64))
        assert tr.to_json() == jr.to_json()
        assert tr.exceeds() == jr.exceeds()
        assert tr.summary() == jr.summary()
    rep = TO.HealthMonitor(warmup_s=0.0).evaluate(_store(TO, cap=64))
    assert {f.code for f in rep.breaches()} >= {"HLT001"}
    assert [d.code for d in TO.default_detectors()] == [
        d.code for d in JO.default_detectors()] == [
        "HLT001", "HLT002", "HLT003", "HLT004", "HLT005", "HLT006"]
    with pytest.raises(ValueError):
        TO.Detector("x", "H", "s", threshold=0.0)


# -- soak runs --------------------------------------------------------------
@pytest.fixture(scope="module")
def port_factory():
    """``run_soak(engine_factory=)`` over one port engine of the bench's
    geometry on the CPU, rebound per leg."""
    eng, _ = SB.build_serve_engine(**GEOM, clock=TF.VirtualClock(),
                                   device="cpu")

    def factory(*, clock=None, flight=None, attention_impl=None):
        eng.rebind_obs(clock=clock, flight=flight)
        return eng

    return factory


@pytest.fixture(scope="module")
def jax_factory():
    """The same over a JAX engine built from the port's numpy weights."""
    np_w = tgpt2.init_params_numpy(tgpt2.GPT2Config.tiny(), 0)
    g = {k: GEOM[k] for k in ("slots", "page_size", "n_pages",
                              "pages_per_seq")}
    jd = jax_decode_build(jgpt2.GPT2Config.tiny(), **g)
    jc = J.Cluster.from_jax_devices(jax.devices()[:1])
    eng = JaxBackend(jc).paged_decode_engine(
        jd.graph, J.get_scheduler("greedy").schedule(jd.graph, jc), jd.config,
        {k: jnp.asarray(v) for k, v in np_w.items()},
        JPool(n_pages=g["n_pages"], page_size=g["page_size"]),
        slots=g["slots"], pages_per_seq=g["pages_per_seq"],
        seg_steps=GEOM["seg_steps"], clock=JF.VirtualClock())

    def factory(*, clock=None, flight=None, attention_impl=None):
        eng.rebind_obs(clock=clock, flight=flight)
        return eng

    return factory


@pytest.fixture(scope="module")
def banked_art(port_factory):
    return TS.run_soak(TS.SoakConfig(**BANKED["config"]),
                       engine_factory=port_factory)


def test_banked_soak_values_reproduced(banked_art):
    keys = sorted(k for k in BANKED if k.startswith("soak."))
    assert len(keys) == 7
    assert {k: banked_art[k] for k in keys} == {k: BANKED[k] for k in keys}
    assert banked_art["soak.hbm_slope_bytes_s"] == 17913.148579565444
    assert banked_art["soak.jit_cache_slope_entries_s"] == 0.6003765117866862
    assert banked_art["verdict"] == BANKED["verdict"] == "healthy"
    assert banked_art["offered_load"] == BANKED["offered_load"]
    assert banked_art["steady_state"] == BANKED["steady_state"]
    assert TS.validate_soak_artifact(banked_art) == []
    assert banked_art["serving"]["pages_leaked"] == 0


def test_soak_digest_and_artifact_equal_jax(banked_art, jax_factory):
    jart = JS.run_soak(JS.SoakConfig(**BANKED["config"]),
                       engine_factory=jax_factory)
    assert banked_art["digest"] == jart["digest"]
    assert banked_art["timeseries"] == jart["timeseries"]
    assert banked_art["health"] == jart["health"]
    assert banked_art["serving"] == jart["serving"]
    assert banked_art["interference"] == jart["interference"]


@pytest.fixture(scope="module")
def leak_arts(tmp_path_factory, port_factory, jax_factory):
    d = tmp_path_factory.mktemp("flight")
    t = TS.run_soak(TS.SoakConfig(), flight_dir=str(d / "t"),
                    inject_leak_every=2, engine_factory=port_factory)
    j = JS.run_soak(JS.SoakConfig(), flight_dir=str(d / "j"),
                    inject_leak_every=2, engine_factory=jax_factory)
    return j, t


def test_injected_leak_trips_hlt001_as_jax(leak_arts):
    jart, tart = leak_arts
    assert tart["verdict"] == "breach"
    assert tart["injection"] == {"page_leak_every": 2}
    errors = [f for f in tart["health"]["findings"]
              if f["severity"] == "error"]
    assert any(f["code"] == "HLT001" for f in errors)
    assert tart["health"] == jart["health"]
    for k in TS.SLOPE_METRICS.values():
        assert tart[k] == jart[k], k
    assert tart["soak.page_leak_slope_pages_s"] > 0.05
    dump = tart["flight_dumps"][0]
    assert dump["reasons"] == jart["flight_dumps"][0]["reasons"]
    assert any("HLT001" in r for r in dump["reasons"])
    assert validate_trace(dump["trace"]) == []
    re = TO.report_from_soak_artifact(tart)
    assert re.exceeds() and re.worst_breach().code == "HLT001"


def test_injected_churn_trips_hlt003_as_jax(port_factory, jax_factory):
    tart = TS.run_soak(TS.SoakConfig(), inject_churn=True,
                       engine_factory=port_factory)
    jart = JS.run_soak(JS.SoakConfig(), inject_churn=True,
                       engine_factory=jax_factory)
    assert tart["verdict"] == "breach"
    assert "HLT003" in {f["code"] for f in tart["health"]["findings"]
                        if f["severity"] == "error"}
    assert tart["health"] == jart["health"]
    assert tart["soak.jit_cache_slope_entries_s"] == (
        jart["soak.jit_cache_slope_entries_s"]) > 3.0


def test_instrumented_soak_bit_identical_to_bare(banked_art, port_factory):
    bare = TS.run_soak(TS.SoakConfig(**BANKED["config"]), instrument=False,
                       engine_factory=port_factory)
    assert "timeseries" not in bare
    assert bare["digest"] == banked_art["digest"]
    assert bare["serving"] == banked_art["serving"]
    again = TS.run_soak(TS.SoakConfig(**BANKED["config"]),
                        engine_factory=port_factory)
    assert again == banked_art
    assert not TO.report_from_soak_artifact(banked_art).exceeds()


def test_soak_config_rejected():
    for bad in (TS.SoakConfig(duration_s=0.0),
                TS.SoakConfig(sample_every_s=0.0),
                TS.SoakConfig(warmup_s=5.0), TS.SoakConfig(rate_rps=-1.0),
                TS.SoakConfig(admission="vip"), TS.SoakConfig(capacity=1),
                TS.SoakConfig(attention_impl="pallas"),
                TS.SoakConfig(chunk_tokens=0)):
        with pytest.raises(ValueError):
            bad.validate()
    with pytest.raises(ValueError):
        TO.report_from_soak_artifact({"schema": "nope"})


def test_real_clock_soak_smoke(port_factory):
    art = TS.run_soak(TS.SoakConfig(
        duration_s=1.0, warmup_s=0.5, rate_rps=4.0, ttft_s=2.0,
        window_s=1.0, real_clock=True), engine_factory=port_factory)
    assert TS.validate_soak_artifact(art) == []
    assert art["clock"] == "wall"
    assert art["serving"]["pages_leaked"] == 0
    for name, row in art["timeseries"]["series"].items():
        stamps = [t for t, _ in row["points"]]
        assert stamps == sorted(stamps) and len(set(stamps)) == len(stamps)
