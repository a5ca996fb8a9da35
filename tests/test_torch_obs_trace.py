"""The port's tracer, export, attribution, request waterfalls and flight
recorder against the JAX package's, on the CPU.

* fed the same calls on a scripted clock, the port's ``Tracer``,
  ``RequestTraceRecorder``, ``RingTracer``/``TeeTracer`` and
  ``FlightRecorder`` hold event lists equal to the JAX objects', their
  Chrome/Perfetto renderings are equal and validate, and the attribution
  of one span list is equal;
* the paged decode engine, traced over the serve bench's slo leg (tracer,
  flight ring and waterfalls on a virtual clock), records the JAX
  engine's event list: names, tracks, categories, args and order, event
  for event, and both serve the same tokens;
* a bare engine and an instrumented one serve bit-identical tokens,
  request rows and page books;
* ``DeviceBackend.execute`` with a tracer on every rung (per task,
  planned, coalesced, segmented, compiled, streamed, profile) gives
  outputs bit-equal to the untraced run, an export that validates, flow
  arrows across nodes, and an attribution that tiles its makespan;
* the ambient hooks (``DLS_TRACE``/``DLS_FLIGHT``), the metrics
  snapshot checks and the profiling helpers behave as the JAX ones.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu import obs as JO
from distributed_llm_scheduler_tpu.backends.device import (
    DeviceBackend as JaxBackend,
)
from distributed_llm_scheduler_tpu.eval import serve_bench as JSB
from distributed_llm_scheduler_tpu.frontend.decode_dag import (
    build_paged_decode_dag as jax_decode_build,
)
from distributed_llm_scheduler_tpu.models import gpt2 as jgpt2
from distributed_llm_scheduler_tpu.models.kv_pages import PagePool as JPool
from distributed_llm_scheduler_tpu.obs import export as JX
from distributed_llm_scheduler_tpu.obs.slo import SLOPolicy as JPolicy
from distributed_llm_scheduler_tpu.serve import frontend as JF
from distributed_llm_scheduler_tpu.serve import loadgen as JL
from distributed_llm_scheduler_tpu_torch import obs as TO
from distributed_llm_scheduler_tpu_torch.eval import serve_bench as SB
from distributed_llm_scheduler_tpu_torch.models import gpt2 as tgpt2
from distributed_llm_scheduler_tpu_torch.obs import export as TX
from distributed_llm_scheduler_tpu_torch.obs.slo import SLOPolicy
from distributed_llm_scheduler_tpu_torch.serve import frontend as TF
from distributed_llm_scheduler_tpu_torch.serve import loadgen as TL
from distributed_llm_scheduler_tpu_torch.utils import profiling

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: its tensors are tiny, and the
    test run's workers share the host's cores, where many threads per
    worker spin more than they compute."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _script(O):
    """One scripted run of the tracer surface over package ``O``'s obs."""
    clk = FakeClock(100.0)
    tr = O.Tracer(clock=clk)
    ex = tr.begin("execute", cat="schedule", policy="greedy")
    clk.t = 100.2
    with tr.span("work", track="core_1", cat="task", tid="t1"):
        clk.t = 100.4
    tr.complete("task_a", 100.5, 101.0, track="core_0", cat="task")
    tr.complete("task_b", 101.2, 101.9, track="core_1", cat="task")
    tr.flow("transfer", "core_0", 101.0, "core_1", 101.2, bytes=64,
            src="task_a", dst="task_b")
    tr.instant("fence_done", track=O.HOST_TRACK, cat="collect", t=102.0)
    tr.instant("retire", track="decode", cat="decode", rid="r0")
    tr.counter("decode.queue_depth", 1, t=100.2)
    tr.counter("decode.queue_depth", 0)
    clk.t = 102.5
    tr.end(ex, makespan_s=2.5)
    return tr


def test_tracer_event_lists_equal_jax():
    jt, tt = _script(JO), _script(TO)
    assert tt.events == jt.events
    assert tt.tracks() == jt.tracks()
    assert tt.counter_names() == jt.counter_names() == ["decode.queue_depth"]
    assert len(tt) == len(jt) == 9


def test_chrome_export_equal_jax_and_validates(tmp_path):
    jev = JX.chrome_events(_script(JO), process_name="p")
    tev = TX.chrome_events(_script(TO), process_name="p")
    assert tev == jev
    path = str(tmp_path / "obs" / "trace.json")
    TX.export_perfetto(_script(TO), path)
    assert TX.validate_trace(path) == []
    summ = TX.trace_summary(path)
    assert summ == JX.trace_summary({"traceEvents": jev,
                                     "displayTimeUnit": "ms"})
    assert summ["flows"] == 1 and summ["counter_tracks"] == [
        "decode.queue_depth"]
    bad = {"traceEvents": [
        {"ph": "Z", "name": "bad", "pid": 1, "tid": 1},
        {"ph": "X", "name": "neg", "pid": 1, "tid": 1, "ts": 1.0,
         "dur": -2.0},
        {"ph": "s", "name": "transfer", "pid": 1, "tid": 1, "ts": 0.0,
         "id": 7},
    ]}
    assert TX.validate_trace(bad) == JX.validate_trace(bad) != []


def _doctor(O):
    """The JAX tests' critical-path scenario: task_a -> task_b -> (flow)
    -> task_c, makespan 8.0 = compute 6.5 + transfer 0.5 + dispatch 0.8
    + idle 0.2."""
    clk = FakeClock(0.0)
    tr = O.Tracer(clock=clk)
    ex = tr.begin("execute", cat="schedule", policy="manual")
    tr.complete("dispatch_order", 0.0, 0.2, cat="schedule")
    tr.complete("place_params", 0.2, 0.8, cat="stage")
    tr.complete("task_a", 1.0, 3.0, track="core_0", cat="task")
    tr.complete("task_b", 3.0, 4.5, track="core_0", cat="task")
    tr.complete("task_c", 5.0, 8.0, track="core_1", cat="task")
    tr.flow("transfer", "core_0", 4.5, "core_1", 5.0,
            src="task_b", dst="task_c", bytes=64)
    clk.t = 9.0
    tr.end(ex)
    return tr


def test_attribution_equal_jax_and_tiles(tmp_path):
    j = JO.attribute_run(_doctor(JO)).summary()
    t = TO.attribute_run(_doctor(TO)).summary()
    assert t == j
    assert [s["task"] for s in t["critical_path"]] == [
        "task_a", "task_b", "task_c"]
    assert t["breakdown_s"] == pytest.approx(
        {"compute": 6.5, "transfer": 0.5, "dispatch": 0.8, "idle": 0.2})
    assert abs(sum(t["breakdown_s"].values()) - t["makespan_s"]) < 1e-9
    path = str(tmp_path / "t.json")
    TX.export_perfetto(_doctor(TO), path)
    assert TO.attribute_trace(path).summary()["critical_path"] == (
        JO.attribute_trace(path).summary()["critical_path"])
    w = TO.attribute_run(_doctor(TO), window=(4.0, 9.0))
    assert [s.name for s in w.critical_path] == ["task_c"]
    assert TO.attribute_run(TO.Tracer(clock=FakeClock())).critical_path == []


def _waterfalls(O):
    """The same request-waterfall calls over package ``O``."""
    clk = FakeClock(0.0)
    tr = O.Tracer(clock=clk)
    rt = O.RequestTraceRecorder(tr)
    rt.submit("r0", 0.0, prompt_len=8, max_new_tokens=4)
    rt.submit("r1", 0.1, prompt_len=8, max_new_tokens=4)
    rt.wait("r1", 0.2, "slots_full", by=["r0"])
    rt.admitted("r0", 0.3, wave=["r0"])
    rt.prefill("r0", 0.3, 0.4, tokens=8, wave_size=1, shared_pages=0)
    rt.first_token("r0", 0.4)
    rt.segment("r0", 0.4, 0.6, tokens=3, co_resident=["r0"])
    rt.preempt("r0", 0.6, by="r1", cause="preempt_tier0_victim")
    rt.admitted("r1", 0.6, chunked=True)
    rt.chunk("r1", 0.6, 0.7, base=0, tokens=8)
    rt.first_token("r1", 0.7)
    rt.submit("r0#p1", 0.7, prompt_len=12, max_new_tokens=1)
    rt.cow("r1", 0.7, 0.71, src=3, dst=5)
    rt.retire("r1", 0.9, tokens=4)
    rt.shed("r2", 1.0, cause="slo_shed")
    return tr, rt


def test_request_waterfalls_equal_jax():
    (jt, jr), (tt, tr) = _waterfalls(JO), _waterfalls(TO)
    assert tt.events == jt.events
    assert tr.tracks() == jr.tracks()
    for rid in ("r0", "r0#p1", "r7#m2#p3", 5):
        assert TO.base_rid(rid) == JO.base_rid(rid)
        assert TO.request_track(rid) == JO.request_track(rid)


def _flight(O, out_dir):
    """A small ring fed through a tee, then a triggered dump."""
    clk = FakeClock(0.0)
    fl = O.FlightRecorder(capacity=8, request_capacity=2, clock=clk)
    main = O.Tracer(clock=clk)
    tee = O.TeeTracer(main, fl.tracer)
    for i in range(6):
        clk.t = float(i)
        tee.counter("decode.chunk_stalls", float(i))
        tee.complete(f"s{i}", i, i + 0.5, track="decode", cat="decode")
    for rid in ("a", "b", "c"):
        fl.reqlog.submit(rid, 8, 4, clk.t)
    reasons = fl.triggers(chunk_stalls=fl.chunk_stall_samples())
    rec = fl.maybe_dump(out_dir, chunk_stalls=fl.chunk_stall_samples())
    return main, fl, reasons, rec


def test_flight_ring_tee_and_dump_equal_jax(tmp_path):
    jm, jf, jr, _ = _flight(JO, str(tmp_path / "j"))
    tm, tf, tr, rec = _flight(TO, str(tmp_path / "t"))
    assert tm.events == jm.events and len(tm.events) == 12
    assert list(tf.tracer.events) == list(jf.tracer.events)
    assert len(tf.tracer.events) == 8
    assert tr == jr and tr and tr[0].startswith("chunk_stall")
    assert TX.validate_trace(rec["trace"]) == []
    with open(rec["requests"]) as f:
        got = json.load(f)
    with open(str(tmp_path / "j" / "flight_requests.json")) as f:
        want = json.load(f)
    assert got == want
    assert TO.FlightRecorder.triggers() == []


def test_metrics_snapshot_checks_equal_jax():
    def snaps(O):
        a = O.MetricsRegistry(prefix="n0.", replica="n0")
        b = O.MetricsRegistry(prefix="n0.", replica="n1")
        for r, k in ((a, 1), (b, 3)):
            r.counter("x").inc(k)
            r.gauge("g").set(2 * k)
            for v in range(10 * k):
                r.histogram("h", unit="s").observe(v / 7)
        return a.snapshot(), b.snapshot()

    from distributed_llm_scheduler_tpu.obs import metrics as JM
    from distributed_llm_scheduler_tpu_torch.obs import metrics as TM

    ja, jb = snaps(JO)
    ta, tb = snaps(TO)
    assert (ta, tb) == (ja, jb)
    assert TM.validate_snapshot(ta) == [] and TM.validate_snapshot(5)
    assert TM.validate_snapshot({"schema": "x"}) == JM.validate_snapshot(
        {"schema": "x"})
    assert TM.diff_snapshots(ta, tb) == JM.diff_snapshots(ja, jb)
    with pytest.raises(ValueError):
        TM.diff_snapshots({"schema": "nope"}, tb)


def test_ambient_hooks(monkeypatch):
    monkeypatch.delenv("DLS_TRACE", raising=False)
    monkeypatch.delenv("DLS_FLIGHT", raising=False)
    TO.reset_ambient()
    assert TO.ambient_tracer() is None and TO.ambient_metrics() is None
    assert TO.ambient_flight() is None and not TO.trace_enabled()
    monkeypatch.setenv("DLS_TRACE", "1")
    monkeypatch.setenv("DLS_FLIGHT", "yes")
    try:
        tr, reg, fl = TO.ambient_tracer(), TO.ambient_metrics(), TO.ambient_flight()
        assert isinstance(tr, TO.Tracer) and tr is TO.ambient_tracer()
        assert reg is TO.ambient_metrics() and fl is TO.ambient_flight()
        # an engine built now records into the ambient pair and ring
        eng, _ = SB.build_serve_engine(clock=TF.VirtualClock(), device="cpu")
        assert eng.tracer.primary is tr and eng.tracer.mirror is fl.tracer
        assert eng.metrics is reg
        TO.reset_ambient()
        assert TO.ambient_tracer() is not tr
    finally:
        TO.reset_ambient()


# -- the engine's event list against the JAX engine's ----------------------
GEOM = {k: SB.SCENARIO[k] for k in ("slots", "page_size", "n_pages",
                                    "pages_per_seq")}


@pytest.fixture(scope="module")
def engines():
    """The JAX and port serve engines at the bench's geometry, both from
    the port's bench weights (numpy seed 0)."""
    sc = SB.SCENARIO
    teng, _ = SB.build_serve_engine(**GEOM, seg_steps=sc["seg_steps"],
                                    clock=TF.VirtualClock(), device="cpu")
    np_w = tgpt2.init_params_numpy(tgpt2.GPT2Config.tiny(), 0)
    jd = jax_decode_build(jgpt2.GPT2Config.tiny(), **GEOM)
    jc = J.Cluster.from_jax_devices(jax.devices()[:1])
    jeng = JaxBackend(jc).paged_decode_engine(
        jd.graph, J.get_scheduler("greedy").schedule(jd.graph, jc), jd.config,
        {k: jnp.asarray(v) for k, v in np_w.items()},
        JPool(n_pages=GEOM["n_pages"], page_size=GEOM["page_size"]),
        slots=GEOM["slots"], pages_per_seq=GEOM["pages_per_seq"],
        seg_steps=sc["seg_steps"], clock=JF.VirtualClock())
    return jeng, teng


def _leg(sb, F, L, Policy, O, eng, instrument=True, n=None):
    sc = dict(sb.SCENARIO, **({"n_requests": n} if n else {}))
    vc = F.VirtualClock()
    obs = dict(tracer=O.Tracer(clock=vc), flight=O.FlightRecorder(clock=vc),
               memprof=O.MemoryProfiler(clock=vc)) if instrument else {}
    eng.rebind_obs(clock=vc, **obs)
    arr = L.poisson_arrivals(
        sc["rate_rps"], sc["n_requests"], 7, prompt_lens=sc["prompt_lens"],
        max_new_tokens=sc["max_new_tokens"], priorities=sc["priorities"],
        priority_weights=sc["priority_weights"])
    leg = sb.run_serving_leg(
        arr, Policy(ttft_s=sc["ttft_s"], window_s=sc["window_s"],
                    percentile=sc["percentile"]),
        "slo", True,
        F.ServiceTimeModel(wave_s=sc["wave_s"], segment_s=sc["segment_s"],
                           idle_s=sc["idle_s"]),
        sc, engine=eng)
    return leg, obs, {k: np.asarray(v) for k, v in eng.results.items()}


@pytest.fixture(scope="module")
def traced(engines):
    jeng, teng = engines
    j = _leg(JSB, JF, JL, JPolicy, JO, jeng)
    t = _leg(SB, TF, TL, SLOPolicy, TO, teng)
    return j, t


def test_engine_event_list_equals_jax(traced):
    (jleg, jobs, jres), (tleg, tobs, tres) = traced
    jev, tev = jobs["tracer"].events, tobs["tracer"].events
    assert len(tev) == len(jev) > 400
    for i, (a, b) in enumerate(zip(jev, tev)):
        assert b == a, i
    assert list(tobs["flight"].tracer.events) == list(
        jobs["flight"].tracer.events)
    assert tleg["digest"] == jleg["digest"]
    assert tres.keys() == jres.keys()
    for rid in jres:
        np.testing.assert_array_equal(tres[rid], jres[rid])
    names = {e["name"] for e in tev if e["type"] == "span"}
    assert {"segment", "admission_wave", "prefill"} <= names
    assert {"decode.queue_depth", "decode.page_pool_occupancy_pages",
            "decode.jit_cache_entries"} <= set(tobs["tracer"].counter_names())


def test_engine_export_has_one_waterfall_per_request(traced, tmp_path):
    _, (tleg, tobs, _) = traced
    path = str(tmp_path / "serve.json")
    TX.export_perfetto(tobs["tracer"], path)
    assert TX.validate_trace(path) == []
    tracks = set(tobs["tracer"].tracks())
    rids = {TO.base_rid(r["rid"]) for r in tleg["requests"]}
    assert {TO.request_track(r) for r in rids} <= tracks
    assert tleg["pages_leaked"] == 0


def test_bare_and_instrumented_engines_bit_identical(engines):
    _, teng = engines
    bare, _, bres = _leg(SB, TF, TL, SLOPolicy, TO, teng, instrument=False,
                         n=12)
    assert teng.tracer is None and teng.reqtrace is None
    bare_books = (teng.pool.free_pages, teng.pool.used_pages)
    inst, obs, ires = _leg(SB, TF, TL, SLOPolicy, TO, teng, n=12)
    assert len(obs["tracer"].events) > 0
    assert inst["digest"] == bare["digest"]
    assert inst["requests"] == bare["requests"]
    assert ires.keys() == bres.keys()
    for rid in bres:
        np.testing.assert_array_equal(ires[rid], bres[rid])
    assert (teng.pool.free_pages, teng.pool.used_pages) == bare_books


# -- DeviceBackend.execute, traced on every rung ---------------------------
KW = dict(batch=2, seq_len=16, microbatches=2, vocab_shards=2)


@pytest.fixture(scope="module")
def placed():
    dag = P.build_gpt2_dag(P.GPT2Config.tiny(), **KW)
    g = dag.graph.freeze()
    params = dag.init_params(0, CPU)
    ids = dag.make_inputs(5, CPU)
    cl = P.Cluster.from_torch_devices([CPU] * 4, hbm_cap_gb=4.0)
    return dict(g=g, params=params, ids=ids, cl=cl,
                heft=P.get_scheduler("heft").schedule(g, cl))


RUNGS = {
    "per_task": dict(planned=False),
    "profile": dict(profile=True),
    "planned": {},
    "coalesced": dict(coalesce=True),
    "segmented": dict(segments=True),
    "compiled": dict(compiled=True),
    "streamed": dict(stream_params=True),
    "streamed_segmented": dict(stream_params=True, segments=True),
}


@pytest.mark.parametrize("rung", list(RUNGS))
def test_execute_traced_bit_equal_and_attributed(placed, rung, tmp_path):
    kw = RUNGS[rung]
    be = P.DeviceBackend(placed["cl"])
    reps = 1 if rung in ("profile",) or "stream_params" in kw else 2
    args = (placed["g"], placed["heft"], placed["params"], placed["ids"])
    off = be.execute(*args, reps=reps, **kw)
    tr, reg = TO.Tracer(), TO.MetricsRegistry()
    on = be.execute(*args, reps=reps, trace=tr, metrics=reg, **kw)
    assert torch.equal(on.output, off.output)
    assert off.attribution is None and off.memory is None
    path = str(tmp_path / "run.json")
    TX.export_perfetto(tr, path)
    assert TX.validate_trace(path) == []
    summ = TX.trace_summary(path)
    nodes = set(placed["heft"].placement.values())
    assert nodes <= set(summ["rows"])
    if rung != "compiled":
        assert summ["flows"] > 0
    att = on.attribution
    assert att is not None and att["critical_path"]
    assert abs(sum(att["breakdown_s"].values()) - att["makespan_s"]) < 1e-9
    spans = {e["name"] for e in tr.events if e["type"] == "span"}
    assert {"execute", "rep0", "fence"} <= spans
    snap = reg.snapshot()
    assert snap["counters"]["dispatch.launches"]["value"] == (
        on.n_dispatches * reps)
    assert snap["histograms"]["execute.makespan_s"]["count"] == 1
    if rung == "profile":
        assert set(snap["gauges"]) == {f"device.utilization.{n}"
                                       for n in nodes}


def test_profiling_helpers(tmp_path):
    with profiling.wall_timer() as t:
        sum(range(1000))
    assert t["seconds"] >= 0.0
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    assert profiling.time_fn(torch.matmul, a, b, repeats=2) >= 0.0
    flops = profiling.flop_count(torch.matmul, a, b)
    assert flops["flops"] == 2 * 8 * 16 * 4
    path = str(tmp_path / "prof" / "t.json")
    with profiling.torch_trace(path):
        torch.matmul(a, b)
    with open(path) as f:
        assert "traceEvents" in json.load(f)


def test_schedule_timeline_export(placed, tmp_path):
    g, sched = placed["g"], placed["heft"]
    P.DeviceBackend(placed["cl"]).execute(
        g, sched, placed["params"], placed["ids"], profile=True)
    path = profiling.export_chrome_trace(sched, str(tmp_path / "s.json"),
                                         graph=g)
    assert TX.validate_trace(path) == []
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    cross = sum(1 for t in g for d in t.dependencies
                if sched.placement[d] != sched.placement[t.task_id])
    assert cross > 0 and len([e for e in events if e["ph"] == "s"]) == cross
    assert [e for e in events if e["name"] == "run_fence"]
