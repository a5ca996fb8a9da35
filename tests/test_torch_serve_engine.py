"""The port's serving engine against the JAX package's, on the CPU.

Both ``PagedDecodeEngine``s are built from the same numpy weights (the
tiny f32 GPT-2, seed 0) at the serve bench's geometry (4 slots, 8-token
pages, 13 pages, 4 pages a slot, 4-step segments) and driven alike on a
virtual clock that moves between segments.  In each mode — whole-prompt
admission, chunked prefill, prefix sharing — their greedy tokens, request
lifecycle log, page books and page-ownership events must be equal.
Chunked tokens must be equal across chunk sizes and to whole-prompt
tokens, sharing on and off must give equal tokens, a preempted request
resumed from its prefix must continue as an uninterrupted one, a forced
copy-on-write split must leave every token unchanged, and a draining
engine must refuse work as the JAX one does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu.backends.device import DeviceBackend as JaxBackend
from distributed_llm_scheduler_tpu.frontend.decode_dag import (
    build_paged_decode_dag as jax_build,
)
from distributed_llm_scheduler_tpu.models import gpt2 as jgpt2
from distributed_llm_scheduler_tpu.models.kv_pages import PageOwnershipLog as JLog
from distributed_llm_scheduler_tpu.models.kv_pages import PagePool as JPool
from distributed_llm_scheduler_tpu.serve.frontend import VirtualClock as JClock
from distributed_llm_scheduler_tpu_torch.analysis import analyze_pages
from distributed_llm_scheduler_tpu_torch.models import gpt2 as tgpt2
from distributed_llm_scheduler_tpu_torch.models.kv_pages import PageOwnershipLog as TLog
from distributed_llm_scheduler_tpu_torch.serve.frontend import VirtualClock as TClock

CPU = torch.device("cpu")
GEOM = dict(slots=4, page_size=8, n_pages=13, pages_per_seq=4)
SEG = 4
SEG_S, SUBMIT_S = 0.05, 0.01


@pytest.fixture(scope="module")
def weights():
    np_w = tgpt2.init_params_numpy(tgpt2.GPT2Config.tiny(), 0)
    return ({k: jnp.asarray(v) for k, v in np_w.items()},
            tgpt2.params_from_numpy(np_w, CPU))


def _jax_engine(jw, sharing, chunk):
    jd = jax_build(jgpt2.GPT2Config.tiny(), **GEOM)
    jc = J.Cluster.from_jax_devices(jax.devices()[:1])
    return JaxBackend(jc).paged_decode_engine(
        jd.graph, J.get_scheduler("greedy").schedule(jd.graph, jc), jd.config,
        jw, JPool(n_pages=GEOM["n_pages"], page_size=GEOM["page_size"],
                  sharing=sharing),
        slots=GEOM["slots"], pages_per_seq=GEOM["pages_per_seq"],
        seg_steps=SEG, clock=JClock(), chunk_tokens=chunk)


def _torch_engine(tw, sharing, chunk):
    td = P.build_paged_decode_dag(P.GPT2Config.tiny(), **GEOM)
    tc = P.Cluster.from_torch_devices([CPU])
    return P.DeviceBackend(tc).paged_decode_engine(
        td.graph, P.get_scheduler("greedy").schedule(td.graph, tc), td.config,
        tw, P.PagePool(n_pages=GEOM["n_pages"], page_size=GEOM["page_size"],
                       sharing=sharing),
        slots=GEOM["slots"], pages_per_seq=GEOM["pages_per_seq"],
        seg_steps=SEG, clock=TClock(), chunk_tokens=chunk)


@pytest.fixture(scope="module")
def engines(weights):
    """mode -> (JAX engine, port engine), built once; each test resets."""
    jw, tw = weights
    modes = {"whole": (False, None), "chunked": (False, 8), "shared": (True, None)}
    return {m: (_jax_engine(jw, s, c), _torch_engine(tw, s, c))
            for m, (s, c) in modes.items()}


def workload(mode):
    """Seeded requests: 8- and 16-token prompts (24 with chunking, so some
    prompts take three 8-token chunks); with sharing, every prompt opens
    with one of two 8-token system prompts."""
    rng = np.random.default_rng(21)
    systems = rng.integers(0, 512, size=(2, 8), dtype=np.int32)
    lens = (8, 16, 24) if mode == "chunked" else (8, 16)
    reqs = []
    for i in range(10):
        plen = lens[i % len(lens)]
        ids = rng.integers(0, 512, size=(1, plen), dtype=np.int32)
        if mode == "shared":
            ids[0, :8] = systems[i % 2]
        gen = 32 - plen if i % 3 == 0 else 4 + i % 5
        reqs.append((f"q{i}", ids, gen))
    return reqs


def drive(eng, reqs, stagger=3, on_segment=None):
    """Submit ``stagger`` requests, then one more before each segment,
    moving the clock by SUBMIT_S per submit and SEG_S per segment; run
    until drained.  Returns {rid: tokens}."""
    eng.reset()
    eng._clock.reset()
    pending = list(reqs)

    def submit_one():
        rid, ids, gen = pending.pop(0)
        eng.submit(rid, ids, gen)
        eng._clock.advance(SUBMIT_S)

    for _ in range(min(stagger, len(pending))):
        submit_one()
    n = 0
    while pending or eng._queue or any(r is not None for r in eng._slot_req):
        if pending:
            submit_one()
        if on_segment is not None:
            on_segment(eng, n)
        eng.step_segment()
        eng._clock.advance(SEG_S)
        n += 1
        assert n < 500, "engine stalled"
    return {k: np.asarray(v) for k, v in eng.results.items()}


def _snapshot(eng):
    return eng.reqlog.snapshot()


@pytest.mark.parametrize("mode", ["whole", "chunked", "shared"])
def test_engines_equal_jax_in_each_mode(engines, mode):
    jeng, teng = engines[mode]
    reqs = workload(mode)
    logs, out, counts = {}, {}, {}
    counters = ("decode.requests_completed", "decode.tokens_delivered",
                "decode.admission_waves", "decode.segments_run",
                "decode.chunk_admitted", "decode.prefix_shared_pages")
    for name, eng, log in (("jax", jeng, JLog()), ("torch", teng, TLog())):
        before = {c: eng.metrics.counter(c).value for c in counters}
        eng.attach_ownership_log(log)
        out[name] = drive(eng, reqs)
        logs[name] = log
        eng.attach_ownership_log(None)
        counts[name] = {c: eng.metrics.counter(c).value - before[c]
                        for c in counters}
    assert sorted(out["torch"]) == sorted(out["jax"]) == sorted(r for r, _, _ in reqs)
    for rid, _, gen in reqs:
        assert out["torch"][rid].shape == (gen,)
        np.testing.assert_array_equal(out["torch"][rid], out["jax"][rid], err_msg=rid)
    assert _snapshot(teng) == _snapshot(jeng)
    assert logs["torch"].snapshot() == logs["jax"].snapshot()
    assert len(logs["torch"]) > 0
    assert teng.segments_run == jeng.segments_run
    assert teng.summary() == jeng.summary()
    assert teng.page_occupancy()["free_pages"] == GEOM["n_pages"] - 1
    assert counts["torch"] == counts["jax"]
    kinds = {e["kind"] for e in logs["torch"].events}
    if mode == "shared":
        assert {"share", "write"} <= kinds
        assert counts["torch"]["decode.prefix_shared_pages"] > 0
    if mode == "chunked":
        assert counts["torch"]["decode.chunk_admitted"] > 0


def test_chunked_tokens_equal_across_chunk_sizes(engines):
    """One port engine, chunk sizes None (whole prompts), 4, 8 and 16:
    every request's tokens equal."""
    _, teng = engines["chunked"]
    reqs = workload("chunked")
    runs = {}
    try:
        for ct in (None, 4, 8, 16):
            teng.chunk_tokens = ct
            admitted = teng.metrics.counter("decode.chunk_admitted").value
            runs[ct] = drive(teng, reqs)
            chunked = teng.metrics.counter("decode.chunk_admitted").value - admitted
            assert (chunked > 0) == (ct is not None), ct
    finally:
        teng.chunk_tokens = 8
    for ct in (4, 8, 16):
        for rid, _, _ in reqs:
            np.testing.assert_array_equal(runs[ct][rid], runs[None][rid],
                                          err_msg=f"{rid} chunk {ct}")


def test_sharing_on_and_off_gives_equal_tokens(engines):
    _, teng = engines["shared"]
    reqs = workload("shared")
    runs = {}
    try:
        for mode in (True, False):
            teng.pool.sharing = mode
            runs[mode] = drive(teng, reqs)
    finally:
        teng.pool.sharing = True
    for rid, _, _ in reqs:
        np.testing.assert_array_equal(runs[True][rid], runs[False][rid], err_msg=rid)


def _preempted_run(eng, reqs, victim, at_segment):
    """``drive``, preempting ``victim`` before segment ``at_segment`` and
    resubmitting its prompt + prefix as ``victim#p1``; returns the run's
    tokens with the victim's passes stitched, and the preempt result."""
    got = {}

    def hook(e, n):
        if n == at_segment:
            res = e.preempt(victim, cause="test", by="q0")
            got["res"] = res
            ids = dict((r, i) for r, i, _ in reqs)[victim]
            e.submit(f"{victim}#p1",
                     np.concatenate([ids, res["tokens"][None, :]], axis=1),
                     res["remaining"])

    out = drive(eng, reqs, on_segment=hook)
    res = got["res"]
    out[victim] = np.concatenate([res["tokens"], out.pop(f"{victim}#p1")])
    return out, res


def test_preempted_and_resumed_request_equals_uninterrupted(engines):
    """q0 (a long generation) is preempted after two segments and resumed
    from its prefix under a new rid: its stitched tokens equal an
    uninterrupted run's, the preempt result and the lifecycle logs equal
    the JAX engine's, and its record ends ``preempted``."""
    jeng, teng = engines["whole"]
    reqs = workload("whole")
    plain = drive(teng, reqs)
    got, res = _preempted_run(teng, reqs, "q0", 2)
    jgot, jres = _preempted_run(jeng, reqs, "q0", 2)
    assert res["rid"] == jres["rid"] == "q0"
    assert res["remaining"] == jres["remaining"] > 0
    np.testing.assert_array_equal(res["tokens"], np.asarray(jres["tokens"]))
    for rid, _, _ in reqs:
        np.testing.assert_array_equal(got[rid], plain[rid], err_msg=rid)
        np.testing.assert_array_equal(got[rid], jgot[rid], err_msg=rid)
    assert _snapshot(teng) == _snapshot(jeng)
    assert teng.reqlog.get("q0").state == "preempted"
    assert teng.metrics.counter("decode.requests_preempted").value >= 1
    with pytest.raises(ValueError, match="not in flight"):
        teng.preempt("q0")


def test_chunk_prefilling_request_is_not_preemptible(engines):
    _, teng = engines["chunked"]
    teng.reset()
    teng.submit("long", np.zeros((1, 24), np.int32), 4)
    teng.submit("short", np.ones((1, 8), np.int32), 20)
    # admission claims the long prompt's slot and first chunk only; the
    # budget of the segment runs its chunks
    teng._admit()
    assert teng.is_prefilling("long") and not teng.is_prefilling("short")
    with pytest.raises(ValueError, match="mid-chunked-prefill"):
        teng.preempt("long")
    teng.run()
    assert teng.page_occupancy()["free_pages"] == GEOM["n_pages"] - 1


def test_forced_copy_on_write_keeps_tokens(engines):
    """An alias forced onto a request's write page (an extra reference on
    its tail page) makes ``_ensure_exclusive`` split it before the
    segment: the request gets a copy, the tokens equal an unsplit run's,
    and the ownership log records the cow and its write."""
    _, teng = engines["shared"]
    reqs = workload("shared")[:3]
    plain = drive(teng, reqs)
    log = TLog()
    teng.attach_ownership_log(log)
    forced = {}

    def hook(e, n):
        if n == 1:
            s = next(s for s in range(e.slots)
                     if e._slot_req[s] is not None and e.remaining[s] > 0)
            page = int(e.page_table[s, int(e.lengths[s]) // e.page_size])
            e.pool.share([page])
            forced["page"] = page
        if n == 2:
            e.pool.release_ref([forced["page"]])

    try:
        got = drive(teng, reqs, on_segment=hook)
    finally:
        teng.attach_ownership_log(None)
    for rid, _, _ in reqs:
        np.testing.assert_array_equal(got[rid], plain[rid], err_msg=rid)
    cows = [e for e in log.events if e["kind"] == "cow"]
    assert len(cows) == 1 and cows[0]["pages"][0] == forced["page"]
    assert any(e["kind"] == "write" and e["site"] == "cow" for e in log.events)
    assert not analyze_pages(log).diagnostics
    assert teng.page_occupancy()["free_pages"] == GEOM["n_pages"] - 1


def test_submit_raises_while_draining(engines):
    jeng, teng = engines["whole"]
    for eng in (jeng, teng):
        eng.reset()
        eng.submit("a", np.zeros((1, 8), np.int32), 4)
        eng.begin_drain()
        eng.begin_drain()  # idempotent
        assert eng.draining and eng.summary()["draining"] is True
    with pytest.raises(RuntimeError) as jerr:
        jeng.submit("b", np.zeros((1, 8), np.int32), 4)
    with pytest.raises(RuntimeError) as terr:
        teng.submit("b", np.zeros((1, 8), np.int32), 4)
    assert str(terr.value) == str(jerr.value)
    # queued work is a commitment: the draining engine empties itself
    assert sorted(teng.run()) == ["a"]
    assert teng.metrics.counter("decode.drains_begun").value >= 1
    teng.end_drain()
    teng.submit("b", np.zeros((1, 8), np.int32), 4)
    teng.reset()
    assert not teng.draining
    jeng.end_drain()
    jeng.reset()


def test_rebind_obs_gives_a_fresh_engine(engines):
    """``rebind_obs`` wires a new clock, metrics and ownership log and
    wipes run state: the next run equals a reset engine's; a tracer,
    memory profiler and flight recorder are wired the same way, and a
    rebind without them unwires them."""
    _, teng = engines["whole"]
    reqs = workload("whole")[:4]
    plain = drive(teng, reqs)
    clock, metrics, log = TClock(), P.MetricsRegistry(), TLog()
    teng.submit("left", np.zeros((1, 8), np.int32), 4)
    teng.rebind_obs(clock=clock, metrics=metrics, ownlog=log)
    assert teng._clock is clock and teng.metrics is metrics
    assert teng.pool.ownlog is log and not teng._queue
    got = drive(teng, reqs)
    for rid, _, _ in reqs:
        np.testing.assert_array_equal(got[rid], plain[rid])
    assert metrics.counter("decode.requests_completed").value == len(reqs)
    assert len(log) > 0
    from distributed_llm_scheduler_tpu_torch.obs import (
        FlightRecorder, MemoryProfiler, Tracer)

    tr, mp, fl = Tracer(), MemoryProfiler(), FlightRecorder()
    teng.rebind_obs(tracer=tr, memprof=mp, flight=fl)
    assert teng.tracer.primary is tr and teng.tracer.mirror is fl.tracer
    assert teng.memprof is mp and teng.reqtrace is not None
    teng.rebind_obs(clock=TClock())
    assert teng.tracer is None and teng.memprof is None
    assert teng.reqtrace is None and teng.flight is None
