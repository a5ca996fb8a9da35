"""The serving layer's framework-free modules against the JAX package's.

``obs/reqlog``, ``obs/slo``, ``obs/interference``, ``analysis/
lifecycle_pass``, ``analysis/page_pass`` and ``serve/loadgen`` are copies
of the JAX package's; on seeded synthetic inputs each must give what the
reference gives: schedules, prompts and digests; request-log snapshots,
validation, summaries and chains; SLO reports; latency attributions; and
the lifecycle and page-lifetime diagnostics, faults included.
"""

import copy
import json

import numpy as np
import pytest

from distributed_llm_scheduler_tpu.analysis import lifecycle_pass as JLC
from distributed_llm_scheduler_tpu.analysis import page_pass as JPP
from distributed_llm_scheduler_tpu.obs import interference as JI
from distributed_llm_scheduler_tpu.obs import reqlog as JR
from distributed_llm_scheduler_tpu.obs import slo as JS
from distributed_llm_scheduler_tpu.serve import loadgen as JL
from distributed_llm_scheduler_tpu_torch.analysis import lifecycle_pass as TLC
from distributed_llm_scheduler_tpu_torch.analysis import page_pass as TPP
from distributed_llm_scheduler_tpu_torch.obs import interference as TI
from distributed_llm_scheduler_tpu_torch.obs import reqlog as TR
from distributed_llm_scheduler_tpu_torch.obs import slo as TS
from distributed_llm_scheduler_tpu_torch.serve import loadgen as TL

SEEDS = (0, 7, 123)


def _arrivals(mod, kind, seed):
    if kind == "poisson":
        return mod.poisson_arrivals(
            30.0, 40, seed, prompt_lens=(8, 16, 24), max_new_tokens=(4, 8, 16),
            priorities=(0, 1, 2), priority_weights=(0.2, 0.5, 0.3))
    if kind == "session":
        return mod.session_arrivals(
            20.0, 12, seed, system_len=16, user_len=8, turns=3,
            max_new_tokens=(8, 12), priorities=(0, 1))
    return mod.mixed_long_prompt_arrivals(
        8.0, 26, seed, short_lens=(5, 8), long_len=24, long_every=6,
        max_new_tokens=(8, 12), long_max_new_tokens=4)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["poisson", "session", "mixed"])
def test_loadgen_schedules_equal(kind, seed):
    ja, ta = _arrivals(JL, kind, seed), _arrivals(TL, kind, seed)
    assert [a.to_json() for a in ta] == [a.to_json() for a in ja]
    assert TL.schedule_digest(ta) == JL.schedule_digest(ja)
    assert TL.arrivals_to_json(ta) == JL.arrivals_to_json(ja)


def test_prompt_materializers_and_traces_equal(tmp_path):
    for rid, plen in (("r0", 8), ("r17", 33), ("s3.t1", 32)):
        np.testing.assert_array_equal(
            TL.prompt_token_ids(rid, plen, 512, 3), JL.prompt_token_ids(rid, plen, 512, 3))
    for rid in ("s0.t0", "s0.t1", "s5.t2"):
        plen = 16 + 8 * (int(rid[-1]) + 1)
        np.testing.assert_array_equal(
            TL.session_prompt_token_ids(rid, plen, 512, 0, system_len=16, user_len=8),
            JL.session_prompt_token_ids(rid, plen, 512, 0, system_len=16, user_len=8))
    arr = _arrivals(TL, "poisson", 7)
    path = str(tmp_path / "trace.json")
    TL.save_trace(arr, path)
    assert [a.to_json() for a in JL.load_trace(path)] == [a.to_json() for a in arr]
    assert [a.to_json() for a in TL.load_trace(path)] == [a.to_json() for a in arr]
    bad = json.loads(open(path).read())
    bad["arrivals"][2]["t"] = -1.0
    del bad["arrivals"][3]["rid"]
    assert TL.validate_trace_obj(bad) == JL.validate_trace_obj(bad) != []


def _drive_log(mod, seed, capacity=None):
    """A seeded lifecycle: submits, admissions, first tokens, deliveries,
    retirements and preemptions (with resumed passes), on increasing
    times."""
    rng = np.random.RandomState(seed)
    log = mod.RequestLog(clock=lambda: 0.0, capacity=capacity)
    t = 0.0
    live = []
    for i in range(24):
        t += float(rng.exponential(0.01))
        rid = f"r{i}"
        log.submit(rid, int(rng.randint(4, 32)), int(rng.randint(2, 12)), t)
        live.append(rid)
        if rng.rand() < 0.7 and live:
            r = live.pop(0)
            t += 0.002
            log.admit(r, t)
            t += 0.003
            log.first_token(r, t)
            for _ in range(int(rng.randint(0, 3))):
                t += 0.005
                log.deliver(r, t, int(rng.randint(1, 5)))
            t += 0.001
            if rng.rand() < 0.25:
                log.preempt(r, t, "preempt_tier0_victim")
                log.submit(f"{r}#p1", 20, 3, t)
                log.admit(f"{r}#p1", t + 0.001)
                log.first_token(f"{r}#p1", t + 0.002)
                log.retire(f"{r}#p1", t + 0.004)
            else:
                log.retire(r, t)
    return log


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("capacity", [None, 8])
def test_reqlog_equal(seed, capacity):
    jl, tl = _drive_log(JR, seed, capacity), _drive_log(TR, seed, capacity)
    snap = tl.snapshot()
    assert snap == jl.snapshot()
    assert TR.validate_request_log(snap) == JR.validate_request_log(snap) == []
    assert TR.summarize_request_log(snap) == JR.summarize_request_log(snap)
    assert TR.stitch_logical_chains(snap["requests"]) == JR.stitch_logical_chains(
        snap["requests"])
    broken = copy.deepcopy(snap)
    broken["requests"][0]["t_first_token"] = -1.0
    broken["requests"][1]["state"] = "flying"
    assert TR.validate_request_log(broken) == JR.validate_request_log(broken) != []


@pytest.mark.parametrize("seed", SEEDS)
def test_slo_and_interference_equal(seed):
    snap = _drive_log(TR, seed).snapshot()
    for pol in (dict(ttft_s=0.004, window_s=0.05, percentile="p95"),
                dict(ttft_s=0.01, tpot_s=0.002, window_s=0.1, percentile="p99")):
        jrep = JS.evaluate_slo(snap, JS.SLOPolicy(**pol), t_end=0.5)
        trep = TS.evaluate_slo(snap, TS.SLOPolicy(**pol), t_end=0.5)
        assert trep.summary() == jrep.summary()
        assert (trep.tokens_good, trep.exceeds(), trep.breaches) == (
            jrep.tokens_good, jrep.exceeds(), jrep.breaches)
    rows = snap["requests"]
    for target in (None, 0.004):
        jatt = JI.attribute_requests(rows, ttft_target_s=target)
        tatt = TI.attribute_requests(rows, ttft_target_s=target)
        assert tatt.summary() == jatt.summary()
        assert tatt.max_residual_s() == jatt.max_residual_s()


def _diag(rep):
    return rep.to_json()


@pytest.mark.parametrize("seed", SEEDS)
def test_lifecycle_pass_equal(seed):
    rows = _drive_log(TR, seed).snapshot()["requests"]
    assert _diag(TLC.analyze_lifecycle(rows, final=True)) == _diag(
        JLC.analyze_lifecycle(rows, final=True))
    bad = copy.deepcopy(rows)
    bad[0]["t_admit"], bad[0]["t_submit"] = bad[0]["t_submit"], bad[0]["t_admit"] + 1
    bad[1]["state"] = "decoding"
    bad[2]["t_retire"] = None
    for final in (True, False):
        t = _diag(TLC.analyze_lifecycle(bad, final=final, label="leg"))
        assert t == _diag(JLC.analyze_lifecycle(bad, final=final, label="leg"))
        assert t["diagnostics"]


def _events(seed, fault=None):
    """A seeded ownership stream over a 9-page pool: allocs, assigns,
    releases and frees with the tiling counts (pages still held at the
    end are orphans), then one fault."""
    rng = np.random.RandomState(seed)
    ev, free, used = [], list(range(8, 0, -1)), []

    def rec(kind, pages, **kw):
        ev.append(dict(seq=len(ev), kind=kind, pages=list(pages), owner=kw.get("owner"),
                       site=kw.get("site"), free_pages=kw.get("free_pages"),
                       used_pages=kw.get("used_pages")))
        if "refcounts" in kw:
            ev[-1]["refcounts"] = kw["refcounts"]

    owned = {}
    for i in range(12):
        if free and rng.rand() < 0.6:
            n = min(len(free), int(rng.randint(1, 3)))
            pages = [free.pop() for _ in range(n)]
            used += pages
            rec("alloc", pages, free_pages=len(free), used_pages=len(used))
            rec("assign", pages, owner=f"r{i}", site="admit")
            owned[f"r{i}"] = pages
        elif owned:
            rid = sorted(owned)[int(rng.randint(len(owned)))]
            pages = owned.pop(rid)
            rec("release", pages, owner=rid, site="retire")
            for p in pages:
                used.remove(p)
                free.append(p)
            rec("free", pages, free_pages=len(free), used_pages=len(used))
    if fault == "double_free" and ev:
        last = next(e for e in reversed(ev) if e["kind"] == "free")
        rec("free", last["pages"], free_pages=len(free), used_pages=len(used))
    if fault == "trash":
        rec("alloc", [0], free_pages=len(free), used_pages=len(used) + 1)
    if fault == "tiling":
        ev[0]["free_pages"] += 1
    return {"schema": "dls.pages/1", "n_pages": 9, "events": ev}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", [None, "double_free", "trash", "tiling"])
def test_page_pass_equal(seed, fault):
    snap = _events(seed, fault)
    for final in (True, False):
        t = _diag(TPP.analyze_pages(snap, final=final))
        assert t == _diag(JPP.analyze_pages(snap, final=final))
        if fault:
            assert t["diagnostics"], fault
    art = {"schema": "dls.serve/1", "legs": {"a": {
        "pages_leaked": 1, "page_events": snap,
        "requests": _drive_log(TR, seed).snapshot()["requests"]}}}
    assert _diag(TPP.analyze_serve_artifact(art)) == _diag(JPP.analyze_serve_artifact(art))
    with pytest.raises(ValueError, match="schema"):
        TPP.analyze_serve_artifact({"schema": "x"})
