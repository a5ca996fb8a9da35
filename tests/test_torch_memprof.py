"""The port's memory profiler (``obs/memprof.py``) and its wiring into the
device backend and the paged decode engine, against the JAX package's,
on the CPU.

* fed the same alloc/free calls on a scripted clock, the port's
  ``MemoryProfiler`` holds the JAX one's events, timelines, peaks,
  watermark buckets and summary;
* ``DeviceBackend.execute(memprof=)`` on the f32 tiny GPT-2 placed run
  books every birth and free of the JAX backend's, byte for byte and in
  order, on every rung (per task, planned, coalesced, segmented,
  compiled) and on the streamed rungs (loads as param births, graveyard
  drops as frees), with equal per-device peaks and watermark buckets;
* the paged engine over the serve bench's slo leg books the JAX engine's
  kv-page timeline (pages x page_size x (Hkv, hd) x k+v x n_layers);
* on the CPU ``reconcile`` has no allocator to read, so the source stays
  ``model``; given a peak it carries ``platform`` and the ratio.
"""

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
from distributed_llm_scheduler_tpu.frontend.gpt2_dag import (
    build_gpt2_dag as jax_build,
)
from distributed_llm_scheduler_tpu.models import gpt2 as jgpt2
from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config as JaxConfig
from distributed_llm_scheduler_tpu.models.kv_pages import PagePool as JPool
from distributed_llm_scheduler_tpu.obs.slo import SLOPolicy as JPolicy
from distributed_llm_scheduler_tpu.serve import frontend as JF
from distributed_llm_scheduler_tpu.serve import loadgen as JL
from distributed_llm_scheduler_tpu_torch import obs as TO
from distributed_llm_scheduler_tpu_torch.eval import serve_bench as SB
from distributed_llm_scheduler_tpu_torch.models import gpt2 as tgpt2
from distributed_llm_scheduler_tpu_torch.obs.memprof import (
    BUCKETS,
    COUNTER_PREFIX,
)
from distributed_llm_scheduler_tpu_torch.obs.slo import SLOPolicy
from distributed_llm_scheduler_tpu_torch.serve import frontend as TF
from distributed_llm_scheduler_tpu_torch.serve import loadgen as TL

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


def _golden(O):
    clk = FakeClock(1.0)
    tr = O.Tracer(clock=clk)
    mem = O.MemoryProfiler(clock=clk, tracer=tr)
    mem.alloc("core_0", "param:w0", 100, "params")
    clk.t = 2.0
    mem.alloc("core_0", "input", 40, "activations")
    clk.t = 3.0
    mem.alloc("core_0", "out:t1", 60, "activations")
    clk.t = 4.0
    mem.free("core_0", "input")
    mem.free("core_0", "out:never_born")
    clk.t = 5.0
    mem.alloc("core_1", "xfer:t1", 60, "transfers")
    mem.alloc("core_1", "xfer:t1", 70, "transfers")
    mem.alloc("core_1", "kv:r0", 32, "kv_pages")
    mem.reconcile({"core_0": 300})
    return mem, tr


def test_golden_timeline_equal_jax():
    (jm, jt), (tm, tt) = _golden(JO), _golden(TO)
    assert tm.events == jm.events
    assert tt.events == jt.events
    assert tm.summary() == jm.summary()
    assert tm.timeline("core_0") == [(1.0, 100), (2.0, 140), (3.0, 200),
                                     (4.0, 160)]
    assert tm.peak("core_0") == (200, 3.0)
    wm = tm.watermark("core_0")
    assert wm["buckets"] == {"params": 100, "activations": 100,
                             "kv_pages": 0, "transfers": 0}
    assert tm.verify() == [] and tm.task_output_bytes() == {"t1": 60}
    assert tm.events[-2]["replaced"] == 60
    devs = tm.summary()["devices"]
    assert devs["core_0"]["source"] == "platform"
    assert devs["core_0"]["platform_ratio"] == pytest.approx(1.5)
    assert devs["core_1"]["source"] == "model"
    assert tm.summary()["buckets"] == list(BUCKETS)
    assert {COUNTER_PREFIX + "core_0", COUNTER_PREFIX + "core_1"} <= set(
        tt.counter_names())
    tm.events[1]["total"] = 999
    assert "live-set sum 140 != recorded total 999" in tm.verify()[0]


# -- the placed run, byte for byte -----------------------------------------
KW = dict(batch=2, seq_len=16, microbatches=2, vocab_shards=2)


@pytest.fixture(scope="module")
def setup():
    jdag = jax_build(JaxConfig.tiny(), **KW)
    tdag = P.build_gpt2_dag(P.GPT2Config.tiny(), **KW)
    jparams = jdag.init_params()
    tparams = P.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, CPU)
    ids = np.random.default_rng(5).integers(0, 512, (2, 16), dtype=np.int32)
    return dict(jg=jdag.graph.freeze(), tg=tdag.graph.freeze(),
                jparams=jparams, tparams=tparams, ids=ids)


def _both(setup, policy, n, cap_gb=4.0, **kw):
    """One memprof'd run through each package on the same schedule, each
    on a clock that ticks once per read."""
    jc = J.Cluster.from_jax_devices(jax.devices()[:n], hbm_cap_gb=cap_gb)
    tc = P.Cluster.from_torch_devices([CPU] * n, hbm_cap_gb=cap_gb)
    js = J.get_scheduler(policy).schedule(setup["jg"], jc)
    ts = P.get_scheduler(policy).schedule(setup["tg"], tc)
    assert ts.per_node == js.per_node
    mems = []
    for _ in range(2):
        ticks = iter(range(10 ** 6))
        mems.append(TO.MemoryProfiler(clock=lambda: float(next(ticks))))
    jticks = iter(range(10 ** 6))
    jm = JO.MemoryProfiler(clock=lambda: float(next(jticks)))
    reps = 1 if kw.get("stream_params") else 2
    jrep = JaxBackend(jc, pre_analysis=False).execute(
        setup["jg"], js, setup["jparams"], jnp.asarray(setup["ids"]),
        memprof=jm, reps=reps, **kw)
    trep = P.DeviceBackend(tc).execute(
        setup["tg"], ts, setup["tparams"], torch.from_numpy(setup["ids"]),
        memprof=mems[0], reps=reps, **kw)
    return jm, mems[0], jrep, trep


RUNS = {
    "greedy_x1_planned": ("greedy", 1, {}),
    "heft_x4_planned": ("heft", 4, {}),
    "heft_x4_coalesced": ("heft", 4, dict(coalesce=True)),
    "heft_x4_per_task": ("heft", 4, dict(planned=False)),
    "heft_x4_segmented": ("heft", 4, dict(segments=True)),
    "greedy_x1_compiled": ("greedy", 1, dict(compiled=True)),
    "heft_x4_compiled": ("heft", 4, dict(compiled=True)),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_placed_run_timeline_byte_exact(setup, run):
    policy, n, kw = RUNS[run]
    jm, tm, jrep, trep = _both(setup, policy, n, **kw)
    assert tm.events == jm.events
    assert len(tm.events) > 5
    assert tm.verify() == []
    for dev in jm.devices():
        assert tm.peak(dev) == jm.peak(dev)
        assert tm.watermark(dev) == jm.watermark(dev)
    assert trep.memory == tm.summary()
    # the CPU has no allocator peak: every device stays model-sourced
    assert {d["source"] for d in trep.memory["devices"].values()} == {"model"}


@pytest.mark.parametrize("seg", [False, True], ids=["per_task", "segmented"])
def test_streamed_run_books_loads_and_drops(setup, seg):
    """Oversubscribed streaming (a third of the weights per node): every
    load is a param birth and every graveyard drop its free, as the JAX
    streamer books them."""
    total = setup["jg"].total_param_gb()
    jm, tm, jrep, trep = _both(setup, "mru", 1, cap_gb=total * 0.35,
                               stream_params=True, segments=seg)
    assert trep.param_evictions == jrep.param_evictions > 0
    assert tm.events == jm.events
    frees = [e for e in tm.events if e["kind"] == "free"]
    assert frees and all(e["label"].startswith("param:") for e in frees)
    assert tm.verify() == []


def test_memprof_run_outputs_bit_equal(setup):
    tc = P.Cluster.from_torch_devices([CPU] * 4, hbm_cap_gb=4.0)
    ts = P.get_scheduler("heft").schedule(setup["tg"], tc)
    be = P.DeviceBackend(tc)
    args = (setup["tg"], ts, setup["tparams"], torch.from_numpy(setup["ids"]))
    plain = be.execute(*args)
    mem = TO.MemoryProfiler()
    traced = be.execute(*args, memprof=mem, trace=TO.Tracer())
    assert torch.equal(plain.output, traced.output)
    assert any(mem.watermark(d)["buckets"]["params"] > 0
               for d in mem.devices())


# -- the serving engine's kv pages ------------------------------------------
GEOM = {k: SB.SCENARIO[k] for k in ("slots", "page_size", "n_pages",
                                    "pages_per_seq")}


@pytest.fixture(scope="module")
def engines():
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


def _serve(sb, F, L, Policy, O, eng):
    sc = sb.SCENARIO
    vc = F.VirtualClock()
    mem = O.MemoryProfiler(clock=vc)
    eng.rebind_obs(clock=vc, memprof=mem)
    arr = L.poisson_arrivals(
        sc["rate_rps"], sc["n_requests"], 7, prompt_lens=sc["prompt_lens"],
        max_new_tokens=sc["max_new_tokens"], priorities=sc["priorities"],
        priority_weights=sc["priority_weights"])
    leg = sb.run_serving_leg(
        arr, Policy(ttft_s=sc["ttft_s"], window_s=sc["window_s"],
                    percentile=sc["percentile"]), "slo", True,
        F.ServiceTimeModel(wave_s=sc["wave_s"], segment_s=sc["segment_s"],
                           idle_s=sc["idle_s"]), sc, engine=eng)
    return mem, leg


def test_serve_scenario_kv_pages_byte_exact(engines):
    jeng, teng = engines
    jm, jleg = _serve(JSB, JF, JL, JPolicy, JO, jeng)
    tm, tleg = _serve(SB, TF, TL, SLOPolicy, TO, teng)
    assert teng._page_bytes == jeng._page_bytes
    cfg = tgpt2.GPT2Config.tiny()
    assert teng._page_bytes == (cfg.n_layer * 2 * GEOM["page_size"]
                                * cfg.n_head * (cfg.n_embd // cfg.n_head) * 4)
    assert tm.events == jm.events and len(tm.events) > 20
    node = tm.devices()[0]
    assert tm.watermark(node) == jm.watermark(node)
    wm = tm.watermark(node)
    assert wm["buckets"]["kv_pages"] == wm["peak_bytes"] > 0
    assert tm.live_bytes(node) == 0 and tm.verify() == []
    assert tleg["pages_leaked"] == 0
