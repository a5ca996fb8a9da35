"""Training-step DAG benchmark (BASELINE.json config #5), on a card.

PyTorch port of ``distributed_llm_scheduler_tpu.eval.train_bench``.  The
training-step DAG (``frontend/train_dag.py``) makes one
fwd+bwd+optimizer step a placeable task graph whose backward edges invert
the forward chain: each layer's params are needed a second time far from
the first, and forward activations stay live until their distant
backward consumer.  The bench:

1. executes the whole step on the card (``greedy`` on one node), with the
   loss and updated params held against the fused ``loss_fn`` + autograd
   + SGD oracle (loss rtol 1e-4; params rtol 5e-4, atol 5e-5), then times
   ``reps`` back-to-back steps (4 on a card, as the JAX bench on its
   chip);
2. takes per-task costs from the graph's saved calibration on this card
   or calibrates and saves them (``utils/costmodel.calibrate_cached``,
   ``.costmodel_torch/``), and the link measured on the card
   (``benchlib.choose_link``);
3. places the step on a modeled 8-node cluster under an activation-
   pressure budget and replays all 10 policies; reports makespans,
   completion, and the validator's per-node peak (no-evict residency) for
   the winner.

Run on the card::

    python -m distributed_llm_scheduler_tpu_torch.eval.train_bench [small]

It prints one JSON dict with the JAX bench's keys plus ``device`` (the
card's name and power limit, as ``nvidia-smi`` gives them).  f32 matmuls
run at full precision (TF32 off), which the oracle's tolerances assume.
Nothing falls back: off the card the cost model and the link must be
injected (``cost_model=``, ``link=``), and a failed leg raises.
"""

from __future__ import annotations
# dls-lint: allow-file(DET001) benchmark harness: wall time IS the measured quantity

import contextlib
import sys
import time
from typing import Any, Dict, Optional

import torch

from .bench import CACHE_DIR, nvidia_smi_line


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@contextlib.contextmanager
def full_precision_f32():
    """f32 matmuls and convolutions off the TF32 tensor-core path for the
    duration, the previous settings restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def step_matches(got: Dict[str, Any], want: Dict[str, Any],
                 loss_rtol: float = 1e-4, rtol: float = 5e-4,
                 atol: float = 5e-5) -> bool:
    """A step's loss and every updated param within the oracle's
    tolerances of ``want``'s (the JAX bench's by default)."""
    ok = abs(float(got["loss"]) - float(want["loss"])) <= (
        loss_rtol * abs(float(want["loss"])))
    for k, w in want["params"].items():
        g = got["params"][k].to(w.device)
        ok = ok and bool(torch.allclose(g, w, rtol=rtol, atol=atol))
    return ok


def measure_train_dag(
    config: Any = None,
    batch: int = 8,
    seq_len: int = 512,
    hbm_gb: float = 14.0,
    pressure_frac: float = 0.55,
    cache_dir: str = CACHE_DIR,
    device: Any = "cuda",
    cost_model: Any = None,
    link: Any = None,
    reps: Optional[int] = None,
    log=log,
) -> Dict[str, Any]:
    """Execute and model the GPT-2 training-step DAG on ``device``.

    ``pressure_frac``: the modeled per-node budget is ``pressure_frac x``
    the step's footprint on one node (params + peak activations, the
    validator's no-evict peak), so placement must spread the step and
    eviction-aware policies have something to win (the JAX bench's
    default 0.55).  ``reps`` defaults to 4 on a card and 1 elsewhere.
    """
    from ..backends.device import DeviceBackend
    from ..backends.sim import SimulatedBackend
    from ..core.cluster import Cluster, DeviceState
    from ..core.validate import validate_schedule
    from ..frontend.train_dag import build_gpt2_train_dag
    from ..models.gpt2 import GPT2Config
    from ..sched.policies import ALL_SCHEDULERS, get_scheduler
    from ..utils.costmodel import calibrate_cached, recalibrate_requested
    from .benchlib import choose_link, pick_best

    t0 = time.time()
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError("train_bench: no CUDA device visible")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        smi = nvidia_smi_line(device)
    elif cost_model is None or link is None:
        raise ValueError(
            f"train_bench on {device} needs an injected cost model and "
            "link: only a card is measured")
    else:
        smi = device.type
    if reps is None:
        reps = 4 if on_card else 1
    config = config or GPT2Config.small()
    dag = build_gpt2_train_dag(config, batch=batch, seq_len=seq_len)
    graph = dag.graph
    params = dag.init_params(seed=0, device=device)
    inputs = dag.make_inputs(device=device)
    log(f"train_bench: {graph.name}: {len(graph)} tasks, "
        f"{graph.total_param_gb():.2f} GB params on {smi}")

    with full_precision_f32():
        # 1. executed anchor: the full step on one node, oracle-checked
        one = Cluster.from_torch_devices([device])
        backend = DeviceBackend(one)
        sched_one = get_scheduler("greedy").schedule(graph, one)
        if sched_one.failed:
            raise RuntimeError(
                f"train_bench: greedy x1 failed {sorted(sched_one.failed)[:3]}")
        rep = backend.execute(graph, sched_one, params, inputs)
        want = dag.reference_forward(params, inputs)
        loss_got, loss_want = float(rep.output["loss"]), float(want["loss"])
        oracle_ok = step_matches(rep.output, want)
        del want, rep
        measured = backend.execute(
            graph, sched_one, params, inputs, warmup=False, reps=reps
        ).makespan_s
    log(f"train_bench: executed step {measured * 1e3:.1f} ms (reps={reps}); "
        f"loss {loss_got:.4f} vs oracle {loss_want:.4f}; "
        f"params+grads match: {oracle_ok}")

    # 2. the cost model: injected, or this card's saved calibration
    if cost_model is not None:
        cm, cost_prov = cost_model, "injected"
    else:
        with full_precision_f32():
            cm = calibrate_cached(graph, params, inputs, cache_dir,
                                  device=device, refresh=recalibrate_requested())
        cost_prov = f"{device.type}:" + ("cached" if cm.cache_hit else "live")
    cm.apply(graph)

    # 3. modeled placement under activation pressure: the step's
    # footprint on one node is the validator's no-evict peak there
    vone = validate_schedule(graph, one, sched_one)
    step_gb = max(vone.peak_no_evict_gb.values()) if vone.peak_no_evict_gb \
        else graph.total_param_gb()
    budget = max(step_gb * pressure_frac, 0.05)
    cluster = Cluster(
        [DeviceState(f"core_{i}", min(budget, hbm_gb)) for i in range(8)]
    )
    if link is None:
        link, link_prov = choose_link(device, cache_dir)
    else:
        link_prov = "injected"
    sim = SimulatedBackend(fidelity="full", link=link, dispatch_s=cm.dispatch_s)
    makespans, schedules = {}, {}
    for pol in sorted(ALL_SCHEDULERS):
        s = get_scheduler(pol, link=link).schedule(graph, cluster)
        r = sim.execute(graph, cluster, s, dag_type="gpt2_train")
        completion = r.completed_tasks / r.num_tasks
        makespans[pol] = (r.makespan, completion)
        schedules[pol] = s
        log(f"train_bench: {pol:10s} makespan={r.makespan * 1e3:9.3f} ms "
            f"completion={completion:.2f}")
    best_name, best, rr = pick_best(makespans)
    rr_complete = makespans["roundrobin"][1] >= 1.0
    if not rr_complete:
        log("train_bench: WARNING roundrobin did not complete; its "
            "makespan (and vs_roundrobin) is a lower bound")
    vrep = validate_schedule(graph, cluster, schedules[best_name])
    peak = max(vrep.peak_no_evict_gb.values())
    log(f"train_bench: best={best_name} {best * 1e3:.2f} ms vs roundrobin "
        f"{rr * 1e3:.2f} ms ({rr / max(best, 1e-12):.2f}x); winner per-node "
        f"peak {peak:.3f} GB on {budget:.3f} GB budget")

    return {
        "model": graph.name,
        "platform": device.type,
        "device": smi,
        "cost_provenance": cost_prov,
        "link_provenance": link_prov,
        "n_tasks": len(graph),
        "total_param_gb": round(graph.total_param_gb(), 4),
        "step_footprint_gb": round(step_gb, 4),
        "oracle_ok": oracle_ok,
        "executed_step_ms": round(measured * 1e3, 3),
        "modeled_budget_gb_per_core": round(budget, 4),
        "policies": {
            p: {"makespan_ms": round(m * 1e3, 3), "completion": c}
            for p, (m, c) in makespans.items()
        },
        "best_policy": best_name,
        "best_makespan_ms": round(best * 1e3, 3),
        "vs_roundrobin": round(rr / max(best, 1e-12), 4),
        "baseline_complete": rr_complete,
        "winner_peak_hbm_gb": round(peak, 4),
        "wall_s": round(time.time() - t0, 1),
    }


def main(argv=None) -> int:
    import json

    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] != "small":
        raise SystemExit(
            f"usage: train_bench [small], got {argv[0]!r} "
            "(GPT-2 small is the config-#5 scale)")
    print(json.dumps(measure_train_dag(), indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
