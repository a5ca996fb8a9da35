"""Pure, unit-testable logic for the port's north-star bench (``eval/bench.py``).

PyTorch port of the parts of ``distributed_llm_scheduler_tpu.eval.
benchlib`` that mean something on an NVIDIA card: picking the best policy
against round-robin, the repeat-capture spread, the output oracle, FLOPs
and MFU, the link model's regime, the interconnect sensitivity sweep, the
modeled KV page peak, and :class:`BenchResult`, the one JSON line.  The
bench itself is orchestration over these.

Left out, with no meaning on the card: the TPU backend probe, the TPU
cost-model derivation and its fallback chain, and the measured-snapshot
save, load and headline promotion.  The port's bench measures on the card
on every run or fails.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

# Peak FLOP/s for MFU, by (card name as torch.cuda.get_device_name gives
# it, dtype).  NVIDIA H100 SXM5 data sheet, dense (without sparsity):
# 989 TFLOP/s bf16 on the tensor cores; 67 TFLOP/s float32 outside them
# (TF32 is off, so float32 matmuls do not reach the tensor cores).
PEAK_FLOPS = {
    ("NVIDIA H100 80GB HBM3", "bfloat16"): 989e12,
    ("NVIDIA H100 80GB HBM3", "float32"): 67e12,
}


def device_kind(device: Any) -> str:
    """The card's name for a CUDA device; the device type otherwise."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def choose_link(device: Any, cache_dir: str):
    """The link model of the card the bench runs on, measured in this run.

    Calls ``calibrate_link_cached`` on ``device``, which measures the host
    leg now (the saved calibration is only the degradation guard's
    baseline); with one card the interconnect leg is the H100
    estimate.  Returns ``(LinkModel, provenance)``, the provenance
    ``cuda:measured`` plus each leg's own.  Raises off CUDA and when the
    measurement fails: nothing falls back to an estimate or a file.
    """
    from ..utils.linkmodel import calibrate_link_cached

    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(
            f"choose_link measures a CUDA device; got {device} (inject a "
            "link model to run the bench off the card)"
        )
    cal = calibrate_link_cached(cache_dir, devices=[device])
    prov = "cuda:measured," + ",".join(
        f"{k}={v}" for k, v in sorted(cal.provenance.items())
    )
    return cal.to_link_model(), prov


def ici_sensitivity(
    graph,
    cluster,
    schedules: Mapping[str, object],
    link,
    dispatch_s: float = 0.0,
    scales: Tuple[float, ...] = (0.25, 4.0),
    dag_type: str = "gpt2_small",
) -> Dict[str, Dict[str, object]]:
    """Replay the ALREADY-FOUND placements under scaled interconnect
    bandwidth.

    With one card the interconnect leg is an estimate; this sweep shows
    whether the best-policy choice and vs_baseline ratio survive the
    estimate being 4x too optimistic or too pessimistic.  Schedules are
    NOT re-optimized per scale.

    Returns ``{"x0.25": {best_policy, best_makespan_s, vs_baseline}, ...}``.
    ``schedules`` must include the ``roundrobin`` baseline.
    """
    import dataclasses as _dc

    from ..backends.sim import SimulatedBackend

    if "roundrobin" not in schedules:
        raise ValueError(
            "ici_sensitivity needs the 'roundrobin' baseline schedule; "
            f"got {sorted(schedules)}"
        )
    out: Dict[str, Dict[str, object]] = {}
    for scale in scales:
        scaled = (
            link
            if link.interconnect_gbps is None
            else _dc.replace(
                link, interconnect_gbps=link.interconnect_gbps * scale
            )
        )
        sim = SimulatedBackend(
            fidelity="full", link=scaled, dispatch_s=dispatch_s
        )
        mk = {}
        for name, sched in schedules.items():
            r = sim.execute(graph, cluster, sched, dag_type=dag_type)
            mk[name] = (r.makespan, r.completed_tasks / max(r.num_tasks, 1))
        best_name, best, rr = pick_best(mk)
        out[f"x{scale:g}"] = {
            "best_policy": best_name,
            "best_makespan_s": best,
            "vs_baseline": rr / best if best > 0 else 1.0,
        }
    return out


# -- result shaping ----------------------------------------------------------


def pick_best(
    makespans: Mapping[str, Tuple[float, float]],
    baseline: str = "roundrobin",
) -> Tuple[str, float, float]:
    """(best_policy, best_makespan, baseline_makespan) over policies that
    completed 100%; the baseline itself is used even if incomplete (its
    makespan is then only a lower bound — callers log that)."""
    complete = {n: m for n, (m, c) in makespans.items() if c >= 1.0}
    rr = makespans[baseline][0]
    if not complete:
        return baseline, rr, rr
    best_name = min(complete, key=complete.get)
    return best_name, complete[best_name], rr


def best_of(n: int, fn):
    """Minimum over ``n`` repeated measurements of ``fn()``."""
    from ..utils.costmodel import repeat_capture

    return min(repeat_capture(fn, n))


def spread_stats(samples) -> Dict[str, float]:
    """Artifact-ready spread of one repeat-captured leg (seconds in,
    milliseconds out): median + min/max over N samples.  Headline numbers
    quote the MEDIAN; min/max bound what the run actually saw."""
    ss = sorted(float(s) for s in samples)
    return {
        "median_ms": round(statistics.median(ss) * 1e3, 4),
        "min_ms": round(ss[0] * 1e3, 4),
        "max_ms": round(ss[-1] * 1e3, 4),
        "n": len(ss),
    }


def oracle_close(
    expected,
    got,
    dtype_name: str,
    max_violation_frac: float = 1e-6,
    max_rel_fro: float = 2e-2,
) -> bool:
    """Numerical-parity oracle robust to low-precision tail outliers.

    For float32, strict elementwise ``allclose`` at 2e-4.  For lower
    precision, two valid orders of the same math accumulate symmetric
    rounding noise, so: the count of elements outside the 5e-2 band (abs
    + rel) must stay within ``max(1, max_violation_frac * N)``, AND the
    relative Frobenius error within ``max_rel_fro`` — a systematic error
    (wrong weights, missed residual, swapped shard) fails both; symmetric
    rounding tails fail neither.  The JAX package's rule, computed on the
    tensors' own device (so a card's logits never pass through the host),
    with the norms accumulated in float64.
    """
    a = torch.as_tensor(expected)
    b = torch.as_tensor(got, device=a.device)
    if a.shape != b.shape:
        return False
    a, b = a.float(), b.float()
    if dtype_name == "float32":
        return bool(torch.allclose(a, b, rtol=2e-4, atol=2e-4))
    tol = 5e-2
    diff = a - b
    n_viol = int((diff.abs() > (tol + tol * a.abs())).sum())
    # allow max(1, frac*N) violating elements: a pure fraction bound
    # degenerates to strict allclose for outputs under ~1/frac elements
    n_allowed = max(1, int(max_violation_frac * a.numel()))
    denom = float(torch.linalg.vector_norm(a, dtype=torch.float64))
    rel_fro = float(torch.linalg.vector_norm(diff, dtype=torch.float64)) / max(
        denom, 1e-12
    )
    return bool(n_viol <= n_allowed and rel_fro <= max_rel_fro)


def graph_flops(graph) -> float:
    """Total analytic FLOPs over tasks that declare them."""
    return float(
        sum(t.flops for t in graph if getattr(t, "flops", None) is not None)
    )


def compute_mfu(
    flops: float, makespan_s: float, kind: str, dtype_name: str
) -> Optional[float]:
    """Model FLOP utilization against the card's published peak; None on
    the CPU and on any card :data:`PEAK_FLOPS` does not name (an MFU
    against a guessed peak would be noise)."""
    peak = PEAK_FLOPS.get((kind, dtype_name))
    if peak is None or makespan_s <= 0 or flops <= 0:
        return None
    return flops / (makespan_s * peak)


def modeled_kv_pages_peak(
    slots: int, prompt_len: int, max_new: int, page_size: int
) -> int:
    """Modeled steady-state KV page-pool peak for a paged decode leg:
    every slot busy with a full-horizon request, i.e. ``slots x
    pages_needed(prompt + max_new, page_size)``.  Pure host arithmetic."""
    from ..models.kv_pages import pages_needed

    return slots * pages_needed(prompt_len + max_new, page_size)


@dataclass
class BenchResult:
    """Everything the bench prints; ``to_json`` is THE one stdout line.

    A field that is None is left out of the line, as in the JAX package's:
    ``eval/regress.py`` reads a key present in the baseline as a leg to
    check, so a null would fail every later run as ``missing``
    (``fence_rtt_s`` and, off the card, the MFUs are None).  The JAX package's fields, plus ``device`` (the card's name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit --format=csv,
    noheader`` gives them), ``node_hbm_gb`` (each replay node's budget),
    each policy's replayed ``(makespan_s, completion)``, the fused leg's
    MFU, the measured pre-flight footprint's maximum, the kernel
    launches of each measured leg, the per-task total of the calibration
    the replay used (``calibrated_task_s``) and the profile runs it was
    reduced from (``calibration_runs``; None for an injected or saved
    one), whether the calibration was a saved one (``cache_hit``; None
    for an injected one) and, for a saved one, its age in days
    (``calibration_age_days``).  Each policy's entry also carries its
    scheduling wall (``policy_sched_s``, host seconds), the digest of
    its placement (``placement_digests``) and, for a policy that keeps
    them (refine, search), its ``stats`` (``policy_stats``: evals and
    whether the static pre-filter ran, ``static_filter``).  ``link_model``
    is the link the replay used (not printed: ``link`` names its
    provenance), so a caller can replay again under the same link;
    ``schedules`` are the policies' schedules (not printed), so a caller
    can execute them."""

    n_policies: int
    platform_suffix: str
    best_policy: str
    best_makespan_s: float
    baseline_makespan_s: float
    oracle_ok: Optional[bool] = None
    fallback: bool = False
    peak_hbm_gb_measured: Optional[float] = None
    peak_hbm_gb_modeled: Optional[float] = None
    # per-device modeled peak bytes from the winning schedule's no-evict
    # replay, emitted flattened as ``peak_hbm_bytes.<node>``; and the
    # modeled steady-state KV page-pool peak of the decode leg's geometry
    peak_hbm_bytes: Optional[Dict[str, int]] = None
    kv_pages_peak: Optional[int] = None
    mfu_single_chip: Optional[float] = None
    dispatch_overhead: Optional[float] = None
    link_provenance: Optional[str] = None
    # the segment-fused and whole-program (compiled) legs
    segmented_makespan_s: Optional[float] = None
    mfu_segmented: Optional[float] = None
    compiled_makespan_s: Optional[float] = None
    mfu_compiled: Optional[float] = None
    compiled_dispatch_overhead_ms: Optional[float] = None
    # the headline number is a cost-model REPLAY of the winning placement
    # (modeled=True, always — one card cannot execute an 8-node placement)
    modeled: bool = True
    # fused_forward_s returns the full logits, as every DAG execution
    # must; the scalar-reduced variant anchors MFU only
    fused_forward_s: Optional[float] = None
    fused_scalar_s: Optional[float] = None
    fence_rtt_s: Optional[float] = None
    # replay prediction for the one-card schedule that was executed
    singlechip_replay_s: Optional[float] = None
    ici_sensitivity: Optional[Dict[str, Dict[str, object]]] = None
    # repeat-capture spread per measured leg (``spread_stats`` output)
    spread: Optional[Dict[str, Dict[str, float]]] = None
    # measured host wall inside the dispatch loop per rep, per-task leg
    dispatch_overhead_ms: Optional[float] = None
    model_tag: str = "gpt2s"
    device: Optional[str] = None
    node_hbm_gb: Optional[float] = None
    policies: Optional[Dict[str, Tuple[float, float]]] = None
    mfu_fused: Optional[float] = None
    preflight_max_gb: Optional[float] = None
    launches: Optional[Dict[str, Dict[str, int]]] = None
    cost_measured_at: Optional[str] = None
    calibrated_task_s: Optional[float] = None
    calibration_runs: Optional[int] = None
    cache_hit: Optional[bool] = None
    calibration_age_days: Optional[float] = None
    policy_sched_s: Optional[Dict[str, float]] = None
    placement_digests: Optional[Dict[str, str]] = None
    policy_stats: Optional[Dict[str, Dict[str, object]]] = None
    link_model: Optional[Any] = None
    schedules: Optional[Dict[str, Any]] = None

    @property
    def metric(self) -> str:
        return (
            f"{self.model_tag}_fwd_dag_makespan_best_of_"
            f"{self.n_policies}_policies" + self.platform_suffix
        )

    @property
    def vs_baseline(self) -> float:
        if self.best_makespan_s <= 0:
            return 1.0
        return self.baseline_makespan_s / self.best_makespan_s

    def to_json(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "metric": self.metric,
            "value": round(self.best_makespan_s * 1e3, 4),
            "unit": "ms",
            "vs_baseline": round(self.vs_baseline, 4),
            "best_policy": self.best_policy,
            "oracle_ok": self.oracle_ok,
            "fallback": self.fallback,
        }
        if self.peak_hbm_gb_measured is not None:
            out["peak_hbm_gb_measured"] = round(self.peak_hbm_gb_measured, 3)
        if self.peak_hbm_gb_modeled is not None:
            out["peak_hbm_gb_modeled"] = round(self.peak_hbm_gb_modeled, 3)
        if self.peak_hbm_bytes is not None:
            for node in sorted(self.peak_hbm_bytes):
                out[f"peak_hbm_bytes.{node}"] = int(
                    self.peak_hbm_bytes[node]
                )
        if self.kv_pages_peak is not None:
            out["kv_pages_peak"] = int(self.kv_pages_peak)
        if self.mfu_single_chip is not None:
            out["mfu_single_chip"] = round(self.mfu_single_chip, 4)
        if self.dispatch_overhead is not None:
            out["dispatch_overhead"] = round(self.dispatch_overhead, 4)
        if self.dispatch_overhead_ms is not None:
            out["dispatch_overhead_ms"] = round(self.dispatch_overhead_ms, 4)
        if self.segmented_makespan_s is not None:
            out["segmented_makespan_ms"] = round(
                self.segmented_makespan_s * 1e3, 4
            )
        if self.mfu_segmented is not None:
            out["mfu_segmented"] = round(self.mfu_segmented, 4)
        if self.compiled_makespan_s is not None:
            out["compiled_makespan_ms"] = round(
                self.compiled_makespan_s * 1e3, 4
            )
        if self.mfu_compiled is not None:
            out["mfu_compiled"] = round(self.mfu_compiled, 4)
        if self.compiled_dispatch_overhead_ms is not None:
            out["compiled_dispatch_overhead_ms"] = round(
                self.compiled_dispatch_overhead_ms, 4
            )
        out["modeled"] = self.modeled
        if self.fused_forward_s is not None:
            out["fused_forward_ms"] = round(self.fused_forward_s * 1e3, 4)
        if self.fused_scalar_s is not None:
            out["fused_scalar_ms"] = round(self.fused_scalar_s * 1e3, 4)
        if self.fence_rtt_s is not None:
            out["fence_rtt_ms"] = round(self.fence_rtt_s * 1e3, 4)
        if self.singlechip_replay_s is not None:
            out["singlechip_replay_ms"] = round(
                self.singlechip_replay_s * 1e3, 4
            )
        if self.link_provenance is not None:
            out["link"] = self.link_provenance
        if self.spread is not None:
            out["spread"] = {"quotes": "median", **self.spread}
        if self.ici_sensitivity is not None:
            out["ici_sensitivity"] = {
                k: {
                    "best_policy": v["best_policy"],
                    "best_makespan_ms": round(
                        float(v["best_makespan_s"]) * 1e3, 4
                    ),
                    "vs_baseline": round(float(v["vs_baseline"]), 4),
                }
                for k, v in self.ici_sensitivity.items()
            }
        if self.policies is not None:
            out["policies"] = {
                name: {"makespan_ms": round(m * 1e3, 4),
                       "completion": round(c, 4)}
                for name, (m, c) in sorted(self.policies.items())
            }
            for name, entry in out["policies"].items():
                if self.policy_sched_s is not None:
                    entry["sched_s"] = round(self.policy_sched_s[name], 4)
                if self.placement_digests is not None:
                    entry["digest"] = self.placement_digests[name]
                if self.policy_stats and name in self.policy_stats:
                    entry["stats"] = self.policy_stats[name]
        if self.mfu_fused is not None:
            out["mfu_fused"] = round(self.mfu_fused, 4)
        if self.calibrated_task_s is not None:
            out["calibrated_task_ms"] = round(self.calibrated_task_s * 1e3, 4)
        for key in ("device", "node_hbm_gb", "preflight_max_gb", "launches",
                    "cost_measured_at", "calibration_runs", "cache_hit",
                    "calibration_age_days"):
            if getattr(self, key) is not None:
                out[key] = getattr(self, key)
        return out
