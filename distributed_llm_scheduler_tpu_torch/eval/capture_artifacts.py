"""One-shot capture of the measured perf records on the card.

PyTorch port of ``distributed_llm_scheduler_tpu.eval.capture_artifacts``:
streaming under eviction, decode (roofline, attribution, the families,
the task-graph decode, paged serving and its kernel, tensor-parallel
decode) and the training-step DAG, captured in ONE sequential pass so
every record carries the same provenance: ``platform`` and ``card`` (the
card's name and power limit).  Each leg is independently guarded: one
failure or hang degrades that record to an ``{"error": ...}`` stub
instead of losing the pass, and makes ``main`` exit 1.

The legs run at their full sizes on the cards.  The CPU rehearsal sizes
apply only when the caller asks for the CPU (``DLS_PLATFORM=cpu``); with
no card and no such request ``main`` exits 2 with one line.  On the CPU
the stream and train legs refuse (they measure a card's link and cost
model), so a rehearsal holds the wiring and the decode legs::

    python -m distributed_llm_scheduler_tpu_torch.eval.capture_artifacts 23
    python -m distributed_llm_scheduler_tpu_torch.eval.capture_artifacts 23 stream decode

Writes ``STREAM_TORCH_r{N:02d}.json`` / ``DECODE_TORCH_r..`` /
``TRAIN_TORCH_r..`` at the repo root (new names: the JAX package's
``STREAM_r..`` records stay as they are).
"""

from __future__ import annotations
# dls-lint: allow-file(DET001) capture harness: leg timeouts need the host clock

import json
import os
import sys
import time
import traceback
from typing import Any, Callable, Dict

from ..utils.config import env_str

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
# legs that consult calibration caches must hit the repo's
# .costmodel_torch regardless of invocation cwd (same anchoring as
# eval/bench.py)
CACHE_DIR = os.path.join(REPO_ROOT, ".costmodel_torch")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _has_error(d: Any) -> bool:
    """True if an ``error`` stub appears anywhere in the artifact — sub-leg
    failures (e.g. attribution inside the decode artifact) must surface in
    the exit code, not just in the JSON."""
    if isinstance(d, dict):
        return "error" in d or any(_has_error(v) for v in d.values())
    return False


class _LegTimeout(BaseException):
    """BaseException, NOT Exception: the legs wrap sub-legs in broad
    ``except Exception`` guards (the nested decode sub-legs) — an
    Exception-derived timeout would be swallowed right there, the alarm
    would be spent, and the next blocking call of the wedged leg would
    hang the pass with no protection left."""


def _guarded(name: str, fn: Callable[[], Dict[str, Any]]) -> Dict[str, Any]:
    """Run one capture leg with exception AND hang protection.

    A wedged leg (a blocking call that never returns) would otherwise
    stall the whole sequential pass and lose every later leg.  SIGALRM
    (main thread, Linux — exactly this script's environment) turns the
    hang into a per-leg ``{"error": ...}`` stub; budget via ``DLS_CAPTURE_LEG_TIMEOUT``
    seconds (default 1200, 0 disables)."""
    import signal
    import threading

    budget = float(env_str("DLS_CAPTURE_LEG_TIMEOUT", "1200"))
    t0 = time.time()

    def _alarm(signum, frame):
        raise _LegTimeout(f"leg exceeded {budget:.0f}s (a wedged call?)")

    use_alarm = (
        budget > 0
        and hasattr(signal, "SIGALRM")
        and threading.current_thread() is threading.main_thread()
    )
    prev_handler = prev_remaining = None
    if use_alarm:
        import math

        prev_handler = signal.signal(signal.SIGALRM, _alarm)
        # sub-legs nest (_guarded inside _guarded): remember the outer
        # timer's remaining seconds so this leg's cleanup can re-arm it.
        # ceil: alarm(int(0.5)) would be alarm(0) = CANCEL, silently
        # disarming the protection a fractional budget asked for
        prev_remaining = signal.alarm(max(1, int(math.ceil(budget))))
    def _stub() -> Dict[str, Any]:
        log(f"capture[{name}]: FAILED\n" + traceback.format_exc())
        return {"error": traceback.format_exc(limit=3),
                "capture_wall_s": round(time.time() - t0, 1)}

    try:
        out = fn()
        # disarm FIRST: the alarm could otherwise fire between fn()
        # returning and the finally, escaping this frame entirely
        if use_alarm:
            signal.alarm(0)
        out["capture_wall_s"] = round(time.time() - t0, 1)
        return out
    except _LegTimeout:
        if not use_alarm:
            # an ENCLOSING leg's timer fired while this frame ran without
            # one of its own — not ours to swallow (doing so would spend
            # the outer timer without re-arming it)
            raise
        signal.alarm(0)  # before traceback formatting, which takes time
        return _stub()
    except Exception:
        if use_alarm:
            signal.alarm(0)
        return _stub()
    finally:
        if use_alarm:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, prev_handler)
            if prev_remaining:
                left = prev_remaining - (time.time() - t0)
                # the outer leg already overran: let IT time out promptly
                signal.alarm(max(1, int(left)))


def _on_card() -> bool:
    """The platform seam's platform is the cards (``DLS_PLATFORM`` unset)."""
    from ..utils.config import platform

    return platform() == "cuda"


def capture_stream(budget_frac: float = 0.3) -> Dict[str, Any]:
    import torch

    from .stream_bench import measure_streaming

    if _on_card():
        return measure_streaming(budget_frac=budget_frac, log=log)
    # the CPU rehearsal's scale (capture_train's pattern): the medium-class
    # bf16 forward takes hours through a host core.  At small scale the
    # 0.3x budget sits BELOW the tied embedding matrix, making the cap
    # unsatisfiable by construction — the budget must exceed the largest
    # single param while staying well under total params
    from ..models.gpt2 import GPT2Config

    return measure_streaming(
        config=GPT2Config.small(dtype=torch.bfloat16), batch=4, seq_len=128,
        budget_frac=max(budget_frac, 0.4), device="cpu", log=log,
    )


def capture_decode() -> Dict[str, Any]:
    """The decode artifact: whole-program roofline numbers, per-component
    attribution of the gap to the HBM bound, and the task-graph decode
    path's own perf (VERDICT r3 next #6 — both halves)."""
    import torch

    from ..utils.config import platform_world
    from .decode_bench import (
        _round4 as _rounded,
        decode_attribution,
        measure_decode,
        measure_decode_dag,
        measure_decode_sharded,
    )

    on_card = _on_card()
    dev = {"device": "cuda" if on_card else "cpu"}
    # the CPU rehearsal's scale for the gpt2 legs (capture_train's
    # pattern: the full-size legs take hours through a host core).  The
    # record's batch / prompt_len / new_tokens fields plus the platform
    # stamp disclose it, and every relative claim a leg makes (int8 vs
    # bf16, paged vs dense) is measured at equal config WITHIN that leg.
    gpt2_kw: Dict[str, Any] = (
        dev if on_card
        else {"batch": 4, "prompt_len": 128, "new_tokens": 16, **dev}
    )
    out = _guarded(
        "decode.whole_program",
        lambda: _rounded(measure_decode(**gpt2_kw)),
    )
    # the whole_program dict becomes the artifact's top level, where
    # main()'s outer stamp would overwrite its wall time — keep it under
    # its own name like the sibling sub-legs keep theirs
    out["whole_program_wall_s"] = out.pop("capture_wall_s", None)
    out["attribution"] = _guarded(
        "decode.attribution", lambda: decode_attribution(**gpt2_kw)
    )
    # int8 weights: decode is bandwidth-bound, so halving the weight
    # bytes is the structural lever (the roofline in this leg reflects
    # the quantized bytes)
    out["quantized"] = _guarded(
        "decode.quantized",
        lambda: _rounded(measure_decode(quantize=True, **gpt2_kw)),
    )
    # weights AND KV cache int8: both dominant byte terms halved
    out["quantized_kv"] = _guarded(
        "decode.quantized_kv",
        lambda: _rounded(
            measure_decode(quantize=True, kv_int8=True, **gpt2_kw)
        ),
    )
    # family breadth (the gpt2 numbers above are the roofline story;
    # these pin the OTHER decode paths' measured rates): a GPT-2-small-
    # class Llama (GQA 12:4 + RoPE + SwiGLU) and Mixtral (per-token
    # top-2 routing in the decode step).  CPU fallback runs the tiny
    # configs — a functional rehearsal, disclosed by the model field.
    from ..models.llama import LlamaConfig
    from ..models.mixtral import MixtralConfig

    lcfg = (
        LlamaConfig(
            vocab_size=32_000, max_seq_len=1024, d_model=768,
            n_layers=12, n_heads=12, n_kv_heads=4, ffn_hidden=2048,
            dtype=torch.bfloat16,
        )
        if on_card else LlamaConfig.tiny(dtype=torch.bfloat16)
    )
    mcfg = (
        MixtralConfig(
            vocab_size=32_000, max_seq_len=1024, d_model=512,
            n_layers=8, n_heads=8, n_kv_heads=4, ffn_hidden=1408,
            n_experts=8, top_k=2, dtype=torch.bfloat16,
        )
        if on_card else MixtralConfig.tiny(dtype=torch.bfloat16)
    )
    # tiny configs cap max_seq_len at 128 — the CPU rehearsal must shrink
    # the sequence budget with them (capture_train's CPU-scale pattern)
    # or decode.generate's position-limit guard rejects every call
    size_kw = dev if on_card else {"prompt_len": 64, "new_tokens": 16, **dev}
    for name, cfg in (("llama", lcfg), ("mixtral", mcfg)):
        out[name] = _guarded(
            f"decode.{name}",
            lambda cfg=cfg: _rounded(measure_decode(config=cfg, **size_kw)),
        )
        out[name]["model"] = (
            f"{name}_{cfg.n_layers}l_d{cfg.d_model}_"
            f"{str(cfg.dtype).removeprefix('torch.')}"
        )
    dag_kw: Dict[str, Any] = (
        dev if on_card
        else {"batch": 4, "prompt_len": 128, "new_tokens": 8, "reps": 4, **dev}
    )
    out["task_graph"] = _guarded(
        "decode.task_graph", lambda: measure_decode_dag(**dag_kw)
    )
    # paged KV cache + continuous batching (r6): mixed-length multi-
    # request traffic, paged engine vs dense static batching at equal
    # token budgets — tokens must match bit-exactly, throughput >= dense
    from .decode_bench import measure_paged_decode

    out["paged"] = _guarded(
        "decode.paged", lambda: _rounded(measure_paged_decode(**dev))
    )
    # the kernel leg: the same serving workload through two engines
    # differing only in attention impl — the plain gather vs the CUDA
    # kernels (on the CPU both run the plain version: parity only)
    from .decode_bench import measure_paged_kernel

    out["paged_kernel"] = _guarded(
        "decode.paged_kernel", lambda: measure_paged_kernel(**dev)
    )
    # flat decode.* keys at the artifact top level (the serve artifact's
    # flat-key pattern) — what the regress families gate on
    paged, kern = out["paged"], out["paged_kernel"]
    if "error" not in paged:
        out["decode.paged_tok_s"] = paged["paged_tok_s"]
        out["decode.paged_speedup"] = paged["speedup"]
        out["decode.paged_tokens_exact"] = paged["tokens_exact"]
        out["decode.pages_leaked"] = paged["pages_leaked"]
    if "error" not in kern:
        out["decode.kernel_tokens_exact"] = kern["tokens_exact"]
        out["decode.kernel_parity_ok"] = kern["parity_ok"]
        out["decode.kernel_pages_leaked"] = (
            kern["pages_leaked_gather"] + kern["pages_leaked_kernel"]
        )
        if "kernel_vs_gather_speedup" in kern:
            # present only when measured on a card
            out["decode.kernel_vs_gather_speedup"] = (
                kern["kernel_vs_gather_speedup"]
            )
    n_dev = platform_world()
    if n_dev >= 2:
        out["tp_sharded"] = _guarded(
            "decode.tp", lambda: measure_decode_sharded(tp=2)
        )
    else:
        # one card cannot run tp=2 — skip honestly
        out["tp_sharded"] = {
            "skipped": f"{n_dev} device(s); tp decode needs two "
            "(tests/test_torch_sharded_decode.py holds it on the CPU)"
        }
    return out


def capture_train() -> Dict[str, Any]:
    from .train_bench import measure_train_dag

    if _on_card():
        return measure_train_dag(cache_dir=CACHE_DIR)
    # CPU-fallback scale, disclosed via the artifact's model tag: the
    # full config-#5 step takes minutes per execution on a host, and the
    # completion-cliff story (eviction-aware policies place 100% under
    # the 0.55x pressure budget where critical/dfs drop tasks) is what
    # the artifact exists to show
    return measure_train_dag(batch=4, seq_len=128, cache_dir=CACHE_DIR,
                             device="cpu")


LEGS = {
    "stream": ("STREAM", capture_stream),
    "decode": ("DECODE", capture_decode),
    "train": ("TRAIN", capture_train),
}


def main(argv) -> int:
    if not argv or not argv[0].isdigit():
        print(__doc__, file=sys.stderr)
        return 2
    round_n = int(argv[0])
    wanted = argv[1:] or list(LEGS)
    unknown = [w for w in wanted if w not in LEGS]
    if unknown:
        print(f"unknown legs {unknown}; have {sorted(LEGS)}",
              file=sys.stderr)
        return 2

    from ..obs import ambient_metrics, ambient_tracer, reset_ambient
    from ..utils.config import ConfigError, platform, platform_devices

    try:
        card = platform_devices()[0]
    except ConfigError as e:  # no card, and the CPU not asked for
        print(f"capture: {e}", file=sys.stderr)
        return 2
    if card.type == "cuda":
        from .bench import nvidia_smi_line

        card = nvidia_smi_line(card)
    else:
        card = card.type
    plat = platform()
    log(f"capture: round {round_n}, platform={plat}, card={card}, "
        f"legs={wanted}")
    rc = 0

    for w in wanted:
        prefix, fn = LEGS[w]
        t0 = time.time()
        reset_ambient()  # each leg's ambient snapshot starts clean
        out = _guarded(w, fn)
        out.setdefault("platform", plat)
        out["card"] = card
        out["round"] = round_n
        # DLS_TRACE=1: attach the leg's ambient metrics snapshot (obs) —
        # transfer bytes per edge, jit-cache hits, overhead histograms
        amb = ambient_metrics()
        if amb is not None:
            out["obs_metrics"] = amb.snapshot()
        atr = ambient_tracer()
        if atr is not None:
            # run-doctor attribution of the leg's last traced execute; a
            # failure is a stub in the record, so the pass exits 1
            from ..obs import attribute_run

            att = _guarded(f"{w}.attribution",
                           lambda: {"attribution": attribute_run(atr)})
            if "error" in att:
                out["obs_attribution"] = att
            elif att["attribution"].critical_path:
                out["obs_attribution"] = att["attribution"].summary()
        path = os.path.join(REPO_ROOT, f"{prefix}_TORCH_r{round_n:02d}.json")
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        log(f"capture[{w}]: wrote {path} ({time.time()-t0:.0f}s)")
        if _has_error(out):
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
