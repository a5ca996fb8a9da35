"""Assemble RANKCHECK_TORCH_r{N}.json: the flagship and separating legs.

PyTorch port of ``distributed_llm_scheduler_tpu.eval.rankcheck_artifact``.
The two legs answer different questions:

* ``flagship`` — the bench's own configuration (GPT-2 small mb8+vs8
  fused) on every visible card, with the two-anchor in-situ calibration
  (``run_rank_check(anchor_calibrate=True)``): does the replay's cost
  model, once grounded against the run itself, rank the policies the way
  the cards do?
* ``separating`` — the transfer-bound stress DAG on four distinct cards,
  where the sim predicts separation from first principles, so rank
  agreement is asserted with no tie escape and no calibration.

Nodes sharing one card copy nothing between them, so both legs need four
distinct cards: with fewer (one card, or the CPU) ``main`` exits 2 with
one line, as ``rankcheck --stress`` does.  Exit 0 only when both legs
agree on the winner with Kendall's tau >= 0.8, else 1.  The record is
written at the repo root, beside the card's name and power limit::

    python -m distributed_llm_scheduler_tpu_torch.eval.rankcheck_artifact 23
"""

from __future__ import annotations

import json
import os
import sys

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
#: distinct cards both legs need (the stress DAG's regime)
CARDS = 4


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def flagship_leg() -> dict:
    from ..core.fusion import fuse_linear_chains
    from ..frontend.gpt2_dag import build_gpt2_dag
    from ..models.gpt2 import GPT2Config
    from .rankcheck import run_rank_check

    dag = build_gpt2_dag(
        GPT2Config.small(), batch=8, seq_len=128, microbatches=8,
        vocab_shards=8,
    )
    graph = fuse_linear_chains(dag.graph)
    return run_rank_check(
        graph, dag.init_params(device="cuda"), dag.make_inputs(device="cuda"),
        policies=("roundrobin", "critical", "pipeline", "pack", "greedy"),
        hbm_cap_gb=4.0, measure_repeats=5, anchor_calibrate=True, log=log,
    )


def separating_leg() -> dict:
    import torch

    from ..core.cluster import Cluster
    from ..frontend.stress_dag import build_transfer_stress_dag
    from .rankcheck import run_rank_check

    dag = build_transfer_stress_dag(chains=6, length=6, edge_mb=8.0)
    cards = [torch.device("cuda", i) for i in range(CARDS)]
    cluster = Cluster.from_torch_devices(cards, hbm_cap_gb=4.0)
    return run_rank_check(
        dag.graph, dag.init_params(device=cards[0]),
        dag.make_inputs(device=cards[0]),
        policies=("roundrobin", "critical", "dfs", "greedy", "pipeline"),
        cluster=cluster, measure_repeats=5, log=log,
    )


def _distinct_cards() -> int:
    """Distinct devices of the platform seam (1 on the CPU); no card on
    ``cuda`` raises ``utils.config.ConfigError``."""
    from ..utils.config import platform_devices

    return len(dict.fromkeys(platform_devices(CARDS)))


def main(argv) -> int:
    from ..utils.config import ConfigError

    if not argv or not argv[0].isdigit():
        print(__doc__, file=sys.stderr)
        return 2
    round_n = int(argv[0])
    try:
        n = _distinct_cards()
    except ConfigError as e:
        print(f"rankcheck_artifact: {e}", file=sys.stderr)
        return 2
    if n < CARDS:
        print(f"rankcheck_artifact needs >= {CARDS} cards ({n} distinct "
              "device(s) here; nodes sharing a card copy nothing between "
              "them)", file=sys.stderr)
        return 2
    import torch

    from .bench import nvidia_smi_line

    out = {
        "round": round_n,
        "card": nvidia_smi_line(torch.device("cuda", 0)),
        "note": (
            "Two legs: 'flagship' = the bench configuration with "
            "two-anchor in-situ calibration (anchors in-sample, other "
            "policies and the ordering out-of-sample) on every visible "
            "card; 'separating' = the transfer-bound stress config on "
            f"{CARDS} cards, where the sim predicts separation "
            "uncalibrated."
        ),
        "flagship": flagship_leg(),
        "separating": separating_leg(),
    }
    path = os.path.join(REPO_ROOT, f"RANKCHECK_TORCH_r{round_n:02d}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    log(f"rankcheck_artifact: wrote {path}")
    ok = True
    for leg in ("flagship", "separating"):
        d = out[leg]
        ok &= bool(d["winner_agreement"]) and d["kendall_tau"] >= 0.8
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
