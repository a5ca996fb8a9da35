"""Transfer-stress DAG: a workload whose makespan is decided by placement.

PyTorch port of ``distributed_llm_scheduler_tpu.frontend.stress_dag``.
The flagship rank check runs in a compute-tied regime, where every
reasonable placement predicts (and measures) a near-tie — an agreement
check there "passes" only by tie semantics and guards nothing.  This
builder constructs the opposite regime: ``chains`` independent chains of
``length`` cheap elementwise tasks, each edge carrying a ``edge_mb``-sized
activation, with one tiny per-chain reduction and a scalar aggregation at
the end.  Compute is negligible; cross-device edges are copies of real
megabytes between cards.  A locality-aware policy keeps each chain on one
device (near-zero transfer); a placement that alternates devices pays the
full wire time for every edge.  Nodes that share one card copy nothing, so
the regime needs distinct cards (``rankcheck --stress`` asks for four).

The graph (task ids, dependencies, memory, params, bytes, ``param_alias``)
is the JAX package's.  Weights come from a numpy seed (``init_params``);
the tests bridge the JAX package's draws in through ``params_from_numpy``.

Reference lineage: the reference's pipeline-shaped synthetic DAG
(reference ``simulation.py:116-151``) is the closest shape; this one adds
real task fns and true byte sizes so the same graph runs on live devices.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.graph import GB, Task, TaskGraph
from .gpt2_dag import ModelDAG


class _StressModel:
    """The family module :class:`ModelDAG` expects: a numpy init and its
    conversion to tensors."""

    @staticmethod
    def init_params_numpy(config: "_StressConfig", seed: int = 0
                          ) -> Dict[str, np.ndarray]:
        ws = np.random.default_rng(seed).uniform(0.5, 1.5, config.chains)
        return {f"chain{c}_w": np.asarray(ws[c], np.float32)
                for c in range(config.chains)}

    @staticmethod
    def params_from_numpy(np_params: Dict[str, Any], device: Any = "cpu",
                          dtype: torch.dtype = torch.float32
                          ) -> Dict[str, torch.Tensor]:
        return {k: torch.tensor(np.asarray(v, np.float32)).to(
                    device=device, dtype=dtype)
                for k, v in np_params.items()}


def build_transfer_stress_dag(
    chains: int = 8,
    length: int = 6,
    edge_mb: float = 8.0,
    dtype: torch.dtype = torch.float32,
) -> ModelDAG:
    """``chains`` independent chains of ``length`` elementwise tasks over a
    ``edge_mb`` MB activation, then per-chain scalar reduce + global sum.

    Every chain shares one tiny param (its locality signal for
    greedy-style policies); task fns are shared across chains via
    ``param_alias``.
    """
    if chains < 1 or length < 2:
        raise ValueError(f"need chains >= 1, length >= 2, got {chains}/{length}")
    itemsize = dtype.itemsize
    n_elem = max(1, int(edge_mb * 1024**2 / itemsize))
    # 2-D shape, cols fixed at 1024 (the JAX package's layout)
    cols = 1024
    rows = max(1, n_elem // cols)
    shape = (rows, cols)
    edge_bytes = rows * cols * itemsize
    edge_gb = edge_bytes / GB

    def root_fn(p, x):
        # broadcast the (tiny) graph input up to the big edge tensor
        return p["w"].to(dtype).expand(shape) + x.to(dtype).sum()

    def step_fn(p, y):
        return y * 1.0001 + p["w"]

    def reduce_fn(p, y):
        del p
        return y.sum(dtype=torch.float32).reshape(1)

    def agg_fn(p, *tails):
        del p
        acc = tails[0]
        for t in tails[1:]:
            acc = acc + t
        return acc

    graph = TaskGraph(name=f"xfer_stress_c{chains}_l{length}_{int(edge_mb)}mb")
    flops_step = 2.0 * rows * cols  # mul + add per element
    param_specs: Dict[str, torch.Tensor] = {}
    tails = []
    for c in range(chains):
        w = f"chain{c}_w"
        param_specs[w] = torch.empty((), dtype=dtype, device="meta")
        prev: Optional[str] = None
        for i in range(length):
            tid = f"c{c}_t{i}"
            graph.add_task(Task(
                task_id=tid,
                memory_required=edge_gb,
                compute_time=1e-4,  # seed; calibration overwrites
                dependencies=[prev] if prev else [],
                params_needed={w},
                param_bytes={w: itemsize},
                fn=root_fn if prev is None else step_fn,
                param_alias={"w": w},
                out_bytes=edge_bytes,
                flops=flops_step,
                group=f"chain{c}",
            ))
            prev = tid
        rid = f"c{c}_reduce"
        graph.add_task(Task(
            task_id=rid,
            memory_required=edge_gb,
            compute_time=1e-4,
            dependencies=[prev],
            fn=reduce_fn,
            out_bytes=4,
            flops=rows * cols,
            group=f"chain{c}",
        ))
        tails.append(rid)
    graph.add_task(Task(
        task_id="agg",
        memory_required=1e-6,
        compute_time=1e-5,
        dependencies=list(tails),
        fn=agg_fn,
        out_bytes=4,
        flops=chains,
    ))
    graph.freeze()

    def reference_forward(params, x):
        acc = torch.zeros((1,), dtype=torch.float32, device=x.device)
        for c in range(chains):
            y = root_fn({"w": params[f"chain{c}_w"]}, x)
            for _ in range(length - 1):
                y = step_fn({"w": params[f"chain{c}_w"]}, y)
            acc = acc + reduce_fn({}, y)
        return acc

    return ModelDAG(
        graph=graph,
        config=_StressConfig(dtype=dtype, chains=chains, length=length,
                             edge_mb=edge_mb),
        input_spec=torch.empty((1,), dtype=torch.int32, device="meta"),
        param_specs=param_specs,
        reference_forward=reference_forward,
        model=_StressModel,
        derive_params=lambda params: params,
    )


class _StressConfig:
    """Minimal config shim (ModelDAG expects .dtype and .vocab_size)."""

    vocab_size = 2  # make_inputs draws int32 in [0, 2)

    def __init__(self, dtype, chains, length, edge_mb):
        self.dtype = dtype
        self.chains = chains
        self.length = length
        self.edge_mb = edge_mb


__all__ = ["build_transfer_stress_dag"]
