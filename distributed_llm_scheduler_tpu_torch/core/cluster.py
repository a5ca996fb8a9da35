"""Cluster model: memory-limited accelerator devices.

PyTorch port of ``distributed_llm_scheduler_tpu.core.cluster``.  Capability
parity with the reference's ``Node`` (reference ``schedulers.py:19-29``):
each device has a total memory budget, an available counter, a
compute-speed multiplier, a set of resident ("cached") parameters, and an
MRU recency deque.  Differences from the reference:

* a node can be bound to a ``torch.device`` (a GPU, or the CPU in tests);
  its memory budget then defaults to the card's free memory, and placement
  decisions made against this model are executed for real by the device
  backend.  Several nodes may share one card: they split its memory.
* parameter sizes are real bytes (via the owning :class:`TaskGraph`), not a
  0.5 GB constant — the constant remains only as the default for synthetic
  workloads.
* heterogeneous ``compute_speed`` does not exist among identical cards;
  we keep it for the simulated backend and parity tests, and reframe
  heterogeneity on real hardware as per-device memory budgets.
"""

from __future__ import annotations

import random
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set


@dataclass
class DeviceState:
    """One schedulable core: memory budget + parameter cache.

    ``torch_device`` is optionally a ``torch.device``; the scheduler layer
    never touches it, only the execution backend does.  Param *recency* is
    tracked by the MRU policy itself under its logical clock (the reference
    also keeps a per-node deque, ``schedulers.py:28``, but its scheduler
    reads its own usage dicts — we keep only the read path).

    ``slice_id`` is the device's slice (host or pod) membership: transfers
    within a slice ride the fast interconnect; transfers between slices ride
    the much slower data-center network (:class:`~..backends.sim.TieredLinkModel`).  The
    reference has no notion of network topology at all.
    """

    node_id: str
    total_memory: float  # GB
    compute_speed: float = 1.0
    torch_device: Optional[Any] = None
    slice_id: int = 0

    available_memory: float = field(init=False)
    cached_params: Set[str] = field(default_factory=set)
    running_tasks: List[str] = field(default_factory=list)
    completed_tasks: List[str] = field(default_factory=list)
    # reference parity: per-node MRU recency window, written on every
    # assignment (reference schedulers.py:29,99 — the reference never reads
    # it back, and neither do our policies, which track recency under the
    # MRU logical clock; the state exists for inspection parity)
    last_used_params: deque = field(
        default_factory=lambda: deque(maxlen=10)
    )

    def __post_init__(self) -> None:
        self.available_memory = self.total_memory

    def reset(self) -> None:
        self.available_memory = self.total_memory
        self.cached_params.clear()
        self.running_tasks.clear()
        self.completed_tasks.clear()
        self.last_used_params.clear()

    @property
    def used_memory(self) -> float:
        return self.total_memory - self.available_memory

    def __repr__(self) -> str:
        return (
            f"DeviceState({self.node_id!r}, {self.available_memory:.2f}/"
            f"{self.total_memory:.2f}GB free, speed={self.compute_speed}, "
            f"{len(self.cached_params)} params cached)"
        )


class Cluster:
    """An ordered collection of :class:`DeviceState`.

    Constructors cover the reference's provisioning profiles (reference
    ``simulation.py:161-190`` and ``test_gpt2.py:278-283``) plus a
    device-backed constructor that derives budgets from live device memory.
    """

    def __init__(self, devices: Sequence[DeviceState]):
        if not devices:
            raise ValueError("cluster needs at least one device")
        ids = [d.node_id for d in devices]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate device ids: {ids}")
        self.devices: List[DeviceState] = list(devices)
        self._by_id: Dict[str, DeviceState] = {d.node_id: d for d in devices}

    def __len__(self) -> int:
        return len(self.devices)

    def __iter__(self):
        return iter(self.devices)

    def __getitem__(self, node_id: str) -> DeviceState:
        return self._by_id[node_id]

    def __contains__(self, node_id: str) -> bool:
        return node_id in self._by_id

    def ids(self) -> List[str]:
        return [d.node_id for d in self.devices]

    def total_memory(self) -> float:
        return sum(d.total_memory for d in self.devices)

    def reset(self) -> None:
        for d in self.devices:
            d.reset()

    # -- provisioning profiles --------------------------------------------
    @classmethod
    def uniform(cls, n: int, memory_gb: float, speed: float = 1.0,
                prefix: str = "core") -> "Cluster":
        return cls([
            DeviceState(f"{prefix}_{i}", memory_gb, speed) for i in range(n)
        ])

    @classmethod
    def heterogeneous(cls, total_memory: float, num_nodes: int,
                      rng: Optional[random.Random] = None) -> "Cluster":
        """Reference memory-regime provisioning profiles.

        2 nodes: 60/40 split, speeds 1.2/1.0; 4 nodes: 35/25/25/15, speeds
        1.2/1.0/1.0/0.8; otherwise equal split with speeds drawn uniformly
        from 0.7-1.3 (reference ``simulation.py:161-190``), seedable here
        (the reference draws unseeded, so its sweeps aren't reproducible).
        """
        rng = rng or random.Random(0)
        if num_nodes == 2:
            fracs, speeds = [0.60, 0.40], [1.2, 1.0]
        elif num_nodes == 4:
            fracs, speeds = [0.35, 0.25, 0.25, 0.15], [1.2, 1.0, 1.0, 0.8]
        else:
            fracs = [1.0 / num_nodes] * num_nodes
            speeds = [rng.uniform(0.7, 1.3) for _ in range(num_nodes)]
        return cls([
            DeviceState(f"node_{i}", total_memory * f, s)
            for i, (f, s) in enumerate(zip(fracs, speeds))
        ])

    @classmethod
    def multislice(cls, n_slices: int, cores_per_slice: int,
                   memory_gb: float, speed: float = 1.0,
                   prefix: str = "core") -> "Cluster":
        """Multi-slice TPU topology (BASELINE config #3: 2 x v5e-8 = 16
        cores, DCN between slices).  Devices are ordered slice-by-slice, so
        contiguous pipeline stages cross DCN only at slice boundaries."""
        return cls([
            DeviceState(
                f"{prefix}_{s}_{i}", memory_gb, speed, slice_id=s
            )
            for s in range(n_slices)
            for i in range(cores_per_slice)
        ])

    def without(self, *node_ids: str) -> "Cluster":
        """A new cluster of fresh DeviceStates minus ``node_ids`` — the
        survivor set after failures (elastic recovery).  Copies every
        identity field (incl. torch_device binding and slice topology) so
        callers can't drift by hand-rebuilding DeviceStates."""
        dead = set(node_ids)
        return Cluster([
            DeviceState(
                d.node_id, d.total_memory, d.compute_speed,
                torch_device=d.torch_device, slice_id=d.slice_id,
            )
            for d in self.devices if d.node_id not in dead
        ])

    def slice_ids(self) -> Dict[str, int]:
        """node_id -> slice_id (for topology-aware cost call sites)."""
        return {d.node_id: d.slice_id for d in self.devices}

    @classmethod
    def laptops(cls) -> "Cluster":
        """The reference's 4-laptop fleet (reference test_gpt2.py:278-283)."""
        profile = [("laptop_0", 8.0, 1.0), ("laptop_1", 8.0, 1.2),
                   ("laptop_2", 6.0, 0.8), ("laptop_3", 6.0, 0.9)]
        return cls([DeviceState(n, m, s) for n, m, s in profile])

    @classmethod
    def from_torch_devices(cls, devices: Optional[Sequence[Any]] = None,
                           hbm_cap_gb: Optional[float] = None) -> "Cluster":
        """Build from torch devices (one DeviceState per entry).

        ``devices=None`` binds every visible CUDA device and raises when
        there is none: the execution path never falls back to the CPU
        silently.  Pass CPU devices explicitly (tests do).

        Budget per node: ``hbm_cap_gb`` when given; else, on CUDA, the
        card's free memory (``torch.cuda.mem_get_info``) split evenly
        among the nodes bound to that card, so virtual nodes sharing one
        card cannot promise the scheduler more memory than it has; on the
        CPU, 16.0 GB.  Devices are identical, so ``compute_speed`` is 1.0.
        """
        import torch

        if devices is None:
            n = torch.cuda.device_count()
            if n == 0:
                raise RuntimeError(
                    "no CUDA device visible; pass devices=[torch.device("
                    "'cpu')] explicitly to build a CPU cluster"
                )
            devices = [torch.device("cuda", i) for i in range(n)]
        devices = [torch.device(d) for d in devices]
        # "cuda" and "cuda:0" are one card: index every CUDA device so
        # nodes sharing a card are counted together
        devices = [
            torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d
            for d in devices
        ]
        sharing: Dict[Any, int] = {}
        for dev in devices:
            sharing[dev] = sharing.get(dev, 0) + 1
        out = []
        for i, dev in enumerate(devices):
            cap = hbm_cap_gb
            if cap is None:
                if dev.type == "cuda":
                    free, _total = torch.cuda.mem_get_info(dev)
                    cap = free / 1024**3 / sharing[dev]
                else:
                    cap = 16.0
            out.append(DeviceState(f"core_{i}", cap, 1.0, torch_device=dev))
        return cls(out)

    def __repr__(self) -> str:
        return (
            f"Cluster({len(self.devices)} devices, "
            f"{self.total_memory():.1f}GB total)"
        )


def estimate_cluster_memory_needed(graph) -> float:
    """Lower-bound cluster memory for a graph: the reference's estimator.

    max single-task activation footprint + per-param cache cost over unique
    params (reference ``simulation.py:194-214``), generalized to real param
    sizes.  Used to size memory regimes.
    """
    return graph.max_task_memory() + graph.total_param_gb()
