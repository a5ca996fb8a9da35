"""Simulated execution backend (CPU-runnable cost-model replay).

PyTorch port of ``distributed_llm_scheduler_tpu.backends.sim``: the same
replay, without the JAX package's static pre-execution analysis gate
(the analysis layer is not ported yet).

Replays a :class:`Schedule` against a cost model and produces per-task
timings plus the reference's metric set.  Two fidelity modes:

* ``fidelity="reference"`` reproduces the reference's replay exactly
  (reference ``simulation.py:216-278``): each node runs its task list
  sequentially at ``compute_time / compute_speed``, cross-node dependency
  waits are ignored, caches start empty, transfers are free.  Kept for
  parity testing against the paper's numbers.
* ``fidelity="full"`` (default) fixes the reference's two acknowledged
  blind spots (SURVEY.md §2 quirks, §5.8): a task cannot start before its
  dependencies *finish* (even on other nodes), and both parameter loads
  (host→device) and cross-node activation edges (device→device) are charged
  at configurable bandwidths.  This is the model the device backend's
  measured timings calibrate.

Cache hit/miss accounting replays each node's param cache fresh, as the
reference does, so hit-rate numbers are comparable across modes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Set

from ..core.cluster import Cluster
from ..core.graph import TaskGraph
from ..core.schedule import Schedule, TaskTiming


@dataclass
class LinkModel:
    """Bandwidth/latency model for data movement, GB and seconds.

    Defaults approximate a v5e slice, kept equal to the JAX package's so
    the two packages place graphs identically: ~1 TB/s effective ICI per
    link for core-to-core activation hops, ~50 GB/s host-to-HBM for
    parameter loads (PCIe-ish), plus a per-transfer latency floor.  The
    reference charges zero for both (paper §6.6.1 acknowledges this); set
    both bandwidths to ``None`` to reproduce that.
    """

    param_load_gbps: Optional[float] = 50.0
    interconnect_gbps: Optional[float] = 1000.0
    latency_s: float = 10e-6

    def param_load_time(self, gb: float) -> float:
        if self.param_load_gbps is None:
            return 0.0
        return self.latency_s + gb / self.param_load_gbps

    def transfer_time(
        self,
        gb: float,
        src_slice: Optional[int] = None,
        dst_slice: Optional[int] = None,
    ) -> float:
        """Device-to-device transfer cost.  The slice arguments exist for
        topology-aware subclasses (:class:`TieredLinkModel`); the flat model
        charges every hop at ICI rate regardless."""
        if self.interconnect_gbps is None:
            return 0.0
        return self.latency_s + gb / self.interconnect_gbps


@dataclass
class TieredLinkModel(LinkModel):
    """Two-tier interconnect: ICI within a slice, DCN between slices.

    BASELINE config #3 ("v5e-16, DCN-aware") is two v5e-8 slices joined by
    data-center network: intra-slice hops keep ``interconnect_gbps``;
    cross-slice hops pay ``dcn_gbps`` + ``dcn_latency_s`` (defaults are
    v5e-class estimates: ~12.5 GB/s effective per-host DCN, tens of us
    latency — an order of magnitude below ICI, which is the whole point).
    Call sites without slice information (``None``) are charged the ICI
    tier, so single-slice users never see DCN costs by accident.
    """

    dcn_gbps: Optional[float] = 12.5
    dcn_latency_s: float = 50e-6

    def transfer_time(
        self,
        gb: float,
        src_slice: Optional[int] = None,
        dst_slice: Optional[int] = None,
    ) -> float:
        cross = (
            src_slice is not None
            and dst_slice is not None
            and src_slice != dst_slice
        )
        if not cross:
            return super().transfer_time(gb)
        if self.dcn_gbps is None:
            return 0.0
        return self.dcn_latency_s + gb / self.dcn_gbps


@dataclass
class ExecutionReport:
    """Metric set matching the reference's TestResult fields
    (reference ``simulation.py:15-30``) plus per-task timings."""

    scheduler_name: str
    dag_type: str
    num_nodes: int
    num_tasks: int
    completed_tasks: int
    failed_tasks: int
    makespan: float
    cache_hits: int
    cache_misses: int
    load_balance_score: float
    node_utilization: Dict[str, float]
    scheduling_wall_s: float
    memory_regime: float = 1.0
    transfer_time_total: float = 0.0
    param_load_time_total: float = 0.0
    timings: Dict[str, TaskTiming] = field(default_factory=dict)

    @property
    def completion_rate(self) -> float:
        return self.completed_tasks / self.num_tasks if self.num_tasks else 0.0

    @property
    def cache_hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    def to_row(self) -> Dict[str, object]:
        """Flat dict for CSV export (column parity with the reference)."""
        return {
            "scheduler": self.scheduler_name,
            "dag_type": self.dag_type,
            "num_nodes": self.num_nodes,
            "memory_regime": self.memory_regime,
            "total_tasks": self.num_tasks,
            "completed_tasks": self.completed_tasks,
            "failed_tasks": self.failed_tasks,
            "completion_rate": self.completion_rate,
            "makespan": self.makespan,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "cache_hit_rate": self.cache_hit_rate,
            "load_balance_score": self.load_balance_score,
            "avg_utilization": (
                sum(self.node_utilization.values()) / len(self.node_utilization)
                if self.node_utilization
                else 0.0
            ),
            "execution_time": self.scheduling_wall_s,
            "transfer_time_total": self.transfer_time_total,
            "param_load_time_total": self.param_load_time_total,
        }


def calculate_load_balance(per_node_load: Dict[str, float]) -> float:
    """1/(1+CV) over per-node compute loads (reference simulation.py:280-302).

    Zero/empty loads score 0 (as in the reference): a schedule that ran
    nothing must not outrank working schedulers on balance.
    """
    loads = list(per_node_load.values())
    if not loads or all(v == 0 for v in loads):
        return 0.0
    mean = sum(loads) / len(loads)
    if mean == 0:
        return 0.0
    var = sum((v - mean) ** 2 for v in loads) / len(loads)
    cv = var**0.5 / mean
    return 1.0 / (1.0 + cv)


class SimulatedBackend:
    """Replays schedules under a cost model; pure Python.

    ``prefetch_params=True`` (default in full fidelity) models what the
    device backend actually does (``DeviceBackend.place_params``): parameter
    loads start at t=0 per node in first-use order over the host link (DMA
    overlapping compute), and a task waits until its params' loads complete
    rather than paying the load inline at start.  ``False`` charges loads
    inline at task start (load-on-demand).
    """

    def __init__(self, fidelity: str = "full", link: Optional[LinkModel] = None,
                 prefetch_params: bool = True, host_slots: Optional[int] = None,
                 dispatch_s: float = 0.0,
                 host_synchronous_transfers: bool = False,
                 host_serial_loads: bool = False):
        if fidelity not in ("full", "reference"):
            raise ValueError(
                f"fidelity must be 'full' or 'reference', got {fidelity!r}"
            )
        if host_slots is not None and host_slots < 1:
            raise ValueError(f"host_slots must be >= 1, got {host_slots}")
        self.fidelity = fidelity
        self.prefetch_params = prefetch_params and fidelity == "full"
        # per-task HOST dispatch cost (measured: utils/costmodel): one
        # Python dispatcher enqueues tasks serially in assignment order,
        # so task i cannot start before (i+1) * dispatch_s even when its
        # device/inputs are ready — visible on fine-grained DAGs
        self.dispatch_s = dispatch_s if fidelity == "full" else 0.0
        # Shared-substrate cap: at most this many tasks execute concurrently
        # across ALL nodes.  Real TPU cores are independent (None =
        # unlimited, the default); the CPU-faked mesh shares the host's
        # cores, so predicting what DeviceBackend will *measure* there
        # requires capping concurrency at the physical core count — this is
        # what makes sim-vs-real validation honest on any machine.
        self.host_slots = host_slots
        # Host-mediated transfers: in the real per-task dispatch loop every
        # cross-node edge is an inline ``jax.device_put`` — a HOST call.
        # On platforms where that call blocks while copying (the CPU mesh:
        # device_put is a synchronous memcpy), each transfer's full wire
        # time also occupies the serial dispatcher, delaying every later
        # dispatch.  Without this, a transfer-heavy placement's replay
        # ties a transfer-light one while its measured makespan is ~1.5x
        # worse (found by eval/rankcheck on the flagship structure).  On
        # real TPU (async DMA) leave False; the per-call host cost is
        # covered by dispatch_s below.
        self.host_synchronous_transfers = (
            host_synchronous_transfers and fidelity == "full"
        )
        # Host-mediated parameter staging: DeviceBackend.place_params
        # stages every param with device_put before dispatch.  Real TPU
        # DMA engines give each device its own async queue (per-node
        # prefetch queues below); on the CPU mesh every device_put is a
        # synchronous memcpy on ONE host thread, so all nodes' loads
        # drain through a single serial queue — a placement that
        # duplicates params (round-robin: every node loads every layer)
        # pays the whole duplicated byte count in wall time, which the
        # per-node queues hide behind 8x parallelism (found by the r4
        # flagship rankcheck: predicted spread 1.7% vs measured 37%).
        self.host_serial_loads = host_serial_loads and fidelity == "full"
        if fidelity == "reference":
            # Reference fidelity is *defined* as zero-cost data movement
            # (paper §6.6.1); a caller-supplied link would silently skew
            # totals without affecting timings, so it is rejected.
            if link is not None:
                raise ValueError("fidelity='reference' implies a zero-cost link")
            self.link = LinkModel(
                param_load_gbps=None, interconnect_gbps=None, latency_s=0.0
            )
        else:
            self.link = link or LinkModel()

    def execute(
        self,
        graph: TaskGraph,
        cluster: Cluster,
        schedule: Schedule,
        dag_type: str = "unknown",
        memory_regime: float = 1.0,
    ) -> ExecutionReport:
        placement = schedule.placement
        speeds = {d.node_id: d.compute_speed for d in cluster}

        # fresh per-node caches for hit/miss accounting
        # (reference simulation.py:233-244 starts caches empty)
        caches: Dict[str, Set[str]] = {d.node_id: set() for d in cluster}
        hits = misses = 0
        param_load_total = 0.0
        transfer_total = 0.0

        node_clock: Dict[str, float] = {d.node_id: 0.0 for d in cluster}
        finish: Dict[str, float] = {}
        timings: Dict[str, TaskTiming] = {}
        per_node_load: Dict[str, float] = {d.node_id: 0.0 for d in cluster}

        # prefetch model: per-node host-link queue; param p's load completes
        # at the cumulative queue position (first-use order).  Under
        # host_serial_loads the loads charge the dispatcher clock instead.
        load_queue_end: Dict[str, float] = {d.node_id: 0.0 for d in cluster}
        param_ready_at: Dict[tuple, float] = {}

        # shared-substrate slots: classic machine model — one heap entry per
        # slot holding the time that slot next frees up
        import heapq

        slot_free: list = (
            [0.0] * self.host_slots if self.host_slots is not None else []
        )

        # Execute in global assignment order (the order the scheduler decided),
        # which respects dependencies by construction.
        host_clock = 0.0  # serial dispatcher position
        for tid in schedule.assignment_order:
            task = graph[tid]
            node_id = placement[tid]
            cache = caches[node_id]
            host_clock += self.dispatch_s

            # parameter loads
            load_time = 0.0
            params_ready = 0.0
            for p in sorted(task.params_needed):
                if p in cache:
                    hits += 1
                    if self.prefetch_params:
                        params_ready = max(
                            params_ready, param_ready_at.get((node_id, p), 0.0)
                        )
                else:
                    misses += 1
                    cache.add(p)
                    t_load = self.link.param_load_time(graph.param_size_gb(p))
                    load_time += t_load
                    if self.prefetch_params:
                        if self.host_serial_loads:
                            # staging occupies the DISPATCHER: the copy
                            # runs on the same host thread that enqueues
                            # tasks, so every later dispatch waits behind
                            # it (and this task waits for its own copy)
                            host_clock += t_load
                            param_ready_at[(node_id, p)] = host_clock
                            params_ready = max(params_ready, host_clock)
                        else:
                            load_queue_end[node_id] += t_load
                            param_ready_at[(node_id, p)] = (
                                load_queue_end[node_id]
                            )
                            params_ready = max(
                                params_ready, load_queue_end[node_id]
                            )
            param_load_total += load_time

            start = max(node_clock[node_id], host_clock)
            inbound_xfer = 0.0
            if self.fidelity == "full":
                # dependency wait: inputs must exist; cross-node edges pay ICI
                for d in task.dependencies:
                    if d not in finish:
                        continue  # failed dep (shouldn't occur for completed)
                    dep_ready = finish[d]
                    if placement.get(d) != node_id:
                        xfer = self.link.transfer_time(
                            graph.output_gb(d),
                            src_slice=cluster[placement[d]].slice_id,
                            dst_slice=cluster[node_id].slice_id,
                        )
                        dep_ready += xfer
                        transfer_total += xfer
                        inbound_xfer += xfer
                        if self.host_synchronous_transfers:
                            # a cross-node device_put needs CONCRETE
                            # bytes: the dispatcher blocks until the
                            # producer finishes, then performs the copy
                            # itself — so every cross-node edge collapses
                            # the dispatch-ahead window to the producer's
                            # finish time before charging the copy
                            host_clock = max(host_clock, finish[d]) + xfer
                    start = max(start, dep_ready)
                if self.host_synchronous_transfers:
                    # the task cannot start before the dispatcher finished
                    # copying ALL its inputs (start was read from
                    # host_clock before the dep loop advanced it)
                    start = max(start, host_clock)
                if self.prefetch_params:
                    # DMA overlaps compute; task just waits for its weights
                    start = max(start, params_ready)
                else:
                    start += load_time

            if self.host_slots is not None:
                # earliest-available slot executes this task (greedy in
                # assignment order — an approximation, but it keeps full
                # occupancy history unlike dropping finished intervals)
                start = max(start, heapq.heappop(slot_free))

            duration = task.compute_time / speeds[node_id]
            if self.host_synchronous_transfers and self.host_slots is not None:
                # shared-substrate fidelity: the dispatcher's synchronous
                # memcpy runs on the same physical cores that execute
                # compute, so inbound copy time occupies this task's slot
                # too — without this, a transfer-heavy placement's copies
                # hide entirely inside slot waits and the replay predicts
                # a tie where the mesh measures a large spread (the r3
                # rankcheck's 1.3%-predicted vs 29%-measured failure)
                duration += inbound_xfer
            end = start + duration
            if self.host_slots is not None:
                heapq.heappush(slot_free, end)
            node_clock[node_id] = end
            finish[tid] = end
            timings[tid] = TaskTiming(tid, node_id, start, end)
            # load balance counts COMPUTE only (reference metric semantics);
            # the slot-charged copy time above is occupancy, not load
            per_node_load[node_id] += task.compute_time / speeds[node_id]

        makespan = max(node_clock.values()) if node_clock else 0.0
        utilization = {
            n: (per_node_load[n] / makespan if makespan > 0 else 0.0)
            for n in node_clock
        }
        schedule.timings = timings
        return ExecutionReport(
            scheduler_name=schedule.policy,
            dag_type=dag_type,
            num_nodes=len(cluster),
            num_tasks=len(graph),
            completed_tasks=len(schedule.completed),
            failed_tasks=len(schedule.failed),
            makespan=makespan,
            cache_hits=hits,
            cache_misses=misses,
            load_balance_score=calculate_load_balance(per_node_load),
            node_utilization=utilization,
            scheduling_wall_s=schedule.scheduling_wall_s,
            memory_regime=memory_regime,
            transfer_time_total=transfer_total,
            param_load_time_total=param_load_total,
            timings=timings,
        )
