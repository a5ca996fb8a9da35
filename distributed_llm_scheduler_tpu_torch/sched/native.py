"""NativeScheduler: the C++ engine behind the BaseScheduler interface.

The PyTorch port of ``distributed_llm_scheduler_tpu.sched.native`` over
the same engine source (``native/engine.cpp``).

Flattens (graph, cluster) into integer-indexed arrays, runs the requested
policy inside the native engine (:mod:`..native`), and reconstructs the same
:class:`Schedule` the pure-Python policy would emit — the parity tests assert
bit-identical per-node lists, assignment order, and failure sets.  Use it via
``get_scheduler("native:heft")`` etc., or set ``DLS_NATIVE=1`` to make
``get_scheduler`` upgrade every supported policy (a failed engine build
raises; it never runs the Python policy instead).

Why it exists: scheduling wall-time is a first-class reported metric
(reference ``simulation.py:327-333``); on multi-thousand-task microbatched
DAGs the Python round loops are the bottleneck of a full evaluator sweep.
"""

from __future__ import annotations

import ctypes
import time
from typing import Dict, List

import numpy as np

from ..core.cluster import Cluster
from ..core.graph import TaskGraph, TaskStatus
from ..core.schedule import Schedule
from ..backends.sim import LinkModel
from .base import BaseScheduler


class NativeScheduler(BaseScheduler):
    """One of the nine policies, executed by the native engine."""

    def __init__(self, policy: str, link=None):
        from ..native import POLICY_IDS

        if policy not in POLICY_IDS:
            raise ValueError(
                f"no native implementation of {policy!r}; "
                f"available: {sorted(POLICY_IDS)}"
            )
        self.policy = policy
        self.name = f"native:{policy}"
        link = link or LinkModel()
        # None means "free" in LinkModel; the engine uses <=0 for the same
        self._link = (
            link.param_load_gbps or 0.0,
            link.interconnect_gbps or 0.0,
            link.latency_s,
        )
        # the C ABI carries a single flat link tier; a tiered (ICI/DCN)
        # model would be silently flattened to ICI — refuse rather than
        # let heft/pipeline optimize the wrong costs on multislice clusters
        from ..backends.sim import TieredLinkModel

        if isinstance(link, TieredLinkModel):
            raise ValueError(
                "NativeScheduler supports flat LinkModel only; use the "
                "Python policies for TieredLinkModel (DCN-aware) runs"
            )

    def schedule(self, graph: TaskGraph, cluster: Cluster) -> Schedule:
        from ..native import POLICY_IDS, load_engine

        engine = load_engine()
        graph.freeze()
        graph.reset()
        cluster.reset()
        # dls-lint: allow(DET001) scheduling_wall_s is reported metadata
        t0 = time.perf_counter()

        tids = graph.task_ids()
        tidx = {tid: i for i, tid in enumerate(tids)}
        n = len(tids)
        if n == 0:  # every policy's empty-graph behavior: empty schedule
            return Schedule(
                policy=self.policy,
                per_node={nid: [] for nid in cluster.ids()},
                # dls-lint: allow(DET001) reported metadata
                scheduling_wall_s=time.perf_counter() - t0,
            )
        # param ids assigned in sorted-name order: id order == name order,
        # which the engine's tie-breaks rely on
        params = sorted(graph.unique_params())
        pidx = {p: i for i, p in enumerate(params)}

        task_mem = np.empty(n, dtype=np.float64)
        task_time = np.empty(n, dtype=np.float64)
        dep_off = np.zeros(n + 1, dtype=np.int32)
        par_off = np.zeros(n + 1, dtype=np.int32)
        dep_ids: List[int] = []
        par_ids: List[int] = []
        for i, tid in enumerate(tids):
            t = graph[tid]
            task_mem[i] = t.memory_required
            task_time[i] = t.compute_time
            dep_ids.extend(tidx[d] for d in t.dependencies)
            dep_off[i + 1] = len(dep_ids)
            par_ids.extend(sorted(pidx[p] for p in t.params_needed))
            par_off[i + 1] = len(par_ids)
        dep_arr = np.asarray(dep_ids, dtype=np.int32)
        par_arr = np.asarray(par_ids, dtype=np.int32)
        out_gb = np.asarray(
            [graph.output_gb(tid) for tid in tids], dtype=np.float64
        )
        param_gb = np.asarray(
            [graph.param_size_gb(p) for p in params], dtype=np.float64
        )
        node_mem = np.asarray(
            [d.total_memory for d in cluster], dtype=np.float64
        )
        node_speed = np.asarray(
            [d.compute_speed for d in cluster], dtype=np.float64
        )
        link3 = np.asarray(self._link, dtype=np.float64)

        group_ids = None
        node_rank = None
        group_rank = None
        if self.policy in ("pipeline", "pack", "refine"):
            # group index by first appearance over the TOPO order, matching
            # the Python _group_stats ordering (ungrouped: singleton groups)
            gidx: Dict[str, int] = {}
            for t in graph.topo_order:
                glabel = graph[t].group or t
                if glabel not in gidx:
                    gidx[glabel] = len(gidx)
            group_ids = np.asarray(
                [gidx[graph[t].group or t] for t in tids], dtype=np.int32
            )
        if self.policy == "refine":
            # refine's tie-breaks compare node-id / group-name STRINGS
            # (bottleneck max, basin-hop glist = sorted(best)); the engine
            # only sees indices, so ship each id's lexicographic rank
            node_ids_ = cluster.ids()
            pos = {nid: i for i, nid in enumerate(node_ids_)}
            node_rank = np.empty(len(node_ids_), dtype=np.int32)
            for r, nid in enumerate(sorted(node_ids_)):
                node_rank[pos[nid]] = r
            group_rank = np.empty(len(gidx), dtype=np.int32)
            for r, glabel in enumerate(sorted(gidx)):
                group_rank[gidx[glabel]] = r

        out_assign = np.empty(n, dtype=np.int32)
        out_order = np.empty(max(n, 1), dtype=np.int32)
        out_n = np.zeros(1, dtype=np.int32)

        def ptr(a, typ):
            if a.size == 0:  # NULL is fine: engine never derefs empty CSR data
                return None
            return a.ctypes.data_as(ctypes.POINTER(typ))

        rc = engine.dls_schedule(
            POLICY_IDS[self.policy], n, len(params), len(cluster),
            ptr(task_mem, ctypes.c_double), ptr(task_time, ctypes.c_double),
            ptr(out_gb, ctypes.c_double),
            ptr(dep_off, ctypes.c_int32), ptr(dep_arr, ctypes.c_int32),
            ptr(par_off, ctypes.c_int32), ptr(par_arr, ctypes.c_int32),
            ptr(param_gb, ctypes.c_double), ptr(node_mem, ctypes.c_double),
            ptr(node_speed, ctypes.c_double), ptr(link3, ctypes.c_double),
            None if group_ids is None else ptr(group_ids, ctypes.c_int32),
            None if node_rank is None else ptr(node_rank, ctypes.c_int32),
            None if group_rank is None else ptr(group_rank, ctypes.c_int32),
            ptr(out_assign, ctypes.c_int32), ptr(out_order, ctypes.c_int32),
            ptr(out_n, ctypes.c_int32),
        )
        if rc != 0:
            raise RuntimeError(f"native engine returned {rc}")
        # dls-lint: allow(DET001) scheduling_wall_s is reported metadata
        wall = time.perf_counter() - t0

        node_ids = cluster.ids()
        per_node: Dict[str, List[str]] = {nid: [] for nid in node_ids}
        order: List[str] = []
        completed, failed = set(), set()
        for k in range(int(out_n[0])):
            i = int(out_order[k])
            tid = tids[i]
            order.append(tid)
            per_node[node_ids[out_assign[i]]].append(tid)
        for i, tid in enumerate(tids):
            task = graph[tid]
            if out_assign[i] >= 0:
                completed.add(tid)
                task.status = TaskStatus.COMPLETED
                task.assigned_node = node_ids[out_assign[i]]
            else:
                failed.add(tid)
                task.status = TaskStatus.FAILED
        return Schedule(
            policy=self.policy,  # report under the policy's own name so
            # evaluator rows group with the Python twin
            per_node=per_node,
            assignment_order=order,
            completed=completed,
            failed=failed,
            scheduling_wall_s=wall,
        )
