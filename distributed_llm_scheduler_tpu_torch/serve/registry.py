"""Replica registry: N named engines, each with its own obs universe.

The fleet tier (``serve/router.py``) needs replicas that are genuinely
independent observability domains — per-replica metrics registry
(``{rid}.``-prefixed, ``replica``-labeled so snapshots merge without
key collisions), per-replica request log and ownership log (owned by
the engine itself), and a per-replica :class:`~..obs.timeseries.
TimeSeriesStore` the health detectors judge.  This module owns that
wiring so the router can stay pure policy.

``EngineRegistry`` builds engines through a caller-supplied factory::

    factory(rid, *, clock, metrics) -> engine

The factory either constructs a fresh ``PagedDecodeEngine`` with that
clock/metrics (tests on a cold cache) or takes a POOLED engine and
``rebind_obs(clock=..., metrics=...)``s it (the session-fixture path —
no fresh engine builds per test).  Either way the registry hands back a
:class:`ReplicaHandle` whose obs surfaces are exclusively this
replica's.

:meth:`EngineRegistry.restart` is the failover primitive: rebind the
SAME engine (weights and step kept) against the SAME clock (the fleet
timeline must not rewind) but FRESH metrics and a FRESH series store —
a restarted replica's trends start from its restart epoch, which is
why the handle records ``epoch_t0``: detector warmup is measured from
there, not from fleet t0.  ``rebind_obs`` also swaps any fault-injected
pool wrapper for a pristine one, so a restart genuinely cures a
``_LeakyPool``.

The PyTorch port's copy of ``distributed_llm_scheduler_tpu.serve.registry``: framework-free,
so the port keeps it without importing the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from ..obs.metrics import MetricsRegistry
from ..obs.timeseries import TimeSeriesStore
from .frontend import VirtualClock


class ReplicaHandle:
    """One replica's engine plus its private observability surfaces and
    the router-visible health state machine
    (``active`` → ``draining`` → ``probation`` → ``active``)."""

    __slots__ = ("rid", "engine", "clock", "metrics", "store",
                 "epoch_t0", "restarts", "state", "probation_until",
                 "routed", "drains")

    def __init__(self, rid: str, engine: Any, clock: Any,
                 metrics: MetricsRegistry, store: TimeSeriesStore):
        self.rid = rid
        self.engine = engine
        self.clock = clock
        self.metrics = metrics
        self.store = store
        self.epoch_t0 = float(clock())   # start of current obs epoch
        self.restarts = 0
        self.state = "active"            # active | draining | probation
        self.probation_until: Optional[float] = None
        self.routed = 0                  # arrivals routed here
        self.drains = 0                  # times drained

    @property
    def admitting(self) -> bool:
        """Whether the router may place NEW arrivals here (probation
        replicas serve what they have but take no new work until the
        window passes — the router flips them back to active)."""
        return self.state == "active"

    def summary(self) -> Dict[str, Any]:
        return {
            "rid": self.rid,
            "state": self.state,
            "restarts": self.restarts,
            "drains": self.drains,
            "routed": self.routed,
            "epoch_t0": self.epoch_t0,
            "engine": self.engine.summary(),
        }


class EngineRegistry:
    """Replica-id-addressed engine set sharing one factory seam.

    Replica ids are caller-chosen strings (the fleet bench uses
    ``n0..n2`` — disjoint from request rids ``r*`` so merged logs stay
    unambiguous).  Duplicate ids are a hard error: an id is an obs
    namespace, and two engines writing one namespace is exactly the
    collision this layer exists to prevent.
    """

    def __init__(
        self,
        factory: Callable[..., Any],
        *,
        series_capacity: int = 512,
    ):
        self.factory = factory
        self.series_capacity = int(series_capacity)
        self._replicas: Dict[str, ReplicaHandle] = {}

    def __len__(self) -> int:
        return len(self._replicas)

    def __contains__(self, rid: str) -> bool:
        return rid in self._replicas

    def rids(self) -> List[str]:
        return sorted(self._replicas)

    def replicas(self) -> List[ReplicaHandle]:
        """Handles in sorted-rid order (the router's deterministic
        iteration order)."""
        return [self._replicas[r] for r in sorted(self._replicas)]

    def get(self, rid: str) -> ReplicaHandle:
        h = self._replicas.get(rid)
        if h is None:
            raise KeyError(f"unknown replica {rid!r}; "
                           f"have {self.rids()}")
        return h

    def _obs_for(self, rid: str, clock: Any):
        metrics = MetricsRegistry(prefix=f"{rid}.", replica=rid)
        store = TimeSeriesStore(
            capacity=self.series_capacity, clock=clock
        )
        return metrics, store

    def add(self, rid: str, *, clock: Any = None) -> ReplicaHandle:
        """Build (or rebind) an engine for ``rid`` and register it.
        ``clock`` defaults to a fresh :class:`VirtualClock` at t=0 so
        all replicas start on aligned timelines."""
        rid = str(rid)
        if rid in self._replicas:
            raise ValueError(f"duplicate replica id {rid!r}")
        clk = clock if clock is not None else VirtualClock()
        metrics, store = self._obs_for(rid, clk)
        engine = self.factory(rid, clock=clk, metrics=metrics)
        if engine is None:
            raise ValueError(
                f"factory returned None for replica {rid!r}"
            )
        h = ReplicaHandle(rid, engine, clk, metrics, store)
        self._replicas[rid] = h
        return h

    def restart(self, rid: str) -> ReplicaHandle:
        """Failover restart: same engine and clock, fresh obs epoch.

        ``rebind_obs`` wipes run state (queue/slots/pages/reqlog),
        swaps a fault-injected pool wrapper for a pristine pool, and
        clears any drain flag; the handle gets a fresh metrics registry
        and series store so post-restart trends are judged only on
        post-restart samples (``epoch_t0`` moves to now)."""
        h = self.get(rid)
        metrics, store = self._obs_for(rid, h.clock)
        h.engine.rebind_obs(clock=h.clock, metrics=metrics)
        h.metrics = metrics
        h.store = store
        h.epoch_t0 = float(h.clock())
        h.restarts += 1
        return h

    def merged_metrics(self) -> Dict[str, Any]:
        """One ``dls.metrics/1`` snapshot over every replica (see
        :func:`~..obs.fleet.merge_snapshots`)."""
        from ..obs.fleet import merge_snapshots

        return merge_snapshots(
            [h.metrics.snapshot() for h in self.replicas()]
        )


__all__ = ["EngineRegistry", "ReplicaHandle"]
