"""Fleet-level observability: merged snapshots and the fleet doctor.

One replica's health surface already exists — ``dls.metrics/1``
snapshots, ``dls.timeseries/1`` series, the HLT detector battery
(:mod:`.health`).  This module lifts it to N replicas:

* :func:`merge_snapshots` — union N replica-labeled metric snapshots
  into one ``dls.metrics/1`` aggregate.  Replica registries are built
  with ``MetricsRegistry(prefix="{rid}.", replica=rid)``, so the merged
  key space is collision-free by construction; a collision anyway
  (mislabeled registry) is a hard error naming the replicas.
* :func:`fleet_detectors` — the battery the router consults per
  replica per tick.  Deliberately just HLT001 (page leak): it is the
  one detector whose healthy value is EXACTLY zero at any load, so
  routing skew between replicas cannot fake a breach — the latency and
  throughput detectors (HLT004–006) compare load-dependent trends and
  belong to the offline soak doctor, not the routing control loop.
* :class:`FleetHealthReport` — the ``doctor --fleet`` gate surface,
  mirroring :class:`~.health.HealthReport` (``exceeds`` /
  ``worst_breach`` / ``summary`` / ``to_json``) but per replica, with
  the drain/restart history that proves failover actually fired.  The
  gate judges CURRENT findings: a replica that breached, drained,
  restarted, and re-evaluated clean leaves its breach in ``history``
  (the CI grep target) without failing the fleet — self-healing that
  worked is exit 0.

The PyTorch port's copy of ``distributed_llm_scheduler_tpu.obs.fleet``: framework-free,
so the port keeps it without importing the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from .health import Detector, HealthFinding
from .metrics import SCHEMA as METRICS_SCHEMA
from .metrics import validate_snapshot

SCHEMA = "dls.fleet-health/1"

_REPLICA_STATES = ("active", "draining", "probation")


def merge_snapshots(snaps: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Union replica-labeled ``dls.metrics/1`` snapshots into one.

    Every input must validate and carry a distinct ``replica`` label;
    instrument names must be disjoint across inputs (prefixed
    registries guarantee it).  The output is a plain ``dls.metrics/1``
    snapshot — ``diff_snapshots`` and the artifact schema tests consume
    it unchanged — plus a ``replicas`` list recording the sources.
    """
    if not snaps:
        raise ValueError("merge_snapshots: no snapshots given")
    replicas: List[str] = []
    out: Dict[str, Any] = {
        "schema": METRICS_SCHEMA,
        "counters": {},
        "gauges": {},
        "histograms": {},
    }
    owner: Dict[str, str] = {}   # instrument name -> replica
    for i, snap in enumerate(snaps):
        errs = validate_snapshot(snap)
        if errs:
            raise ValueError(
                f"snapshot #{i} invalid: " + "; ".join(errs[:5])
            )
        rid = snap.get("replica")
        if not rid:
            raise ValueError(
                f"snapshot #{i} has no replica label — only "
                f"replica-labeled snapshots can merge unambiguously"
            )
        if rid in replicas:
            raise ValueError(f"duplicate replica label {rid!r}")
        replicas.append(rid)
        for family in ("counters", "gauges", "histograms"):
            for name, row in snap[family].items():
                prev = owner.get(name)
                if prev is not None:
                    raise ValueError(
                        f"instrument {name!r} appears in both replica "
                        f"{prev!r} and {rid!r} — registries must be "
                        f"prefix-namespaced"
                    )
                owner[name] = rid
                out[family][name] = dict(row)
    for family in ("counters", "gauges", "histograms"):
        out[family] = dict(sorted(out[family].items()))
    out["replicas"] = sorted(replicas)
    return out


def fleet_detectors() -> List[Detector]:
    """The router's per-replica battery: HLT001 only (see module
    docstring for why the load-dependent detectors stay offline)."""
    return [
        Detector("page_leak", "HLT001", "pool.orphan_pages",
                 threshold=0.05),
    ]


class FleetHealthReport:
    """Per-replica detector verdicts + the drain/restart event history.

    ``replicas`` maps replica id to a dict with ``state`` (active |
    draining | probation), ``restarts``, ``drains``, ``warmup_s`` (the
    store-clock timestamp the replica's current epoch was judged from)
    and ``findings`` (:class:`~.health.HealthFinding` rows for the
    replica's CURRENT series store).  ``history`` is the append-only
    event log: one row per breach/drain/restart/readmit with the fleet
    time it happened.
    """

    def __init__(
        self,
        replicas: Dict[str, Dict[str, Any]],
        history: Optional[List[Dict[str, Any]]] = None,
    ):
        for rid, row in replicas.items():
            state = row.get("state")
            if state not in _REPLICA_STATES:
                raise ValueError(
                    f"replica {rid!r}: unknown state {state!r}"
                )
        self.replicas = replicas
        self.history = list(history or [])

    # -- gate surface (mirrors HealthReport) ------------------------------
    def breaches(self) -> List[Tuple[str, HealthFinding]]:
        """(replica, finding) pairs breaching at error severity in the
        CURRENT findings — healed replicas contribute nothing here."""
        out: List[Tuple[str, HealthFinding]] = []
        for rid in sorted(self.replicas):
            for f in self.replicas[rid].get("findings", []):
                if f.severity == "error":
                    out.append((rid, f))
        return out

    def exceeds(self) -> bool:
        """True when any replica currently breaches — the CI gate.  A
        breach that was drained + restarted away lives only in
        ``history`` and does not fail the fleet."""
        return bool(self.breaches())

    def worst_breach(self) -> Optional[Tuple[str, HealthFinding]]:
        worst, worst_ratio = None, -1.0
        for rid, f in self.breaches():
            if f.slope is None:
                continue
            ratio = abs(f.slope) / f.threshold
            if ratio > worst_ratio:
                worst, worst_ratio = (rid, f), ratio
        return worst

    def restarts(self) -> int:
        return sum(
            int(r.get("restarts", 0)) for r in self.replicas.values()
        )

    def drains(self) -> int:
        return sum(
            int(r.get("drains", 0)) for r in self.replicas.values()
        )

    def summary(self) -> str:
        lines = [
            f"fleet health: {len(self.replicas)} replica(s), "
            f"{len(self.breaches())} current breach(es), "
            f"{self.drains()} drain(s), {self.restarts()} restart(s)"
        ]
        for rid in sorted(self.replicas):
            row = self.replicas[rid]
            findings = row.get("findings", [])
            n_err = sum(1 for f in findings if f.severity == "error")
            mark = "BREACH" if n_err else "ok"
            lines.append(
                f"  [{mark:6s}] {rid:8s} state={row['state']:10s} "
                f"restarts={row.get('restarts', 0)} "
                f"drains={row.get('drains', 0)} "
                f"findings={len(findings)}"
            )
        for ev in self.history:
            lines.append(
                f"  t={ev.get('t', 0):9.3f} {ev.get('event', '?'):10s} "
                f"{ev.get('replica', '?'):8s} {ev.get('detail', '')}"
            )
        return "\n".join(lines)

    def to_json(self) -> Dict[str, Any]:
        return {
            "schema": SCHEMA,
            "exceeds": self.exceeds(),
            "replicas": {
                rid: {
                    "state": row["state"],
                    "restarts": int(row.get("restarts", 0)),
                    "drains": int(row.get("drains", 0)),
                    "warmup_s": float(row.get("warmup_s", 0.0)),
                    "findings": [
                        f.to_json() for f in row.get("findings", [])
                    ],
                }
                for rid, row in sorted(self.replicas.items())
            },
            "history": list(self.history),
        }

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "FleetHealthReport":
        errs = validate_fleet_health(obj)
        if errs:
            raise ValueError(
                "malformed fleet health: " + "; ".join(errs[:5])
            )
        replicas: Dict[str, Dict[str, Any]] = {}
        for rid, row in obj["replicas"].items():
            replicas[rid] = {
                "state": row["state"],
                "restarts": int(row.get("restarts", 0)),
                "drains": int(row.get("drains", 0)),
                "warmup_s": float(row.get("warmup_s", 0.0)),
                "findings": [
                    HealthFinding(
                        code=f["code"], severity=f["severity"],
                        detector=f["detector"], series=f["series"],
                        slope=f["slope"], threshold=f["threshold"],
                        message=f["message"],
                    )
                    for f in row.get("findings", [])
                ],
            }
        return cls(replicas, history=obj.get("history", []))


def validate_fleet_health(obj: Any) -> List[str]:
    """Structural check of a ``dls.fleet-health/1`` dict; returns
    human-readable problems (empty list == valid)."""
    errs: List[str] = []
    if not isinstance(obj, dict):
        return [f"fleet health is {type(obj).__name__}, not dict"]
    if obj.get("schema") != SCHEMA:
        errs.append(f"schema is {obj.get('schema')!r}, want {SCHEMA!r}")
    replicas = obj.get("replicas")
    if not isinstance(replicas, dict) or not replicas:
        return errs + ["replicas block missing, not a dict, or empty"]
    for rid, row in replicas.items():
        if not isinstance(row, dict):
            errs.append(f"replicas.{rid} is not a dict")
            continue
        if row.get("state") not in _REPLICA_STATES:
            errs.append(
                f"replicas.{rid}.state is {row.get('state')!r}, want "
                f"one of {_REPLICA_STATES}"
            )
        for f in ("restarts", "drains"):
            if not isinstance(row.get(f), int) or row.get(f, 0) < 0:
                errs.append(
                    f"replicas.{rid}.{f} is {row.get(f)!r}, want a "
                    f"non-negative int"
                )
        findings = row.get("findings")
        if not isinstance(findings, list):
            errs.append(f"replicas.{rid}.findings is not a list")
            continue
        for i, frow in enumerate(findings):
            if not isinstance(frow, dict):
                errs.append(f"replicas.{rid}.findings[{i}] not a dict")
                continue
            for k in ("code", "severity", "detector", "series",
                      "slope", "threshold", "message"):
                if k not in frow:
                    errs.append(
                        f"replicas.{rid}.findings[{i}] missing {k!r}"
                    )
    history = obj.get("history")
    if history is not None and not isinstance(history, list):
        errs.append("history is not a list")
    elif isinstance(history, list):
        for i, ev in enumerate(history):
            if not isinstance(ev, dict) or "event" not in ev:
                errs.append(f"history[{i}] is not an event dict")
                break
    return errs


def report_from_fleet_artifact(obj: Dict[str, Any]) -> FleetHealthReport:
    """Re-gate a saved fleet artifact offline (``doctor --fleet``):
    accepts either a full ``dls.fleet/1`` bench artifact (reads its
    embedded ``fleet_health`` block) or a bare ``dls.fleet-health/1``
    dict.  Raises ``ValueError`` on malformed input — the CLI maps that
    to exit 2."""
    if not isinstance(obj, dict):
        raise ValueError(
            f"fleet artifact is {type(obj).__name__}, not dict"
        )
    block = obj.get("fleet_health") if obj.get("schema") != SCHEMA else obj
    if not isinstance(block, dict):
        raise ValueError("fleet artifact has no fleet_health block")
    return FleetHealthReport.from_json(block)


__all__ = [
    "SCHEMA",
    "FleetHealthReport",
    "fleet_detectors",
    "merge_snapshots",
    "report_from_fleet_artifact",
    "validate_fleet_health",
]
