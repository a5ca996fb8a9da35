"""Online serving layer: open-loop load generation (:mod:`.loadgen`),
the event-loop front-end with SLO-aware admission and priority
preemption (:mod:`.frontend`) over the paged continuous-batching decode
engine, the duration-bounded soak harness with health gating
(:mod:`.soak`), and the fleet tier: the replica registry
(:mod:`.registry`) and the health-driven router with drain and failover
(:mod:`.router`)."""

from .frontend import ServiceTimeModel, ServingFrontend, VirtualClock
from .loadgen import (
    TRACE_SCHEMA,
    Arrival,
    arrivals_to_json,
    load_trace,
    mixed_long_prompt_arrivals,
    poisson_arrivals,
    prompt_token_ids,
    save_trace,
    schedule_digest,
    session_arrivals,
    session_prompt_token_ids,
    validate_trace_obj,
)
from .registry import EngineRegistry, ReplicaHandle
from .router import DuplicateRidError, FleetFrontend
from .soak import (
    SoakConfig,
    inject_jit_churn,
    inject_page_leak,
    inject_refcount_underflow,
    load_soak_artifact,
    run_soak,
    validate_soak_artifact,
)

__all__ = [
    "Arrival",
    "DuplicateRidError",
    "EngineRegistry",
    "FleetFrontend",
    "ReplicaHandle",
    "SoakConfig",
    "ServiceTimeModel",
    "ServingFrontend",
    "TRACE_SCHEMA",
    "VirtualClock",
    "arrivals_to_json",
    "load_trace",
    "mixed_long_prompt_arrivals",
    "poisson_arrivals",
    "prompt_token_ids",
    "save_trace",
    "schedule_digest",
    "session_arrivals",
    "session_prompt_token_ids",
    "validate_soak_artifact",
    "validate_trace_obj",
    "inject_jit_churn",
    "inject_page_leak",
    "inject_refcount_underflow",
    "load_soak_artifact",
    "run_soak",
]
