"""Online serving layer: open-loop load generation (:mod:`.loadgen`) and
the event-loop front-end with SLO-aware admission and priority
preemption (:mod:`.frontend`) over the paged continuous-batching decode
engine.  The soak harness and the fleet tier (registry, router) of the
JAX package's ``serve`` are not ported."""

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

__all__ = [
    "Arrival",
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
    "validate_trace_obj",
]
