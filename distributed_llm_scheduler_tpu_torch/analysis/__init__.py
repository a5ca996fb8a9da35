"""Static analysis over graphs, schedules and clusters (the ported passes).

PyTorch port of the framework-free part of ``distributed_llm_scheduler_tpu.
analysis`` that ``core.validate.validate_schedule`` needs: the structured
diagnostics, the schedule-consistency pass and the memory-feasibility
pass; the stream-safety prover that ``DeviceBackend.execute(
compiled=True, stream_params=True)`` consults; and the two serving
passes, the request-lifecycle checker (``ServingFrontend.lint``) and the
page-lifetime prover over a ``PageOwnershipLog``.  The other passes, the
``analyze`` entry point and the pre-execution gate are not ported yet.
"""

from .diagnostics import (
    CODES,
    JSON_SCHEMA,
    AnalysisError,
    AnalysisReport,
    Diagnostic,
    Severity,
)
from .lifecycle_pass import analyze_lifecycle
from .memory_pass import analyze_memory, node_memory_slice
from .page_pass import analyze_pages, analyze_serve_artifact
from .schedule_pass import analyze_schedule, placement_of
from .stream_pass import analyze_streaming, compiled_stream_refusal, stream_verdict

__all__ = [
    "CODES",
    "JSON_SCHEMA",
    "AnalysisError",
    "AnalysisReport",
    "Diagnostic",
    "Severity",
    "analyze_lifecycle",
    "analyze_memory",
    "analyze_pages",
    "analyze_schedule",
    "analyze_serve_artifact",
    "analyze_streaming",
    "compiled_stream_refusal",
    "node_memory_slice",
    "placement_of",
    "stream_verdict",
]
