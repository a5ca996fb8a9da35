"""distributed_llm_scheduler_tpu_torch — the PyTorch and CUDA port of
``distributed_llm_scheduler_tpu``.

Memory-constrained task-DAG scheduling and real execution for LLMs on
NVIDIA GPUs: the GPT-2 forward is built as a task DAG, placed by a policy
onto memory-limited nodes bound to torch devices, and executed for real,
with attention in a hand-written CUDA flash kernel and LayerNorm in a
hand-written CUDA kernel (``csrc/``); the Llama-3 forward likewise, with
RMSNorm in a hand-written CUDA kernel, placed in pipeline stages; and the
paged decode step is built as a task DAG, placed, and served by a
continuous-batching engine whose attention runs in hand-written CUDA
paged-attention kernels; the north-star bench (``eval/bench.py``)
calibrates the GPT-2 flagship on the card, executes it, and replays every
ported policy's placement against round-robin.  Module
paths and public names follow the JAX package, which stays the reference
this package is held against; this package imports neither JAX nor it.
"""

from .core.graph import (
    DEFAULT_PARAM_GB,
    GraphValidationError,
    Task,
    TaskGraph,
    TaskStatus,
)
from .core.cluster import Cluster, DeviceState, estimate_cluster_memory_needed
from .core.fusion import fuse_linear_chains
from .core.schedule import Schedule, TaskTiming
from .core.validate import ValidationReport, validate_schedule
from .backends.sim import LinkModel, SimulatedBackend, TieredLinkModel
from .backends.device import DeviceBackend, DeviceReport
from .backends.decode_loop import (
    PagedDecodeEngine,
    build_paged_decode_loop,
    compose_paged_step_fn,
)
from .sched.base import BaseScheduler
from .sched.heft import HEFTScheduler
from .sched.pack import GroupPackScheduler
from .sched.pipeline import PipelineStageScheduler
from .sched.eventsim import (
    PlacementTimeline,
    dependency_aware_order,
    simulate_placement,
    simulate_placement_timeline,
)
from .sched.policies import (
    ALL_SCHEDULERS,
    CriticalPathScheduler,
    DFSScheduler,
    GreedyScheduler,
    MRUScheduler,
    RoundRobinScheduler,
    get_scheduler,
)
from .models.gpt2 import GPT2Config, params_from_numpy
from .models.llama import LlamaConfig
from .frontend.gpt2_dag import ModelDAG, build_gpt2_dag
from .frontend.llama_dag import build_llama_dag
from .frontend.decode_dag import PagedDecodeDAG, build_paged_decode_dag
from .models.kv_pages import TRASH_PAGE, PagePool, pages_needed
from .obs.metrics import MetricsRegistry
from .ops.attention import (
    gqa_mha,
    mha,
    paged_decode_attention,
    reference_mha,
    reference_paged_attention,
    reference_paged_attention_ragged,
)
from .ops.norms import (
    layer_norm,
    reference_layer_norm,
    reference_rms_norm,
    rms_norm,
)
from .utils.costmodel import CostModel, calibrate

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_PARAM_GB",
    "GraphValidationError",
    "Task",
    "TaskGraph",
    "TaskStatus",
    "Cluster",
    "DeviceState",
    "estimate_cluster_memory_needed",
    "fuse_linear_chains",
    "Schedule",
    "TaskTiming",
    "ValidationReport",
    "validate_schedule",
    "LinkModel",
    "SimulatedBackend",
    "TieredLinkModel",
    "DeviceBackend",
    "DeviceReport",
    "PagedDecodeEngine",
    "build_paged_decode_loop",
    "compose_paged_step_fn",
    "BaseScheduler",
    "HEFTScheduler",
    "GroupPackScheduler",
    "PipelineStageScheduler",
    "PlacementTimeline",
    "dependency_aware_order",
    "simulate_placement",
    "simulate_placement_timeline",
    "ALL_SCHEDULERS",
    "CriticalPathScheduler",
    "DFSScheduler",
    "GreedyScheduler",
    "MRUScheduler",
    "RoundRobinScheduler",
    "get_scheduler",
    "GPT2Config",
    "params_from_numpy",
    "LlamaConfig",
    "ModelDAG",
    "build_gpt2_dag",
    "build_llama_dag",
    "PagedDecodeDAG",
    "build_paged_decode_dag",
    "TRASH_PAGE",
    "PagePool",
    "pages_needed",
    "MetricsRegistry",
    "mha",
    "gqa_mha",
    "paged_decode_attention",
    "reference_mha",
    "reference_paged_attention",
    "reference_paged_attention_ragged",
    "layer_norm",
    "rms_norm",
    "reference_layer_norm",
    "reference_rms_norm",
    "CostModel",
    "calibrate",
]
