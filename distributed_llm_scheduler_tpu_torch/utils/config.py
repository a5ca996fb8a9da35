"""Run configuration.

A dataclass carries the whole experiment description and maps 1:1 onto the
CLI flags in ``__main__``; everything has a default so ``python -m
distributed_llm_scheduler_tpu_torch <cmd>`` just works.  The JAX package's
``utils/config.py`` counterpart: the same fields, graph builds and errors,
with live clusters bound to torch devices.

The platform seam: ``DLS_PLATFORM`` (``cpu`` or ``cuda``; ``DLS_FORCE_CPU``
set is shorthand for ``cpu``) picks what :meth:`RunConfig.build_cluster_with_devices`
binds.  Unset means the CUDA cards, and no card raises: nothing falls back
to the CPU on its own.  A parallel run (``train``) starts one process per
device: :func:`platform_world` ranks.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional, Tuple

# the environment seam lives in utils/env.py; re-exported here, where the
# JAX package keeps it
from .env import env_flag, env_str

PLATFORMS = ("cpu", "cuda")


class ConfigError(RuntimeError):
    """A run that cannot start as configured: no card on ``cuda``, or a
    native engine that does not build.  The CLI turns it into exit 2 with
    one line; a fault on the card (a launch failure, out of memory) is not
    one and keeps its traceback."""


def platform() -> str:
    """``"cpu"`` or ``"cuda"``, from ``DLS_PLATFORM`` / ``DLS_FORCE_CPU``
    (unset: ``"cuda"``).  Any other value raises ``ValueError``."""
    plat = env_str("DLS_PLATFORM") or ("cpu" if env_str("DLS_FORCE_CPU") else None)
    plat = plat or "cuda"
    if plat not in PLATFORMS:
        raise ValueError(
            f"DLS_PLATFORM={plat!r} is not a platform of this package; "
            f"choose {' | '.join(PLATFORMS)}"
        )
    return plat


def platform_devices(n: Optional[int] = None) -> list:
    """The devices of :func:`platform`: ``n`` CPU devices (one when ``n``
    is None), or every visible CUDA card.  No card on ``cuda`` raises
    :class:`ConfigError`."""
    import torch

    if platform() == "cpu":
        return [torch.device("cpu")] * (n or 1)
    count = torch.cuda.device_count()
    if count == 0:
        raise ConfigError(
            "no CUDA device visible; set DLS_PLATFORM=cpu to run on the CPU"
        )
    return [torch.device("cuda", i) for i in range(count)]


def platform_world() -> int:
    """The ranks of a parallel run (one process per device) on
    :func:`platform`: every visible card on ``cuda`` (none raises
    :class:`ConfigError`); on ``cpu``, ``DLS_CPU_WORLD`` processes
    (default 1), the counterpart of XLA's host device count."""
    import torch

    if platform() == "cpu":
        raw = env_str("DLS_CPU_WORLD") or "1"
        if not raw.isdigit() or int(raw) < 1:
            raise ValueError(f"DLS_CPU_WORLD={raw!r} is not a positive count")
        return int(raw)
    count = torch.cuda.device_count()
    if count == 0:
        raise ConfigError(
            "no CUDA device visible; set DLS_PLATFORM=cpu to run on the CPU"
        )
    return count


@dataclasses.dataclass
class RunConfig:
    # workload
    # gpt2[-medium|-tiny] | llama[-8b|-tiny] | mixtral[-8x7b|-tiny]
    # | llm | random | pipeline
    model: str = "gpt2"
    batch: int = 1
    seq_len: int = 512
    microbatches: int = 1
    vocab_shards: int = 1          # shard the embedding/LM-head tables
    fuse: bool = False             # fuse linear task chains (core/fusion.py)
    quantize: str = "none"         # none | int8 (utils/quantize.py)
    num_layers: Optional[int] = None  # synthetic workloads / overrides
    train_step: bool = False       # schedule one fwd+bwd+opt step (gpt2*)
    routed: bool = False           # mixtral*: capacity-buffer sparse MoE
    capacity_factor: float = 2.0   # routed capacity slack (x k*N/E)

    # cluster
    num_nodes: int = 8
    hbm_gb: float = 14.0
    memory_regime: float = 1.0
    slices: int = 1                # >1: multi-slice topology (DCN between)

    # scheduling
    scheduler: str = "heft"
    # search-tier knobs (``--scheduler search``): eval budget and RNG
    # seed for the annealed placement search.  None keeps the policy's
    # own defaults; other policies ignore them (get_scheduler forwards
    # kwargs only to constructors that declare them)
    search_budget: Optional[int] = None
    search_seed: Optional[int] = None

    # backend
    backend: str = "sim"           # sim | sim-reference | device
    prefetch_params: bool = True

    # evaluation sweep
    num_runs: int = 3
    node_counts: Tuple[int, ...] = (2, 4, 8)
    memory_regimes: Tuple[float, ...] = (1.0, 0.9, 0.8)

    # io
    out_dir: str = "evaluation_results"
    seed: int = 0
    # optional pretrained weights for `execute`: a torch state-dict file
    # (gpt2 / llama / mixtral families; frontend/pretrained.py name-maps
    # it) — random init when unset
    weights: Optional[str] = None

    def _model_family(self):
        """(variants, layers_field, max_seq_field, builder) for real model
        families, or None for synthetic workloads.  One table so every
        family shares the same variant lookup / num_layers override /
        seq-len clamp behavior."""
        if self.model.startswith("gpt2"):
            from ..frontend.gpt2_dag import build_gpt2_dag
            from ..models.gpt2 import GPT2Config

            return (
                {
                    "gpt2": GPT2Config.small,
                    "gpt2-medium": GPT2Config.medium,
                    "gpt2-tiny": GPT2Config.tiny,
                },
                "n_layer", "n_positions", build_gpt2_dag,
            )
        if self.model.startswith("llama"):
            from ..frontend.llama_dag import build_llama_dag
            from ..models.llama import LlamaConfig

            return (
                {
                    "llama": LlamaConfig.llama3_8b,
                    "llama-8b": LlamaConfig.llama3_8b,
                    "llama-tiny": LlamaConfig.tiny,
                },
                "n_layers", "max_seq_len", build_llama_dag,
            )
        if self.model.startswith("mixtral"):
            from ..frontend.moe_dag import build_moe_dag
            from ..models.mixtral import MixtralConfig

            return (
                {
                    "mixtral": MixtralConfig.mixtral_8x7b,
                    "mixtral-8x7b": MixtralConfig.mixtral_8x7b,
                    "mixtral-tiny": MixtralConfig.tiny,
                },
                "n_layers", "max_seq_len", build_moe_dag,
            )
        return None

    def model_config(self):
        """Model config instance for a real-family variant name.

        The ONE variant-name lookup (CLI generate and build_graph share
        it): returns None for synthetic workloads, raises ValueError for an
        unknown variant of a known family."""
        family = self._model_family()
        if family is None:
            return None
        variants = family[0]
        maker = variants.get(self.model)
        if maker is None:
            raise ValueError(
                f"unknown model {self.model!r}; variants are "
                f"{' / '.join(sorted(variants))}"
            )
        return maker()

    def build_graph(self):
        from ..frontend import generators

        if self.train_step and not self.model.startswith("gpt2"):
            raise ValueError(
                "--train-step currently supports gpt2* models only"
            )
        if self.train_step and self.microbatches != 1:
            raise ValueError(
                "--train-step does not support --microbatches yet"
            )
        if self.train_step and self.vocab_shards != 1:
            raise ValueError(
                "--train-step does not support --vocab-shards yet"
            )
        if self.train_step and self.fuse:
            raise ValueError("--train-step does not support --fuse yet")
        if self.quantize not in ("none", "int8"):
            raise ValueError(
                f"unknown quantize mode {self.quantize!r}; choose none | int8"
            )
        if self.routed and not self.model.startswith("mixtral"):
            # same contract as --quantize below: silently ignoring the
            # flag would report dense numbers as routed ones
            raise ValueError(
                "--routed applies to mixtral* models only (sparse expert "
                "dispatch); other workloads have no experts"
            )
        if self.quantize != "none" and self.train_step:
            raise ValueError(
                "--train-step does not support --quantize (int8 weights "
                "are an inference-path representation)"
            )
        if self.quantize != "none" and self._model_family() is None:
            # silently ignoring the flag would report full-precision
            # numbers as quantized ones
            raise ValueError(
                "--quantize needs a real model family (gpt2*/llama*/"
                "mixtral*); synthetic graphs carry no weights to quantize"
            )

        family = self._model_family()
        if family is not None:
            variants, layers_field, max_seq_field, builder = family
            cfg = self.model_config()
            if self.num_layers:
                cfg = dataclasses.replace(cfg, **{layers_field: self.num_layers})
            seq = min(self.seq_len, getattr(cfg, max_seq_field))
            if self.train_step:
                from ..frontend.train_dag import build_gpt2_train_dag

                return build_gpt2_train_dag(cfg, batch=self.batch, seq_len=seq)
            extra = (
                {"routed": True, "capacity_factor": self.capacity_factor}
                if self.routed
                else {}
            )
            dag = builder(
                cfg, batch=self.batch, seq_len=seq,
                microbatches=self.microbatches,
                vocab_shards=self.vocab_shards,
                **extra,
            )
            if self.fuse:
                from ..core.fusion import fuse_linear_chains

                dag = dataclasses.replace(
                    dag, graph=fuse_linear_chains(dag.graph)
                )
            if self.quantize == "int8":
                from .quantize import quantize_dag

                dag = quantize_dag(dag)
            return dag
        makers = {
            "llm": lambda: generators.generate_llm_dag(
                num_layers=self.num_layers or 4, seed=self.seed
            ),
            "random": lambda: generators.generate_random_dag(
                num_tasks=(self.num_layers or 4) * 8, seed=self.seed
            ),
            "pipeline": lambda: generators.generate_pipeline_dag(
                num_stages=self.num_layers or 4, seed=self.seed
            ),
        }
        if self.model not in makers:
            raise ValueError(
                f"unknown model {self.model!r}; choose gpt2[-medium|-tiny] / "
                "llama[-8b|-tiny] / mixtral[-8x7b|-tiny] / llm / random / "
                "pipeline"
            )
        graph = makers[self.model]()
        if self.fuse:
            from ..core.fusion import fuse_linear_chains

            graph = fuse_linear_chains(graph)
        return graph

    def build_cluster(self):
        from ..core.cluster import Cluster

        if self.slices > 1:
            if self.num_nodes % self.slices != 0:
                raise ValueError(
                    f"--slices {self.slices} must divide "
                    f"--num-nodes {self.num_nodes}"
                )
            return Cluster.multislice(
                self.slices,
                self.num_nodes // self.slices,
                self.hbm_gb * self.memory_regime,
            )
        return Cluster.uniform(self.num_nodes, self.hbm_gb * self.memory_regime)

    def build_link(self):
        """The replay's link model: tiered (ICI/DCN) for multi-slice
        topologies, flat defaults otherwise."""
        if self.slices > 1:
            from ..backends.sim import TieredLinkModel

            return TieredLinkModel()
        return None  # SimulatedBackend's flat defaults

    def build_scheduler(self):
        """The configured policy; link-aware policies receive the same
        link model the replay charges (``get_scheduler`` detects the
        ``link=`` keyword), so multi-slice runs optimize DCN-aware costs."""
        from ..sched.policies import get_scheduler

        return get_scheduler(
            self.scheduler, link=self.build_link(),
            budget=self.search_budget, seed=self.search_seed,
        )

    def build_backend(self):
        from ..backends.sim import SimulatedBackend

        if self.backend == "sim":
            return SimulatedBackend(
                fidelity="full", prefetch_params=self.prefetch_params,
                link=self.build_link(),
            )
        if self.backend == "sim-reference":
            return SimulatedBackend(fidelity="reference")
        if self.backend == "device":
            from ..backends.device import DeviceBackend

            return DeviceBackend(self.build_cluster_with_devices())
        raise ValueError(f"unknown backend {self.backend!r}")

    def build_cluster_with_devices(self):
        """A cluster bound to live devices: a prefix of ``num_nodes`` of
        the cards (a note on stderr when fewer exist), or, under
        ``DLS_PLATFORM=cpu``, ``num_nodes`` CPU devices."""
        from ..core.cluster import Cluster

        devs = platform_devices(self.num_nodes)
        if self.num_nodes and self.num_nodes < len(devs):
            devs = devs[: self.num_nodes]
        elif self.num_nodes and self.num_nodes > len(devs):
            # live clusters cannot invent devices; disclose the clamp
            # instead of silently reporting an un-honored request
            print(
                f"note: {self.num_nodes} nodes requested but only "
                f"{len(devs)} live device(s) exist; binding {len(devs)}",
                file=sys.stderr,
            )
        return Cluster.from_torch_devices(devs, hbm_cap_gb=self.hbm_gb)


__all__ = [
    "PLATFORMS",
    "RunConfig",
    "env_flag",
    "env_str",
    "platform",
    "platform_devices",
    "platform_world",
]
