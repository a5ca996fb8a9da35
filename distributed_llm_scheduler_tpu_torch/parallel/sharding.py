"""Parameter sharding rules for the model families.

PyTorch port of the rule tables of ``distributed_llm_scheduler_tpu.
parallel.sharding``: Megatron-style tensor parallelism, one spec per
parameter name.

* qkv / mlp-expand weights: column-sharded over ``tp`` (output features);
* attn-proj / mlp-contract weights: row-sharded over ``tp`` (input
  features) — their matmul results are partial sums to all-reduce;
* biases follow their weight's output sharding; LN/scalars replicated;
* embedding tables replicated.

A spec is a plain tuple with one entry per leading dimension: ``None``
(not sharded), a mesh axis name, or a tuple of names — the JAX package's
``PartitionSpec`` entries.  ``()`` replicates.  The rules and
:func:`param_spec` are equal to the JAX package's; the static sharding
pass (``analysis/sharding_pass.py``) reads them.

Placing by these specs: the JAX package ``device_put``s a global array
onto a ``NamedSharding`` and every device keeps its block; here each rank
of a :class:`.mesh.Mesh` keeps its own block (:class:`Sharding`,
:func:`shard_params`, :func:`batch_sharding`, :func:`activation_sharding`)
and nothing else exists.  One block differs from GSPMD's: GPT-2's fused
``attn_qkv_w`` (d, 3d) / ``attn_qkv_b`` (3d,), column-sharded over tp.
GSPMD's contiguous column block of the fused matrix is not a set of whole
heads (for tp=2 it is all of q and half of k), which does not matter to
XLA, which partitions the global program as a whole.  A rank that
computes whole heads needs the q, k and v columns of its heads, so here
the block of tp rank r is ``[q_r | k_r | v_r]``, each the r-th of tp
column blocks of q, k and v: the same shape as GSPMD's block, its columns
permuted.  :meth:`Sharding.gather` undoes it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Tuple, Union

import torch

#: a spec entry: not sharded, one mesh axis, or several
SpecEntry = Optional[Union[str, Tuple[str, ...]]]
Spec = Tuple[SpecEntry, ...]

# parameter-name pattern -> spec, checked in order (GPT-2 family naming
# from models/gpt2.py; llama/mixtral reuse the same suffix scheme)
GPT2_PARAM_RULES = [
    # embedding table replicated: GPT-2's vocab (50257) is not divisible by
    # any tp, and an even split is required.  Memory-sharding the table
    # needs vocab padding to a tp multiple first
    (r"wte$", ()),
    (r"wpe$", ()),                       # positions replicated
    (r"attn_qkv_w$", (None, "tp")),
    (r"attn_qkv_b$", ("tp",)),
    (r"attn_proj_w$", ("tp", None)),
    (r"attn_proj_b$", ()),
    (r"mlp_fc_w$", (None, "tp")),
    (r"mlp_fc_b$", ("tp",)),
    (r"mlp_proj_w$", ("tp", None)),
    (r"mlp_proj_b$", ()),
    (r"ln.*_[gb]$", ()),
    (r".*", ()),                         # anything else: replicated
]


# Llama-backbone families (llama + mixtral): Megatron split of the GQA
# attention and the SwiGLU / expert FFNs.  KV projections are column-sharded
# over tp, so tp must divide n_kv_heads for an even head split (LlamaConfig
# defaults: 8 kv heads).  The expert suffixes (``e{j}_w_gate`` etc.) match
# the same FFN rules.  ``lm_head`` (d, vocab) column-shards when tp divides
# the vocab (128256 = 8 x 16032); ``tok_emb`` stays replicated.
LLAMA_PARAM_RULES = [
    (r"tok_emb$", ()),
    (r"(wq|wk|wv)$", (None, "tp")),      # column: heads split over tp
    (r"wo$", ("tp", None)),              # row: output partial-summed
    (r"(w_gate|w_up)$", (None, "tp")),
    (r"w_down$", ("tp", None)),
    (r"router$", ()),
    (r"lm_head$", (None, "tp")),
    (r".*_g$", ()),                      # RMSNorm gains replicated
    (r".*", ()),
]


def param_spec(name: str, family: str = "gpt2") -> Spec:
    """The spec the rules give parameter ``name`` of ``family``."""
    # stacked-layer params (models/gpt2.stack_layer_params): the leading
    # layer dim is never sharded; the per-layer spec shifts right by one
    if name.startswith("layers_"):
        return (None, *param_spec(name[len("layers_"):], family))
    rules = GPT2_PARAM_RULES if family.startswith("gpt2") else LLAMA_PARAM_RULES
    for pattern, spec in rules:
        if re.search(pattern, name):
            return spec
    return ()


#: the fused projections whose tp block is whole heads: q, k and v's blocks
FUSED_QKV = re.compile(r"attn_qkv_[wb]$")


def _axes(entry: SpecEntry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh: which block of a global tensor this rank holds.

    ``fused`` > 1 marks a fused projection (GPT-2's qkv, 3 parts) whose
    sharded dim is cut part by part, so each rank holds whole heads."""

    mesh: Any
    spec: Spec
    fused: int = 1

    def _dims(self, ndim: int):
        """(dim, axes, n, index) of each sharded dim."""
        out = []
        for dim, entry in enumerate(self.spec[:ndim]):
            axes = _axes(entry)
            n = self.mesh.axis_size(*axes) if axes else 1
            if n > 1:
                out.append((dim, axes, n, self.mesh.axis_index(*axes)))
        return out

    def local_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """The shape of this rank's block of a global ``shape``."""
        local = list(shape)
        for dim, _axes_, n, _ in self._dims(len(shape)):
            local[dim] //= n
        return tuple(local)

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global tensor ``t`` (a copy of its
        own, so the global one may be dropped)."""
        for dim, axes, n, idx in self._dims(t.ndim):
            size = t.shape[dim]
            if size % (n * self.fused):
                raise ValueError(
                    f"dim {dim} of size {size} does not split evenly over "
                    f"{'x'.join(axes)}={n}")
            if self.fused > 1:
                parts = t.unflatten(dim, (self.fused, size // self.fused))
                t = parts.chunk(n, dim=dim + 1)[idx].flatten(dim, dim + 1)
            else:
                t = t.chunk(n, dim=dim)[idx]
        return t.contiguous().clone()

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The global tensor from every rank's block ``t`` (a collective
        over the sharded axes; the inverse of :meth:`shard`)."""
        from .collectives import all_gather_dim

        for dim, axes, n, _ in reversed(self._dims(t.ndim)):
            group = self.mesh.group(*axes)
            if self.fused > 1:
                parts = t.unflatten(dim, (self.fused, t.shape[dim] // self.fused))
                t = all_gather_dim(parts, group, dim + 1).flatten(dim, dim + 1)
            else:
                t = all_gather_dim(t, group, dim)
        return t


def param_shardings(mesh: Any, params: Dict[str, Any], family: str = "gpt2"
                    ) -> Dict[str, Sharding]:
    """Each param's :class:`Sharding` on ``mesh`` under the family's rules."""
    return {k: Sharding(mesh, param_spec(k, family),
                        3 if FUSED_QKV.search(k) else 1) for k in params}


def shard_params(mesh: Any, params: Dict[str, Any], family: str = "gpt2"
                 ) -> Dict[str, torch.Tensor]:
    """This rank's blocks of the whole param dict, by the rules."""
    shardings = param_shardings(mesh, params, family)
    return {k: shardings[k].shard(v) for k, v in params.items()}


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """How a rank's training state maps onto the model's whole, flat
    leaves (what a checkpoint holds, the JAX package's layout): ``shapes``
    the global shape of every param of the model, whichever rank holds
    it; ``shardings`` the :class:`Sharding` of each param this rank holds
    (its block of the global leaf); ``group`` the process group of the
    ranks that hold the state (None: this rank alone); ``staged`` whether
    those ranks hold disjoint params (the pipeline's stages) rather than a
    block of every param."""

    shapes: Dict[str, Tuple[int, ...]]
    shardings: Dict[str, Sharding]
    group: Any = None
    staged: bool = False


def batch_sharding(mesh: Any, seq_parallel: bool = False) -> Sharding:
    """(B, T) token batches: batch over dp, optionally sequence over sp."""
    return Sharding(mesh, ("dp", "sp" if seq_parallel else None))


def activation_sharding(mesh: Any, seq_parallel: bool = False) -> Sharding:
    """(B, T, D) activations: batch over dp, optionally sequence over sp."""
    return Sharding(mesh, ("dp", "sp" if seq_parallel else None, None))


__all__ = [
    "FUSED_QKV", "FlatLayout", "GPT2_PARAM_RULES", "LLAMA_PARAM_RULES", "Sharding", "Spec",
    "activation_sharding", "batch_sharding", "param_shardings", "param_spec",
    "shard_params",
]
