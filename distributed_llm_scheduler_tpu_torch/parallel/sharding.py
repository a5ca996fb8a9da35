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
pass (``analysis/sharding_pass.py``) reads them.  Placing params by these
specs (``shard_params``, the batch and activation shardings over a live
mesh) comes with the parallel layer on ``torch.distributed`` (ROADMAP.md
A.11).
"""

from __future__ import annotations

import re
from typing import Optional, Tuple, Union

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


__all__ = ["GPT2_PARAM_RULES", "LLAMA_PARAM_RULES", "Spec", "param_spec"]
