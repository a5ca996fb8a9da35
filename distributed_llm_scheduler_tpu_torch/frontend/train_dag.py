"""GPT-2 training-step DAG: forward + backward + optimizer as tasks
(BASELINE.json config #5).

PyTorch port of ``distributed_llm_scheduler_tpu.frontend.train_dag``, with
its ``3 * n_layer + 7`` tasks, ids, dependencies, param aliases, FLOP
fields, groups, dict outputs and graph name:

* ``batch`` — identity root carrying ``{"ids", "targets"}`` to consumers;
* ``embedding_fwd``, ``layer_{i}_fwd`` — layer-granular forward; each
  output (the residual stream entering layer i+1) stays live until
  ``layer_{i+1}_bwd`` (``layer_0_bwd`` for the embedding's) consumes it
  at the far end of the schedule;
* ``head_bwd`` — final LN + tied-weight logits + cross-entropy loss and
  its VJP in one task (returns ``loss``, ``grad_x``, ``grads``);
* ``layer_{i}_bwd`` — **rematerializing** VJP: recomputes layer i's
  forward from its saved input and pulls the upstream cotangent back
  through it, so tasks exchange only tensors and dicts of them, and each
  layer's params are needed a second time, far from the first;
* ``opt_layer_{i}`` / ``opt_head`` / ``opt_embed`` — SGD updates; the
  tied embedding table receives the summed grads of ``embedding_bwd``
  and ``head_bwd``;
* ``step_out`` — gathers the new params + loss.

Each VJP is ``torch.autograd.grad`` under ``torch.enable_grad()`` on
detached copies of the task's inputs, inside the task: the backends run
task fns under ``torch.no_grad()``, and the recompute runs the same
kernels as the forward (flash attention and LayerNorm on a card, their
backward by recompute through the plain versions).  Backward FLOPs are
seeded at 2x forward; calibration replaces them with measurements.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

import torch

from ..core.graph import Task, TaskGraph
from ..models import gpt2
from ..models.gpt2 import GPT2Config
from .gpt2_dag import DEFAULT_EFFECTIVE_FLOPS, ModelDAG, make_task_adder


class TrainDAG(ModelDAG):
    """ModelDAG whose input is ``{"ids", "targets"}`` and whose
    ``reference_forward`` is the fused one-step oracle returning
    ``{"loss", "params"}``."""

    def make_inputs(self, generator: Optional[torch.Generator] = None,
                    device: Any = "cuda") -> Dict[str, torch.Tensor]:
        """Token ids and targets in ``[0, vocab)``, int32, drawn on the
        host from ``generator`` (a CPU generator seeded 1 when None), so
        a seed gives the same batch on every device."""
        if generator is None:
            generator = torch.Generator().manual_seed(1)
        shape = tuple(self.input_spec["ids"].shape)
        V = self.config.vocab_size
        return {
            k: torch.randint(0, V, shape, generator=generator,
                             dtype=torch.int32).to(device)
            for k in ("ids", "targets")
        }


def _layer_params(i: int) -> List[str]:
    p = f"h{i}_"
    return [p + s for s in gpt2._BLOCK_KEYS]


def vjp(fn: Callable[..., Any], params: Dict[str, Any], *xs: Any,
        cotangent: Any = None):
    """``(out, grads of params by name, grads of xs)`` of ``fn(params,
    *xs)`` at ``cotangent`` (1 for a scalar), by autograd on detached
    copies of the inputs.  Every ``xs`` entry must be a float tensor;
    integer inputs belong in ``fn``'s closure."""
    with torch.enable_grad():
        p_ = {k: v.detach().requires_grad_() for k, v in params.items()}
        x_ = [x.detach().requires_grad_() for x in xs]
        out = fn(p_, *x_)
        grads = torch.autograd.grad(
            out, [*p_.values(), *x_],
            torch.ones_like(out) if cotangent is None else cotangent)
    n = len(p_)
    return out.detach(), dict(zip(p_, grads[:n])), list(grads[n:])


def build_gpt2_train_dag(
    config: Optional[GPT2Config] = None,
    batch: int = 1,
    seq_len: int = 128,
    lr: float = 1e-3,
    effective_flops: float = DEFAULT_EFFECTIVE_FLOPS,
) -> TrainDAG:
    """One SGD step over the port's GPT-2 as a schedulable task DAG."""
    config = config or GPT2Config.small()
    if seq_len > config.n_positions:
        raise ValueError(f"seq_len {seq_len} exceeds n_positions {config.n_positions}")
    B, T, D, V = batch, seq_len, config.n_embd, config.vocab_size
    eps, n_head = config.ln_eps, config.n_head

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    specs = {
        name: meta(shape, dtype)
        for name, (shape, dtype) in gpt2.param_shapes(config).items()
    }
    input_spec = {
        "ids": meta((B, T), torch.int32),
        "targets": meta((B, T), torch.int32),
    }

    tasks: List[Task] = []
    out_specs: Dict[str, Any] = {}
    add = make_task_adder(tasks, out_specs, specs, input_spec, effective_flops)

    # ---- model pieces ----------------------------------------------------
    def layer_fwd(p, x):
        """One transformer block with LOCAL param names (alias-mapped)."""
        return gpt2.transformer_block(p, x, config)

    def head_loss(p, x, targets):
        h = gpt2.layer_norm(x, p["ln_f_g"], p["ln_f_b"], eps)
        return gpt2.nll_loss(gpt2.output_projection(h, p["wte"]), targets)

    # ---- task fns --------------------------------------------------------
    def f_batch(p, inputs):
        return inputs

    def f_emb_fwd(p, inputs):
        return gpt2.embedding(inputs["ids"], p["wte"], p["wpe"])

    def f_layer_fwd(p, x):
        return layer_fwd(p, x)

    def f_head_bwd(p, x, inputs):
        """Loss + VJP of (final LN -> tied logits -> cross-entropy)."""
        loss, grads_p, (grad_x,) = vjp(
            lambda pp, xx: head_loss(pp, xx, inputs["targets"]), p, x)
        return {"loss": loss, "grad_x": grad_x, "grads": grads_p}

    def f_layer_bwd(p, x_in, upstream):
        """Rematerializing VJP of one block: recompute fwd from the saved
        input, pull the upstream cotangent back through it."""
        _, grads_p, (grad_x,) = vjp(layer_fwd, p, x_in,
                                    cotangent=upstream["grad_x"])
        return {"grad_x": grad_x, "grads": grads_p}

    def f_emb_bwd(p, inputs, upstream):
        _, grads_p, _ = vjp(
            lambda pp: gpt2.embedding(inputs["ids"], pp["wte"], pp["wpe"]), p,
            cotangent=upstream["grad_x"])
        return {"grads": grads_p}

    def make_f_opt(prefix: str) -> Callable[..., Dict[str, torch.Tensor]]:
        """SGD update emitting GLOBAL param names (``h{i}_...``) so
        step_out can merge per-layer outputs without collisions."""

        def f_opt(p, bwd_out):
            return {
                prefix + k: p[k] - lr * bwd_out["grads"][k].to(p[k].dtype)
                for k in p
            }

        return f_opt

    def f_opt_embed(p, emb_bwd_out, head_bwd_out):
        """Tied wte: sum the embedding-lookup and logits-projection grads."""
        g_wte = emb_bwd_out["grads"]["wte"] + head_bwd_out["grads"]["wte"]
        return {
            "wte": p["wte"] - lr * g_wte.to(p["wte"].dtype),
            "wpe": p["wpe"] - lr * emb_bwd_out["grads"]["wpe"].to(p["wpe"].dtype),
        }

    def f_opt_head(p, head_bwd_out):
        g = head_bwd_out["grads"]
        return {
            "ln_f_g": p["ln_f_g"] - lr * g["ln_f_g"].to(p["ln_f_g"].dtype),
            "ln_f_b": p["ln_f_b"] - lr * g["ln_f_b"].to(p["ln_f_b"].dtype),
        }

    def f_step_out(p, head_bwd_out, *opt_outs):
        merged: Dict[str, torch.Tensor] = {}
        for o in opt_outs:
            merged.update(o)
        return {"loss": head_bwd_out["loss"], "params": merged}

    # ---- graph assembly --------------------------------------------------
    L = config.n_layer
    layer_flops = (
        2.0 * B * T * D * 3 * D + 4.0 * B * n_head * T * T * (D // n_head)
        + 2.0 * B * T * D * D + 16.0 * B * T * D * D + 12.0 * B * T * D
    )
    head_flops = 2.0 * B * T * D * V
    emb_flops = 2.0 * B * T * D

    add("batch", f_batch, [], {}, 1.0 * B * T, "io")
    add("embedding_fwd", f_emb_fwd, ["batch"],
        {"wte": "wte", "wpe": "wpe"}, emb_flops, "embed")

    prev = "embedding_fwd"
    for i in range(L):
        alias = {s.split("_", 1)[1]: s for s in _layer_params(i)}
        add(f"layer_{i}_fwd", f_layer_fwd, [prev], alias,
            layer_flops, f"layer_{i}")
        prev = f"layer_{i}_fwd"

    # head: loss + its backward in one task (weight-tied wte grads included)
    add("head_bwd", f_head_bwd, [prev, "batch"],
        {"ln_f_g": "ln_f_g", "ln_f_b": "ln_f_b", "wte": "wte"},
        3.0 * head_flops, "head")

    upstream = "head_bwd"
    for i in reversed(range(L)):
        x_in = "embedding_fwd" if i == 0 else f"layer_{i - 1}_fwd"
        alias = {s.split("_", 1)[1]: s for s in _layer_params(i)}
        add(f"layer_{i}_bwd", f_layer_bwd, [x_in, upstream], alias,
            2.0 * layer_flops, f"layer_{i}")
        upstream = f"layer_{i}_bwd"

    add("embedding_bwd", f_emb_bwd, ["batch", upstream],
        {"wte": "wte", "wpe": "wpe"}, 2.0 * emb_flops, "embed")

    opt_ids: List[str] = []
    for i in range(L):
        alias = {s.split("_", 1)[1]: s for s in _layer_params(i)}
        tid = f"opt_layer_{i}"
        add(tid, make_f_opt(f"h{i}_"), [f"layer_{i}_bwd"], alias,
            2.0 * sum(
                math.prod(specs[g].shape) for g in _layer_params(i)
            ), f"layer_{i}")
        opt_ids.append(tid)
    add("opt_embed", f_opt_embed, ["embedding_bwd", "head_bwd"],
        {"wte": "wte", "wpe": "wpe"},
        2.0 * (V + config.n_positions) * D, "embed")
    opt_ids.append("opt_embed")
    add("opt_head", f_opt_head, ["head_bwd"],
        {"ln_f_g": "ln_f_g", "ln_f_b": "ln_f_b"}, 4.0 * D, "head")
    opt_ids.append("opt_head")

    add("step_out", f_step_out, ["head_bwd"] + opt_ids, {},
        1.0 * B * T, "io")

    # ---- fused one-step oracle ------------------------------------------
    def reference_step(params: Dict[str, torch.Tensor],
                       inputs: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """``loss_fn`` + autograd + SGD over the whole model at once."""
        loss, grads, _ = vjp(
            lambda pp: gpt2.loss_fn(pp, inputs["ids"], inputs["targets"],
                                    config), params)
        new = {k: params[k] - lr * grads[k].to(params[k].dtype)
               for k in params}
        return {"loss": loss, "params": new}

    name = f"gpt2_train_{L}l_d{D}_b{B}_t{T}"
    graph = TaskGraph(tasks, name=name).freeze()
    return TrainDAG(
        graph=graph,
        config=config,
        input_spec=input_spec,
        param_specs=specs,
        reference_forward=reference_step,
        model=gpt2,
        derive_params=dict,
    )
