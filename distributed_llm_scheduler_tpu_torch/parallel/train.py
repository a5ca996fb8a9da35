"""Sharded training step: data, tensor and sequence parallel.

PyTorch port of ``distributed_llm_scheduler_tpu.parallel.train``, the
training step BASELINE.json config #5 asks for.  The JAX package jits one
global program (loss, grad, optax update) with sharding annotations on
params, optimizer state and batch, and XLA inserts the gradient
all-reduce over ``dp`` and the Megatron collectives over ``tp``
(``train.py:4-8``).  Here each rank of a :class:`.mesh.Mesh` runs:

* the forward on its param blocks and its rows of the batch
  (:func:`.blocks.gpt2_forward`: the Megatron pair inside every block;
  with ``seq_parallel`` its chunk of the sequence, attention as ring
  attention over ``sp``);
* the backward by autograd, through the collectives' own backwards;
* the mean of the gradients over ``dp`` (and ``sp``): every rank's loss
  is the mean over its tokens, the chunks are equal, so the mean of the
  ranks' gradients is the gradient of the global mean.  Params sharded
  over ``tp`` keep their own gradient; replicated ones get the same one
  on every ``tp`` rank from the collectives;
* ``torch.optim.AdamW(lr=3e-4, weight_decay=0.01)`` on its blocks,
  ``optax.adamw``'s update with its defaults (betas 0.9 and 0.999, eps
  1e-8, decoupled decay of every param); elementwise, so the blocks'
  update is the global one's.

The state is updated in place, the counterpart of ``donate_argnums``.
The step returns the loss averaged over ``dp`` and ``sp``: JAX's mean
over the global batch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models import gpt2
from ..models.gpt2 import GPT2Config
from .blocks import gpt2_forward
from .collectives import all_gather_dim, all_reduce_, dist, group_size, mean_over
from .sharding import FlatLayout, Sharding, batch_sharding, param_shardings, shard_params

#: the default optimizer, ``optax.adamw(3e-4, weight_decay=0.01)``'s
#: counterpart
ADAMW = functools.partial(torch.optim.AdamW, lr=3e-4, weight_decay=0.01)


@dataclasses.dataclass
class TrainState:
    """This rank's params (its blocks), its optimizer over them, the step
    count, and the :class:`.sharding.FlatLayout` that maps the blocks onto
    the model's whole leaves (what a checkpoint holds)."""

    params: Dict[str, torch.Tensor]
    opt_state: torch.optim.Optimizer
    step: int
    layout: Any


def _materialize(opt: torch.optim.Optimizer) -> None:
    """Give every param its Adam moments and step now, as ``optax``'s
    ``init`` does, so a fresh state has the layout a checkpoint restores
    into (torch's AdamW would make them at the first step)."""
    for group in opt.param_groups:
        for p in group["params"]:
            opt.state[p] = {
                "step": torch.tensor(0.0, dtype=torch.float32),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
            }


def _all_reduce_flat(grads: List[torch.Tensor], group, div: int = 1
                     ) -> List[torch.Tensor]:
    """One all-reduce (sum, divided by ``div``) of every gradient of
    ``grads``, flattened together."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, group)
    if div > 1:
        flat.div_(div)
    return [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]


def make_step_from_loss(
    loss_fn: Callable[..., torch.Tensor],
    init_params: Callable[..., Dict[str, torch.Tensor]],
    optimizer: Optional[Callable[[List[torch.Tensor]], torch.optim.Optimizer]] = None,
    data_sharding: Any = None,
    grad_group: Any = None,
    sum_group: Any = None,
    sum_params: Tuple[str, ...] = (),
    layout: Any = None,
) -> Tuple[Callable[..., Any], Callable[..., TrainState]]:
    """The one optimizer skeleton behind the train-step builders:
    ``loss_fn(params, input_ids, targets)`` (this rank's mean loss) and a
    param initializer ``init_params(seed, params)`` -> ``(train_step,
    init_state)``.  ``optimizer`` makes a ``torch.optim.Optimizer`` from
    the param list (default :data:`ADAMW`).  ``data_sharding`` (a
    :class:`.sharding.Sharding`) cuts this rank's block out of the global
    token batches; ``grad_group`` is the process group the gradients and
    the loss are averaged over.  The gradients of ``sum_params`` are
    first summed over ``sum_group`` (the pipeline's shared params, each
    stage holding a part of their gradient); a param the loss does not
    reach on this rank gets a zero gradient.  ``layout`` goes into the
    state (:class:`TrainState`); by default every param is whole on this
    rank."""
    optimizer = optimizer or ADAMW

    def init_state(seed: int = 0, params: Optional[Mapping[str, Any]] = None
                   ) -> TrainState:
        """A fresh state from ``seed`` (or from the whole ``params``)."""
        local = init_params(seed, params)
        for t in local.values():
            t.requires_grad_(True)
        opt = optimizer(list(local.values()))
        _materialize(opt)
        return TrainState(params=local, opt_state=opt, step=0,
                          layout=layout or FlatLayout(
                              {k: tuple(v.shape) for k, v in local.items()},
                              {k: Sharding(None, ()) for k in local}))

    def train_step(state: TrainState, input_ids, targets):
        if data_sharding is not None:
            input_ids = data_sharding.shard(input_ids)
            targets = data_sharding.shard(targets)
        names = list(state.params)
        params = list(state.params.values())
        loss = loss_fn(state.params, input_ids, targets)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            params, torch.autograd.grad(loss, params, allow_unused=True))]
        if sum_params and group_size(sum_group) > 1:
            at = [i for i, k in enumerate(names) if k in sum_params]
            for i, g in zip(at, _all_reduce_flat([grads[i] for i in at], sum_group)):
                grads[i] = g
        n = group_size(grad_group)
        if n > 1:
            grads = _all_reduce_flat(grads, grad_group, n)
        for p, g in zip(params, grads):
            p.grad = g.view_as(p)
        state.opt_state.step()
        state.opt_state.zero_grad(set_to_none=True)
        state.step += 1
        return state, mean_over(loss, grad_group)

    return train_step, init_state


def _check_divides(mesh, config: GPT2Config) -> None:
    tp = mesh.axis_size("tp")
    if config.n_head % tp:
        raise ValueError(f"tp={tp} must divide the head count "
                         f"{config.n_head} (pick a smaller tp)")


def make_train_step(
    config: GPT2Config,
    mesh,
    optimizer: Optional[Callable[[List[torch.Tensor]], torch.optim.Optimizer]] = None,
    seq_parallel: bool = False,
    remat: bool = False,
    scan: bool = False,
) -> Tuple[Callable[..., Any], Callable[..., TrainState]]:
    """Returns ``(train_step, init_state)`` for GPT-2 on ``mesh``.

    ``train_step(state, input_ids, targets) -> (state, loss)`` takes the
    global (B, T) batch (the same on every rank; B divisible by dp, T by
    sp with ``seq_parallel``) and updates ``state`` in place;
    ``init_state(seed, params=None)`` draws the whole params from
    ``seed`` (``gpt2.init_params_numpy``) or takes the whole ``params``
    given (numpy arrays or tensors, bridged in ``config.dtype``) and keeps
    this rank's blocks on its device.  ``remat`` recomputes each block in
    the backward; ``scan`` stacks the layer params and applies one block
    along them (``gpt2.stack_layer_params``, ``forward_scan``'s layout)."""
    from .launch import device

    _check_divides(mesh, config)
    dev = device()

    def loss_fn(params, input_ids, targets):
        logits = gpt2_forward(params, input_ids, config, mesh, remat=remat,
                              scan=scan, seq_parallel=seq_parallel)
        return gpt2.nll_loss(logits, targets)

    def init_params(seed: int, params: Optional[Mapping[str, Any]]):
        whole = params if params is not None else gpt2.init_params_numpy(config, seed)
        whole = gpt2.params_from_numpy(
            {k: v.detach().cpu().float().numpy() if torch.is_tensor(v) else v
             for k, v in whole.items()}, dev, config.dtype)
        if scan:
            whole = gpt2.stack_layer_params(whole, config)
        return shard_params(mesh, whole)

    shapes = {k: s for k, (s, _) in gpt2.param_shapes(config).items()}
    if scan:
        shapes = {k: tuple(v.shape) for k, v in gpt2.stack_layer_params(
            {k: torch.empty(s, device="meta") for k, s in shapes.items()},
            config).items()}
    return make_step_from_loss(
        loss_fn, init_params, optimizer,
        data_sharding=batch_sharding(mesh, seq_parallel=seq_parallel),
        grad_group=mesh.group("dp", "sp"),
        layout=FlatLayout(shapes, param_shardings(mesh, shapes),
                          group=mesh.group(*mesh.axes)),
    )


def make_eval_step(config: GPT2Config, mesh, seq_parallel: bool = False):
    """The sharded forward (inference step): ``eval_step(params,
    input_ids)`` takes this rank's param blocks and the global batch and
    returns the global logits on every rank."""
    data = batch_sharding(mesh, seq_parallel=seq_parallel)

    @torch.no_grad()
    def eval_step(params, input_ids):
        logits = gpt2_forward(params, data.shard(input_ids), config, mesh,
                              seq_parallel=seq_parallel)
        if seq_parallel:
            logits = all_gather_dim(logits, mesh.group("sp"), 1)
        return all_gather_dim(logits, mesh.group("dp"), 0)

    return eval_step


def train_batch(batch: int, seq: int, vocab_size: int, seed: int = 1):
    """The CLI's synthetic batch: (batch, seq) int32 ids in ``[0, vocab)``
    from numpy seed ``seed``, and their next-token targets (the ids
    rolled left by one, as the JAX CLI's ``jnp.roll``)."""
    ids = np.random.default_rng(seed).integers(
        0, vocab_size, size=(batch, seq), dtype=np.int32)
    return ids, np.roll(ids, -1, axis=1)


def train_setup(config: Any, world: int, pp: int = 0, microbatches: int = 1,
                remat: bool = False, scan: bool = False, routed: bool = False,
                capacity_factor: float = 2.0):
    """The ``train`` command's path on this rank of a world of ``world``:
    ``(train_step, init_state, batch)``.  Mixtral trains dp x ep
    (:func:`.expert.expert_mesh_axes`, :func:`.expert.make_moe_train_step`);
    ``pp`` > 0 pipelines GPT-2 over the first ``pp`` ranks with
    ``max(microbatches, pp)`` microbatches (:func:`.pipeline_pp.
    make_pp_train_step`); else GPT-2 trains dp x tp over the world
    (``factorize_mesh``).  The batch is ``max(2 * dp, 2)`` sequences, and
    with pp at least one per microbatch (the JAX CLI's rules)."""
    from ..models.family import family_of
    from .mesh import factorize_mesh, make_axes_mesh, make_mesh

    if family_of(config) == "mixtral":
        from .expert import expert_mesh_axes, make_moe_train_step

        dp, ep = expert_mesh_axes(config.n_experts, world)
        mesh = make_axes_mesh(dp=dp, ep=ep)
        step, init = make_moe_train_step(config, mesh, remat=remat,
                                         routed=routed,
                                         capacity_factor=capacity_factor)
        return step, init, max(2 * dp, 2)
    if pp:
        from .pipeline_pp import make_pp_train_step

        mesh = make_axes_mesh(pp=pp)
        pp_mb = max(microbatches, pp)
        step, init = make_pp_train_step(config, mesh, microbatches=pp_mb,
                                        remat=remat)
        return step, init, max(2, pp_mb)
    axes = factorize_mesh(world)
    step, init = make_train_step(config, make_mesh(**axes), remat=remat,
                                 scan=scan)
    return step, init, max(2 * axes["dp"], 2)


def collective_probe(devices=None):
    """``(fn, args)`` for the collective sweep (``analysis.parallel_sweep``,
    ``lint --parallel``): one dp x tp training step of tiny GPT-2, ``tp``
    2 from two devices, ``dp`` 2 from four (the JAX hook's mesh rule), on
    the global (4, 8) batch; ``fn(*args)`` runs on every rank of a world
    of ``len(devices)`` ranks (default :func:`.launch.world_devices`) and
    the ranks beyond the mesh sit out. The forward's Megatron pairs, the
    backward's and the gradient and loss means over ``dp`` are the
    collectives it issues."""
    from .launch import device, world_devices
    from .mesh import make_mesh

    n = len(devices if devices is not None else world_devices())
    tp = 2 if n >= 2 else 1  # tiny() has n_head=4: tp=2 divides
    dp = 2 if n >= 4 else 1
    config = GPT2Config.tiny()
    ids = np.random.default_rng(0).integers(0, config.vocab_size, size=(4, 8),
                                            dtype=np.int32)

    def fn(ids):
        mesh = make_mesh(dp=dp, tp=tp)
        if not mesh.contains:
            return None
        train_step, init_state = make_train_step(config, mesh)
        batch = torch.from_numpy(ids).to(device())
        return float(train_step(init_state(0), batch, batch)[1])

    return fn, (ids,)


def run_train_loop(config: Any, steps: int, seq: int, seed: int = 0,
                   ckpt: Optional[str] = None,
                   path: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One rank of the ``train`` command (every rank of the world runs
    it), the JAX CLI's ``_run_train_loop`` for every path: the path's
    mesh, step and batch size (:func:`train_setup` with the keywords of
    ``path``: ``pp``, ``microbatches``, ``remat``, ``scan``, ``routed``,
    ``capacity_factor``), the state from ``seed`` or resumed from
    ``ckpt`` when it exists, ``steps`` steps on the synthetic batch
    (:func:`train_batch`, ``seq`` tokens), and the state saved to
    ``ckpt``.  Returns what the command prints: ``stdout`` (a ``step N:
    loss X`` line per step), and ``resumed`` / ``saved`` (its notes, or
    None)."""
    import os

    from ..utils.checkpoint import load_state, save_state
    from .launch import device

    world = dist.get_world_size() if dist.is_initialized() else 1
    train_step, init_state, batch = train_setup(config, world, **(path or {}))
    state = init_state(seed)
    out: Dict[str, Any] = {"stdout": [], "resumed": None, "saved": None}
    if ckpt and os.path.exists(ckpt):
        state = load_state(ckpt, state)
        out["resumed"] = f"resumed from {ckpt} at step {state.step}"
    ids, targets = (torch.from_numpy(a).to(device())
                    for a in train_batch(batch, seq, config.vocab_size))
    for _ in range(steps):
        state, loss = train_step(state, ids, targets)
        out["stdout"].append(f"step {state.step}: loss {float(loss):.4f}")
    if ckpt:
        out["saved"] = f"saved {save_state(state, ckpt)}"
    return out


def gather_params(state: TrainState) -> Dict[str, np.ndarray]:
    """The whole params of a sharded state as float32 numpy arrays on
    every rank of its layout's group (a collective over the sharded axes;
    of a staged layout, over the stages too): copies, which later steps
    leave as they are."""
    from .collectives import gather_objects

    lay = state.layout
    out = {k: lay.shardings[k].gather(state.params[k].detach()).to(
               "cpu", torch.float32, copy=True).numpy()
           for k in sorted(state.params)}
    if lay.staged:
        for part in gather_objects(out, lay.group):
            out.update(part)
    return out


__all__ = [
    "ADAMW", "TrainState", "collective_probe", "gather_params", "make_eval_step",
    "make_step_from_loss", "make_train_step", "run_train_loop", "train_batch",
    "train_setup",
]
