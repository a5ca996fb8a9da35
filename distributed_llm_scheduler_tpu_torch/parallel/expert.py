"""Expert parallelism: Mixtral experts sharded over an ``ep`` mesh axis.

PyTorch port of ``distributed_llm_scheduler_tpu.parallel.expert``.  The
JAX package stacks each layer's experts on a leading dim, shards that dim
over ``ep`` with a ``NamedSharding`` and lets XLA derive the collectives
(``expert.py:10-24`` there).  Here each rank of a ``(dp, ep)``
:class:`.mesh.Mesh` holds its ``E / ep`` experts of every
``l{i}_moe_gate/up/down`` (``(E, d, f)`` / ``(E, f, d)`` stacked) and its
``B / dp`` rows of the batch, and the collectives are written out
(:mod:`.collectives`):

* **dense dispatch** (:func:`_moe_stacked`): every local expert runs on
  every local token; the combine over the local experts is a partial sum,
  summed over ``ep`` (:func:`.collectives.reduce_from_group`: the psum
  XLA derives).  The router and the gates are computed on every ep rank,
  but each rank backpropagates through its own experts' columns only, so
  the MoE input and the router weight enter through
  :func:`.collectives.copy_to_group` (their gradients summed over ``ep``);
* **routed dispatch** (:func:`moe_routed_stacked`): the JAX function is
  written in the global view (``N = B*T`` over every dp shard, capacity
  ``C = moe_capacity(N, ...)``, each assignment's slot a cumsum over the
  global (token, slot) order).  A rank places its tokens from one
  all-gather of the per-expert counts over ``dp`` (the offsets of the dp
  shards before it), writes its tokens into the slots of its own experts,
  and sums that ``(E / ep, C, D)`` buffer over ``dp`` (each slot has one
  writer, so the sum is the global buffer's block, exactly).  The local
  experts run on the whole block; each rank gathers its own tokens' slots
  of its own experts, and the partial outputs are summed over ``ep``.
  The buffer's backward is the identity: a slot is read back only by the
  token that wrote it, on the rank that wrote it.

Both are the JAX layout's numbers: the buffer sharded over ``ep`` and
replicated over ``dp``, the tokens sharded over ``dp``.  The training
step (:func:`make_moe_train_step`) averages the gradients over ``dp``; the
expert blocks and the replicated params then hold the global step's
update.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..models import llama, mixtral
from ..models.mixtral import MixtralConfig
from .collectives import all_gather_dim, all_reduce_, copy_to_group, reduce_from_group
from .sharding import Sharding, Spec

_EXPERT_SUFFIXES = ("w_gate", "w_up", "w_down")


def _stack(arrays):
    return torch.stack(arrays) if torch.is_tensor(arrays[0]) else np.stack(arrays)


def _is_expert(name: str) -> bool:
    return "_e" in name and any(name.endswith(s) for s in _EXPERT_SUFFIXES)


def stack_expert_params(params: Dict[str, Any], config: MixtralConfig
                        ) -> Dict[str, Any]:
    """Per-expert ``l{i}_e{e}_w_*`` arrays -> stacked ``l{i}_moe_*`` (numpy
    arrays or tensors): the task-graph layout to the expert-parallel one,
    a pure re-index."""
    out = {k: v for k, v in params.items() if not _is_expert(k)}
    for i in range(config.n_layers):
        for suffix in _EXPERT_SUFFIXES:
            out[f"l{i}_moe_{suffix[2:]}"] = _stack(
                [params[f"l{i}_e{e}_{suffix}"] for e in range(config.n_experts)])
    return out


def unstack_expert_params(params: Dict[str, Any], config: MixtralConfig
                          ) -> Dict[str, Any]:
    """Inverse of :func:`stack_expert_params` (checkpoint interchange)."""
    out = {k: v for k, v in params.items() if "_moe_" not in k}
    for i in range(config.n_layers):
        for suffix in _EXPERT_SUFFIXES:
            stacked = params[f"l{i}_moe_{suffix[2:]}"]
            for e in range(config.n_experts):
                out[f"l{i}_e{e}_{suffix}"] = stacked[e]
    return out


def _groups(mesh):
    """(dp group, ep group, dp size, this rank's ep index)."""
    if mesh is None:
        return None, None, 1, 0
    return (mesh.group("dp"), mesh.group("ep"), mesh.axis_size("dp"),
            mesh.axis_index("ep"))


def _moe_stacked(block_params: Dict[str, Any], x, config: MixtralConfig,
                 mesh=None):
    """Router + this rank's stacked experts (SwiGLU) + combine over
    UNPREFIXED names: the one implementation of the stacked MoE math (cf.
    ``models.mixtral._moe`` for the per-expert layout).  With a mesh the
    local experts' sum is summed over ``ep``."""
    _, ep_group, _, e_idx = _groups(mesh)
    x = copy_to_group(x, ep_group)
    router = copy_to_group(block_params["router"], ep_group)
    gate, up, down = (block_params["moe_gate"], block_params["moe_up"],
                      block_params["moe_down"])
    lo = e_idx * gate.shape[0]
    w = mixtral.router_weights(x, router, config.top_k)[..., lo:lo + gate.shape[0]]
    g = F.silu(torch.einsum("btd,edf->ebtf", x, gate))
    u = torch.einsum("btd,edf->ebtf", x, up)
    y = torch.einsum("ebtf,efd->ebtd", g * u, down)
    out = torch.einsum("bte,ebtd->btd", w, y).to(x.dtype)
    return reduce_from_group(out, ep_group)


def moe_block_stacked(params: Dict[str, Any], x, layer: int,
                      config: MixtralConfig, mesh=None):
    """Layer-prefixed wrapper over :func:`_moe_stacked` (equal to
    ``models.mixtral``'s per-expert MoE: the same math, reassociated)."""
    p = f"l{layer}_"
    keys = ("router", "moe_gate", "moe_up", "moe_down")
    return _moe_stacked({k: params[p + k] for k in keys}, x, config, mesh)


def _route_global(xf, router, k: int, C: int, E: int, mesh):
    """``mixtral.route_topk``'s metadata for this rank's tokens, with each
    assignment's slot in the GLOBAL (token, slot) order: its position
    among this rank's assignments to its expert plus the assignments of
    the dp shards before it (one all-gather of the (E,) counts)."""
    N = xf.shape[0]
    # a capacity no assignment reaches: the local positions, unclamped
    route = mixtral.route_topk(xf, router, k, N * k + 1, xf.dtype)
    flat_e, local_pos = route["flat_e"].long(), route["pos"].long()
    dp_group, _, _, _ = _groups(mesh)
    if dp_group is not None:
        counts = torch.bincount(flat_e, minlength=E)
        every = all_gather_dim(counts[None], dp_group, 0)  # (dp, E)
        local_pos = local_pos + every[:mesh.axis_index("dp")].sum(0)[flat_e]
    keep = local_pos < C
    return {"top_w": route["top_w"], "flat_e": route["flat_e"],
            "pos": torch.where(keep, local_pos, C - 1).int(), "keep": keep}


def _local_route(route: Dict[str, Any], lo: int, n: int) -> Dict[str, Any]:
    """``route`` restricted to the experts ``lo .. lo + n - 1``, renumbered
    from 0 (other experts' assignments kept out)."""
    flat_e = route["flat_e"].long()
    mine = route["keep"] & (flat_e >= lo) & (flat_e < lo + n)
    return {"top_w": route["top_w"], "keep": mine, "pos": route["pos"],
            "flat_e": (flat_e - lo).clamp(0, n - 1)}


def moe_routed_stacked(block_params: Dict[str, Any], x, config: MixtralConfig,
                       capacity_factor: float = 2.0, mesh=None,
                       with_stats: bool = False):
    """Routed (capacity-buffer) MoE over this rank's stacked experts, the
    JAX global view's numbers on a ``(dp, ep)`` mesh (module doc); x is
    this rank's (B / dp, T, D) rows.  Returns ``out`` or ``(out, stats)``
    with ``with_stats`` (``dropped_slots`` summed over the dp shards).
    ``mesh=None``: one device."""
    B, T, D = x.shape
    E, k = config.n_experts, config.top_k
    dp_group, ep_group, ndp, e_idx = _groups(mesh)
    N_local = B * T
    C = mixtral.moe_capacity(N_local * ndp, E, k, capacity_factor)
    x = copy_to_group(x, ep_group)
    router = copy_to_group(block_params["router"], ep_group)
    xf = x.reshape(N_local, D)
    route = _route_global(xf, router, k, C, E, mesh)

    gate, up, down = (block_params["moe_gate"], block_params["moe_up"],
                      block_params["moe_down"])
    mine = _local_route(route, e_idx * gate.shape[0], gate.shape[0])
    # this rank's tokens in its experts' slots, then every dp shard's
    buf = reduce_from_group(
        mixtral.routed_dispatch(xf, mine, gate.shape[0], C), dp_group)
    h = F.silu(torch.bmm(buf, gate)) * torch.bmm(buf, up)
    out_buf = torch.bmm(h, down)  # (E / ep, C, D)
    out = reduce_from_group(mixtral.routed_collect(out_buf, mine, N_local),
                            ep_group).reshape(B, T, D)
    if with_stats:
        st = mixtral.route_stats(route, C)
        all_reduce_(st["dropped_slots"], dp_group)
        st["total_slots"] *= ndp
        return out, st
    return out


_EP_BLOCK_KEYS = (
    "attn_norm_g", "wq", "wk", "wv", "wo", "ffn_norm_g", "router",
    "moe_gate", "moe_up", "moe_down",
)


def _make_ep_block(config: MixtralConfig, routed: bool = False,
                   capacity_factor: float = 2.0, mesh=None,
                   stats_sink: Optional[list] = None
                   ) -> Callable[[Dict[str, Any], Any], Any]:
    """One EP layer over unprefixed params, the rematerialization unit.
    ``routed=True`` swaps dense dispatch for :func:`moe_routed_stacked`;
    ``stats_sink`` (routed only): a list the block appends each layer's
    drop stats to, so the plain and the stats forward share one body."""

    def block(block_params: Dict[str, Any], x):
        h = mixtral.rms_norm(x, block_params["attn_norm_g"], config.rms_eps)
        h = mixtral.gqa_attention(
            h, block_params["wq"], block_params["wk"], block_params["wv"],
            block_params["wo"], config.n_heads, config.n_kv_heads,
            config.rope_theta,
        )
        x2 = mixtral.residual_add(x, h)
        h = mixtral.rms_norm(x2, block_params["ffn_norm_g"], config.rms_eps)
        if routed:
            if stats_sink is not None:
                moe, st = moe_routed_stacked(block_params, h, config,
                                             capacity_factor, mesh=mesh,
                                             with_stats=True)
                stats_sink.append(st)
            else:
                moe = moe_routed_stacked(block_params, h, config,
                                         capacity_factor, mesh=mesh)
        else:
            moe = _moe_stacked(block_params, h, config, mesh)
        return mixtral.residual_add(x2, moe)

    return block


def forward_ep(params: Dict[str, Any], input_ids, config: MixtralConfig,
               remat: bool = False, routed: bool = False,
               capacity_factor: float = 2.0, mesh=None,
               _stats_sink: Optional[list] = None):
    """Mixtral forward over stacked expert params (the EP train and eval
    path), gradients flowing: this rank's param blocks and token rows in,
    its rows' logits out.  The Llama backbone (``models.llama.backbone``)
    over the stacked-expert block; ``remat=True`` checkpoints each layer (the block's
    collectives run again in the recompute, on every rank alike);
    ``routed=True`` uses :func:`moe_routed_stacked`."""
    if _stats_sink is not None and remat:
        # the recompute replays the block; its appends would double
        raise ValueError("stats collection is incompatible with remat")
    block = _make_ep_block(config, routed, capacity_factor, mesh, _stats_sink)
    return llama.backbone(params, input_ids, config,
                          lambda bp, x, cfg: block(bp, x), _EP_BLOCK_KEYS,
                          remat=remat)


def loss_fn_ep(params, input_ids, targets, config: MixtralConfig,
               remat: bool = False, routed: bool = False,
               capacity_factor: float = 2.0, mesh=None):
    """This rank's mean next-token cross-entropy through :func:`forward_ep`."""
    return mixtral.nll_loss(
        forward_ep(params, input_ids, config, remat=remat, routed=routed,
                   capacity_factor=capacity_factor, mesh=mesh), targets)


def forward_ep_stats(params: Dict[str, Any], input_ids, config: MixtralConfig,
                     capacity_factor: float = 2.0, mesh=None):
    """Routed-EP forward with the drop statistics summed over the layers
    (and the dp shards): ``(logits, {dropped_slots, total_slots,
    capacity})``, through the same block body as :func:`forward_ep`."""
    sink: list = []
    logits = forward_ep(params, input_ids, config, routed=True,
                        capacity_factor=capacity_factor, mesh=mesh,
                        _stats_sink=sink)
    dropped = sum((st["dropped_slots"].int() for st in sink),
                  torch.zeros((), dtype=torch.int32, device=logits.device))
    return logits, {
        "dropped_slots": dropped,
        "total_slots": sum(st["total_slots"] for st in sink),
        "capacity": sink[-1]["capacity"] if sink else None,
    }


# -- sharding rules ----------------------------------------------------------

def ep_param_spec(name: str) -> Spec:
    """Stacked expert tensors shard their expert dim over ``ep``; everything
    else (attention, norms, router, embeddings) is replicated."""
    if "_moe_" in name:
        return ("ep",)
    return ()


def ep_param_shardings(mesh, params: Iterable[str]) -> Dict[str, Sharding]:
    """Each param's :class:`.sharding.Sharding` on ``mesh`` under
    :func:`ep_param_spec`."""
    return {k: Sharding(mesh, ep_param_spec(k)) for k in params}


def shard_ep_params(mesh, params: Mapping[str, Any]) -> Dict[str, Any]:
    """This rank's blocks of a whole stacked param dict."""
    sh = ep_param_shardings(mesh, params)
    return {k: sh[k].shard(v) for k, v in params.items()}


def stacked_shapes(config: MixtralConfig) -> Dict[str, Tuple[int, ...]]:
    """The global shape of every stacked param (the MoE path's leaves)."""
    shapes = {k: s for k, (s, _) in mixtral.param_shapes(config).items()}
    out = {k: s for k, s in shapes.items() if not _is_expert(k)}
    for i in range(config.n_layers):
        for suffix in _EXPERT_SUFFIXES:
            out[f"l{i}_moe_{suffix[2:]}"] = (config.n_experts,
                                             *shapes[f"l{i}_e0_{suffix}"])
    return out


def _rank_params(mesh, config: MixtralConfig,
                 items: Iterable[Tuple[str, Any]], dev) -> Dict[str, torch.Tensor]:
    """This rank's stacked blocks from a stream of per-expert ``(name,
    array)`` in the initializer's order: each expert not its own dropped
    as it comes, so the whole model never sits on the device."""
    E = config.n_experts
    per = E // mesh.axis_size("ep")
    lo = mesh.axis_index("ep") * per
    out: Dict[str, torch.Tensor] = {}
    held: Dict[str, list] = {}
    for name, v in items:
        if _is_expert(name):
            layer, expert, suffix = name.split("_", 2)
            if not lo <= int(expert[1:]) < lo + per:
                continue
        t = (v if torch.is_tensor(v) else torch.from_numpy(np.array(v, np.float32))
             ).to(device=dev, dtype=config.dtype)
        if _is_expert(name):
            held.setdefault(f"{layer}_moe_{suffix[2:]}", []).append(t)
        else:
            out[name] = t.detach().clone()
    for key in list(held):  # each key's experts freed once stacked
        out[key] = torch.stack(held.pop(key))
    return {k: out[k] for k in stacked_shapes(config)}


def expert_mesh_axes(n_experts: int, n_devices: int) -> Tuple[int, int]:
    """``(dp, ep)`` of the ``train`` command's MoE mesh: the widest ``ep``
    that divides both the expert count and the device count, the other
    devices ``dp``."""
    ep = 1
    for cand in range(min(n_experts, n_devices), 0, -1):
        if n_experts % cand == 0 and n_devices % cand == 0:
            ep = cand
            break
    return n_devices // ep, ep


def make_moe_train_step(config: MixtralConfig, mesh,
                        optimizer: Optional[Callable[..., torch.optim.Optimizer]] = None,
                        learning_rate: float = 3e-4, remat: bool = False,
                        routed: bool = False, capacity_factor: float = 2.0):
    """dp x ep sharded Mixtral training step; returns ``(step, init)`` in
    the dp x tp step's contract (:func:`.train.make_train_step`):
    ``step(state, input_ids, targets) -> (state, loss)`` takes the global
    (B, T) batch (B divisible by dp) and updates ``state`` in place;
    ``init(seed=0, params=None)`` takes the whole params (per-expert
    ``l{i}_e{e}_w_*``, a mapping or a stream of ``(name, array)``; by
    default ``models.mixtral.init_params_numpy(config, seed)``) and keeps
    this rank's blocks.  The mesh has ``dp`` and ``ep`` axes, and ``ep``
    must divide ``n_experts``.  ``routed=True`` trains through the
    capacity-buffer dispatch (dropped assignments get zero gradient)."""
    from .launch import device
    from .sharding import FlatLayout
    from .train import make_step_from_loss

    ep = mesh.axis_size("ep")
    if config.n_experts % ep != 0:
        raise ValueError(f"ep={ep} must divide n_experts={config.n_experts}")
    optimizer = optimizer or functools.partial(
        torch.optim.AdamW, lr=learning_rate, weight_decay=0.01)
    dev = device()

    def loss_fn(params, input_ids, targets):
        return loss_fn_ep(params, input_ids, targets, config, remat, routed,
                          capacity_factor, mesh)

    def init_params(seed: int, params: Union[None, Mapping, Iterable]):
        if params is None:
            params = mixtral.init_params_numpy(config, seed)
        items = params.items() if isinstance(params, Mapping) else params
        return _rank_params(mesh, config, items, dev)

    shapes = stacked_shapes(config)
    return make_step_from_loss(
        loss_fn, init_params, optimizer,
        data_sharding=Sharding(mesh, ("dp", None)),
        grad_group=mesh.group("dp"),
        layout=FlatLayout(shapes, ep_param_shardings(mesh, shapes),
                          group=mesh.group(*mesh.axes)),
    )


__all__ = [
    "ep_param_shardings", "ep_param_spec", "expert_mesh_axes", "forward_ep",
    "forward_ep_stats", "loss_fn_ep", "make_moe_train_step",
    "moe_block_stacked", "moe_routed_stacked", "shard_ep_params",
    "stack_expert_params", "stacked_shapes", "unstack_expert_params",
]
