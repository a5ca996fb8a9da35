"""Entry points that run one parallel path on every rank of a world.

:func:`.launch.spawn` pickles its function by import path, so the
functions a world runs live here, in the package, and take and return
plain data (numpy arrays, configs, numbers).  :func:`run_legs` runs a
list of legs in order on every rank and returns rank 0's results: one
world (one spawn) serves every case of a caller.  Each leg builds its own
mesh over the first ranks of the world (every rank calls
:func:`.mesh.make_mesh`; a rank outside the mesh returns None), and a leg
that refuses its arguments with ``ValueError`` on every rank (a head
count that does not divide, a mesh larger than the world) gives
``{"ValueError": message}`` in its place.
"""

from __future__ import annotations

import functools
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import kernels
from .launch import device
from .mesh import make_axes_mesh, make_mesh
from .sharding import Sharding


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device())


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy() if t.is_floating_point() \
        else t.detach().cpu().numpy()


def train(config: Any, axes: Dict[str, int], params: Dict[str, np.ndarray],
          ids: np.ndarray, targets: np.ndarray, steps: int,
          seq_parallel: bool = False, remat: bool = False,
          scan: bool = False) -> Optional[Dict[str, Any]]:
    """GPT-2 from the whole ``params`` on a mesh of ``axes``: the shard
    shapes of this rank's blocks, the sharded forward's global logits
    (``make_eval_step``, before any step), ``steps`` train steps' losses,
    and the whole params after them."""
    from .train import gather_params, make_eval_step, make_train_step

    mesh = make_mesh(**axes)
    if not mesh.contains:
        return None
    step, init = make_train_step(config, mesh, seq_parallel=seq_parallel,
                                 remat=remat, scan=scan)
    state = init(params=params)
    ids_t, tgt_t = _t(ids), _t(targets)
    out: Dict[str, Any] = {
        "shard_shapes": {k: tuple(v.shape) for k, v in state.params.items()},
    }
    if not scan:
        logits = make_eval_step(config, mesh, seq_parallel)(state.params, ids_t)
        out["logits"] = _np(logits)
    kernels.reset_launches()
    losses = []
    for _ in range(steps):
        state, loss = step(state, ids_t, tgt_t)
        losses.append(float(loss))
    out["launches"] = _ran()
    out["losses"] = losses
    out["step"] = state.step
    out["params"] = gather_params(state)
    return out


def resume(config: Any, axes: Dict[str, int], params: Dict[str, np.ndarray],
           ids: np.ndarray, targets: np.ndarray,
           other_configs: Sequence[Any] = ()) -> Optional[Dict[str, Any]]:
    """Two steps, save, load into a fresh state, two more steps; beside
    four uninterrupted steps from the same params.  For each of
    ``other_configs``, the refusal of loading the checkpoint into its
    fresh state (None if it loaded).  Every rank of the world must be in
    the mesh."""
    from ..utils.checkpoint import load_state, save_state
    from .train import make_train_step

    mesh = make_mesh(**axes)
    step, init = make_train_step(config, mesh)
    ids_t, tgt_t = _t(ids), _t(targets)
    with tempfile.TemporaryDirectory(prefix="dls_ckpt_") as tmp:
        # every rank must write the same directory: rank 0's, broadcast
        path = _shared_dir(tmp)
        state = init(params=params)
        for _ in range(2):
            state, _ = step(state, ids_t, tgt_t)
        save_state(state, path)
        resumed = load_state(path, init(params=params))
        restored_step = resumed.step
        got = []
        for _ in range(2):
            resumed, loss = step(resumed, ids_t, tgt_t)
            got.append(float(loss))
        ref = init(params=params)
        want = []
        for _ in range(4):
            ref, loss = step(ref, ids_t, tgt_t)
            want.append(float(loss))
        out = {"resumed": got, "uninterrupted": want,
               "restored_step": restored_step}
        out["refusals"] = []
        for other in other_configs:
            _, other_init = make_train_step(other, mesh)
            try:
                load_state(path, other_init())
                out["refusals"].append(None)
            except ValueError as e:
                out["refusals"].append(str(e))
        _barrier()
    return out


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def _shared_dir(tmp: str) -> str:
    """Rank 0's ``tmp`` on every rank (one host: one file system)."""
    import torch.distributed as dist

    box = [tmp]
    if dist.is_initialized():
        dist.broadcast_object_list(box, src=0)
    return box[0] + "/ckpt"


def attention(kind: str, q: np.ndarray, k: np.ndarray, v: np.ndarray,
              sp: int, causal: bool = True) -> Optional[np.ndarray]:
    """``ring_attention_sharded`` (``kind="ring"``) or
    ``ulysses_attention_sharded`` over an ``sp`` axis: the global output."""
    from .ring_attention import ring_attention_sharded
    from .ulysses import ulysses_attention_sharded

    mesh = make_mesh(sp=sp)
    if not mesh.contains:
        return None
    q, k, v = (_t(a) for a in (q, k, v))
    if kind == "ring":
        return _np(ring_attention_sharded(q, k, v, mesh))
    return _np(ulysses_attention_sharded(q, k, v, mesh, causal=causal))


def decode(config: Any, axes: Dict[str, int], params: Dict[str, np.ndarray],
           ids: np.ndarray, max_new_tokens: int, **kw
           ) -> Optional[Dict[str, Any]]:
    """``generate_sharded`` from the whole ``params``: the tokens, and the
    shape of this rank's blocks and of its KV cache's heads."""
    from ..models.gpt2 import params_from_numpy
    from .blocks import kv_heads
    from .decode import generate_sharded, shard_decode_params

    mesh = make_mesh(**axes)
    if not mesh.contains:
        return None
    whole = params_from_numpy(params, device(), config.dtype)
    local = shard_decode_params(mesh, whole, config)
    tokens = generate_sharded(whole, _t(ids), config, mesh, max_new_tokens,
                              **kw)
    return {"tokens": _np(tokens),
            "shard_shapes": {k: tuple(v.shape) for k, v in local.items()},
            "kv_heads_local": kv_heads(config) // mesh.axis_size("tp")}


def _ran() -> Dict[str, int]:
    """This rank's flash, LayerNorm and RMSNorm launches that ran since the
    counts were set to 0 (all 0 on the CPU, where the plain versions run)."""
    from ..ops import attention, norms

    return {k: kernels.ran(k)
            for k in (attention.KERNEL, norms.LN_KERNEL, norms.RMS_KERNEL)}


class KeepGrads(torch.optim.Optimizer):
    """An optimizer that keeps the gradients a training step hands it
    (after the step's own reductions) and changes no param: one step with
    it reads the step's gradients."""

    def __init__(self, params):
        super().__init__(params, {})
        self.grads: List[torch.Tensor] = []

    def step(self, closure=None):
        self.grads = [p.grad.detach().clone()
                      for g in self.param_groups for p in g["params"]]


def _step_grads(make_step, params, ids, targets
                ) -> Tuple[Dict[str, torch.Tensor], float]:
    """This rank's gradients of one step of ``make_step(optimizer=...)``
    from the whole ``params``, by param name, and the step's loss."""
    step, init = make_step(optimizer=KeepGrads)
    state = init(params=params)
    _, loss = step(state, ids, targets)
    return dict(zip(state.params, state.opt_state.grads)), float(loss)


def expert(config: Any, axes: Dict[str, int], params: Dict[str, np.ndarray],
           ids: np.ndarray, targets: np.ndarray, steps: int,
           remat: bool = False, routed: bool = False,
           capacity_factor: float = 2.0, stats_capacity: Sequence[float] = (),
           grads: bool = False) -> Optional[Dict[str, Any]]:
    """Mixtral from the whole per-expert ``params`` on a ``(dp, ep)`` mesh
    of ``axes``: the shard shapes of this rank's blocks, the sharded
    forward's global logits (before any step), ``forward_ep_stats`` at
    each of ``stats_capacity`` (the global logits and dropped-slot count),
    with ``grads`` the whole gradients of a first step (the step's own,
    averaged over ``dp``), ``steps`` train
    steps' losses and this rank's kernel launches over them, and the
    whole stacked params after them."""
    from .collectives import all_gather_dim
    from .expert import forward_ep, forward_ep_stats, make_moe_train_step
    from .train import gather_params

    mesh = make_axes_mesh(**axes)
    if not mesh.contains:
        return None
    step, init = make_moe_train_step(config, mesh, remat=remat, routed=routed,
                                     capacity_factor=capacity_factor)
    state = init(params=params)
    data = Sharding(mesh, ("dp", None))
    ids_t, tgt_t = _t(ids), _t(targets)
    mine = data.shard(ids_t)
    out: Dict[str, Any] = {
        "shard_shapes": {k: tuple(v.shape) for k, v in state.params.items()}}
    with torch.no_grad():
        logits = forward_ep(state.params, mine, config, routed=routed,
                            capacity_factor=capacity_factor, mesh=mesh)
        out["logits"] = _np(all_gather_dim(logits, mesh.group("dp"), 0))
        out["stats"] = []
        for cf in stats_capacity:
            lg, st = forward_ep_stats(state.params, mine, config, cf, mesh=mesh)
            out["stats"].append({
                "logits": _np(all_gather_dim(lg, mesh.group("dp"), 0)),
                "dropped_slots": int(st["dropped_slots"]),
                "total_slots": int(st["total_slots"]),
                "capacity": st["capacity"]})
    if grads:
        g, _ = _step_grads(functools.partial(
            make_moe_train_step, config, mesh, remat=remat, routed=routed,
            capacity_factor=capacity_factor), params, ids_t, tgt_t)
        sh = state.layout.shardings
        out["grads"] = {k: _np(sh[k].gather(v)) for k, v in sorted(g.items())}
    kernels.reset_launches()
    losses = []
    for _ in range(steps):
        state, loss = step(state, ids_t, tgt_t)
        losses.append(float(loss))
    out["launches"] = _ran()
    out["losses"] = losses
    out["step"] = state.step
    out["params"] = gather_params(state)
    return out


def _count_p2p(counts: Dict[str, int]):
    """``dist.batch_isend_irecv`` counting the sends and receives it is
    given into ``counts``."""
    import torch.distributed as dist

    real = dist.batch_isend_irecv

    def counted(ops):
        for op in ops:
            counts["send" if op.op is dist.isend else "recv"] += 1
        return real(ops)

    return counted


def pipeline(config: Any, stages: int, microbatches: int,
             params: Dict[str, np.ndarray], ids: np.ndarray,
             targets: Optional[np.ndarray] = None, remat: bool = False,
             grads: bool = False, steps: int = 0) -> Optional[Dict[str, Any]]:
    """``pipeline_forward`` of the whole ``params`` over a ``(pp,)`` mesh of
    ``stages`` ranks: its logits, every stage rank's hop sends and
    receives (``hops``, forward and backward), with ``grads`` the loss
    and the whole gradients of a first training step (each stage's
    layers, the shared params' parts summed over ``pp``), and
    ``steps`` losses of ``make_pp_train_step`` from the same params with
    this rank's kernel launches over them."""
    from unittest import mock

    import torch.distributed as dist

    from ..models.gpt2 import params_from_numpy
    from .collectives import gather_objects
    from .pipeline_pp import make_pp_train_step, pipeline_forward, stage_param_names

    mesh = make_axes_mesh(pp=stages)
    if not mesh.contains:
        return None
    ids_t = _t(ids)
    counts = {"send": 0, "recv": 0}
    out: Dict[str, Any] = {}
    with mock.patch.object(dist, "batch_isend_irecv", _count_p2p(counts)):
        if grads:
            g, out["loss"] = _step_grads(functools.partial(
                make_pp_train_step, config, mesh, microbatches, remat=remat),
                params, ids_t, _t(targets))
            parts = gather_objects({k: _np(v) for k, v in g.items()},
                                   mesh.group("pp"))
            out["grads"] = {k: v for part in parts for k, v in part.items()}
        else:
            names = stage_param_names(config, stages, mesh.axis_index("pp"))
            local = params_from_numpy({k: params[k] for k in names}, device(),
                                      config.dtype)
            with torch.no_grad():
                out["logits"] = _np(pipeline_forward(local, ids_t, config, mesh,
                                                     microbatches, remat=remat))
    out["hops"] = gather_objects(counts, mesh.group("pp"))
    if steps:
        step, init = make_pp_train_step(config, mesh, microbatches, remat=remat)
        state = init(params=params)
        kernels.reset_launches()
        losses = []
        for _ in range(steps):
            state, loss = step(state, ids_t, _t(targets))
            losses.append(float(loss))
        out["launches"] = _ran()
        out["losses"] = losses
    return out


def _path_mesh(axes: Dict[str, int]):
    return (make_axes_mesh(**axes) if "ep" in axes or "pp" in axes
            else make_mesh(**axes))


def _path_step(config: Any, axes: Dict[str, int], mesh, microbatches: int):
    """The training step of the path ``axes`` names: with ``ep`` the dp x
    ep MoE step, with ``pp`` the pipeline, else GPT-2 dp x tp."""
    if "ep" in axes:
        from .expert import make_moe_train_step

        return make_moe_train_step(config, mesh)
    if "pp" in axes:
        from .pipeline_pp import make_pp_train_step

        return make_pp_train_step(config, mesh, microbatches)
    from .train import make_train_step

    return make_train_step(config, mesh)


def reshard(config: Any, save: Dict[str, int], loads: Sequence[Dict[str, int]],
            params: Dict[str, np.ndarray], ids: np.ndarray, targets: np.ndarray,
            steps: int = 2, microbatches: int = 2) -> Dict[str, Any]:
    """A checkpoint written on one mesh and read on others: ``steps``
    steps from ``params`` on the mesh of ``save`` (axes: with ``ep`` the dp
    x ep MoE step, with ``pp`` the pipeline, else dp x tp), the state
    saved, then ``steps`` more; for each of ``loads``, a fresh state of
    another seed on its mesh restored from the checkpoint, then ``steps``
    steps.  Returns a row per mesh: the whole params at the checkpoint,
    the losses after it and (loads) the restored step.  Every rank builds
    every mesh; a rank outside one sits its part out."""
    from ..utils.checkpoint import load_state, save_state
    from .train import gather_params

    every = (save, *loads)
    meshes = [_path_mesh(axes) for axes in every]
    ids_t, tgt_t = _t(ids), _t(targets)
    rows = []
    with tempfile.TemporaryDirectory(prefix="dls_ckpt_") as tmp:
        path = _shared_dir(tmp)
        for i, (axes, mesh) in enumerate(zip(every, meshes)):
            if mesh.contains:
                step, init = _path_step(config, axes, mesh, microbatches)
                if i == 0:
                    state = init(params=params)
                    for _ in range(steps):
                        state, _ = step(state, ids_t, tgt_t)
                    save_state(state, path)
                else:
                    state = load_state(path, init(seed=1))
                row = {"step": state.step, "params": gather_params(state),
                       "losses": [float(step(state, ids_t, tgt_t)[1])
                                  for _ in range(steps)]}
                rows.append(row)
            _barrier()
    return {"rows": rows}


LEGS = {"train": train, "resume": resume, "attention": attention,
        "decode": decode, "expert": expert, "pipeline": pipeline,
        "reshard": reshard}


def run_legs(legs: Sequence[Tuple[str, Dict[str, Any]]]) -> List[Any]:
    """Run each ``(name, kwargs)`` leg of :data:`LEGS` in order on this
    rank; rank 0's results are what :func:`.launch.spawn` returns."""
    out = []
    for name, kw in legs:
        try:
            out.append(LEGS[name](**kw))
        except ValueError as e:
            out.append({"ValueError": str(e)})
    return out


__all__ = ["KeepGrads", "LEGS", "attention", "decode", "expert", "pipeline",
           "reshard", "resume", "run_legs", "train"]
