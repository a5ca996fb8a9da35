"""Parameter and training-state checkpointing.

PyTorch port of ``distributed_llm_scheduler_tpu.utils.checkpoint``.  The
JAX package saves param pytrees with Orbax (a directory) or as a plain
``numpy .npz``; a ``.npz`` written by either package loads in the other,
array for array.  The card host has no Orbax, so a path that is not
``.npz`` becomes a ``torch.distributed.checkpoint`` directory here.

A training state (:class:`..parallel.train.TrainState`: this rank's param
blocks, their Adam moments and the step) is saved the same way, each
tensor under a key that names its leaf and, for a block of a tensor
sharded over ``tp``, the block's index (``params/h0_attn_qkv_w@tp1``): the
ranks that hold the same block (over ``dp``) write it once, and every
rank reads back its own.  :func:`load_state` takes the layout from its
target, a fresh state of the same model on the same mesh, and refuses a
checkpoint whose leaves differ in number or shape with the JAX package's
messages, before anything is read.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def _is_npz(path: str, use_npz: Optional[bool]) -> bool:
    return path.endswith(".npz") if use_npz is None else use_npz


def _single() -> bool:
    """No process group: the checkpoint is one process's."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized())


def save_params(params: Dict[str, Any], path: str,
                use_npz: Optional[bool] = None) -> str:
    """Save a flat param dict: a ``.npz`` file (float32 and integer
    arrays as the JAX package writes them), or a
    ``torch.distributed.checkpoint`` directory for any other path.
    Returns the path written."""
    if _is_npz(path, use_npz):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        arrays = {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                      else np.asarray(v)) for k, v in params.items()}
        np.savez(path, **arrays)
        return path
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    dcp.save({k: torch.as_tensor(v) for k, v in params.items()},
             checkpoint_id=path, no_dist=_single())
    return path


def _metadata(path: str) -> Dict[str, Any]:
    """Key -> tensor metadata (``size``, ``properties.dtype``) of a
    ``torch.distributed.checkpoint`` directory."""
    from torch.distributed.checkpoint import FileSystemReader

    return dict(FileSystemReader(path).read_metadata().state_dict_metadata)


def load_params(path: str, use_npz: Optional[bool] = None
                ) -> Dict[str, Any]:
    """Load what :func:`save_params` (or the JAX package's) wrote: numpy
    arrays from a ``.npz``, CPU tensors from a checkpoint directory."""
    if _is_npz(path, use_npz):
        with np.load(path) as f:
            return {k: f[k] for k in f.files}
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    out = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
           for k, m in _metadata(path).items()}
    dcp.load(out, checkpoint_id=path, no_dist=_single())
    return out


def _state_tensors(state: Any, mesh: Any = None) -> Dict[str, torch.Tensor]:
    """The state's tensors by checkpoint key: ``params/<name>``,
    ``opt/<name>/exp_avg`` and ``/exp_avg_sq`` (``@tp<i>`` on a block of a
    tensor sharded over tp), and ``step``."""
    from ..parallel.sharding import param_spec

    def suffix(name: str) -> str:
        if mesh is None or mesh.axis_size("tp") == 1:
            return ""
        sharded = any(e == "tp" or (isinstance(e, tuple) and "tp" in e)
                      for e in param_spec(name))
        return f"@tp{mesh.coords['tp']}" if sharded else ""

    out: Dict[str, torch.Tensor] = {}
    opt = state.opt_state
    for name, p in state.params.items():
        tag = suffix(name)
        out[f"params/{name}{tag}"] = p.data
        moments = opt.state[p]
        out[f"opt/{name}/exp_avg{tag}"] = moments["exp_avg"]
        out[f"opt/{name}/exp_avg_sq{tag}"] = moments["exp_avg_sq"]
    out["step"] = torch.tensor([state.step], dtype=torch.int64)
    return out


def _leaf(key: str) -> str:
    return key.split("@", 1)[0]


def save_state(state: Any, path: str, mesh: Any = None) -> str:
    """Save a whole training state (params, optimizer moments and step)
    as a ``torch.distributed.checkpoint`` directory; with a sharded state,
    every rank of the world calls it with its ``mesh``.  Returns the
    absolute path."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    dcp.save(_state_tensors(state, mesh), checkpoint_id=path,
             no_dist=_single())
    return path


def load_state(path: str, target: Any, mesh: Any = None) -> Any:
    """Restore a training state saved by :func:`save_state` into
    ``target``, a fresh state of the same structure (e.g.
    ``init_state(seed)``) on the same mesh: it supplies the layout and
    this rank's blocks, which are overwritten in place (params, their
    optimizer's moments and Adam step counts, the step).  Raises
    ``ValueError`` when the checkpoint's leaves differ from the target's
    in number or in shape: a wrong-config resume must fail loudly, not
    train on misrestored weights."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    mine = _state_tensors(target, mesh)
    meta = _metadata(path)
    saved_leaves = {_leaf(k) for k in meta}
    target_leaves = {_leaf(k) for k in mine}
    if len(saved_leaves) != len(target_leaves):
        raise ValueError(
            f"checkpoint at {path} has {len(saved_leaves)} leaves; the target "
            f"state has {len(target_leaves)} — wrong model/optimizer config?"
        )
    for key in sorted(mine):
        t_shape = tuple(mine[key].shape)
        r_shape = tuple(meta[key].size) if key in meta else None
        if t_shape != r_shape:
            raise ValueError(
                f"checkpoint leaf {key} has shape {r_shape}; target "
                f"expects {t_shape} — wrong model config?"
            )
    dcp.load(mine, checkpoint_id=path, no_dist=_single())
    target.step = int(mine["step"][0])
    for moments in target.opt_state.state.values():
        moments["step"].fill_(float(target.step))
    return target


__all__ = ["load_params", "load_state", "save_params", "save_state"]
