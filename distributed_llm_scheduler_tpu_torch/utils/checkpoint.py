"""Parameter and training-state checkpointing.

PyTorch port of ``distributed_llm_scheduler_tpu.utils.checkpoint``.  The
JAX package saves param pytrees with Orbax (a directory) or as a plain
``numpy .npz``; a ``.npz`` written by either package loads in the other,
array for array.  The card host has no Orbax, so a path that is not
``.npz`` becomes a ``torch.distributed.checkpoint`` directory here.

A training state (:class:`..parallel.train.TrainState`: this rank's param
blocks, their Adam moments and the step) is saved as the whole, flat
leaves the JAX package saves (``params/<name>``, ``opt/<name>/exp_avg``
and ``/exp_avg_sq``, ``step``), whatever the mesh: the state's layout
(:class:`..parallel.sharding.FlatLayout`) gathers each block to its leaf
(a dp x tp block over ``tp``, a stacked ``l{i}_moe_*`` over ``ep``), and
each pipeline stage writes its own layers.  Loading cuts every rank's
block back out, so a checkpoint written on one mesh loads on another: at
another ``tp``, ``ep`` or ``pp``, and a pipeline's into the dp x tp path.
:func:`load_state` takes the layout from its target, a fresh state of the
same model, and refuses a checkpoint whose leaves differ in number or
shape with the JAX package's messages, before anything is read.
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


def _leaf_keys(name: str):
    return (f"params/{name}", f"opt/{name}/exp_avg", f"opt/{name}/exp_avg_sq")


def _flat_tensors(state: Any) -> Dict[str, torch.Tensor]:
    """The state by whole-leaf key: each param and moment gathered from
    its blocks (a collective over the sharded axes, every rank's leaves in
    the same order), on the host."""
    lay, opt = state.layout, state.opt_state
    out: Dict[str, torch.Tensor] = {}
    for name in sorted(state.params):
        p, sh = state.params[name], lay.shardings[name]
        moments = opt.state[p]
        for key, t in zip(_leaf_keys(name), (p.data, moments["exp_avg"],
                                             moments["exp_avg_sq"])):
            out[key] = sh.gather(t).cpu()
    out["step"] = torch.tensor([state.step], dtype=torch.int64)
    return out


def save_state(state: Any, path: str) -> str:
    """Save a whole training state (params, optimizer moments and step)
    as a ``torch.distributed.checkpoint`` directory of whole leaves; with a
    sharded state, every rank of its layout's group calls it.  Returns the
    absolute path."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    group = state.layout.group
    dcp.save(_flat_tensors(state), checkpoint_id=path, process_group=group,
             no_dist=group is None)
    return path


def _check_shape(key: str, want, meta) -> None:
    got = tuple(meta[key].size) if key in meta else None
    if tuple(want) != got:
        raise ValueError(
            f"checkpoint leaf {key} has shape {got}; target "
            f"expects {tuple(want)} — wrong model config?"
        )


def load_state(path: str, target: Any) -> Any:
    """Restore a training state saved by :func:`save_state` into
    ``target``, a fresh state of the same model (e.g. ``init_state(seed)``)
    on any mesh: its layout says which leaves this rank reads (whole, on
    the host) and which block of each it keeps; its blocks are
    overwritten in place (params, their optimizer's moments and Adam step
    counts, the step).  Raises ``ValueError`` when the checkpoint's leaves
    differ from the target's in number or in shape: a wrong-config resume
    must fail loudly, not train on misrestored weights."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    meta = _metadata(path)
    lay, opt = target.layout, target.opt_state
    saved, want = len(meta), 3 * len(lay.shapes) + 1
    if saved != want:
        raise ValueError(
            f"checkpoint at {path} has {saved} leaves; the target "
            f"state has {want} — wrong model/optimizer config?"
        )
    whole: Dict[str, torch.Tensor] = {"step": torch.zeros(1, dtype=torch.int64)}
    for name in sorted(target.params):
        for key in _leaf_keys(name):
            _check_shape(key, lay.shapes[name], meta)
            whole[key] = torch.empty(lay.shapes[name],
                                     dtype=meta[key].properties.dtype)
    dcp.load(whole, checkpoint_id=path, process_group=lay.group,
             no_dist=lay.group is None)
    with torch.no_grad():
        for name, p in target.params.items():
            moments, sh = opt.state[p], lay.shardings[name]
            for key, t in zip(_leaf_keys(name), (p, moments["exp_avg"],
                                                 moments["exp_avg_sq"])):
                t.copy_(sh.shard(whole[key]))
    target.step = int(whole["step"][0])
    for moments in opt.state.values():
        moments["step"].fill_(float(target.step))
    return target


__all__ = ["load_params", "load_state", "save_params", "save_state"]
