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

import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .launch import device
from .mesh import make_mesh


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
    losses = []
    for _ in range(steps):
        state, loss = step(state, ids_t, tgt_t)
        losses.append(float(loss))
    out["losses"] = losses
    out["step"] = state.step
    out["params"] = gather_params(state, mesh)
    return out


def resume(config: Any, axes: Dict[str, int], params: Dict[str, np.ndarray],
           ids: np.ndarray, targets: np.ndarray,
           other_configs: Sequence[Any] = ()) -> Optional[Dict[str, Any]]:
    """Two steps, save, load into a fresh state, two more steps; beside
    four uninterrupted steps from the same params.  For each of
    ``other_configs``, the refusal of loading the checkpoint into its
    fresh state (None if it loaded).  Every rank of the world must be in
    the mesh (saving is a collective over the world)."""
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
        save_state(state, path, mesh)
        resumed = load_state(path, init(params=params), mesh)
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
                load_state(path, other_init(), mesh)
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


LEGS = {"train": train, "resume": resume, "attention": attention,
        "decode": decode}


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


__all__ = ["LEGS", "attention", "decode", "resume", "run_legs", "train"]
