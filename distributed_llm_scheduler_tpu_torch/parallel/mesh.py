"""Device mesh construction and axis conventions.

PyTorch port of ``distributed_llm_scheduler_tpu.parallel.mesh``:

* ``dp``  — data parallel (batch dimension; gradients all-reduced)
* ``tp``  — tensor parallel (Megatron-style sharded matmuls; activations
  all-reduced inside each layer)
* ``sp``  — sequence/context parallel (ring attention over sequence chunks)

The JAX package builds one ``jax.sharding.Mesh`` in one process and lets
XLA insert the collectives.  Here every rank of a ``torch.distributed``
world (:mod:`.launch`, one process per device) builds the same
:class:`Mesh`: the ranks ``0 .. dp*sp*tp - 1`` laid out as an array of
shape ``(dp, sp, tp)``, ``tp`` innermost (the chattiest collectives
between neighbouring ranks), and one process group per line of the array
along each axis and each pair of axes that a collective runs over.  An
axis of size 1 has no group: its collectives are no-ops.
:func:`factorize_mesh` is a copy of the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

AXES = ("dp", "sp", "tp")
#: the axis sets a collective of the parallel layer runs over: each axis
#: alone, and data x sequence (the gradient and loss averages of the
#: sequence-parallel step)
GROUP_AXES = (("dp",), ("sp",), ("tp",), ("dp", "sp"))


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a ``(dp, sp, tp)`` mesh.

    ``shape`` maps each axis to its size; ``coords`` this rank's index
    along each axis (None for a rank of the world outside the mesh);
    ``groups`` the process group of this rank's line along each entry of
    :data:`GROUP_AXES` (None where the line has one rank)."""

    shape: Dict[str, int]
    rank: int
    coords: Optional[Dict[str, int]]
    groups: Dict[Tuple[str, ...], object]

    @property
    def size(self) -> int:
        return int(np.prod([self.shape[a] for a in AXES]))

    @property
    def contains(self) -> bool:
        """Whether this rank is one of the mesh's."""
        return self.coords is not None

    def axis_size(self, *axes: str) -> int:
        return int(np.prod([self.shape[a] for a in axes]))

    def axis_index(self, *axes: str) -> int:
        """This rank's index along ``axes`` taken together, the first
        outermost (``axis_index("dp", "sp")`` = dp_index * sp + sp_index)."""
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, *axes: str):
        """The process group of this rank's line along ``axes`` (None when
        it holds this rank alone)."""
        return self.groups[tuple(axes)]


def _lines(arr: np.ndarray, axes: Tuple[str, ...]):
    """Every line of the rank array along ``axes``: tuples of global
    ranks, the lines in row-major order of the other axes."""
    keep = [AXES.index(a) for a in axes]
    rest = [i for i in range(len(AXES)) if i not in keep]
    moved = np.transpose(arr, rest + keep)
    return [tuple(int(r) for r in line.reshape(-1))
            for line in moved.reshape(-1, int(np.prod([arr.shape[i] for i in keep])))]


def make_mesh(dp: int = 1, tp: int = 1, sp: int = 1) -> Mesh:
    """Build this rank's :class:`Mesh` of axes ``("dp", "sp", "tp")`` over
    the first ``dp*sp*tp`` ranks of the world (one rank without an
    initialized process group).

    A collective call: every rank of the world calls it with the same
    sizes (the groups are made in the same order everywhere).  Raises
    ``ValueError`` when the mesh needs more ranks than the world has."""
    import torch.distributed as dist

    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    need = dp * tp * sp
    if need > world:
        raise ValueError(
            f"mesh dp*tp*sp={need} exceeds {world} available devices"
        )
    shape = {"dp": dp, "sp": sp, "tp": tp}
    arr = np.arange(need).reshape(dp, sp, tp)
    coords = None
    if rank < need:
        d, s, t = (int(i) for i in np.argwhere(arr == rank)[0])
        coords = {"dp": d, "sp": s, "tp": t}
    groups: Dict[Tuple[str, ...], object] = {}
    made: Dict[Tuple[int, ...], object] = {}
    for axes in GROUP_AXES:
        for line in _lines(arr, axes):
            # every rank makes every group, in this order (a collective);
            # a line of one rank needs none, and a line already made
            # (dp x sp where sp is 1) is reused
            if len(line) > 1 and line not in made:
                made[line] = dist.new_group(list(line))
            pg = made.get(line)
            if rank in line:
                groups[axes] = pg
    if coords is None:
        groups = {axes: None for axes in GROUP_AXES}
    return Mesh(shape, rank, coords, groups)


def factorize_mesh(n_devices: int, prefer_tp: int = 4) -> Dict[str, int]:
    """Pick a reasonable (dp, tp) split for n devices: tp = the largest
    power-of-two divisor of n up to ``prefer_tp``, dp = the rest."""
    tp = 1
    while tp * 2 <= prefer_tp and n_devices % (tp * 2) == 0:
        tp *= 2
    return {"dp": n_devices // tp, "tp": tp, "sp": 1}


__all__ = ["AXES", "GROUP_AXES", "Mesh", "factorize_mesh", "make_mesh"]
