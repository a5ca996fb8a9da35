"""Device mesh construction and axis conventions.

PyTorch port of ``distributed_llm_scheduler_tpu.parallel.mesh``:

* ``dp``  — data parallel (batch dimension; gradients all-reduced)
* ``tp``  — tensor parallel (Megatron-style sharded matmuls; activations
  all-reduced inside each layer)
* ``sp``  — sequence/context parallel (ring attention over sequence chunks)
* ``ep``  — expert parallel (each rank holds ``E / ep`` experts)
* ``pp``  — pipeline parallel (each rank holds one stage's layers)

The JAX package builds one ``jax.sharding.Mesh`` in one process and lets
XLA insert the collectives.  Here every rank of a ``torch.distributed``
world (:mod:`.launch`, one process per device) builds the same
:class:`Mesh`: the first ranks of the world laid out as an array over the
mesh's axes, the last innermost, and one process group per line of the
array along each axis (and each set of axes) that a collective runs over,
and one of the mesh's ranks together (``mesh.group(*mesh.axes)``: the
world's own group when the mesh is the world).  An axis of size 1 has no
group: its collectives are no-ops.
:func:`make_mesh` lays out ``(dp, sp, tp)``, ``tp`` innermost (the
chattiest collectives between neighbouring ranks);
:func:`make_axes_mesh` any named axes, as the JAX package's expert and
pipeline paths build ``Mesh(devices.reshape(dp, ep), ("dp", "ep"))`` and
``Mesh(devices[:pp], ("pp",))``.  Ranks of the world beyond the mesh sit
out (:attr:`Mesh.contains` is False), as those meshes leave the other
devices idle.  :func:`factorize_mesh` is a copy of the JAX package's.
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
    """This rank's view of a mesh of named axes.

    ``shape`` maps each axis to its size, in the array's order (the last
    innermost); ``coords`` this rank's index along each axis (None for a
    rank of the world outside the mesh); ``groups`` the process group of
    this rank's line along each set of axes a collective runs over (None
    where the line has one rank).  An axis the mesh does not name has
    size 1, index 0 and no group."""

    shape: Dict[str, int]
    rank: int
    coords: Optional[Dict[str, int]]
    groups: Dict[Tuple[str, ...], object]

    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    @property
    def contains(self) -> bool:
        """Whether this rank is one of the mesh's."""
        return self.coords is not None

    def axis_size(self, *axes: str) -> int:
        return int(np.prod([self.shape.get(a, 1) for a in axes]))

    def axis_index(self, *axes: str) -> int:
        """This rank's index along ``axes`` taken together, the first
        outermost (``axis_index("dp", "sp")`` = dp_index * sp + sp_index)."""
        idx = 0
        for a in axes:
            idx = idx * self.shape.get(a, 1) + self.coords.get(a, 0)
        return idx

    def group(self, *axes: str):
        """The process group of this rank's line along ``axes`` (None when
        it holds this rank alone)."""
        return self.groups.get(tuple(axes))


def _lines(arr: np.ndarray, names: Tuple[str, ...], axes: Tuple[str, ...]):
    """Every line of the rank array (axes ``names``) along ``axes``:
    tuples of global ranks, the lines in row-major order of the other
    axes."""
    keep = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in keep]
    moved = np.transpose(arr, rest + keep)
    return [tuple(int(r) for r in line.reshape(-1))
            for line in moved.reshape(-1, int(np.prod([arr.shape[i] for i in keep])))]


def _build(shape: Dict[str, int], group_axes: Tuple[Tuple[str, ...], ...],
           label: str) -> Mesh:
    """This rank's :class:`Mesh` of ``shape`` over the first ranks of the
    world, with a group per line along each entry of ``group_axes``
    (``label`` names the axes' product in the refusal)."""
    import torch.distributed as dist

    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    names = tuple(shape)
    need = int(np.prod(list(shape.values())))
    if need > world:
        raise ValueError(
            f"mesh {label}={need} exceeds {world} available devices"
        )
    arr = np.arange(need).reshape(tuple(shape.values()))
    coords = None
    if rank < need:
        idx = (int(i) for i in np.argwhere(arr == rank)[0])
        coords = dict(zip(names, idx))
    groups: Dict[Tuple[str, ...], object] = {}
    made: Dict[Tuple[int, ...], object] = {}
    for axes in group_axes:
        for line in _lines(arr, names, axes):
            # every rank makes every group, in this order (a collective);
            # a line of one rank needs none, and a line already made
            # (dp x sp where sp is 1) is reused
            if len(line) > 1 and line not in made:
                made[line] = dist.new_group(list(line))
            pg = made.get(line)
            if rank in line:
                groups[axes] = pg
    # the whole mesh (a checkpoint's collectives)
    line = tuple(range(need))
    if 1 < need < world and line not in made:
        made[line] = dist.new_group(list(line))
    groups[names] = made.get(line, dist.group.WORLD if need > 1 else None)
    if coords is None:
        groups = {axes: None for axes in (*group_axes, names)}
    return Mesh(shape, rank, coords, groups)


def make_mesh(dp: int = 1, tp: int = 1, sp: int = 1) -> Mesh:
    """Build this rank's :class:`Mesh` of axes ``("dp", "sp", "tp")`` over
    the first ``dp*sp*tp`` ranks of the world (one rank without an
    initialized process group).

    A collective call: every rank of the world calls it with the same
    sizes (the groups are made in the same order everywhere).  Raises
    ``ValueError`` when the mesh needs more ranks than the world has."""
    return _build({"dp": dp, "sp": sp, "tp": tp}, GROUP_AXES, "dp*tp*sp")


def make_axes_mesh(**sizes: int) -> Mesh:
    """This rank's :class:`Mesh` over named axes in the order given, the
    last innermost (``make_axes_mesh(dp=2, ep=4)``: the JAX package's
    ``Mesh(devices[:8].reshape(2, 4), ("dp", "ep"))``), over the first
    ranks of the world, with a process group per line of each axis.  A
    collective call, as :func:`make_mesh`; raises ``ValueError`` when the
    mesh needs more ranks than the world has."""
    if not sizes or any(n < 1 for n in sizes.values()):
        raise ValueError(f"mesh axes must be >= 1, got {sizes}")
    return _build(dict(sizes), tuple((a,) for a in sizes), "*".join(sizes))


def factorize_mesh(n_devices: int, prefer_tp: int = 4) -> Dict[str, int]:
    """Pick a reasonable (dp, tp) split for n devices: tp = the largest
    power-of-two divisor of n up to ``prefer_tp``, dp = the rest."""
    tp = 1
    while tp * 2 <= prefer_tp and n_devices % (tp * 2) == 0:
        tp *= 2
    return {"dp": n_devices // tp, "tp": tp, "sp": 1}


__all__ = ["AXES", "GROUP_AXES", "Mesh", "factorize_mesh", "make_axes_mesh",
           "make_mesh"]
