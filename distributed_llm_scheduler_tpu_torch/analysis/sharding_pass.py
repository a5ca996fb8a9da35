"""Pass 3 — sharding consistency.

Checks the specs ``parallel/sharding.py``'s rules give a param dict
against the param shapes and mesh geometry — *statically*, with no process
group or device involved, so a bad spec is reported as a named diagnostic
before a sharded run starts.

Checks per spec: every named axis exists in the mesh (``SHD001``); the
spec is no longer than the param rank (``SHD002``); each sharded dimension
is divisible by the product of its axis sizes — NamedSharding requires
even splits (``SHD003``); no axis appears on two dimensions of one spec
(``SHD004``).  Across specs: an axis used for param sharding must not also
shard the batch/activation inputs — the same devices would partition both
weights and data over one axis, which the rule tables never intend
(``SHD005``).

PyTorch port of ``distributed_llm_scheduler_tpu.analysis.sharding_pass``:
a spec is a plain tuple (``parallel.sharding.Spec``) where the JAX package
has a ``PartitionSpec``; the checks and messages are the same.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Sequence, Set, Tuple

from ..parallel.sharding import param_spec
from .diagnostics import AnalysisReport, Severity


def _entry_axes(entry) -> Tuple[str, ...]:
    """A spec entry is None, an axis name, or a tuple of names."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _check_spec(
    rep: AnalysisReport,
    what: str,
    spec: Sequence,
    shape: Optional[Tuple[int, ...]],
    mesh_axes: Dict[str, int],
    *,
    param: Optional[str] = None,
) -> Set[str]:
    """Validate one spec; returns the mesh axes it uses."""
    used: Set[str] = set()
    seen_dims: Dict[str, int] = {}
    for dim, entry in enumerate(spec):
        for axis in _entry_axes(entry):
            if axis not in mesh_axes:
                rep.add(
                    "SHD001",
                    Severity.ERROR,
                    f"{what}: axis {axis!r} not in mesh "
                    f"{sorted(mesh_axes)}",
                    param=param,
                )
                continue
            if axis in seen_dims:
                rep.add(
                    "SHD004",
                    Severity.ERROR,
                    f"{what}: axis {axis!r} shards both dim "
                    f"{seen_dims[axis]} and dim {dim}",
                    param=param,
                )
            seen_dims[axis] = dim
            used.add(axis)
    if shape is None:
        return used
    if len(spec) > len(shape):
        rep.add(
            "SHD002",
            Severity.ERROR,
            f"{what}: spec rank {len(spec)} exceeds param rank "
            f"{len(shape)} (shape {tuple(shape)})",
            param=param,
        )
        return used
    for dim, entry in enumerate(spec):
        axes = [a for a in _entry_axes(entry) if a in mesh_axes]
        if not axes:
            continue
        split = math.prod(mesh_axes[a] for a in axes)
        if split and shape[dim] % split != 0:
            rep.add(
                "SHD003",
                Severity.ERROR,
                f"{what}: dim {dim} of size {shape[dim]} not divisible "
                f"by {'x'.join(axes)}={split}",
                param=param,
            )
    return used


def analyze_sharding(
    param_shapes: Dict[str, Tuple[int, ...]],
    mesh_axes: Dict[str, int],
    family: str = "gpt2",
    *,
    batch_spec: Optional[Iterable] = None,
    activation_spec: Optional[Iterable] = None,
    seq_parallel: bool = False,
) -> AnalysisReport:
    """Lint the sharding a (family, mesh) pair implies for ``param_shapes``.

    ``mesh_axes`` maps axis name -> size (e.g. ``factorize_mesh(8)``).
    ``batch_spec``/``activation_spec`` default to the JAX package's
    ``batch_sharding``/``activation_sharding`` specs.
    """
    rep = AnalysisReport()
    if batch_spec is None:
        batch_spec = ("dp", "sp" if seq_parallel else None)
    if activation_spec is None:
        activation_spec = ("dp", "sp" if seq_parallel else None, None)

    param_axes: Set[str] = set()
    for name in sorted(param_shapes):
        shape = tuple(param_shapes[name])
        spec = param_spec(name, family)
        param_axes |= _check_spec(
            rep,
            f"param {name!r}",
            tuple(spec),
            shape,
            mesh_axes,
            param=name,
        )

    data_axes: Set[str] = set()
    data_axes |= _check_spec(
        rep, "batch_sharding", tuple(batch_spec), None, mesh_axes
    )
    data_axes |= _check_spec(
        rep, "activation_sharding", tuple(activation_spec), None, mesh_axes
    )
    for axis in sorted(param_axes & data_axes):
        rep.add(
            "SHD005",
            Severity.ERROR,
            f"axis {axis!r} shards params and batch/activation inputs "
            "simultaneously (conflicting axis reuse)",
        )
    return rep
