"""Int8 weights for memory-constrained scheduling.

PyTorch port of the weight half of ``distributed_llm_scheduler_tpu.utils.
quantize``: symmetric per-channel int8 weights halve (against bf16) or
quarter (against f32) every number the scheduler optimizes — per-param
bytes in ``can_fit``, host-link load times, residency on the card.

* a quantized param is a :class:`QParam` ``(q: int8, scale: float32)``, a
  ``NamedTuple`` of tensors with per-last-axis-channel absmax scales; the
  device backend moves and counts it leaf by leaf;
* task fns never change: :func:`quantize_dag` wraps each distinct fn ONCE
  with a shim that dequantizes ``QParam`` entries back to the param's
  original dtype before calling through.  Dequantization is elementwise
  inside the task (an int8 -> float32 convert, a multiply by the scale, a
  cast), followed by the matmul the task already has, so the copies over
  the host link and the parameters held on the card stay int8;
* scheduling sees the truth: ``Task.param_bytes`` shrink to the int8 +
  scale sizes, and the graph name gains an ``_int8`` tag so measured
  cost-model caches cannot mix precision regimes.

Only float params with >= ``min_elems`` elements and >= 2 dims quantize;
norm gains and biases (tiny, precision-critical) keep their dtype.  The
embedding table quantizes per channel like any matrix.  The arithmetic is
the JAX package's, in float32 with round-half-to-even, so ``q`` is equal
to its and the scales agree to the last bit on the CPU.  The int8 KV
cache lives with the cache itself (``models/decode.quantize_cache``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, NamedTuple

import torch

from ..core.graph import (
    TaskGraph,
    TaskStatus,
    is_batch0,
    is_concat0,
    mark_batch0,
    mark_concat0,
    mark_rootslice,
    rootslice_of,
)


class QParam(NamedTuple):
    """Symmetric int8 weight: ``deq = q * scale`` in one of three scale
    layouts, distinguished by shape:

    * **channel** (:func:`quantize_array`): ``(1, ..., 1, last)`` — one
      scale per last-axis channel.  The ONLY layout the DAG/shard path
      accepts (:func:`rederive_shard_quants`, :func:`qparam_bytes`).
    * **rowwise** (:func:`quantize_array_rowwise`): ``(..., n, 1)`` — one
      scale per row.
    * **grouped** (:func:`quantize_array_grouped`): ``(n0/group, 1,
      *rest)`` — ``q.ndim + 1``; :func:`dequantize` keys the grouped
      reshape on that rank difference.
    """

    q: torch.Tensor      # int8, original shape
    scale: torch.Tensor  # float32, see the layout table above


def should_quantize(spec: Any, min_elems: int = 4096) -> bool:
    """Quantize float tensors with >= 2 dims and >= min_elems elements."""
    if isinstance(spec, QParam):
        return False
    shape = tuple(spec.shape)
    if len(shape) < 2:
        return False
    size = 1
    for s in shape:
        size *= s
    return size >= min_elems and spec.dtype.is_floating_point


def _absmax_quant(xf: torch.Tensor, dims) -> QParam:
    absmax = xf.abs().amax(dim=dims, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return QParam(q=q, scale=scale)


def quantize_array(x: torch.Tensor) -> QParam:
    """Symmetric absmax int8 over every axis but the last (per-channel)."""
    xf = x.float()
    return _absmax_quant(xf, tuple(range(xf.ndim - 1)))


def quantize_array_rowwise(x: torch.Tensor) -> QParam:
    """Symmetric absmax int8 over the LAST axis (one scale per row): the
    orientation for embedding tables read by row."""
    return _absmax_quant(x.float(), (-1,))


def quantize_array_grouped(x: torch.Tensor, group: int = 64) -> QParam:
    """Per-channel scales refined along the leading (contraction) axis:
    axis 0 split into ``group``-sized blocks, one scale per (block,
    channel), scale shape ``(n0/group, 1, *rest)``.  Falls back to
    :func:`quantize_array` when axis 0 does not divide evenly."""
    xf = x.float()
    n0 = xf.shape[0]
    if xf.ndim < 2 or n0 % group or n0 == group:
        return quantize_array(x)
    xg = xf.reshape((n0 // group, group) + tuple(xf.shape[1:]))
    qg = _absmax_quant(xg, (1,))
    return QParam(q=qg.q.reshape(xf.shape), scale=qg.scale)


#: per-family embedding tables that ``scheme="grouped"`` quantizes row-wise:
#: their consumers read ROWS (a gather; GPT-2's tied head contracts over
#: the last axis).  Llama and Mixtral's untied ``lm_head`` (d, vocab)
#: takes the grouped path (the JAX package's table).
ROWWISE_EMBED_KEYS: Dict[str, tuple] = {
    "gpt2": ("wte", "wpe"),
    "llama": ("tok_emb",),
    "mixtral": ("tok_emb",),
}


def dequantize(v: Any, dtype: torch.dtype) -> Any:
    """QParam -> dense tensor in ``dtype``; anything else passes through.
    Handles the same-ndim layouts (per-channel, row-wise) and the grouped
    ``ndim + 1`` layout."""
    if isinstance(v, QParam):
        q, scale = v.q, v.scale
        if scale.ndim == q.ndim + 1:
            g0 = scale.shape[0]
            qg = q.reshape((g0, q.shape[0] // g0) + tuple(q.shape[1:]))
            return (qg.float() * scale).reshape(q.shape).to(dtype)
        return (q.float() * scale).to(dtype)
    return v


def qparam_bytes(spec: Any) -> int:
    """Bytes of the quantized form of ``spec``: int8 values plus one
    float32 scale per last-axis channel (quantize_array's layout)."""
    shape = tuple(spec.shape)
    n = 1
    for s in shape:
        n *= s
    return n * 1 + shape[-1] * 4


def quantize_params(
    params: Dict[str, Any],
    min_elems: int = 4096,
    scheme: str = "channel",
    group: int = 64,
    rowwise_keys: tuple = (),
) -> Dict[str, Any]:
    """Quantize every qualifying entry of a flat param dict.
    ``scheme="channel"`` is the per-channel layout every byte-accounting
    consumer assumes; ``scheme="grouped"`` gives ``rowwise_keys`` per-row
    scales and everything else ``group``-blocked contraction-axis
    scales."""
    if scheme == "channel":
        return {
            k: quantize_array(v) if should_quantize(v, min_elems) else v
            for k, v in params.items()
        }
    if scheme != "grouped":
        raise ValueError(f"unknown quantization scheme {scheme!r}")
    out: Dict[str, Any] = {}
    for k, v in params.items():
        if not should_quantize(v, min_elems):
            out[k] = v
        elif k in rowwise_keys:
            out[k] = quantize_array_rowwise(v)
        else:
            out[k] = quantize_array_grouped(v, group)
    return out


def _shard_groups(names) -> Dict[str, list]:
    """``{base: [(k, shard_name), ...]}`` for ``{base}_shard_{k}`` keys."""
    groups: Dict[str, list] = {}
    for name in names:
        m = re.fullmatch(r"(.+)_shard_(\d+)", name)
        if m:
            groups.setdefault(m.group(1), []).append((int(m.group(2)), name))
    for entries in groups.values():
        entries.sort()
    return groups


def rederive_shard_quants(params: Dict[str, Any]) -> Dict[str, Any]:
    """Make vocab-shard quantization coherent with the base table's:
    ``{base}_shard_{k}`` entries carry slices of the BASE table's
    quantized values (row slices reuse the base's per-column scales,
    column slices take the matching scale columns), so the shard-consuming
    DAG path and the full-table fused oracle agree."""
    out = dict(params)
    for base, entries in _shard_groups(params).items():
        bq = out.get(base)
        if not isinstance(bq, QParam):
            continue
        if bq.scale.ndim != bq.q.ndim or any(
            s != 1 for s in bq.scale.shape[:-1]
        ):
            raise ValueError(
                f"shard group {base!r}: rederive_shard_quants supports "
                f"only channel-layout scales, got scale shape "
                f"{tuple(bq.scale.shape)} for q {tuple(bq.q.shape)}"
            )
        base_shape = tuple(bq.q.shape)

        def _shape_of(v):
            return tuple((v.q if isinstance(v, QParam) else v).shape)

        present = [name for _, name in entries if name in out]
        shapes = [_shape_of(out[name]) for name in present]
        if not shapes:
            continue
        # infer the slicing axis once per group from all shard shapes
        rows_ok = all(s[1:] == base_shape[1:] for s in shapes)
        cols_ok = all(s[:-1] == base_shape[:-1] for s in shapes)
        if rows_ok and cols_ok:
            if shapes == [base_shape]:
                cols_ok = False
            else:
                rsum = sum(s[0] for s in shapes)
                csum = sum(s[-1] for s in shapes)
                rows_ok = rsum == base_shape[0] and csum != base_shape[-1]
                cols_ok = (not rows_ok) and csum == base_shape[-1]
        if rows_ok == cols_ok:
            raise ValueError(
                f"shard group {base!r}: cannot disambiguate row vs column "
                f"slicing (base {base_shape}, shards {shapes})"
            )
        off = 0
        for name, shape in zip(present, shapes):
            if rows_ok:  # row slice (wte)
                if isinstance(out[name], QParam):
                    out[name] = QParam(
                        q=bq.q[off:off + shape[0]], scale=bq.scale
                    )
                off += shape[0]
            else:  # column slice (lm_head)
                if isinstance(out[name], QParam):
                    out[name] = QParam(
                        q=bq.q[..., off:off + shape[-1]],
                        scale=bq.scale[..., off:off + shape[-1]],
                    )
                off += shape[-1]
    return out


def quantize_like(dag: Any, params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize exactly the params a quantized DAG's specs mark quantized
    (fp weights from elsewhere, converted to the DAG's layout)."""
    out = {}
    for k, v in params.items():
        spec = dag.param_specs.get(k)
        if isinstance(spec, QParam) and not isinstance(v, QParam):
            out[k] = quantize_array(v)
        else:
            out[k] = v
    return rederive_shard_quants(out)


def quantize_dag(
    dag: Any, min_elems: int = 4096, exclude_prefixes: tuple = ()
) -> Any:
    """A ModelDAG whose qualifying weights are int8 end to end.

    Returns a new dag (the input is untouched): fns wrapped with
    dequantization inside the task, ``param_bytes`` shrunk to int8 +
    scale sizes, specs swapped to QParams of meta tensors,
    ``init_params`` (through ``derive_params``) and ``reference_forward``
    quantization-aware, and the graph renamed with an ``_int8`` tag.  The
    wrapper keeps the fn's re-batching markers (``is_batch0``,
    ``is_concat0``, ``rootslice_of``), so segments still re-batch int8
    tasks.  ``exclude_prefixes``: param names starting with any of these
    keep their dtype.
    """
    quantized = {
        name for name, spec in dag.param_specs.items()
        if should_quantize(spec, min_elems)
        and not any(name.startswith(px) for px in exclude_prefixes)
    }
    # decided per shard group: vocab shards follow their base table
    for base, entries in _shard_groups(dag.param_specs).items():
        if base not in dag.param_specs:
            continue
        names = [n for _, n in entries]
        if base in quantized:
            quantized.update(names)
        else:
            quantized.difference_update(names)
    spec_dtype = {
        name: spec.dtype
        for name, spec in dag.param_specs.items()
        if not isinstance(spec, QParam)
    }

    # wrap each distinct fn object once, so structurally identical tasks
    # keep sharing one fn after the transform
    wrapped: Dict[Any, Callable[..., Any]] = {}

    def dequant_wrap(fn, local_dtypes):
        """The bare dequantizing shim around ``fn``; also the body of a
        merged-root call, which is fresh per plan and not memoized."""

        def w(pd, *args, _fn=fn, _dt=dict(local_dtypes)):
            deq = {
                loc: dequantize(v, _dt.get(loc, torch.float32))
                for loc, v in pd.items()
            }
            return _fn(deq, *args)

        return w

    def wrap(fn, local_dtypes):
        dt = tuple(sorted((k, str(v)) for k, v in local_dtypes.items()))
        key = (fn, dt)
        w = wrapped.get(key)
        if w is None:
            w = dequant_wrap(fn, local_dtypes)
            # dequantization is per param, so the wrapper keeps batch-axis-0
            # polymorphism and concat semantics
            if is_batch0(fn):
                mark_batch0(w)
            if is_concat0(fn):
                mark_concat0(w)
            rs = rootslice_of(fn)
            if rs is not None:
                # merged roots dequantize too; the dtypes join the family
                # key, so differently quantized roots never merge
                fam, lo, hi, make = rs
                mark_rootslice(
                    w, ("int8", fam, dt), lo, hi,
                    lambda a, b, _m=make, _d=dict(local_dtypes): (
                        dequant_wrap(_m(a, b), _d)
                    ),
                )
            wrapped[key] = w
        return w

    new_graph = TaskGraph(name=f"{dag.graph.name}_int8")
    for tid in dag.graph.topo_order:
        t = dag.graph[tid]
        pb = dict(t.param_bytes)
        local_dtypes = {}
        for loc, glob in t.param_items():
            if glob in quantized:
                pb[glob] = qparam_bytes(dag.param_specs[glob])
                local_dtypes[loc] = spec_dtype[glob]
        new_graph.add_task(dataclasses.replace(
            t,
            # only tasks that touch quantized params get the shim
            fn=(
                wrap(t.fn, local_dtypes)
                if t.fn is not None and local_dtypes
                else t.fn
            ),
            param_bytes=pb,
            dependencies=list(t.dependencies),
            params_needed=set(t.params_needed),
            arg_tasks=list(t.arg_tasks) if t.arg_tasks is not None else None,
            status=TaskStatus.PENDING,
            assigned_node=None,
        ))
    new_graph.freeze()

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    new_specs = {
        name: (
            QParam(
                q=meta(tuple(spec.shape), torch.int8),
                scale=meta((1,) * (spec.ndim - 1) + (spec.shape[-1],),
                           torch.float32),
            )
            if name in quantized
            else spec
        )
        for name, spec in dag.param_specs.items()
    }

    base_derive = dag.derive_params
    base_forward = dag.reference_forward

    def derive_params(params):
        return rederive_shard_quants({
            k: quantize_array(v) if k in quantized else v
            for k, v in base_derive(params).items()
        })

    def reference_forward(params, input_ids):
        deq = {
            k: dequantize(v, spec_dtype.get(k, torch.float32))
            for k, v in params.items()
        }
        return base_forward(deq, input_ids)

    return dataclasses.replace(
        dag,
        graph=new_graph,
        param_specs=new_specs,
        derive_params=derive_params,
        reference_forward=reference_forward,
    )
