"""Pass 5 — quantization dtype flow.

Checks a quantized param-spec dict (what ``utils.quantize.quantize_dag``
produces: ``name -> QParam`` of shape structs) against the invariants the
dequantize path and the byte accounting rely on: component dtypes
(``QNT001``), scale-shape layout — channel / rowwise / grouped are
distinguished purely by shape, so an unrecognized scale silently
dequantizes wrong (``QNT002``), quantization of tensors
``should_quantize`` would reject (``QNT003``), and agreement between the
graph's declared ``param_bytes`` and ``qparam_bytes`` for channel-layout
params (``QNT004``).

PyTorch port of ``distributed_llm_scheduler_tpu.analysis.quant_pass``
over the port's ``utils/quantize`` (``QParam`` of meta tensors, and
``qparam_bytes``).  Component dtypes may be torch or numpy dtypes; a
message names them as numpy does (``int8``, ``float32``), so the
diagnostics equal the JAX package's on the same shapes and dtypes.
"""

from __future__ import annotations

import math
from typing import Any, Dict

from ..core.graph import TaskGraph
from .diagnostics import AnalysisReport, Severity


def _dtype_name(dtype: Any) -> str:
    """``int8``, ``float32``, ...: the numpy name of a torch or numpy
    dtype."""
    return str(dtype).removeprefix("torch.")


def _layout(q_shape, s_shape) -> str:
    """Which documented scale layout ``s_shape`` matches, or ``""``."""
    q_shape, s_shape = tuple(q_shape), tuple(s_shape)
    if len(s_shape) == len(q_shape):
        if s_shape == (1,) * (len(q_shape) - 1) + (q_shape[-1],):
            return "channel"
        if s_shape == q_shape[:-1] + (1,):
            return "rowwise"
    if (
        len(s_shape) == len(q_shape) + 1
        and len(q_shape) >= 1
        and s_shape[1:2] == (1,)
        and s_shape[2:] == q_shape[1:]
        and s_shape[0] > 0
        and q_shape[0] % s_shape[0] == 0
    ):
        return "grouped"
    return ""


def analyze_quantization(
    graph: TaskGraph, param_specs: Dict[str, Any]
) -> AnalysisReport:
    from ..utils.quantize import QParam, qparam_bytes

    rep = AnalysisReport()
    declared: Dict[str, int] = {}
    for t in graph.tasks():
        for p, nbytes in t.param_bytes.items():
            declared.setdefault(p, nbytes)

    for name in sorted(param_specs):
        spec = param_specs[name]
        if not isinstance(spec, QParam):
            continue
        q, scale = spec.q, spec.scale
        q_dt, s_dt = _dtype_name(q.dtype), _dtype_name(scale.dtype)
        if q_dt != "int8" or s_dt != "float32":
            rep.add(
                "QNT001",
                Severity.ERROR,
                f"QParam {name!r} has q={q_dt}, "
                f"scale={s_dt} (want int8/float32)",
                param=name,
            )
        layout = _layout(q.shape, scale.shape)
        if not layout:
            rep.add(
                "QNT002",
                Severity.ERROR,
                f"QParam {name!r} scale shape {tuple(scale.shape)} matches "
                f"no layout for q shape {tuple(q.shape)}",
                param=name,
            )
            continue
        n_elems = math.prod(q.shape)
        if len(q.shape) < 2 or n_elems < 4096:
            rep.add(
                "QNT003",
                Severity.WARNING,
                f"QParam {name!r} quantizes a tensor should_quantize "
                f"rejects (shape {tuple(q.shape)})",
                param=name,
            )
        if layout == "channel" and name in declared:
            want = qparam_bytes(q)
            if declared[name] != want:
                rep.add(
                    "QNT004",
                    Severity.ERROR,
                    f"param_bytes[{name!r}] = {declared[name]} but the "
                    f"quantized form is {want} bytes",
                    param=name,
                )
    return rep
