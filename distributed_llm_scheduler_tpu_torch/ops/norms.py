"""LayerNorm and RMSNorm: hand-written CUDA kernels beside their plain versions.

PyTorch port of ``distributed_llm_scheduler_tpu.ops.norms``.  The Pallas
TPU kernels ``_ln_kernel`` and ``_rms_kernel`` become the two entry points
of ``csrc/norms.cu``, a CUDA kernel for Hopper that normalizes each row
with f32 statistics and rounds once to the input's dtype.  A norm is pure
memory traffic (read x, write an x-shaped output), and run eagerly as
PyTorch ops it is a chain of small launches (casts, a Welford reduction,
elementwise ops); the kernel is one launch.

``layer_norm`` and ``rms_norm`` are the public entries, with the JAX
package's signatures minus ``impl``.  Dispatch is by device: a CUDA
tensor goes to the kernel, which launches or raises; a CPU or meta tensor
goes to the plain version (:func:`reference_layer_norm`,
:func:`reference_rms_norm`, the JAX package's ``xla`` branches), which is
how the CPU tests and shape inference (``device="meta"`` in the DAG
builders) run.  No other device is accepted.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels

SOURCE = "norms"  # csrc/norms.cu holds both kernels
LN_KERNEL = "layer_norm"
RMS_KERNEL = "rms_norm"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
kernels.launches.setdefault(LN_KERNEL, 0)
kernels.launches.setdefault(RMS_KERNEL, 0)


def reference_layer_norm(x, g, b, eps: float = 1e-5):
    """Plain LayerNorm over the last axis: f32 mean and population
    variance, output in ``x``'s dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * g.float() + b.float()).to(x.dtype)


def reference_rms_norm(x, g, eps: float = 1e-5):
    """Plain RMSNorm over the last axis: ``x * rsqrt(mean(x*x) + eps) * g``
    in f32, output in ``x``'s dtype."""
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * scale * g.float()).to(x.dtype)


def _library() -> ctypes.CDLL:
    lib = kernels.load(SOURCE)
    fn = lib.dls_layer_norm_fwd
    if fn.argtypes is None:  # first load: declare the C signatures
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # x, g, b, out, rows, D, x row stride, x dtype, g dtype, eps, stream
        fn.argtypes = [vp, vp, vp, vp, ll, i, ll, i, i, ctypes.c_float, vp]
        fn.restype = ctypes.c_int
        rms = lib.dls_rms_norm_fwd
        rms.argtypes = [vp, vp, vp, ll, i, ll, i, i, ctypes.c_float, vp]
        rms.restype = ctypes.c_int
    return lib


def _rows(x, weights):
    """``x`` as a (rows, D) view with its row stride, after the checks the
    kernels need; raises on what they do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"the norm kernels take CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype {x.dtype} not supported (float32, bfloat16)")
    if x.stride(-1) != 1:
        raise ValueError("the last dim of x must be contiguous (stride 1)")
    D = x.shape[-1]
    for w in weights:
        if w.device != x.device:
            raise ValueError(f"weight on {w.device}, x on {x.device}")
        if w.dtype not in _DTYPE_CODE or w.dtype != weights[0].dtype:
            raise ValueError(
                f"weights must share one dtype of float32/bfloat16, got "
                f"{[t.dtype for t in weights]}"
            )
        if w.numel() != D:
            raise ValueError(f"weight of {w.numel()} elements for D = {D}")
    # a view when the leading dims collapse to one row stride, else a copy
    x2 = x.reshape(-1, D)
    return x2, x2.stride(0) if x2.shape[0] > 1 else D


def _launch(fn_name: str, kernel: str, x, weights, eps: float):
    x2, row_stride = _rows(x, weights)
    rows, D = x2.shape
    ws = [w.reshape(-1).contiguous() for w in weights]
    out = torch.empty((rows, D), dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, fn_name)(
            x2.data_ptr(), *(w.data_ptr() for w in ws), out.data_ptr(),
            rows, D, row_stride, _DTYPE_CODE[x.dtype], _DTYPE_CODE[ws[0].dtype],
            float(eps), stream,
        )
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    kernels.launches[kernel] += 1
    return out.reshape(x.shape)


def layer_norm_kernel(x, g, b, eps: float = 1e-5):
    """Launch the CUDA LayerNorm kernel on CUDA tensors; see
    :func:`reference_layer_norm` for the function it computes.  Raises
    when the call does not qualify or the launch fails."""
    return _launch("dls_layer_norm_fwd", LN_KERNEL, x, (g, b), eps)


def rms_norm_kernel(x, g, eps: float = 1e-5):
    """Launch the CUDA RMSNorm kernel on CUDA tensors; see
    :func:`reference_rms_norm` for the function it computes.  Raises when
    the call does not qualify or the launch fails."""
    return _launch("dls_rms_norm_fwd", RMS_KERNEL, x, (g,), eps)


def _check(x, g) -> None:
    if x.dim() < 1 or g.dim() < 1 or x.shape[-1] != g.shape[-1]:
        raise ValueError(
            f"norm width mismatch: x {tuple(x.shape)}, g {tuple(g.shape)}"
        )


def layer_norm(x, g, b, eps: float = 1e-5):
    """LayerNorm over the last axis of ``x`` (any leading shape): the CUDA
    kernel for CUDA tensors, the plain version for CPU and meta tensors."""
    _check(x, g)
    kind = x.device.type
    if kind not in ("cuda", "cpu", "meta"):
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    if x.numel() == 0:
        return torch.empty_like(x)
    if kind == "cuda":
        return layer_norm_kernel(x, g, b, eps)
    return reference_layer_norm(x, g, b, eps)


def rms_norm(x, g, eps: float = 1e-5):
    """RMSNorm over the last axis of ``x`` (any leading shape): the CUDA
    kernel for CUDA tensors, the plain version for CPU and meta tensors."""
    _check(x, g)
    kind = x.device.type
    if kind not in ("cuda", "cpu", "meta"):
        raise ValueError(f"rms_norm: unsupported device {x.device}")
    if x.numel() == 0:
        return torch.empty_like(x)
    if kind == "cuda":
        return rms_norm_kernel(x, g, eps)
    return reference_rms_norm(x, g, eps)
