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

``csrc/norms.cu`` holds two kernels for each function: the register path,
which reads each row once into registers (all its loads in flight before
the first use, both statistics and the write from the registers, g and b
held across the rows a thread group walks), and the streaming path, which
takes any alignment and any width.  :func:`norm_plan` picks one per call
on the host, from the shape, row stride, dtype and the pointers'
alignment.  ``kernels.launches`` keeps one count per function
(``layer_norm``, ``rms_norm``) and one per function and variant
(``layer_norm.register``, ``layer_norm.streaming``, ...), so a run can
show which kernel its path took.

The kernels have no backward, as the JAX package's Pallas kernels have no
autodiff rule: a CUDA call with grad enabled on an input that requires
grad raises rather than return an output that drops the gradient.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence

import torch

from . import kernels

SOURCE = "norms"  # csrc/norms.cu holds both kernels
LN_KERNEL = "layer_norm"
RMS_KERNEL = "rms_norm"
REGISTER, STREAMING = "register", "streaming"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ENTRY = {  # C entry of each function's variants
    LN_KERNEL: {REGISTER: "dls_layer_norm_reg_fwd",
                STREAMING: "dls_layer_norm_fwd"},
    RMS_KERNEL: {REGISTER: "dls_rms_norm_reg_fwd",
                 STREAMING: "dls_rms_norm_fwd"},
}
for _name in _ENTRY:
    kernels.launches.setdefault(_name, 0)
    for _variant in (REGISTER, STREAMING):
        kernels.launches.setdefault(f"{_name}.{_variant}", 0)

# Block of both kernels.  The register path's instances as (threads per
# row, 16-byte vectors per thread), smallest first; ``launch_reg`` in
# csrc/norms.cu compiles the same pairs.  The streaming path gives a row
# of up to 1,024 elements one warp and a longer row the block.
THREADS = 128
REGISTER_SHAPES = ((32, 1), (32, 2), (32, 4), (128, 2), (128, 4), (128, 8))
STREAM_WARP_D = 1024


@dataclass(frozen=True)
class NormPlan:
    """How one call runs: ``variant`` (REGISTER or STREAMING), the threads
    that own a row, the vectors each holds (register path; 0 streaming),
    and the blocks that cover the rows (the register kernel caps them at
    what the card holds at once and loops)."""

    variant: str
    threads_per_row: int
    vecs_per_thread: int
    blocks: int


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


def norm_plan(rows: int, D: int, row_stride: int, dtype, x_ptr: int,
              out_ptr: int, weight_ptrs: Sequence[int] = ()) -> NormPlan:
    """The kernel variant for a (rows, D) call with x's rows ``row_stride``
    elements apart, from the shape, stride, dtype and addresses alone.

    The register path takes a call whose x, output and weight pointers are
    16-byte aligned, whose width and row stride are whole 16-byte vectors
    (so every row of x and of the contiguous output starts aligned), and
    whose row fits the largest instance (8,192 bf16 or 4,096 f32
    elements); the smallest instance that holds the row runs it.  Anything
    else streams."""
    n = 16 // dtype.itemsize  # elements of a 16-byte vector
    stride = row_stride if rows > 1 else 0  # one row: no second row start
    if (all(p % 16 == 0 for p in (x_ptr, out_ptr, *weight_ptrs))
            and D % n == 0 and stride % n == 0):
        for tpr, vpt in REGISTER_SHAPES:
            if tpr * vpt * n >= D:
                return NormPlan(REGISTER, tpr, vpt, -(-rows // (THREADS // tpr)))
    tpr = 32 if D <= STREAM_WARP_D else THREADS
    return NormPlan(STREAMING, tpr, 0, -(-rows // (THREADS // tpr)))


def _library() -> ctypes.CDLL:
    lib = kernels.load(SOURCE)
    if lib.dls_layer_norm_fwd.argtypes is None:  # first load: C signatures
        vp, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        # [x, g, b,] out, rows, D, x row stride, x dtype, g dtype, eps,
        # [threads per row, vectors per thread,] stream
        sigs = {
            "dls_layer_norm_fwd": [vp, vp, vp, vp, ll, i, ll, i, i, f, vp],
            "dls_rms_norm_fwd": [vp, vp, vp, ll, i, ll, i, i, f, vp],
            "dls_layer_norm_reg_fwd": [vp, vp, vp, vp, ll, i, ll, i, i, f, i, i, vp],
            "dls_rms_norm_reg_fwd": [vp, vp, vp, ll, i, ll, i, i, f, i, i, vp],
            "dls_norm_empty": [i, vp],  # blocks, stream
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
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


def _launch(kernel: str, x, weights, eps: float):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *weights)):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward (nor has the JAX "
            f"package's Pallas kernel); call it under torch.no_grad() or on "
            f"tensors that do not require grad")
    x2, row_stride = _rows(x, weights)
    rows, D = x2.shape
    ws = [w.reshape(-1).contiguous() for w in weights]
    out = torch.empty((rows, D), dtype=x.dtype, device=x.device)
    plan = norm_plan(rows, D, row_stride, x.dtype, x2.data_ptr(),
                     out.data_ptr(), [w.data_ptr() for w in ws])
    shape = ((plan.threads_per_row, plan.vecs_per_thread)
             if plan.variant == REGISTER else ())
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, _ENTRY[kernel][plan.variant])(
            x2.data_ptr(), *(w.data_ptr() for w in ws), out.data_ptr(),
            rows, D, row_stride, _DTYPE_CODE[x.dtype], _DTYPE_CODE[ws[0].dtype],
            float(eps), *shape, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{kernel} ({plan.variant}) launch failed: cudaError {err}")
    kernels.launches[kernel] += 1
    kernels.launches[f"{kernel}.{plan.variant}"] += 1
    return out.reshape(x.shape)


def empty_kernel(blocks: int, device) -> None:
    """Launch csrc/norms.cu's kernel with no work on ``blocks`` blocks of
    THREADS on ``device``'s current stream.  Its time in a CUDA graph is
    the per-launch floor under a norm kernel's; it is on no path and
    counted nowhere."""
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.dls_norm_empty(blocks, stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: cudaError {err}")


def layer_norm_kernel(x, g, b, eps: float = 1e-5):
    """Launch the CUDA LayerNorm kernel (the variant :func:`norm_plan`
    picks) on CUDA tensors; see :func:`reference_layer_norm` for the
    function it computes.  Raises when the call does not qualify, when
    grad is enabled and an input requires grad, or when the launch
    fails."""
    return _launch(LN_KERNEL, x, (g, b), eps)


def rms_norm_kernel(x, g, eps: float = 1e-5):
    """Launch the CUDA RMSNorm kernel (the variant :func:`norm_plan`
    picks) on CUDA tensors; see :func:`reference_rms_norm` for the
    function it computes.  Raises when the call does not qualify, when
    grad is enabled and an input requires grad, or when the launch
    fails."""
    return _launch(RMS_KERNEL, x, (g,), eps)


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
