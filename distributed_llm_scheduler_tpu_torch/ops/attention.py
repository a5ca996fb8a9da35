"""Multi-head attention: a hand-written CUDA flash kernel and its plain version.

PyTorch port of the dense half of ``distributed_llm_scheduler_tpu.ops.
attention``.  The Pallas TPU kernel (``_flash_kernel``) becomes
``csrc/flash_attention.cu``, a CUDA kernel for Hopper that keeps the
(T, T) score matrix out of device memory with the same online softmax.

``mha`` is the public entry, with the JAX package's signature and (B, H,
T, hd) layout.  A CUDA tensor goes to the kernel, which either launches or
raises; a CPU or meta tensor goes to :func:`reference_mha`, the plain
version, which is how the CPU tests and shape inference (``device="meta"``
in the DAG builder) run.  No other device is accepted.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import kernels

KERNEL = "flash_attention"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
kernels.launches.setdefault(KERNEL, 0)


def reference_mha(q, k, v, causal: bool = True, sm_scale: Optional[float] = None):
    """Plain PyTorch oracle with the JAX package's ``reference_mha``
    arithmetic: scores in the input dtype, softmax in f32, probabilities
    cast to ``v.dtype`` before P@V.  O(T^2) memory."""
    hd = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        T = q.shape[-2]
        i = torch.arange(T, device=q.device)
        scores = torch.where(
            i[None, :] <= i[:, None], scores, torch.finfo(scores.dtype).min
        )
    probs = torch.softmax(scores.float(), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def _library() -> ctypes.CDLL:
    lib = kernels.load(KERNEL)
    fn = lib.dls_flash_attention_fwd
    if fn.argtypes is None:  # first load: declare the C signature
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, i, i, i, i, vp, i, i, ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v) -> None:
    if q.dim() != 4:
        raise ValueError(f"expected (B, H, T, hd) tensors, got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(
                f"{name} shape {tuple(t.shape)} != q shape {tuple(q.shape)}"
            )
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {_HEAD_DIMS}")
    if q.shape[-2] < 1:
        raise ValueError("sequence length must be >= 1")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} head dim must be contiguous (stride 1)")


def flash_attention(q, k, v, causal: bool = True, sm_scale: Optional[float] = None):
    """Launch the CUDA flash kernel on (B, H, T, hd) CUDA tensors.

    q, k and v may be strided views (e.g. heads split out of a fused qkv
    projection) as long as the head dim is contiguous.  The output is
    allocated as (B, T, H, hd) and returned as its (B, H, T, hd) view, so
    the caller's merge of heads back to (B, T, H*hd) needs no copy.
    Raises when the inputs do not qualify or the launch fails."""
    _check(q, k, v)
    B, H, T, hd = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    out = out.transpose(1, 2)
    strides = (ctypes.c_int64 * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3])
    )
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dls_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, T, hd, ctypes.addressof(strides), _DTYPE_CODE[q.dtype],
            int(bool(causal)), float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash attention launch failed: cudaError {err}")
    kernels.launches[KERNEL] += 1
    return out


def mha(q, k, v, causal: bool = True, sm_scale: Optional[float] = None):
    """Multi-head attention on (B, H, T, hd) tensors: the CUDA kernel for
    CUDA tensors, the plain version for CPU and meta tensors."""
    kind = q.device.type
    if kind == "cuda":
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    if kind in ("cpu", "meta"):
        return reference_mha(q, k, v, causal=causal, sm_scale=sm_scale)
    raise ValueError(f"mha: unsupported device {q.device}")
