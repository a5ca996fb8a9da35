"""Hand-written CUDA kernels for the hot ops, each beside its plain version.

``mha``/``gqa_mha``, ``paged_decode_attention``, ``layer_norm`` and
``rms_norm`` dispatch by device: the CUDA kernels (flash attention;
single-token and ragged paged attention; LayerNorm and RMSNorm) for CUDA
tensors, the plain PyTorch versions for CPU and meta tensors.  ``kernels``
builds the ``csrc/`` sources at first use and counts launches.
"""

from .attention import (
    flash_attention,
    gqa_mha,
    mha,
    paged_attention,
    paged_attention_ragged,
    paged_decode_attention,
    paged_kernel_constraints,
    reference_mha,
    reference_paged_attention,
    reference_paged_attention_ragged,
)
from .norms import (
    layer_norm,
    layer_norm_kernel,
    reference_layer_norm,
    reference_rms_norm,
    rms_norm,
    rms_norm_kernel,
)

__all__ = [
    "mha", "gqa_mha", "flash_attention", "reference_mha",
    "paged_decode_attention", "paged_attention", "paged_attention_ragged",
    "paged_kernel_constraints", "reference_paged_attention",
    "reference_paged_attention_ragged",
    "layer_norm", "rms_norm", "layer_norm_kernel", "rms_norm_kernel",
    "reference_layer_norm", "reference_rms_norm",
]
