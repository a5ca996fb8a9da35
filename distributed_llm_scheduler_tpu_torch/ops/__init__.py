"""Hand-written CUDA kernels for the hot ops, each beside its plain version.

``mha`` and ``paged_decode_attention`` dispatch by device: the CUDA
kernels (flash attention; single-token and ragged paged attention) for
CUDA tensors, the plain PyTorch versions for CPU and meta tensors.
``kernels`` builds the ``csrc/`` sources at first use and counts launches.
"""

from .attention import (
    flash_attention,
    mha,
    paged_attention,
    paged_attention_ragged,
    paged_decode_attention,
    paged_kernel_constraints,
    reference_mha,
    reference_paged_attention,
    reference_paged_attention_ragged,
)

__all__ = [
    "mha", "flash_attention", "reference_mha",
    "paged_decode_attention", "paged_attention", "paged_attention_ragged",
    "paged_kernel_constraints", "reference_paged_attention",
    "reference_paged_attention_ragged",
]
