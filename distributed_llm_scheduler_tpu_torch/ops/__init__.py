"""Hand-written CUDA kernels for the hot ops, each beside its plain version.

``mha`` dispatches by device: the CUDA flash-attention kernel for CUDA
tensors, the plain PyTorch version for CPU and meta tensors.
``kernels`` builds the ``csrc/`` sources at first use and counts launches.
"""

from .attention import flash_attention, mha, reference_mha

__all__ = ["mha", "flash_attention", "reference_mha"]
