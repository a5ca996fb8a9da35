"""Evaluation harnesses of the port (the paged kernels' op-parity sweeps)."""
