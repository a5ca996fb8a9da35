"""Evaluation harnesses of the port: the paged kernels' op-parity sweeps,
the north-star bench and its library, and the regression gate."""
