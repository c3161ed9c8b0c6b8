"""Operators with hand-written CUDA kernels (sources in ``csrc/``)."""
