"""Ops with hand-written CUDA kernels (built from ``csrc/`` at first use)."""
