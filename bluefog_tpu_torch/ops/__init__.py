"""Operators of the port: plain PyTorch, plus hand-written CUDA kernels
built from ``csrc/`` at first use."""
