"""Tensor operations and the hand-written CUDA kernels' wrappers."""
