"""Gradient aggregation and the hand-written CUDA kernels under it."""
