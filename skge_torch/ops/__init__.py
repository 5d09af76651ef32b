"""Gradient aggregation and the hand-written CUDA kernels under it."""

from skge_torch.ops.aggregate import segment_mean_dense, segment_mean_unique

__all__ = ["segment_mean_dense", "segment_mean_unique"]
