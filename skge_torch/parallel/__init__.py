"""Partition helpers of the port's scale-out trainers."""

from skge_torch.parallel.partitioned import relabel_entities

__all__ = ["relabel_entities"]
