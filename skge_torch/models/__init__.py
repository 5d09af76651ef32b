"""KGE models of the port. TransE so far; the rest of the JAX package's
family follows."""

from skge_torch.models.base import KGEModel, nunif, normal
from skge_torch.models.transe import TransE

MODELS = {"transe": TransE}

__all__ = ["KGEModel", "MODELS", "TransE", "nunif", "normal"]
