"""KGE models of the port: TransE, RESCAL, HolE and ER-MLP, the reference
family; the rest of the JAX package's zoo follows."""

from skge_torch.models.base import KGEModel, mxu_dot, nunif, normal
from skge_torch.models.ermlp import ERMLP
from skge_torch.models.hole import HolE
from skge_torch.models.rescal import RESCAL
from skge_torch.models.transe import TransE

MODELS = {"transe": TransE, "rescal": RESCAL, "hole": HolE, "ermlp": ERMLP}

__all__ = ["ERMLP", "HolE", "KGEModel", "MODELS", "RESCAL", "TransE",
           "mxu_dot", "nunif", "normal"]
