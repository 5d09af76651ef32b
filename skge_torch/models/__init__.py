"""KGE models of the port: TransE and RESCAL so far; the rest of the JAX
package's family follows."""

from skge_torch.models.base import KGEModel, nunif, normal
from skge_torch.models.rescal import RESCAL
from skge_torch.models.transe import TransE

MODELS = {"transe": TransE, "rescal": RESCAL}

__all__ = ["KGEModel", "MODELS", "RESCAL", "TransE", "nunif", "normal"]
