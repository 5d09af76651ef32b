"""KGE models of the port: the reference family (TransE, RESCAL, HolE,
ER-MLP) and the factorization family (DistMult, ComplEx, SimplE, TuckER,
QuatE); the rest of the JAX package's zoo follows."""

from skge_torch.models.base import KGEModel, mxu_dot, nunif, normal
from skge_torch.models.complexe import ComplEx
from skge_torch.models.distmult import DistMult
from skge_torch.models.ermlp import ERMLP
from skge_torch.models.hole import HolE
from skge_torch.models.quate import QuatE
from skge_torch.models.rescal import RESCAL
from skge_torch.models.simple import SimplE
from skge_torch.models.transe import TransE
from skge_torch.models.tucker import TuckER

MODELS = {
    m.name: m
    for m in (TransE, RESCAL, HolE, ERMLP, DistMult, ComplEx, TuckER, SimplE, QuatE)
}

__all__ = ["ComplEx", "DistMult", "ERMLP", "HolE", "KGEModel", "MODELS", "QuatE",
           "RESCAL", "SimplE", "TransE", "TuckER", "mxu_dot", "nunif", "normal"]
