"""KGE models of the port, the JAX package's 14: the reference family
(TransE, RESCAL, HolE, ER-MLP), the factorization family (DistMult,
ComplEx, SimplE, TuckER, QuatE), the translational relatives (RotatE,
TransH, TransR, PairRE) and ConvE."""

from skge_torch.models.base import KGEModel, activation, mxu_dot, nunif, normal
from skge_torch.models.complexe import ComplEx
from skge_torch.models.conve import ConvE
from skge_torch.models.distmult import DistMult
from skge_torch.models.ermlp import ERMLP
from skge_torch.models.hole import HolE
from skge_torch.models.pairre import PairRE
from skge_torch.models.quate import QuatE
from skge_torch.models.rescal import RESCAL
from skge_torch.models.rotate import RotatE
from skge_torch.models.simple import SimplE
from skge_torch.models.transe import TransE
from skge_torch.models.transh import TransH
from skge_torch.models.transr import TransR
from skge_torch.models.tucker import TuckER

MODELS = {
    m.name: m
    for m in (TransE, RESCAL, HolE, ERMLP, DistMult, ComplEx, RotatE,
              TransH, TransR, TuckER, SimplE, QuatE, PairRE, ConvE)
}

__all__ = ["ComplEx", "ConvE", "DistMult", "ERMLP", "HolE", "KGEModel", "MODELS",
           "PairRE", "QuatE", "RESCAL", "RotatE", "SimplE", "TransE", "TransH",
           "TransR", "TuckER", "activation", "mxu_dot", "nunif", "normal"]
