"""skge_torch: the PyTorch/CUDA port of tpu-kge for NVIDIA Hopper.

The JAX package `skge_tpu` is the reference; module and function names
match it. So far the port holds two slices: TransE and RESCAL trained
against a shared negative pool (pairwise margin loss; RESCAL also the
pointwise logistic loss), row-sparse AdaGrad or SGD, and filtered-ranking
evaluation. The gradient scatters are hand-written CUDA kernels
(`skge_torch.ops.cuda_segment`, and `skge_torch.ops.cuda_outer` for
RESCAL's factored W gradient).

    from skge_torch import RESCAL, AdaGrad, SharedNegativeSampler, \
        init_state, make_pairwise_step, make_epoch_fn
"""

from skge_torch.evaluation import FilteredRankingEval
from skge_torch.models import MODELS, RESCAL, KGEModel, TransE
from skge_torch.optim import OPTIMIZERS, SGD, AdaGrad
from skge_torch.sampling import SharedNegativeSampler
from skge_torch.training import (
    StepMetrics,
    TrainState,
    init_state,
    make_epoch_fn,
    make_pairwise_step,
    make_pointwise_step,
)

__version__ = "0.1.0"

__all__ = [
    "AdaGrad",
    "FilteredRankingEval",
    "KGEModel",
    "MODELS",
    "OPTIMIZERS",
    "RESCAL",
    "SGD",
    "SharedNegativeSampler",
    "StepMetrics",
    "TrainState",
    "TransE",
    "init_state",
    "make_epoch_fn",
    "make_pairwise_step",
    "make_pointwise_step",
]
