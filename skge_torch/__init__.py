"""skge_torch: the PyTorch/CUDA port of tpu-kge for NVIDIA Hopper.

The JAX package `skge_tpu` is the reference; module and function names
match it. So far the port holds one slice: TransE trained with the
pairwise margin loss against a shared negative pool, row-sparse AdaGrad or
SGD, and filtered-ranking evaluation. Its gradient scatter is a
hand-written CUDA kernel (`skge_torch.ops.cuda_segment`).

    from skge_torch import TransE, AdaGrad, SharedNegativeSampler, \
        init_state, make_pairwise_step, make_epoch_fn
"""

from skge_torch.evaluation import FilteredRankingEval
from skge_torch.models import MODELS, KGEModel, TransE
from skge_torch.optim import OPTIMIZERS, SGD, AdaGrad
from skge_torch.sampling import SharedNegativeSampler
from skge_torch.training import (
    StepMetrics,
    TrainState,
    init_state,
    make_epoch_fn,
    make_pairwise_step,
)

__version__ = "0.1.0"

__all__ = [
    "AdaGrad",
    "FilteredRankingEval",
    "KGEModel",
    "MODELS",
    "OPTIMIZERS",
    "SGD",
    "SharedNegativeSampler",
    "StepMetrics",
    "TrainState",
    "TransE",
    "init_state",
    "make_epoch_fn",
    "make_pairwise_step",
]
