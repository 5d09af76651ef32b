"""skge_torch: the PyTorch/CUDA port of tpu-kge for NVIDIA Hopper.

The JAX package `skge_tpu` is the reference; module and function names
match it. The port holds the reference family (TransE, RESCAL, HolE,
ER-MLP) trained two ways: reference-exact, with iid negatives from the
random-mode, LCWA, corrupted or Bernoulli sampler (the fused pairwise
step, or the generic expanded-pair pairwise and pointwise steps), and
against a shared negative pool (pairwise margin and pointwise logistic
loss). Row-sparse AdaGrad or SGD, and filtered-ranking evaluation. The
gradient scatters are hand-written CUDA kernels
(`skge_torch.ops.cuda_segment`, and `skge_torch.ops.cuda_outer` for
RESCAL's factored shared-pool W gradient).

    from skge_torch import HolE, AdaGrad, RandomModeSampler, \
        init_state, make_pairwise_step, make_epoch_fn
"""

from skge_torch.evaluation import FilteredRankingEval
from skge_torch.models import ERMLP, MODELS, RESCAL, HolE, KGEModel, TransE
from skge_torch.optim import OPTIMIZERS, SGD, AdaGrad
from skge_torch.sampling import (SAMPLERS, BernoulliSampler, CorruptedSampler,
                                 LCWASampler, RandomModeSampler,
                                 SharedNegativeSampler)
from skge_torch.training import (
    StepMetrics,
    TrainState,
    init_state,
    make_epoch_fn,
    make_pairwise_step,
    make_pairwise_update,
    make_pointwise_step,
    make_pointwise_update,
)

__version__ = "0.1.0"

__all__ = [
    "AdaGrad",
    "BernoulliSampler",
    "CorruptedSampler",
    "ERMLP",
    "FilteredRankingEval",
    "HolE",
    "KGEModel",
    "LCWASampler",
    "MODELS",
    "OPTIMIZERS",
    "RESCAL",
    "RandomModeSampler",
    "SAMPLERS",
    "SGD",
    "SharedNegativeSampler",
    "StepMetrics",
    "TrainState",
    "TransE",
    "init_state",
    "make_epoch_fn",
    "make_pairwise_step",
    "make_pairwise_update",
    "make_pointwise_step",
    "make_pointwise_update",
]
