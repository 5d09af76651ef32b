"""skge_torch: the PyTorch/CUDA port of tpu-kge for NVIDIA Hopper.

The JAX package `skge_tpu` is the reference; module and function names
match it. The port holds the JAX package's 14 models: the reference
family (TransE, RESCAL, HolE, ER-MLP), the factorization family
(DistMult, ComplEx, SimplE, TuckER, QuatE, with the nuclear 3-norm `n3`),
RotatE, TransH, PairRE, TransR and ConvE, trained two ways: reference-exact,
with iid negatives from the random-mode, LCWA, corrupted or Bernoulli
sampler (the fused pairwise step, or the generic expanded-pair pairwise
and pointwise steps), and against a shared negative pool (pairwise
margin, pointwise logistic, self-adversarial and sampled cross-entropy
losses); and full 1-vs-all cross entropy. Row-sparse AdaGrad, SGD or lazy
Adam with lr schedules, filtered-ranking evaluation and triple
classification, the `Trainer`, npz checkpoints that the JAX package also
reads, the learnable synthetic KGs (`data.latent_kg`), the runtime checks
of `utils.debug`, and the `experiment` CLI
(`python -m skge_torch.experiment`). Serving: exact top-K link prediction
over a table on the device (`LinkPredictor`, int8/fp8/bfloat16 tables) or
streamed from pinned host memory (`StreamedLinkPredictor`). The
out-of-core trainer (`OutOfCoreTrainer`, `--trainer outofcore`) keeps the
entity table in pinned host memory and trains PyTorch-BigGraph-style
buckets of partitions on the device. The partitioned trainer
(`PartitionedTrainer`, `--trainer partitioned`) splits the entity table
over the processes of a `torch.distributed` group, one shard each (NCCL on
the cards, gloo on the CPU). The gradient scatters are
hand-written CUDA kernels (`skge_torch.ops.cuda_segment`, and
`skge_torch.ops.cuda_outer` for RESCAL's factored shared-pool W gradient).
`KGEModel.compute_dtype="bfloat16"` runs the scoring matmuls on bf16
inputs. The scikit-kge class API (`skge_torch.compat`, with the NumPy
modules `sample`, `param`, `actfun` and `util`) trains through the same
steps:

    from skge_torch.compat import HolE, PairwiseStochasticTrainer
    from skge_torch import sample

    from skge_torch import HolE, RandomModeSampler, Trainer, TrainConfig
    Trainer(HolE(n_e, n_r, 150), RandomModeSampler(n_e), TrainConfig()).fit(train)
"""

# first: `training` imports `utils.metrics`, and `utils` imports `training`
from skge_torch.utils import (AsyncCheckpointer, MetricsLogger, load_checkpoint,
                              save_checkpoint)
from skge_torch.evaluation import (FilteredRankingEval, ReciprocalEvalWrapper,
                                   evaluate, relation_categories,
                                   triple_classification)
from skge_torch.models import (ERMLP, MODELS, RESCAL, ComplEx, ConvE, DistMult,
                               HolE, KGEModel, PairRE, QuatE, RotatE, SimplE,
                               TransE, TransH, TransR, TuckER)
from skge_torch.optim import (OPTIMIZERS, SCHEDULES, SGD, AdaGrad, Adam, Schedule,
                              WarmupCosine, WarmupLinear, make_schedule)
from skge_torch.outofcore import OutOfCoreTrainer
from skge_torch.parallel.partitioned import PartitionedTrainer
from skge_torch.sampling import (SAMPLERS, BernoulliSampler, CorruptedSampler,
                                 LCWASampler, RandomModeSampler,
                                 SharedNegativeSampler)
from skge_torch.serving import (LinkPredictor, StreamedLinkPredictor, TopKResult,
                                quantize_table_fp8, quantize_table_int8,
                                top_k_candidates)
from skge_torch.trainer import TrainConfig, Trainer
from skge_torch.training import (
    StepMetrics,
    TrainState,
    init_state,
    make_ce_step,
    make_epoch_fn,
    make_pairwise_step,
    make_pairwise_update,
    make_pointwise_step,
    make_pointwise_update,
    make_sampled_ce_step,
    make_selfadv_step,
)

__version__ = "0.1.0"

__all__ = [
    "AdaGrad",
    "Adam",
    "AsyncCheckpointer",
    "BernoulliSampler",
    "ComplEx",
    "ConvE",
    "CorruptedSampler",
    "DistMult",
    "ERMLP",
    "FilteredRankingEval",
    "HolE",
    "KGEModel",
    "LCWASampler",
    "LinkPredictor",
    "MODELS",
    "MetricsLogger",
    "OPTIMIZERS",
    "OutOfCoreTrainer",
    "PartitionedTrainer",
    "PairRE",
    "QuatE",
    "RESCAL",
    "RandomModeSampler",
    "ReciprocalEvalWrapper",
    "RotatE",
    "SAMPLERS",
    "SCHEDULES",
    "SGD",
    "Schedule",
    "SharedNegativeSampler",
    "SimplE",
    "StepMetrics",
    "StreamedLinkPredictor",
    "TopKResult",
    "TrainConfig",
    "TrainState",
    "Trainer",
    "TransE",
    "TransH",
    "TransR",
    "TuckER",
    "WarmupCosine",
    "WarmupLinear",
    "__version__",
    "evaluate",
    "init_state",
    "load_checkpoint",
    "make_ce_step",
    "make_epoch_fn",
    "make_pairwise_step",
    "make_pairwise_update",
    "make_pointwise_step",
    "make_pointwise_update",
    "make_sampled_ce_step",
    "make_schedule",
    "make_selfadv_step",
    "quantize_table_fp8",
    "quantize_table_int8",
    "relation_categories",
    "save_checkpoint",
    "top_k_candidates",
    "triple_classification",
]
