#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`skge_torch`) on one NVIDIA GPU.

Drives the port's paths once at full width, AdaGrad lr 0.1, 100 batches
per epoch, aggregate="dense_pallas", fp32 with TF32 off, on two synthetic
graphs: FB15k's shape (14,951 entities, 1,345 relations, 483,142 train
triples) and WN18's (40,943 entities, 18 relations, 141,442 train
triples). Every gradient scatter runs in the CUDA kernel `segment_sum`
(skge_torch/csrc/segment_sum.cu), and RESCAL's factored shared-pool W
gradient in `segment_outer_sum` (skge_torch/csrc/segment_outer_sum.cu).

Shared negative pool of 1,024 (`python bench.py`'s scheme), FB15k:
- TransE-L1, ncomp=150, margin 1.0 (`python bench.py`'s default);
- RESCAL, ncomp=100 (`bench.py --model rescal --ncomp 100`), pairwise and
  pointwise.
Reference-exact iid negatives (`pairwise_grads_fused`):
- TransE-L1 on FB15k with 16 random-mode negatives per positive
  (`bench.py --sampler random-mode --negatives 8 --aggregate dense_pallas`);
- HolE, ncomp=150, sigmoid before the margin 0.2, on WN18, one random-mode
  negative per positive and mode (`experiment.py`'s defaults);
- ER-MLP, ncomp=150, nhidden=10, margin 0.2, on FB15k with the Bernoulli
  sampler;
- HolE on WN18 with the LCWA and the corrupted sampler, the iid pointwise
  step, and the shared pool at k=4,096 (`bench.py --model hole --k 4096`).

Phases, each fatal:

1. environment: versions, the card's name and power limit; no GPU -> exit 2;
2. build both kernels from source with nvcc, in parallel;
3. each kernel against its plain PyTorch version on the card, at the
   paths' shapes and at edge shapes, and timed beside its bound (the bytes
   it must move at 3.35 TB/s, or its fp32 operations at 67 TFLOP/s).
   `segment_sum` on its 16-byte path (D = 152) and its scalar path (D =
   151, a misaligned view, D = 1), within 1e-5, also at the iid TransE
   step's 91,808 occurrences, the self-adversarial step's 22,688, and the
   shared pool's 15,520 at the factorization family's widths (D = 304 for
   ComplEx's and SimplE's 2 x 150-wide rows, D = 604 for QuatE's 4 x 150),
   and full-rank TransR's M gradient (T = 4,832, R = 1,345, D = 22,500),
   the partitioned step's one scatter at 11a's shape (T = 16,545 into the
   16,296 rows of the stacked shard and relation tables) and full CE's
   (T = 14,496),
   and timed beside `index_add_` alone (into a table already zeroed) and
   beside `torch.zeros` + `index_add_` (K1's whole function, its output's
   zero fill included); compat RESCAL's W scatter on the
   iid pairwise path (13b: T = 19,328, 4 rows a positive, R = 1,345,
   D = 10,000, no count channel) and its counts (D = 1);
   its scalar path also timed at D = 151
   and at RESCAL's W counts (D = 1), beside `index_add_`; both kernels at
   the quality suite's WN18 shapes (phase 14: K1 at T = 12,437, 6,293,
   11,022 and 18,395, and iid RESCAL's W at D = 10,000, timed at the
   first, third and last; K2 at T = 1,415, R = 18); K1 at phase 16's
   shapes, checked and timed: rotate_probe's RotatE E (T = 14,744,
   R = 40,943, D = 36) and R (T = 3,276, R = 18, D = 20), and bench's
   k=4,096 rows (T = 18,592, R = 16,296, D = 152);
   K1's deterministic variant (sorted ids, each row summed in order, no
   atomics) at 7f's and 15b's shapes and the edge shapes: the same bits
   in two calls, within 1e-5 of the plain version, timed at 7f's E and
   15a's shape beside the plain version and `index_add_`, both under
   deterministic algorithms too;
   `segment_outer_sum` equal bit for bit to its in-order plain version and to itself in a second call, also at ranks 1, 3 and 4,
   d = 37, 12 and 1,100, and with half of the occurrences on one row at
   ranks 1, 3 and 4; timed at WN18's 18 relations, with half and with all
   of the occurrences on one row and with Zipf-distributed ids, beside its
   grouping alone, and at FB15k's shape beside the nearest library
   composite (`einsum` of the outer products, then `index_add_`);
4. training, each path with the launch counts set to 0 just before it and
   read just after, exact launch counts (every gradient scatter on K1's
   16-byte path), finite losses and params on the
   card: TransE (4), RESCAL pairwise (4b), 2 epochs of 100 steps each;
   RESCAL pointwise 10 steps (4c); iid TransE (4d), HolE (4e) and ER-MLP
   (4f), 2 epochs of 100 steps each, with the device's busy time per step
   (also for 4b);
   HolE's LCWA, corrupted, pointwise and k=4,096 paths, 10
   steps each (4g);
5. one step on the card against the same step on the CPU, TransE (5),
   RESCAL (5b), HolE (5c, and the card's `unique` aggregation against its
   `dense_pallas`) and ER-MLP (5d), from the initial params with the
   trained run's AdaGrad accumulators;
6. filtered ranking of 1,000 held-out triples, TransE (6), RESCAL (6b),
   HolE (6c) and ER-MLP (6d);
7. the training surface at full width, through `skge_torch.experiment`'s
   `Experiment` and the `Trainer`, on FB15k's shape as the CLI builds it
   (`--synthetic-entities 14951 --synthetic-relations 1345
   --synthetic-train 483142`), each path with the launch counts set to 0
   just before it and held to their exact values after, then its warm
   step and the device's busy time:
   7a `experiment.py`'s defaults (HolE, random-mode, margin 0.2, ncomp 150)
      with `--aggregate dense_pallas`, 2 epochs, one validation, the
      best model's checkpoint (loaded back onto the card) and the metrics
      JSONL; 1 K1 per step;
   7b RECIPES.md's self-adversarial recipe (TransE-L2, shared pool of
      8,192, margin 3.0, lr 0.3, alpha 2.0), 1 epoch; 1 K1 per step;
   7c RECIPES.md's sampled-CE recipe (HolE, reciprocal relations, Adam lr
      1e-3, pool of 8,192 drawn by unigram degree), 1 epoch; 1 K1 per step;
   7d RECIPES.md's CE recipe (RESCAL ncomp 100, reciprocal, Adam lr 1e-3,
      label smoothing 0.1, cosine schedule with 10 warmup steps), 10
      steps of its batch; no kernel (every table takes a full update);
   7e the `Trainer` over RESCAL's shared-pool margin step, 10 steps; 1 K2
      and 2 K1 per step;
   7f resume: 7e for 2 epochs with a checkpoint each, the epoch-1 file
      loaded (the same generator state) and fitted from epoch 1, within
      1e-5 of the uninterrupted run; both runs under
      `torch.use_deterministic_algorithms(True)`, so every K1 call takes
      its deterministic variant and no atomics' order can flip a margin
      test;
   7g learning: TransE ncomp 32 on `synthetic_kg(200, 8, 2000)`, margin
      0.2, 20 batches, 15 epochs: violations fall to <= 40% of epoch 1's,
      rows stay in the unit ball;
   then one step each of 7b, 7c and 7d on the card against the CPU (5e,
   5f, 5g), from the initial params with the trained run's optimizer
   state, on the same batch and pool ids, within 1e-5;
8. the factorization family (DistMult, ComplEx, SimplE, TuckER, QuatE) at
   the CLI's width (ncomp 150) on FB15k's shape:
   8a each model's shared-pool margin step (k = 1,024, AdaGrad 0.1,
      n3 1e-3), 10 warm steps, 1 K1 a step on the 16-byte path (TuckER's
      core W takes none), busy time, `assert_finite_state`, one step
      against the CPU from warm accumulators; ComplEx's N3 term timed
      beside the busy time;
   8b RECIPES.md:14 for ComplEx (full CE, reciprocal, Adam 1e-3, label
      smoothing 0.1, n3 1e-3) through `Experiment`, 10 steps of its
      9,663-triple batch, warm step, busy time, peak memory, one step
      against the CPU within 1e-5, every Adam slot too;
   8c `latent_kg(kind="bilinear")` built on the card at 40,943 entities,
      18 relations, 141,442 triples, timed; its first 16,384 queries
      assigned again on the card and on the CPU: each card object within
      1e-5 of the CPU's best score, the same object wherever the CPU's
      top two are more than 1e-5 apart;
   8d learning: DistMult, ComplEx (n3) and TuckER, ncomp 64, under the CE
      recipe on `latent_kg(2000, 12, 16000, kind="bilinear", seed=5)`:
      each filtered MRR at least 5x its MRR at init, and ComplEx's triple
      classification accuracy above 0.6;
9. the rest of the zoo at `bench.py`'s ALL_ROWS widths (ncomp 150, ConvE
   128) on FB15k's shape:
   9a RotatE, TransH, PairRE, TransR factored and full rank, and ConvE
      (relations doubled, objects only) on 8a's shared-pool margin step, 10
      warm steps, each with its exact K1 counts (1-3 a step; full-rank
      TransR's M gradient on K1's 16-byte path at D = 22,500 and its
      counts at D = 1), busy time, idle share, peak memory, top operators,
      `assert_finite_state`, and one step against the CPU from warm
      accumulators (full-rank TransR on 512 positives); ConvE's again with
      cuDNN's TF32 on for the process, its convolution against fp64;
   9b RECIPES.md:14's CE recipe for ConvE at ncomp 128 through
      `Experiment`, as 8b;
   9c learning on the card, the JAX package's gates at their sizes and
      thresholds: the margin gates of RotatE, TransH, PairRE and both
      TransRs (violations below 0.7x epoch 1's, filtered MRR above 5 / n_e)
      and ConvE's CE gate (loss below 0.8x epoch 1's, the same MRR gate);
   9d filtered ranking of the 1,000 held-out triples with each of 9a's
      trained states, seconds per 1,000, and 64 queries' `score_all_o` and
      `score_all_s` on the card within 1e-4 of the CPU's largest |score|.

10. the out-of-core trainer and serving at FB15k's shape, each step with
   the launch counts set to 0 just before it and held to their exact
   values after:
   10a `OutOfCoreTrainer`, TransE-L1 ncomp 150, k=1,024, P=4, 20 batches a
      bucket, 3 cached parts with prefetch, the entity table and its
      AdaGrad slot in pinned host memory: 1 K1 a step on the 16-byte path,
      uploads within the chained bucket order's bound, untouched rows
      unchanged, the epoch's time, bytes copied each way, peak memory,
      and the card's busy time over one bucket epoch;
   10b the same with prefetch off and with 2 cached parts, within 1e-5;
   10c P=1 against the in-core epoch from the same params and generator
      state, on a fifth of the triples, within 1e-5;
   10d RESCAL ncomp 100 out of core: 1 K2 and 2 K1 a step;
   10e one bucket epoch on the card against the CPU, TransE-L2 and RESCAL,
      from the initial params with warm accumulators, the same permutation
      and pool ids: within 1e-5, slots within 1e-5 of their size, the same
      violation count;
   10f RECIPES.md's sampled-CE recipe (HolE, reciprocal, Adam 1e-3,
      k=8,192) through `Experiment` with `--trainer outofcore --parts 4`,
      one epoch and one streamed validation, held to the in-core ranking;
      the `.sharded` checkpoint restored and fitted one more epoch within
      1e-5 of the uninterrupted run, both under deterministic algorithms
      as in 7f;
   10g serving on 10a's params on `python -m skge_torch.serving_bench`'s
      query stream and timing at its defaults (59,071 queries, batch
      1,024, k=10, filtered by the train triples):
      `LinkPredictor` exact (queries/s, busy time a batch, its first 1,024
      queries held to the CPU engine), int8, fp8 and bfloat16 (queries/s,
      top-10 overlap), `StreamedLinkPredictor` in 4 chunks of 4,096 from
      pinned memory (held to the in-core engine, bytes a batch); then the
      serving bench's `main()` at its defaults, its JSON line;
   10h the JAX package's out-of-core learning gates on the card.
11. the partitioned trainer at P=1, in this process over an NCCL group of
   one made from a file store under build/chip_smoke/ (destroyed at the
   end), FB15k's shape, TransE-L1 ncomp 150, k=1,024, AdaGrad 0.1, a batch
   of 4,832, each path with the launch counts set to 0 just before it:
   11a `PartitionedTrainer` on a fifth of the triples, one epoch of 20
      steps with the dense and with the ragged exchange from the same
      seed: 1 K1 a step on the 16-byte path, the host waits of an epoch
      (the ragged exchange's exactly 2 a step more), busy time and idle
      share, the first step's violations equal, ragged within 1e-5 of
      dense;
   11b one partitioned step from the initial params with 11a's
      accumulators on the card and on the CPU (a gloo group of one), and
      against the in-core `make_pairwise_step` on the card: within 1e-5,
      the same violations;
   11c self-adversarial, sampled CE on reciprocal relations and full CE
      (DistMult), 3 epochs each on 9,664 triples: 1 K1 a step, the loss
      falls, one step against the CPU within 1e-5, every slot too;
   11d 11a's trainer saved, restored into a new one, one more epoch each:
      within 1e-5;
   11e the sharded ranking of 1,000 test triples against
      `FilteredRankingEval` on `params()`, by the 1e-5 gap rule;
   11f `python -m skge_torch.experiment --trainer partitioned` in this
      process with no launch variables (a world of one), 2 epochs of 10
      steps, validations and the test ranking, 1 K1 a step.
12. the 2-D ('data', 'model') mesh at (1, 1), in this process over NCCL
   groups of one (`parallel.mesh.make_mesh`, a file store under
   build/chip_smoke/, destroyed at the end), FB15k's shape, ncomp 150,
   k=1,024, AdaGrad 0.1, batches of 4,832, each path with the launch
   counts set to 0 just before it:
   12a `Trainer(mesh=)`, TransE-L1 on a shared pool, one epoch of 20 steps
      on a fifth of the triples, against the in-core `Trainer` from the
      same seed (params within 1e-5, the same violations): 1 K1 a step on
      the 16-byte path, then the warm step's time, busy time and idle
      share, and its host waits a step (none);
   12b one step each of the mesh's selfadv (TransE-L2), pointwise on a
      pool (TransE-L2), sampled CE and vocab-parallel full CE (DistMult),
      fused iid margin (TransE-L1, 16 negatives), `sharded`'s generic iid
      pointwise route (TransE-L1, 2 negatives) and RESCAL ncomp 100 with
      `shard_relations` (K2): on the card against the same mesh step on
      the CPU and against the in-core step on the card, from the initial
      params with AdaGrad accumulators at 1, the same batch and draws,
      within 1e-5 and the same violations, each with its exact launch
      counts;
   12c `make_epoch_fn(pad_to=4)` against `pad_to=1` on the card, iid
      TransE-L1 (16 negatives), 10 steps of 4,831 triples padded to 4,832:
      the same violations, params within 1e-5;
   12d `LinkPredictor(mesh=)` against `LinkPredictor()` on 12a's params,
      1,024 queries at `scripts/serving_bench.py`'s defaults, exact and
      int8: the same top-10 ids and values; `FilteredRankingEval(mesh=)`
      against the unsharded ranking of 1,000 test triples by the 1e-5 gap
      rule.
13. the reference class API (`skge_torch.compat`) and `compute_dtype`,
   each path with the launch counts set to 0 just before it and held to
   their exact values after, aggregate "dense_pallas":
   13a README's example, HolE((40,943, 40,943, 18), 150, rparam=0.1) with
      `PairwiseStochasticTrainer` (margin 0.2, the batch of 100 batches)
      and `sample.RandomModeSampler(...).sample` on WN18's shape, 2 epochs
      of 20 steps: the device path (a host draw fails the run), 1 K1 a
      step, a `post_epoch` callback each epoch, one step of the trainer's
      step function on the card against the CPU from its trained state;
      tests/test_compat.py's TransE flow on the card: violations below
      0.6x the first epoch's, normless1;
   13b compat RESCAL ncomp 100 with `sample.LCWASampler` on FB15k's shape,
      one epoch of 20 steps of 4,832: the iid RESCAL path, 3 K1 a step (E
      and W's 10,000-wide rows on the 16-byte path, W's counts), busy and
      idle share and top operators, one step against the CPU;
   13c `StochasticTrainer` with LCWA, the host loop for an arbitrary
      callable, the pre-split pairs (TransE, normless1), 3 steps each;
      `Model` and `Config` saved and loaded on the card;
   13d `compute_dtype="bfloat16"` against fp32 in the same call:
      full-rank TransR's shared-pool step on 512 positives (3 K1 a step),
      RESCAL's at k = 1,024 (1 K2 and 2 K1 a step), `LinkPredictor` top-10
      over HolE at WN18's shape: step or batch times, the largest score
      gap to fp32 beside the JAX package's bound (0.03, checked for HolE),
      the card's bf16 scores within 1e-4 of the CPU's bf16 path, top-10
      overlap; params and accumulators stay fp32.
14. the quality suite (`python -m skge_torch.quality_suite`) on its default
   latent KG, WN18's shape (40,943 entities, 18 relations, 141,442
   triples, 100 batches of 1,415), each run with the launch counts set to
   0 just before it and held to their exact values after:
   14a `main()` as a user runs it: selfadv TransE-L2, k = 8,192, alpha 2,
      validated every 4 epochs, its `--out` line under build/chip_smoke/:
      1 K1 a step on the 16-byte path, filtered MRR at least
      `QUALITY_SELFADV_GATE`;
   14b RESCAL's margin row, k = 8,192, 2 epochs: 1 K2 and 2 K1 a step,
      filtered MRR at least 5x random;
   14c tests/test_quality_gates.py's three 2,000-entity geometry gates at
      their sizes and thresholds (selfadv, 100 epochs of 20 batches):
      RESCAL and TransE on the bilinear KG, RotatE on the rotational KG;
   14d the suite's iid RESCAL (random-mode, 5 negatives a mode): one
      epoch, 3 K1 a step, then one step from the initial params with
      those accumulators (held at >= 1e-6) on the card against the CPU,
      within 1e-5, the same violations.

15. the out-of-core flagship (`python -m skge_torch.flagship`) and the
   entry points beside it, each run with the launch counts set to 0 just
   before it and held to their exact values after:
   15a `flagship.run` at JAX's 1M shape (the 10^6-entity lattice KG, 8 M
      reciprocal triples, P=4, d=64, k=8,192, sampled CE with Adam, one
      epoch of 16 x 400 steps, 200 queries ranked): every phase line in
      order, finite losses, the restored checkpoint equal bit for bit to
      the saved tables, 1 K1 a step on the 16-byte path (each epoch's count
      equal to its steps), the trainer at the shape phase 3 checked;
   15b one off-diagonal bucket epoch at 15a's shape with the bucket stack
      in pinned host memory (`host_buckets=True`) and on the card, from
      the same state, permutation and pools: the uploaded bucket and the
      ids and mask the epoch receives bit-equal to the device stack's, and
      under `torch.use_deterministic_algorithms(True)` (K1's deterministic
      variant) the same loss and tables, params and Adam slots bit for
      bit;
   15c 15a's streamed ranks against `FilteredRankingEval` on the same
      params, by the 1e-5 gap rule;
   15d `python -m skge_torch.profile_step --epochs 1` (the main path's phase
      ablation at FB15k's shape): 1 K1 a step of its full phase;
   15e `python -m skge_torch.ooc_ce_ab --epochs 2 --eval-every 1 --arms
      ce:1,sampled_ce:2` at WN18's shape: 1 K1 a sampled-CE step, none for
      full CE, a row per arm.
   Phase 3 checks and times K1 at the full 10^7 flagship's step
   (`FLAGSHIP_SHAPE`: R = 2S + 128 = 2,938,776, D = 68) and at 15a's.
16. `python -m skge_torch.bench` and the last entry points of the JAX
   system's tools, each run with the launch counts set to 0 just before it
   and held to their exact values after:
   16a `bench.main()` at bench.py's defaults (FB15k's shape, TransE-L1,
      k=1,024, a warm-up and 3 timed epochs of 100 steps): its JSON line,
      400 K1 on the 16-byte path and no K2, a finite positive `value`, and
      the step time it implies beside phase 4's warm run (no ratio gate);
   16b `bench --all --epochs 1`'s rows (`bench.all_rows`, each through
      `bench.run`): every ALL_ROWS row's line in order, each row's exact
      kernel calls (`BENCH_ROW_CALLS`: RESCAL's K2, none for full and
      sampled CE);
   16c `python -m skge_torch.verify_selfadv` at its size with its asserts
      (the loss drops 40%, MRR > 0.05), one seed each of `verify_ce.run`
      and `verify_n3.run`; the Trainer's default `unique` aggregation and
      full CE launch no kernel;
   16d `python -m skge_torch.rotate_probe` at WN18's widths, 2 epochs,
      gamma 6, the paper, nunif and oracle variants: 2 K1 a step, the
      oracle row's MRR; then the oracle with no epoch: its test MRR and
      H@10 at least JAX's at the generator's latents (0.8651, 1.0), the
      card's ranks equal to the CPU's on the same KG and params by the
      RANK_GAP rule;
   16e one `python -m skge_torch.density_curve` point at its widths (10,000
      entities, d=32, translational, density 3.45), 2 epochs (full CE: no
      kernel);
   16f `python -m skge_torch.run_rescal` on FB15k's shape with the shared
      pool and the dense scatters, one epoch and its validation: 1 K2 and
      2 K1 a step.

Prints one JSON line with the kernel table, the nvidia-smi line, and as
its last line {"ok": true, "device": {...}}.

    python3 chip_smoke.py          # from the root of the repository

`--kernel-times` runs phases 1-2 and phase 3's timings alone, on the same
inputs and without the checks, and prints no result line. Copied into an
older tree of the repository and run there, it times that tree's kernels
at this tree's shapes: parent against change on one card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import timeit
import warnings
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

from skge_torch import (bench, compat, density_curve, flagship, ooc_ce_ab, profile_step,
                        quality_suite, rotate_probe, run_rescal, serving_bench, verify_ce,
                        verify_n3, verify_selfadv)
from skge_torch import sample as host_sample
from skge_torch import (ERMLP, MODELS, RESCAL, AdaGrad, Adam, BernoulliSampler,
                        CorruptedSampler, DistMult, FilteredRankingEval, HolE,
                        LCWASampler, LinkPredictor, OutOfCoreTrainer,
                        RandomModeSampler, ReciprocalEvalWrapper,
                        StreamedLinkPredictor,
                        SharedNegativeSampler, TrainConfig, Trainer, TrainState,
                        TransE, init_state, load_checkpoint, make_ce_step,
                        make_epoch_fn, make_pairwise_step, make_pointwise_step,
                        make_sampled_ce_step, make_selfadv_step, triple_classification)
from skge_torch.data import (add_reciprocal_relations, bernoulli_probs, rows_with_keys,
                             latent_assign, latent_kg, latent_queries,
                             latent_scores, latent_tables, sorted_train_keys,
                             synthetic_kg, type_index_arrays, unigram_logits)
from skge_torch.evaluation import classification_negatives
from skge_torch.experiment import Experiment, make_parser
from skge_torch.models import RotatE, conve
from skge_torch.models.base import ACTIVATIONS
from skge_torch.optim import EPS
from skge_torch.ops import _build, cuda_outer, cuda_segment
from skge_torch.outofcore import BucketPoolSampler, make_bucket_epoch
from skge_torch.parallel import distributed as pdist
from skge_torch.parallel import mesh as pmesh
from skge_torch.parallel import partitioned as ppart
from skge_torch.parallel import sharded as psh
from skge_torch.parallel import shardmap_step as psm
from skge_torch.training import regularized
from skge_torch.utils.debug import assert_finite_state

# the graphs the paths train on: FB15k's shape (DATA) and WN18's
DATA = SimpleNamespace(n_entities=14_951, n_relations=1_345, n_train=483_142,
                       n_test=1_000, seed=0)
WN18 = SimpleNamespace(n_entities=40_943, n_relations=18, n_train=141_442,
                       n_test=1_000, seed=0)
# the TransE slice: `python bench.py` defaults (TransE-L1, shared pool)
TRANSE = SimpleNamespace(
    model="transe", loss="pairwise", sampler="shared", ncomp=150, k=1024,
    margin=1.0, lr=0.1, nbatches=100, epochs=2, steps=0, seed=0, data="fb15k",
    profile=False,
)
# the RESCAL slice: `python bench.py --model rescal --ncomp 100`
RESCAL_PAIRWISE = SimpleNamespace(**{**vars(TRANSE), "model": "rescal",
                                     "ncomp": 100, "rparam": 0.0, "profile": True})
RESCAL_POINTWISE = SimpleNamespace(**{**vars(RESCAL_PAIRWISE),
                                      "loss": "pointwise", "steps": 10,
                                      "profile": False})
# the iid slice. `bench.py --sampler random-mode --negatives 8`: 16 pairs
# per positive
TRANSE_IID = SimpleNamespace(**{**vars(TRANSE), "sampler": "random-mode",
                                "negatives": 8, "profile": True})
# `experiment.py`'s defaults: HolE, sigmoid before the margin 0.2, one
# random-mode negative per positive and mode; "HolE on WN18" of BASELINE.json
HOLE = SimpleNamespace(**{**vars(TRANSE), "model": "hole", "sampler": "random-mode",
                          "negatives": 1, "margin": 0.2, "rparam": 0.0,
                          "data": "wn18", "profile": True})
# "ER-MLP on FB15k with Bernoulli negative sampling" of BASELINE.json
ERMLP_BERNOULLI = SimpleNamespace(**{**vars(TRANSE), "model": "ermlp",
                                     "sampler": "bernoulli", "nhidden": 10,
                                     "margin": 0.2, "profile": True})
HOLE_LCWA = SimpleNamespace(**{**vars(HOLE), "sampler": "lcwa", "ntries": 100,
                               "steps": 10, "profile": False})
HOLE_CORRUPTED = SimpleNamespace(**{**vars(HOLE_LCWA), "sampler": "corrupted"})
HOLE_POINTWISE = SimpleNamespace(**{**vars(HOLE_LCWA), "sampler": "random-mode",
                                    "loss": "pointwise"})
# `bench.py`'s ALL_ROWS row `--model hole --k 4096`
HOLE_SHARED = SimpleNamespace(**{**vars(HOLE_LCWA), "sampler": "shared", "k": 4096})
PATHS = (  # (config, phase)
    (TRANSE, "4"), (RESCAL_PAIRWISE, "4b"), (RESCAL_POINTWISE, "4c"),
    (TRANSE_IID, "4d"), (HOLE, "4e"), (ERMLP_BERNOULLI, "4f"),
    (HOLE_LCWA, "4g"), (HOLE_CORRUPTED, "4g"), (HOLE_POINTWISE, "4g"),
    (HOLE_SHARED, "4g"),
)
KERNELS = {  # name: (wrapper module, source, the TPU kernel it replaces)
    "segment_sum": (cuda_segment, "skge_torch/csrc/segment_sum.cu",
                    "skge_tpu/ops/pallas_segment.py:109"),
    "segment_outer_sum": (cuda_outer, "skge_torch/csrc/segment_outer_sum.cu",
                          "skge_tpu/ops/pallas_outer.py:128"),
}
RTOL = ATOL = 1e-5  # segment_sum: fp32 sums in atomic order, as in tests/test_pallas.py
# the least time of a call: its bytes at the HBM rate, or its fp32
# operations at the rate outside the tensor cores (H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
VECTOR = "segment_sum 16-byte path"  # the launch count of K1's float4 path
# phase 3: K1's deterministic variant checked at these cases (7f's E and W
# counts, 15a's and 15b's step, the edge shapes) and timed at the first two
DETERMINISTIC = ("RESCAL's E", "flagship 1M", "RESCAL's W counts, D=1",
                 "ids<0 and >=R dropped", "D=151 scalar path", "misaligned view",
                 "ragged last block", "wide D=22500", "T=0")
# one step, card against CPU, params and p2. The step starts from warm
# AdaGrad accumulators: from p2 = 0 an update is lr*g/max(|g|, 1e-6), which
# turns an fp32 difference d in a gradient below 1e-6 into a param
# difference of lr*d/1e-6 (RESCAL's E: 1.3e-4 from d ~ 1e-9).
STEP_TOL = 1e-5
# phase 7: the training surface, through `skge_torch.experiment` and the
# `Trainer`, on FB15k's shape as the CLI builds it (`--synthetic-*`)
FB15K_ARGS = ["--synthetic-entities", "14951", "--synthetic-relations", "1345",
              "--synthetic-train", "483142"]
SELFADV_K = 8192  # RECIPES.md's --selfadv and --sampled-ce pools
OUT = "build/chip_smoke"  # phase 7's checkpoints and metrics
# phase 8: the factorization family at the CLI's width (--ncomp 150), the
# shared-pool margin step of `python bench.py` with RECIPES.md:14's --n3
FACTORIZATION = ("distmult", "complex", "simple", "tucker", "quate")
FACT = SimpleNamespace(**{**vars(TRANSE), "n3": 1e-3, "steps": 10, "warm": True,
                          "profile": True})
# RECIPES.md:14, the best-quality recipe of the multiplicative family
RECIPE_14 = ["--model", "complex", "--ce", "--reciprocal", "--optimizer", "adam",
             "--lr", "1e-3", "--label-smoothing", "0.1", "--n3", "1e-3"]
# RESULTS.md's 41k-scale bilinear KG (WN18's shape), and the learning gate's
# (tests/test_quality_gates.py:104-108, with a valid split for the
# classification thresholds)
LATENT_41K = dict(n_entities=40_943, n_relations=18, n_train=141_442,
                  latent_dim=8, seed=0, kind="bilinear")
LATENT_GATE = dict(n_entities=2_000, n_relations=12, n_train=16_000, n_valid=400,
                   n_test=400, latent_dim=8, seed=5, kind="bilinear")
LATENT_CHUNK = 16384  # latent_kg's queries per sweep
GATE_NCOMP, GATE_EPOCHS, GATE_NB = 64, 20, 20  # 8d's CE runs
# phase 9: the rest of the zoo at `bench.py`'s ALL_ROWS widths (--ncomp 150,
# ConvE's 128) on phase 8a's shared-pool margin step, 10 warm steps
ZOO = SimpleNamespace(**{**vars(TRANSE), "steps": 10, "warm": True, "profile": True})
# tag: (model, ncomp, constructor keywords, K1 a step, of them on the 16-byte
# path), from the grouping by feature shape (E, R and the rest of one width
# share a scatter), each group padded with its count channel to a multiple
# of 4 columns; full-rank TransR's M gradient (22,500 wide) scatters without
# the channel and its counts separately (D = 1, the scalar path)
ZOO_MODELS = {
    "rotate": ("rotate", 150, {}, 2, 2),                       # E 304, R 152
    "transh": ("transh", 150, {}, 1, 1),                       # E, R, W 152
    "pairre": ("pairre", 150, {}, 2, 2),                       # E 152, R 304
    "transr factored": ("transr", 150, {"factored": True}, 1, 1),  # E, R, U, V 152
    "transr": ("transr", 150, {}, 3, 2),                       # E, R 152; M 22,500 + 1
    "conve": ("conve", 128, {}, 2, 2),                         # E 132, R 132
}
ZOO_CPU_POSITIVES = {"transr": 512}  # the CPU step of full-rank TransR: a cut batch
# ConvE's step against the CPU starts with its accumulators held at >= 1e-6.
# At the initial params some of its subject gradients lie below AdaGrad's
# 1e-6 floor, at rows the trained run never touched (p2 = 0), where an update
# is lr * g / 1e-6: fp32 rounding of g then moves params by more than
# STEP_TOL (7.4e-05 between fp32 and fp64 on the CPU alone). With p2 >= 1e-6
# an update moves at most lr / 1e-3 = 100 times a gradient's difference.
CONVE_P2_FLOOR = 1e-6
# RECIPES.md:14, the CE recipe, for ConvE at `bench.py`'s --ncomp 128
RECIPE_CONVE = ["--model", "conve", "--ce", "--reciprocal", "--optimizer", "adam",
                "--lr", "1e-3", "--label-smoothing", "0.1", "--ncomp", "128"]
# the JAX package's learning gates, at their sizes: the margin gates of
# tests/test_models_translational_plus.py:188-215, test_models_extra.py:149-175,
# test_models_factorized_plus.py:212-238 and test_transr_sweep.py:182-200
# (factored TransR, seed 2), and ConvE's CE gate of test_conve.py:226-252
MARGIN_GATE = dict(n_entities=400, n_relations=6, n_train=2000, n_valid=0, n_test=60,
                   latent_dim=8)
MARGIN_GATES = {"rotate": ({}, 1), "transh": ({}, 1), "pairre": ({}, 1),
                "transr": ({}, 1), "transr factored": ({"factored": True}, 2)}  # (kw, seed)
CONVE_GATE = dict(n_entities=300, n_relations=6, n_train=1200, n_valid=0, n_test=50,
                  latent_dim=6, seed=1)
RANK_QUERIES = 64  # 9d: score_all_o and score_all_s held to the CPU
# phase 10: the out-of-core trainer and serving at FB15k's shape. 10a-10b:
# TransE-L1 at `bench.py`'s width on the shared-pool margin step, P=4, 20
# batches a bucket, 3 cached parts with prefetch (10b: prefetch off, and 2
# parts); 10d RESCAL at `--ncomp 100`
OOC = SimpleNamespace(parts=4, nbatches=20, k=1024, margin=1.0, lr=0.1, seed=0,
                      cache_parts=3)
# FB15k's partition at P=4: rows a part (S) and triples a batch of the longest
# bucket, which set the kernels' shapes on 10a's and 10d's path (off-diagonal
# buckets: K1 over 2S entity rows). Phase 3 checks and times the kernels there
# before the graph is built; 10a and 10d hold the trainers to these numbers.
OOC_SHAPE = SimpleNamespace(part_size=4_212, batch=2_581)
OOC_P1_TRIPLES = 96_628   # 10c: P=1 against in-core on a fifth of the triples
OOC_CPU_TRIPLES = 48_314  # 10e: card against CPU on a tenth (the CPU's time)
OOC_TOL = 1e-5            # K1 sums with atomics: trajectories within 1e-5
# RECIPES.md's sampled-CE recipe on `--trainer outofcore` at the CLI's shape
OOC_RECIPE = ["--model", "hole", "--trainer", "outofcore", "--parts", "4",
              "--reciprocal", "--sampled-ce", "--optimizer", "adam", "--lr", "1e-3",
              "--k", "8192", "--me", "1", "--test-all", "1", "--nb", "20"]
RANK_GAP = 1e-5  # ranks may differ only where a candidate lies this close
# phase 11: the partitioned trainer at P=1 over a process group of one
# (NCCL on the card), FB15k's shape: TransE-L1 at bench.py's width, k = 1,024,
# AdaGrad 0.1, a batch of 4,832 triples as in phase 4
PART = SimpleNamespace(ncomp=150, k=1024, nbatches=20, margin=1.0, lr=0.1, seed=0,
                       epochs=3)
PART_TRIPLES = 96_628  # 11a: a fifth of the triples, 20 steps of 4,832
PART_SMALL = 9_664     # 11c: 2 steps of 4,832 an epoch (4 on reciprocal relations)
# the batch and cap of 11a's trainer, at which phase 3 checks K1: at P=1
# every object is local and the cap is its floor of 1
PART_SHAPE = SimpleNamespace(batch=4_832, cap=1)
PART_STORE = f"{OUT}/process_group_store"
PART_CLI = ["--synthetic-entities", "14951", "--synthetic-relations", "1345",
            "--synthetic-train", "48314", "--model", "transe", "--sampler", "shared",
            "--k", "1024", "--margin", "1.0", "--ncomp", "150", "--me", "2", "--nb",
            "10", "--test-all", "1", "--trainer", "partitioned"]
# phase 12: the 2-D mesh at (1, 1) over NCCL groups of one, FB15k's shape,
# TransE-L1 at bench.py's width, k = 1,024, AdaGrad 0.1, batches of 4,832
MESH = SimpleNamespace(ncomp=150, k=1024, nbatches=20, margin=1.0, lr=0.1, seed=0,
                       rescal_ncomp=100)
MESH_TRIPLES = 96_628      # 12a: a fifth of the triples, 20 steps of 4,832
MESH_PAD_TRIPLES = 48_310  # 12c: 10 steps of 4,831, padded to 4,832 by pad_to=4
MESH_STORE = f"{OUT}/mesh_group_store"
MESH_QUERIES = 1024        # 12d
# 10g: `skge_torch.serving_bench`'s defaults (its stream of random (s, p)
# queries after nknown random triples from default_rng(0), batch 1,024,
# k=10) and `bench`, the arguments its main() runs with; the streamed engine
# 4 chunks of 4,096
SERVE = SimpleNamespace(nqueries=59_071, nknown=483_142, batch=1024, k=10, chunk=4096,
                        cpu_queries=1024, profile_batches=5, bench=[])
# phase 13: the reference class API (`skge_torch.compat`) at full width and
# cut depth: each trainer's batch is that of 100 batches over the whole graph
# (WN18: 1,415 triples, FB15k: 4,832), over the first `steps` batches' worth of
# triples; README's example (HolE ncomp 150, rparam 0.1, margin 0.2) on WN18,
# RESCAL ncomp 100 with the LCWA sampler on FB15k; `few` steps a path in 13c
COMPAT = SimpleNamespace(nbatches=100, steps=20, epochs=2, few=3, seed=0)
# 13d: compute_dtype="bfloat16" against fp32: full-rank TransR (phase 9a) on
# 512 positives and RESCAL (phase 4b) on a shared pool of k = 1,024, `steps`
# timed steps each; HolE's top-10 serving on `queries` queries
BF16 = SimpleNamespace(k=1024, steps=10, transr_positives=512, queries=8192)
BF16_BOUND = 0.03  # tests/test_training.py:187, the JAX package's bf16 score bound
# the JAX package's out-of-core learning gates (tests/test_outofcore.py),
# at their sizes and thresholds
OOC_MARGIN_GATE = dict(n_entities=600, n_relations=8, n_train=3000, n_valid=0,
                       n_test=80, latent_dim=8, seed=3)
OOC_CE_GATE = dict(n_entities=300, n_relations=6, n_train=900, n_test=40,
                   latent_dim=6, seed=3)
# phase 14: the quality suite (`python -m skge_torch.quality_suite`) on its
# default latent KG, WN18's shape (40,943 entities, 18 relations, 141,442
# triples, 100 batches of 1,415); QUALITY_KG shrinks it for a rehearsal
QUALITY_KG: list = []
QUALITY_SELFADV = ["--loss", "selfadv", "--models", "TransE-L2", "--k", "8192",
                   "--adv-alpha", "2.0", "--epochs", "12", "--eval-every", "4"]
# the filtered-MRR gates: ~35% below what one H100 read at these depths
# (14a 0.2458, 14b 0.054), far above random (~0.0005)
QUALITY_SELFADV_GATE = 0.16
QUALITY_RESCAL = ["--k", "8192", "--models", "RESCAL", "--epochs", "2"]
QUALITY_RESCAL_GATE = 0.035
QUALITY_IID = ["--sampler", "random-mode", "--negatives", "5"]
# phase 15: the out-of-core flagship (`python -m skge_torch.flagship`; its
# sampled-CE step scatters s, o and r of the batch and the pool, E's 2S rows
# and the reciprocal relations stacked, 64 + the count channel padded to 68
# columns). FLAGSHIP_SHAPE: the full 10^7 run's (P=8, S and the batch of the
# longest bucket over 400 steps, as it printed them on the card); phase 3
# checks and times K1 there. 15a runs JAX's 1M shape, at which phase 3 checks
# K1 too and 15a holds its trainer
FLAGSHIP_SHAPE = SimpleNamespace(part_size=1_469_324, relations=128, batch=12_804,
                                 k=8192, dim=64)
FLAGSHIP_1M = ["--entities", "1000000", "--ntrain", "4000000", "--parts", "4",
               "--epochs", "1", "--eval-n", "200"]
FLAGSHIP_1M_SHAPE = SimpleNamespace(part_size=252_500, relations=128, batch=2_759,
                                    k=8192, dim=64)
# 15d, 15e: the profiler at its defaults (the main path) for one epoch; the
# A/B's first and a sampled-CE arm for two epochs at WN18's shape
PROFILE_STEP = ["--epochs", "1"]
OOC_CE_AB = ["--epochs", "2", "--eval-every", "1", "--arms", "ce:1,sampled_ce:2"]
# tests/test_quality_gates.py's geometry gates (selfadv, k 1,024, alpha 2,
# AdaGrad 0.3, 100 epochs of 20 batches, ncomp 32) at their sizes
GEOMETRY = SimpleNamespace(ncomp=32, k=1024, alpha=2.0, lr=0.3, epochs=100, nbatches=20,
                           seed=0)
GEOMETRY_KG = {
    "bilinear": dict(n_entities=2000, n_relations=12, n_train=16000, n_test=400,
                     latent_dim=8, seed=5, kind="bilinear"),
    "rotational": dict(n_entities=2000, n_relations=12, n_train=16000, n_test=400,
                       latent_dim=16, seed=6, kind="rotational"),
}
# phase 16: `python -m skge_torch.bench` and the last entry points. Each
# `--all` row's kernel calls a step (K1, K2, K1 on the 16-byte path); the
# rows not listed scatter E, R and their other row tables of one width in
# one K1 call. RotatE, PairRE and ConvE hold rows of two widths; full CE
# updates whole tables, and sampled CE keeps its step factory's `unique`
# aggregation (index_add_ over torch.unique), as the JAX package's bench does
BENCH_ROW_CALLS = {
    "--model rescal --ncomp 100": (2, 1, 1),
    "--model rotate": (2, 0, 2),
    "--model pairre": (2, 0, 2),
    "--model conve --ncomp 128": (2, 0, 2),
    "--model distmult --ce": (0, 0, 0),
    "--model distmult --sampled-ce --k 8192": (0, 0, 0),
    "--model conve --ncomp 128 --ce": (0, 0, 0),
}
# 16a: bench.py's defaults; 16b: the --all matrix at bench.py's widths for one
# timed epoch
BENCH_DEFAULT: list = []
BENCH_ALL = ["--all", "--epochs", "1"]
# 16d: rotate_probe at its widths, depth cut; 16e: one density_curve point at
# its widths; 16f: run_rescal on the shared pool through the dense scatters
ROTATE_PROBE = ["--epochs", "2", "--eval-every", "1", "--gammas", "6",
                "--variants", "paper,nunif,oracle"]
# the oracle at no epoch: the generator's own latents at rotate_probe's
# defaults, ranked on the card and on the CPU; JAX's test MRR, H@10 and MR
# there (RESULTS.md, "Realizability first", a TPU run) are the floor a fault
# in the full-size KG or in the ranking would fall through
ROTATE_PROBE_ORACLE = ["--epochs", "0", "--gammas", "6", "--variants", "oracle"]
ORACLE_JAX = {"mrr": 0.8651, "hits10": 1.0, "mr": 1.4}
DENSITY_POINT = ["--densities", "3.45", "--geometries", "translational",
                 "--epochs", "2", "--eval-every", "1"]
RUN_RESCAL = ["--sampler", "shared", "--aggregate", "dense_pallas", "--ncomp", "100",
              "--me", "1", "--test-all", "1"]


def bench_launches(config: str, steps: int) -> dict:
    """The kernel calls of `steps` steps of the bench row `config`."""
    k1, k2, vector = BENCH_ROW_CALLS.get(config, (1, 0, 1))
    return _launches(k1 * steps, k2 * steps, vector * steps)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {what}")


def log(*args) -> None:
    print(*args, flush=True)


@contextlib.contextmanager
def deterministic():
    """`torch.use_deterministic_algorithms(True)` for the block: K1 takes its
    sorted variant and sums in a fixed order (warn_only: cuBLAS without a
    fixed workspace warns instead of raising)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def environment() -> str:
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs an NVIDIA GPU", file=sys.stderr)
        raise SystemExit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"[1] python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    return smi


def build() -> None:
    """One nvcc per source, all started together."""
    def one(name):
        t0 = time.perf_counter()
        path, out = _build.build(name)
        return name, path, out, time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(one, KERNELS))
    for name, path, out, dt in built:
        log(f"[2] {name}: {'built' if out is not None else 'cached'} {path.name} "
            f"in {dt:.2f} s")
        for line in (out or "").splitlines():
            if "registers" in line or "spill" in line:
                log("    ptxas:", line.strip())
        KERNELS[name][0]._lib()  # loads, binds the C interface


def call_ms(fn, inputs, n=50):
    """Per call, CUDA events around each call: includes the wrapper's host
    time whenever the host is slower than the card."""
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for start, end in pairs:
        start.record()
        fn(*inputs)
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e_) for s, e_ in pairs)


def device_ms(fn, inputs, n=50, tries=3):
    """Per call, the card's own time: the summed durations of every kernel
    and memset the calls ran (torch.profiler), no host time. A profile that
    saw no kernel at all (the profiler now and then drops a profile's
    device records) is taken again, up to `tries` times, a second apart;
    then the n calls are timed back to back between two CUDA events, and
    the log says so."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                fn(*inputs)
            torch.cuda.synchronize()
        us = sum(e.device_time for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / n / 1e3
        log(f"[3] the profiler saw no kernel of {n} calls (try {attempt + 1} of {tries})")
        time.sleep(1.0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn(*inputs)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / n
    log(f"[3] timed with CUDA events around {n} back-to-back calls instead: {ms:.4f} ms a call")
    return ms


def time_rounds(fns, inputs, what, n=50, n_plain=None) -> dict:
    """Medians of 4 alternating rounds (in order, then reversed, twice) of
    `n` calls of each of `fns` {name: fn} (`n_plain` of "plain", whose
    many small ops make the profiler slow); returns {name: device ms per
    call}."""
    t0 = time.perf_counter()
    calls = {name: n_plain if name == "plain" and n_plain else n for name in fns}
    for name, fn in fns.items():
        call_ms(fn, inputs, min(calls[name], 10))  # warm-up
    times = {(name, how): [] for name in fns for how in ("device", "call")}
    for order in (list(fns), list(fns)[::-1]) * 2:
        for name in order:
            times[name, "device"].append(device_ms(fns[name], inputs, calls[name]))
            times[name, "call"].append(call_ms(fns[name], inputs, calls[name]))
    med = {key: statistics.median(v) for key, v in times.items()}
    log(f"[3] {what}, medians of 4 rounds of " + ", ".join(
        f"{calls[name]} calls of {name}" for name in fns) + ": device time " + ", ".join(
        f"{name} {med[name, 'device']:.4f} ms" for name in fns)
        + "; per-call time with host " + ", ".join(
        f"{name} {med[name, 'call']:.4f} ms" for name in fns)
        + f" ({time.perf_counter() - t0:.1f} s)")
    return {name: med[name, "device"] for name in fns}


def bound(nbytes, flops) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the bytes at the HBM rate and the
    operations at the fp32 rate."""
    by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / FP32_FLOP_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def timed_shape(what, times, nbytes, flops, library="index_add_") -> dict:
    """One timed shape of a kernel: its times, its bound and its share;
    `library` names the PyTorch call (or composite) timed as "library"."""
    b_ms, b_by = bound(nbytes, flops)
    shape = {"shape": what, "ms": times["kernel"], "plain_ms": times.get("plain"),
             "library_ms": times.get("library"), "bound_ms": b_ms, "bound_by": b_by,
             "bound_share": b_ms / times["kernel"]}
    if "library" in times:
        shape["library_call"] = library
    if "library_zeros" in times:  # the library's whole function: zero fill included
        shape["library_zero_fill_ms"] = times["library_zeros"]
    if "grouping" in times:  # K2's index preparation, part of "ms"
        shape["grouping_ms"] = times["grouping"]
    log(f"[3] {what}: bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.2f} MB, "
        f"{flops / 1e6:.1f} MFLOP), kernel at {100 * shape['bound_share']:.1f}% of it")
    return shape


def flagship_k1(shape) -> tuple:
    """(T, R, D, low id, high id, offset) of the flagship step's one K1
    call in an off-diagonal bucket of `shape`."""
    rows = 2 * shape.part_size + shape.relations
    d = shape.dim + 1 + (-(shape.dim + 1) % 4)
    return 3 * shape.batch + shape.k, rows, d, 0, rows, 0


def _batch_size(cfg, n=None) -> int:
    return -(-(DATA.n_train if n is None else n) // cfg.nbatches)


def check_segment_sum(name, idx, grads, nrows, vector) -> float:
    """One case: `segment_sum` against `segment_sum_reference` on the same
    card inputs, on the path it must take; returns the max abs error."""
    t, d = grads.shape
    before = cuda_segment.vector_launches
    got = cuda_segment.segment_sum(idx, grads, nrows)
    want = cuda_segment.segment_sum_reference(idx, grads, nrows)
    torch.cuda.synchronize()
    check(got.shape == (nrows, d), f"segment_sum shape for {name}")
    check(cuda_segment.vector_launches - before == int(vector and t > 0),
          f"segment_sum took the {'16-byte' if vector else 'scalar'} path ({name})")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    ok = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))
    log(f"[3] segment_sum {name:24s} T={t:6d} R={nrows:6d} D={d:6d} "
        f"{'16-byte' if vector else 'scalar '}  max|err|={err:.3e}  "
        f"{'ok' if ok else 'MISMATCH'}")
    check(ok, f"segment_sum against its plain version ({name})")
    return err


def check_deterministic(name, idx, grads, nrows, vector) -> float:
    """One case of K1's deterministic variant: two calls equal bit for bit,
    within RTOL/ATOL of `segment_sum_reference` on the same card inputs, on
    the path it must take; returns the max abs error."""
    t, d = grads.shape
    before = cuda_segment.vector_launches, cuda_segment.deterministic_launches
    with deterministic():
        got = [cuda_segment.segment_sum(idx, grads, nrows) for _ in range(2)]
    want = cuda_segment.segment_sum_reference(idx, grads, nrows)
    torch.cuda.synchronize()
    n = 2 * int(t > 0)
    check((cuda_segment.vector_launches - before[0],
           cuda_segment.deterministic_launches - before[1]) == (n * vector, n),
          f"segment_sum took its deterministic variant, "
          f"{'16-byte' if vector else 'scalar'} path ({name})")
    same = bool(torch.equal(got[0], got[1]))
    sequential = bool(torch.equal(got[0].cpu(), cuda_segment.segment_sum_reference(
        idx.cpu(), grads.cpu(), nrows)))
    err = float((got[0] - want).abs().max()) if got[0].numel() else 0.0
    ok = bool(torch.allclose(got[0], want, rtol=RTOL, atol=ATOL))
    log(f"[3] segment_sum deterministic {name:24s} T={t:6d} R={nrows:6d} D={d:6d} "
        f"{'16-byte' if vector else 'scalar '}  max|err|={err:.3e}  two calls "
        f"{'bit-equal' if same else 'DIFFER'}; the CPU's in-order sum "
        f"{'bit-equal' if sequential else 'not bit-equal'}  {'ok' if ok else 'MISMATCH'}")
    check(same, f"segment_sum's deterministic variant repeats bit for bit ({name})")
    check(ok, f"segment_sum's deterministic variant against its plain version ({name})")
    return err


# the 16-byte path's timed shapes, each beside the plain version
VECTOR_TIMED = ("slice", "iid", "selfadv", "ComplEx, SimplE", "QuatE", "TransR's M",
                "out-of-core TransE", "out-of-core RESCAL's E", "partitioned TransE",
                "partitioned full CE", "RESCAL's E", "mesh iid pointwise",
                "compat RESCAL's W", "quality suite TransE k=8192, WN18",
                "quality suite RESCAL's E, WN18", "quality suite iid RESCAL's W, WN18",
                "flagship 10^7", "flagship 1M", "rotate_probe E, WN18",
                "rotate_probe R, WN18", "bench k=4096")


def segment_sum_checks(dev, verify=True) -> tuple[float, list]:
    """`segment_sum` against `segment_sum_reference` on the same card
    inputs, on the 16-byte and the scalar path (`verify`); returns (max abs
    error, [timed shapes]): the TransE slice's shape first, then the iid
    TransE step's (s, o and 16 corruptions into E, and R, in one scatter),
    the self-adversarial step's (k = 8,192) and the shared pool's at
    ComplEx's and SimplE's 2 x 150-wide rows (D = 304) and QuatE's 4 x 150
    (D = 604), full-rank TransR's M gradient (T = one batch, R = relations,
    D = 150 x 150 = 22,500, no count channel), then the scalar path at
    D = 151 and at RESCAL's W counts (D = 1), each beside the plain version
    and `index_add_` alone on the same (in-range) ids. The out-of-core bucket steps of 10a (TransE:
    E's 2S rows and R in one scatter) and 10d (RESCAL's E, D = 101 padded
    to 104) are checked and timed at their own shapes too."""
    e, r = DATA.n_entities, DATA.n_relations

    def padded(row):  # aggregate's count channel, padded to a multiple of 4 columns
        return row + 1 + (-(row + 1) % 4)

    width = padded(TRANSE.ncomp)  # 152
    complex_w, quate_w = padded(2 * FACT.ncomp), padded(4 * FACT.ncomp)  # 304, 604
    t_slice, rows = 3 * _batch_size(TRANSE) + TRANSE.k, e + r
    t_iid = (3 + 2 * TRANSE_IID.negatives) * _batch_size(TRANSE_IID)
    t_selfadv = 3 * _batch_size(TRANSE) + SELFADV_K
    # an off-diagonal bucket step's scatter: s, o, r and the pool for TransE,
    # s, o and the pool for RESCAL (its W goes through K2)
    s, rescal_w = OOC_SHAPE.part_size, padded(RESCAL_PAIRWISE.ncomp)
    t_ooc_transe, t_ooc_rescal = 3 * OOC_SHAPE.batch + OOC.k, 2 * OOC_SHAPE.batch + OOC.k
    # the partitioned step's one scatter at P=1 (11a): the (S, F+1) shard
    # table (s, o, the pool, and the P * (cap + k) rows of the gradient
    # return) and the relation table, S + R rows; full CE's (11c): the
    # s and o rows of the P * B gathered queries, and the relation rows
    b_part = PART_SHAPE.batch
    t_part = 3 * b_part + PART.k + PART_SHAPE.cap + PART.k
    # in-core RESCAL's E (4b, 12b: s, o and the pool); the mesh's generic
    # iid pointwise route (12b): the batch and its 2 negatives a positive,
    # each triple's s and o into E and its relation into R
    t_rescal_e = 2 * _batch_size(RESCAL_PAIRWISE) + RESCAL_PAIRWISE.k
    t_mesh_pw = 3 * 3 * _batch_size(TRANSE)
    # compat RESCAL's iid pairwise step (13b): W's row of the positive and of
    # the negative triple of each of the batch's 2 pairs a positive, d^2 wide
    # (the two-scatter branch: no count channel, the counts at D = 1)
    t_compat_w = 4 * _batch_size(RESCAL_PAIRWISE)
    compat_w = RESCAL_PAIRWISE.ncomp ** 2
    # the quality suite at WN18's shape (phase 14, its batch of 1,415): the
    # shared pool of 8,192 (TransE, selfadv and margin) and of 2,048 (HolE,
    # DistMult, ComplEx, RotatE) into E and R, RESCAL's E (s, o, the pool),
    # iid x5 (s, o, r and 10 corruptions a positive) and iid RESCAL's W
    b_wn, wn_rows = -(-WN18.n_train // 100), WN18.n_entities + WN18.n_relations
    # phase 16: rotate_probe at its defaults (WN18's entities and relations,
    # its batch and its pool of 8,192): RotatE's E (s, o and the pool, 2 x 16
    # wide) and its R (the batch's relations, 16 phases), each with its count
    # channel; bench's k=4,096 rows (TransE-L2, HolE) into E and R
    probe = rotate_probe.parse_args([])
    b_probe = -(-probe.ntrain // probe.nbatches)
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [  # name, T, R, D, low id, high id, storage offset, 16-byte path
        ("slice", t_slice, rows, width, 0, rows, 0, True),
        ("iid", t_iid, rows, width, 0, rows, 0, True),
        ("selfadv", t_selfadv, rows, width, 0, rows, 0, True),
        ("ComplEx, SimplE", t_slice, rows, complex_w, 0, rows, 0, True),
        ("QuatE", t_slice, rows, quate_w, 0, rows, 0, True),
        ("TransR's M", _batch_size(TRANSE), r, ZOO_MODELS["transr"][1] ** 2, 0, r, 0, True),
        ("out-of-core TransE", t_ooc_transe, 2 * s + r, width, 0, 2 * s + r, 0, True),
        ("out-of-core RESCAL's E", t_ooc_rescal, 2 * s, rescal_w, 0, 2 * s, 0, True),
        ("out-of-core RESCAL's W counts", OOC_SHAPE.batch, r, 1, 0, r, 0, False),
        ("partitioned TransE", t_part, rows, width, 0, rows, 0, True),
        ("partitioned full CE", 3 * b_part, rows, width, 0, rows, 0, True),
        ("RESCAL's E", t_rescal_e, e, rescal_w, 0, e, 0, True),
        ("mesh iid pointwise", t_mesh_pw, rows, width, 0, rows, 0, True),
        ("compat RESCAL's W", t_compat_w, r, compat_w, 0, r, 0, True),
        ("compat RESCAL's W counts", t_compat_w, r, 1, 0, r, 0, False),
        ("quality suite TransE k=8192, WN18", 3 * b_wn + SELFADV_K, wn_rows, width, 0,
         wn_rows, 0, True),
        ("quality suite k=2048, WN18", 3 * b_wn + 2048, wn_rows, width, 0, wn_rows, 0, True),
        ("quality suite RESCAL's E, WN18", 2 * b_wn + SELFADV_K, WN18.n_entities, rescal_w,
         0, WN18.n_entities, 0, True),
        ("quality suite iid HolE, WN18", 13 * b_wn, wn_rows, width, 0, wn_rows, 0, True),
        ("quality suite iid RESCAL's W, WN18", b_wn, WN18.n_relations, compat_w, 0,
         WN18.n_relations, 0, True),
        ("flagship 10^7", *flagship_k1(FLAGSHIP_SHAPE), True),
        ("flagship 1M", *flagship_k1(FLAGSHIP_1M_SHAPE), True),
        ("rotate_probe E, WN18", 2 * b_probe + probe.k, probe.entities,
         padded(2 * probe.ncomp), 0, probe.entities, 0, True),
        ("rotate_probe R, WN18", b_probe, probe.relations, padded(probe.ncomp), 0,
         probe.relations, 0, True),
        ("bench k=4096", 3 * _batch_size(TRANSE) + 4096, rows, width, 0, rows, 0, True),
        ("ids<0 and >=R dropped", t_slice, rows, width, -50, rows + 50, 0, True),
        ("D=151 scalar path", t_slice, rows, width - 1, 0, rows, 0, False),
        ("misaligned view", t_slice, rows, width, 0, rows, 1, False),
        ("ragged last block", 1001, 40, 37, 0, 40, 0, False),
        ("D=1", t_slice, rows, 1, 0, rows, 0, False),
        ("RESCAL's W counts, D=1", _batch_size(RESCAL_PAIRWISE), r, 1, 0, r, 0, False),
        ("wide D=22500", 64, 17, 22_500, 0, 19, 0, True),
        ("T=0", 0, 10, 5, 0, 10, 0, False),
    ]
    worst = 0.0
    timed = {}
    for name, t, nrows, d, lo, hi, shift, vector in cases:
        idx = torch.randint(lo, hi, (t,), generator=gen, device=dev)
        grads = torch.randn(t * d + shift, generator=gen, device=dev)[shift:].view(t, d)
        if verify:
            worst = max(worst, check_segment_sum(name, idx, grads, nrows, vector))
            if name in DETERMINISTIC:
                worst = max(worst, check_deterministic(name, idx, grads, nrows, vector))
        if name in DETERMINISTIC[:2]:
            timed[name, "deterministic"] = (idx, grads, nrows)
        if name in (*VECTOR_TIMED, "D=151 scalar path", "RESCAL's W counts, D=1"):
            timed[name] = (idx, grads, nrows)
    shapes = []
    for key, (idx, grads, nrows) in timed.items():
        # (name, "deterministic"): the variant, and the plain version and
        # `index_add_` under deterministic algorithms too
        name, variant = key if isinstance(key, tuple) else (key, "")
        t, d = grads.shape
        table = torch.zeros(nrows, d, device=dev)
        fns = {"kernel": cuda_segment.segment_sum}
        scalar = name not in VECTOR_TIMED
        fns["plain"] = cuda_segment.segment_sum_reference
        fns["library"] = lambda i, g, _: table.index_add_(0, i, g)
        # K1's whole function: its output zeroed, then the sum
        fns["library_zeros"] = lambda i, g, n: torch.zeros(
            n, g.shape[1], device=g.device).index_add_(0, i, g)
        what = f"{name}, {variant}" if variant else name
        with deterministic() if variant else contextlib.nullcontext():
            times = time_rounds(fns, (idx, grads, nrows),
                                f"segment_sum at T={t}, R={nrows}, D={d} ({what})")
        shapes.append(timed_shape(
            f"T={t}, R={nrows}, D={d}" + (", scalar path" if scalar else "")
            + (f", {name}" if name.startswith(("out-of-core", "partitioned", "RESCAL",
                                                "mesh", "compat", "quality", "flagship",
                                                "rotate_probe", "bench"))
               else "") + (f", {variant}" if variant else ""), times,
            nbytes=8 * t + 4 * t * d + 4 * nrows * d, flops=t * d))
    return worst, shapes


def check_segment_outer_sum(name, idx, us, vs, nrows) -> float:
    """One case: `segment_outer_sum` bit-equal to
    `segment_outer_sum_reference` on the same card inputs and to itself in
    a second call; returns the max abs error."""
    t, dd = us[0].shape
    got = cuda_outer.segment_outer_sum(idx, us, vs, nrows)
    again = cuda_outer.segment_outer_sum(idx, us, vs, nrows)
    want = cuda_outer.segment_outer_sum_reference(idx, us, vs, nrows)
    torch.cuda.synchronize()
    check(got.shape == (nrows, dd, dd), f"segment_outer_sum shape for {name}")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    ok = bool(torch.equal(got, want)) and bool(torch.equal(got, again))
    counts = torch.bincount(idx[(idx >= 0) & (idx < nrows)], minlength=nrows)
    long = counts > 64  # rows longer than a window of the kernel's stream
    log(f"[3] segment_outer_sum {name:22s} T={t:5d} R={nrows:5d} d={dd:4d} "
        f"rank={len(us)} longest row {int(counts.max()) if t else 0:5d}, "
        f"{int(long.sum())} rows of > 64 hold {int(counts[long].sum())} of T  "
        f"{'equal to the plain version and to itself' if ok else 'MISMATCH'}")
    check(ok, f"segment_outer_sum bit-equal to its plain version and itself ({name})")
    return err


def _outer_library(idx, us, vs, nrows):
    """K2's library yardstick, a composite (no single PyTorch call computes
    it): the (T, d, d) outer products by `einsum`, then `index_add_`."""
    d = us[0].shape[1]
    outer = torch.einsum("itd,ite->tde", torch.stack(us), torch.stack(vs))
    return torch.zeros(nrows, d, d, device=idx.device).index_add_(0, idx, outer)


def segment_outer_sum_checks(dev, verify=True) -> tuple[float, list]:
    """`segment_outer_sum` against `segment_outer_sum_reference` on the
    same card inputs, bit for bit, and against itself in a second call
    (`verify`); returns (max abs error, [timed shapes]): the RESCAL
    slice's shape first (T = one batch, R = relations, d = ncomp, rank 2),
    then WN18's 18
    relations (~268 occurrences on every row), half and all of the
    occurrences on row 0 (the longest serial chain there can be), and
    Zipf-distributed ids (P(r) ~ 1 / (r + 1): the long rows have
    neighbouring ids), 10d's out-of-core bucket step (T = its batch) and
    phase 14's RESCAL at WN18's shape (T = 1,415, R = 18); the plain
    version is timed at the first and the last two only, the composite
    library yardstick at every timed shape. Each timed
    shape also times the grouping (`group_by_row`) alone."""
    t_slice, r, d = _batch_size(RESCAL_PAIRWISE), DATA.n_relations, RESCAL_PAIRWISE.ncomp
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = [  # name, T, R, d, rank, low id, high id
        ("slice", t_slice, r, d, 2, 0, r),
        ("WN18 R=18", t_slice, 18, d, 2, 0, 18),
        ("half on row 0", t_slice, 18, d, 2, 0, 18),
        ("all on row 0", t_slice, 18, d, 2, 0, 1),
        ("Zipf", t_slice, r, d, 2, 0, r),
        ("out-of-core", OOC_SHAPE.batch, r, RESCAL_PAIRWISE.ncomp, 2, 0, r),
        ("quality suite, WN18", -(-WN18.n_train // 100), WN18.n_relations,
         RESCAL_PAIRWISE.ncomp, 2, 0, WN18.n_relations),
        ("ids<0 and >=R dropped", t_slice, r, d, 2, -50, r + 50),
        ("rank 1", t_slice, r, d, 1, 0, r),
        ("ragged T, d=37", 1001, 40, 37, 2, 0, 40),
        ("d=1100, rank 3", 300, 7, 1100, 3, 0, 7),
        ("d=12, rank 4", 500, 9, 12, 4, 0, 9),
        # a long row, walked in slabs, at the other ranks and staging widths
        ("half on row 0, rank 1", t_slice, 18, d, 1, 0, 18),
        ("half on row 0, d=37, rank 3", 1001, 5, 37, 3, 0, 5),
        ("half on row 0, d=12, rank 4", 2000, 9, 12, 4, 0, 9),
        ("T=0", 0, 10, 5, 2, 0, 10),
    ]
    worst = 0.0
    timed = {}
    for name, t, nrows, dd, rank, lo, hi in cases:
        idx = torch.randint(lo, hi, (t,), generator=gen, device=dev)
        if name.startswith("half on row 0"):
            idx[torch.randperm(t, generator=gen, device=dev)[: t // 2]] = 0
        if name == "Zipf":
            p = 1.0 / torch.arange(1, nrows + 1, device=dev)
            idx = torch.multinomial(p, t, replacement=True, generator=gen)
        us, vs = ([torch.randn(t, dd, generator=gen, device=dev) for _ in range(rank)]
                  for _ in range(2))
        if verify:
            worst = max(worst, check_segment_outer_sum(name, idx, us, vs, nrows))
        if name in ("slice", "WN18 R=18", "half on row 0", "all on row 0", "Zipf",
                    "out-of-core", "quality suite, WN18"):
            timed[name] = (idx, us, vs, nrows)
    shapes = []
    for name, (idx, us, vs, nrows) in timed.items():
        t, dd = us[0].shape
        fns = {"kernel": cuda_outer.segment_outer_sum}
        if hasattr(cuda_outer, "group_by_row"):  # an older tree's K2 takes no grouping
            fns["grouping"] = lambda i, _u, _v, n: cuda_outer.group_by_row(i, n)
        if name in ("slice", "out-of-core", "quality suite, WN18"):
            fns["plain"] = cuda_outer.segment_outer_sum_reference
        fns["library"] = _outer_library  # no one call: the nearest composite
        times = time_rounds(fns, timed[name], f"segment_outer_sum at T={t}, R={nrows}, "
                            f"d={dd}, rank 2 ({name})", n_plain=3)
        shapes.append(timed_shape(
            f"T={t}, R={nrows}, d={dd}, rank 2"
            + ("" if name in ("slice", "WN18 R=18") else f", {name}"),
            times, nbytes=8 * t + 2 * len(us) * 4 * t * dd + 4 * nrows * dd * dd,
            flops=2 * len(us) * t * dd * dd, library="einsum + index_add_ (composite)"))
    return worst, shapes


def make_model(cfg, ds):
    if cfg.model == "transe":
        return TransE(ds.n_entities, ds.n_relations, ncomp=cfg.ncomp)
    if cfg.model == "rescal":
        return RESCAL(ds.n_entities, ds.n_relations, ncomp=cfg.ncomp, rparam=cfg.rparam)
    if cfg.model == "hole":
        return HolE(ds.n_entities, ds.n_relations, ncomp=cfg.ncomp, rparam=cfg.rparam)
    if cfg.model == "ermlp":
        return ERMLP(ds.n_entities, ds.n_relations, ncomp=cfg.ncomp, nhidden=cfg.nhidden)
    if hasattr(cfg, "model_kw"):  # phase 9; ConvE's relations doubled as bench.py's
        n_r = 2 * ds.n_relations if cfg.model == "conve" else ds.n_relations
        return MODELS[cfg.model](ds.n_entities, n_r, ncomp=cfg.ncomp, **cfg.model_kw)
    return MODELS[cfg.model](ds.n_entities, ds.n_relations, ncomp=cfg.ncomp, n3=cfg.n3)


def modes_of(cfg) -> tuple:
    """The corruption modes of the path: objects only for ConvE."""
    return (1,) if cfg.model == "conve" else (0, 1)


def make_sampler(cfg, ds, dev):
    """The path's sampler, its index arrays on `dev`."""
    n_e, n_r = ds.n_entities, ds.n_relations
    if cfg.sampler == "shared":
        return SharedNegativeSampler(n_e, k=cfg.k, modes=modes_of(cfg))
    if cfg.sampler == "random-mode":
        return RandomModeSampler(n_e, modes=(0, 1) * cfg.negatives)
    if cfg.sampler == "bernoulli":
        return BernoulliSampler(
            n_e, torch.as_tensor(bernoulli_probs(ds.train, n_r), device=dev))
    if cfg.sampler == "lcwa":
        return LCWASampler(n_e, n_r, torch.as_tensor(sorted_train_keys(ds), device=dev),
                           ntries=cfg.ntries)
    return CorruptedSampler(n_e, *(torch.as_tensor(a, device=dev)
                                   for a in type_index_arrays(ds.train, n_r)))


def pairs_per_positive(cfg) -> int:
    """Margin-ranked pairs (or appended negatives) per positive, as
    `bench.py` counts them."""
    if cfg.sampler == "shared":
        return len(modes_of(cfg)) * cfg.k
    if cfg.sampler == "random-mode":
        return 2 * cfg.negatives
    return 1 if cfg.sampler == "bernoulli" else 2


def make_step(cfg, model, opt, sampler, aggregate="dense_pallas"):
    if cfg.loss == "pairwise":
        return make_pairwise_step(model, opt, sampler, margin=cfg.margin,
                                  aggregate=aggregate)
    return make_pointwise_step(model, opt, sampler, aggregate=aggregate)


def profile_run(run, nsteps, host_ms, tag) -> float:
    """The card's busy time of `run()` (torch.profiler) per step over its
    `nsteps`, against `host_ms` a step unprofiled; returns the busy ms."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in events) / nsteps / 1e3
    check(busy > 0, "the profiler saw the card's kernels")
    ours = {}  # the ported kernels at this path's shapes: (calls, device us)
    for e in events:
        if "segment_" in e.name:
            calls, us = ours.get(e.name, (0, 0.0))
            ours[e.name] = (calls + 1, us + e.device_time)
    for name, (calls, us) in sorted(ours.items()):
        log(f"[{tag}] kernel {name[:60]}: {calls / nsteps:g} a step, "
            f"{us / calls / 1e3:.4f} ms a call")
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in ops)
    log(f"[{tag}] device busy {busy:.4f} ms per step ({len(events) / nsteps:.0f} device "
        f"events per step): {100 * busy / host_ms:.2f}% of the {host_ms:.3f} ms step, "
        f"idle {100 - 100 * busy / host_ms:.2f}%; by operator: " + ", ".join(
            f"{e.key} {e.self_device_time_total / nsteps / 1e3:.4f} ms "
            f"({100 * e.self_device_time_total / total:.1f}%)" for e in ops[:10]))
    return busy


def profile(step, state, batches, mask, step_ms, tag) -> float:
    """The card's busy time per step over 5 steps (`profile_run`)."""
    def five_steps():
        st = state
        for i in range(5):
            st, _ = step(st, batches[i], mask)

    return profile_run(five_steps, 5, step_ms, tag)


def train(cfg, ds, dev, tag="4"):
    """Phase 4 (and 8a): one path of the port. With `cfg.warm`, one step
    runs before the clock and the counts. Returns (model, opt, initial
    state, trained state, {kernel: launches during training}, the card's
    busy ms per step or None, [the host-clock step ms of each run])."""
    model = make_model(cfg, ds)
    opt = AdaGrad(lr=cfg.lr)
    step = make_step(cfg, model, opt, make_sampler(cfg, ds, dev))
    state0 = init_state(model, opt, torch.Generator(device=dev).manual_seed(cfg.seed))
    xs = torch.as_tensor(ds.train, dtype=torch.int64, device=dev)
    n = xs.shape[0]
    b = _batch_size(cfg, n)
    # a few steps over the first full batches of one shuffle
    perm = torch.randperm(n, generator=state0.generator, device=dev)
    batches = xs[perm[: (max(cfg.steps, 5) + 1) * b]].reshape(-1, b, 3)
    mask = torch.ones(b, device=dev)
    if cfg.steps == 0:
        epoch = make_epoch_fn(step, n, cfg.nbatches)
        runs, steps, triples = [epoch] * cfg.epochs, cfg.nbatches, n
    else:
        def some_steps(state, xs):
            ms = []
            for i in range(cfg.steps):
                state, m = step(state, batches[i], mask)
                ms.append(m)
            return state, SimpleNamespace(
                loss=torch.stack([m.loss for m in ms]),
                nviolations=torch.stack([m.nviolations for m in ms]))

        runs, steps, triples = [some_steps], cfg.steps, cfg.steps * b
    # bench.py's work units: 2 scored triples per margin-ranked pair; a
    # pointwise step scores each positive and each negative once
    per = 2 * pairs_per_positive(cfg) if cfg.loss == "pairwise" else 1 + pairs_per_positive(cfg)
    scored = per * triples
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = state0
    if getattr(cfg, "warm", False):  # one step before the clock and the counts
        state, _ = step(state, batches[-1], mask)
    reset_counts()
    step_ms = []
    for e, run in enumerate(runs):
        _sync(dev)
        t0 = time.perf_counter()
        state, m = run(state, xs)
        _sync(dev)
        dt = time.perf_counter() - t0
        check(bool(torch.isfinite(m.loss).all()), f"{_label(cfg)} finite losses, run {e}")
        step_ms.append(1e3 * dt / steps)
        log(f"[{tag}] {_label(cfg)} {cfg.loss} {cfg.sampler} run {e} ({steps} steps): "
            f"violations {int(m.nviolations.sum())}  loss {float(m.loss.sum()):.6e}  "
            f"{dt:.3f} s  step {1e3 * dt / steps:.3f} ms  "
            f"{scored / dt:.6e} scored triples/s")
    launches = read_counts()
    if dev.type == "cuda":
        log(f"[{tag}] peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    for name, p in state.params.items():
        check(p.device == xs.device, f"params[{name!r}] stayed on {xs.device}")
        check(bool(torch.isfinite(p).all()), f"params[{name!r}] finite")
    log(f"[{tag}] kernel launches {launches} for {len(runs) * steps} steps")
    if cfg.model == "transe":
        norm = float(state.params["E"].norm(dim=1).max())
        log(f"[{tag}] max row norm of E {norm:.7f}")
        check(norm <= 1.0 + 1e-5, "normless1: max row norm of E <= 1 + 1e-5")
    busy = None
    if cfg.profile and dev.type == "cuda":
        busy = profile(step, state, batches, mask, 1e3 * dt / steps, tag)
    return model, opt, state0, state, launches, busy, step_ms


def _label(cfg) -> str:
    return getattr(cfg, "label", cfg.model)


def expected_launches(cfg) -> dict:
    """Per step: the row params of TransE, HolE and ER-MLP (E and R) share
    one segment_sum, ER-MLP's dense W and C take no scatter; RESCAL's
    shared-pool path runs one segment_outer_sum (W) and two segment_sum (E
    with its count channel, W's counts). Every gradient scatter (the one
    with the count channel, padded to a multiple of 4 columns) takes K1's
    16-byte path; W's counts (D = 1) the scalar one."""
    steps = cfg.steps or cfg.epochs * cfg.nbatches
    if cfg.model == "rescal":
        return {"segment_sum": 2 * steps, "segment_outer_sum": steps, VECTOR: steps}
    return {"segment_sum": steps, "segment_outer_sum": 0, VECTOR: steps}


class FixedPool:
    """A `pool`-protocol sampler that always hands out the same ids; with
    `logits`, sampled CE corrects for that proposal."""

    def __init__(self, ids, modes=(0, 1), logits=None):
        self.ids, self.modes, self.logits = ids, modes, logits

    def pool(self, generator, pos, mask):
        return self.ids.to(pos.device)


class FixedCorruptions:
    """A `corruptions`-protocol sampler that always hands out the same
    corruptions."""

    def __init__(self, corruptions):
        self.corr = corruptions

    def corruptions(self, generator, pos, mask):
        return [(m, r.to(pos.device), v.to(pos.device)) for m, r, v in self.corr]


def _state_on(state: TrainState, dev) -> TrainState:
    return TrainState(
        params={k: v.to(dev) for k, v in state.params.items()},
        opt_state={k: {s: v.to(dev) for s, v in slots.items()}
                   for k, slots in state.opt_state.items()},
        generator=torch.Generator(device=dev),
        step=state.step,
    )


@torch.no_grad()
def near_margin(cfg, model, params, batch, sampler) -> int:
    """Pairs whose transformed scores lie within 1e-4 of the margin test's
    edge: the ones fp32 rounding may flip between two devices."""
    af = ACTIVATIONS[model.pairwise_af][0]
    r = model.gather_rows(params, *(batch[:, i] for i in range(3)))
    dense = model.dense_params(params)
    gp = af(model.score_from_rows(r, dense))
    if isinstance(sampler, FixedPool):
        pool = params["E"][sampler.ids.to(batch.device)]
        gns = [af(model.score_pool(r, pool, dense, mode)) for mode in sampler.modes]
        gp = gp[:, None]
    else:
        gns = [af(model.score_from_rows({**r, "es" if mode == 0 else "eo":
                                         params["E"][repl.to(batch.device)]}, dense))
               for mode, repl, _ in sampler.corr]
    return sum(int(((gn + cfg.margin - gp).abs() < 1e-4).sum()) for gn in gns)


def step_against_cpu(cfg, ds, model, opt, start, dev, tag="5", unique_too=False,
                     positives=None, p2_floor=None):
    """Phase 5: one step from the same state, batch and negatives, on the
    card (kernels) and on the CPU (plain versions). At the initial params
    every pair violates by a wide margin, so the violation counts must
    agree. `unique_too`: also the card's `unique` aggregation (no kernel)
    against its `dense_pallas`. `positives`: the step takes the batch's
    first `positives` rows only, on both. `p2_floor`: the start's AdaGrad
    accumulators held at or above it (see `CONVE_P2_FLOOR`)."""
    if p2_floor is not None:
        log(f"[{tag}] {_label(cfg)}: the start's AdaGrad accumulators held at >= {p2_floor:g}")
        start = start._replace(opt_state={
            k: {"p2": torch.clamp(v["p2"], min=p2_floor)} for k, v in start.opt_state.items()})
    gen = torch.Generator().manual_seed(cfg.seed + 2)
    b = _batch_size(cfg, ds.train.shape[0])
    rows = torch.randperm(ds.train.shape[0], generator=gen)[:b]
    if positives is not None:
        log(f"[{tag}] {_label(cfg)}: the step against the CPU takes the first {positives} "
            f"of the batch's {b} positives (CPU time)")
        rows, b = rows[:positives], positives
    batch = torch.as_tensor(ds.train, dtype=torch.int64)[rows]
    mask = torch.ones(b)
    if cfg.sampler == "shared":
        sampler = FixedPool(torch.randint(0, ds.n_entities, (cfg.k,), generator=gen),
                            modes=modes_of(cfg))
    else:
        cpu = torch.device("cpu")
        sampler = FixedCorruptions(
            make_sampler(cfg, ds, cpu).corruptions(gen, batch, mask))
    step = make_step(cfg, model, opt, sampler)
    t0 = time.perf_counter()
    dev_state, dev_m = step(_state_on(start, dev), batch.to(dev), mask.to(dev))
    _sync(dev)
    t1 = time.perf_counter()
    cpu_state, cpu_m = step(_state_on(start, torch.device("cpu")), batch, mask)
    t2 = time.perf_counter()
    nv_dev, nv_cpu = int(dev_m.nviolations), int(cpu_m.nviolations)
    near = near_margin(cfg, model, {k: v.to(dev) for k, v in start.params.items()},
                       batch.to(dev), sampler)
    log(f"[{tag}] {_label(cfg)}: violations card {nv_dev} cpu {nv_cpu}; pairs "
        f"within 1e-4 of the margin {near}; step {t1 - t0:.3f} s card, "
        f"{t2 - t1:.3f} s cpu")
    others = [("cpu", cpu_state, nv_cpu)]
    if unique_too:
        u_state, u_m = make_step(cfg, model, opt, sampler, aggregate="unique")(
            _state_on(start, dev), batch.to(dev), mask.to(dev))
        others.append(("card unique", u_state, int(u_m.nviolations)))
    for what, other, nv in others:
        for name in start.params:
            want = other.params[name].to(dev)
            diff = float((dev_state.params[name] - want).abs().max())
            other_p2 = other.opt_state[name]["p2"].to(dev)
            dp2 = float((dev_state.opt_state[name]["p2"] - other_p2).abs().max())
            p2_max = float(other_p2.max())
            moved = float((want - start.params[name].to(dev)).abs().max())
            log(f"[{tag}] against {what}: max|d{name}| {diff:.3e}  max|d p2[{name}]| "
                f"{dp2:.3e} (max p2 {p2_max:.3e}; max update of {name} {moved:.3e})")
            # p2 sums squares and grows with training: held relative to its size
            check(diff <= STEP_TOL and dp2 <= STEP_TOL * max(1.0, p2_max),
                  f"one {_label(cfg)} step card vs {what}: {name} within {STEP_TOL}")
        check(nv_dev == nv, f"one {_label(cfg)} step card vs {what}: same violation count")


def evaluate(ds, model, state, dev, tag="6") -> None:
    t0 = time.perf_counter()
    res = FilteredRankingEval(model, ds.test, ds.all_triples())(state.params)
    _sync(dev)
    dt = time.perf_counter() - t0
    for ranks in (res.ranks, res.ranks_raw):
        check(ranks.shape == (2, len(ds.test)), "rank array shape")
        check(bool(np.all((ranks >= 1) & (ranks <= ds.n_entities))),
              "ranks lie in [1, n_entities]")
    log(f"[{tag}] {model.name}: filtered ranking of {len(ds.test)} held-out "
        f"triples in {dt:.2f} s: "
        + json.dumps({k: round(v, 6) for k, v in res.summary().items()}))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_counts() -> None:
    for mod, _, _ in KERNELS.values():
        mod.launches = 0
    cuda_segment.vector_launches = 0


def read_counts() -> dict:
    counts = {name: mod.launches for name, (mod, _, _) in KERNELS.items()}
    counts[VECTOR] = cuda_segment.vector_launches
    return counts


def _launches(k1, k2, vector) -> dict:
    return {"segment_sum": k1, "segment_outer_sum": k2, VECTOR: vector}


def drive(dev, tag, what, trainer, xs, run, want, scored_per_epoch, launches):
    """One phase-7 path, `run()` training `trainer` on the triples `xs`:
    the counts set to 0 just before it and read just after, held to `want`
    (on the card), and added to `launches`. Logs each epoch's metrics
    record with its step time and scored triples/s (`bench.py`'s count,
    `scored_per_epoch`). Returns run's result."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    result = run()
    _sync(dev)
    counts = read_counts()
    nb = min(trainer.config.nbatches, len(xs))
    for r in trainer.metrics.history:
        log(f"[{tag}] {what} epoch {r['epoch']} ({nb} steps): loss {r['loss']:.6e}  "
            f"violations {r['nviolations']}  {r['epoch_seconds']:.3f} s  step "
            f"{1e3 * r['epoch_seconds'] / nb:.3f} ms  "
            f"{scored_per_epoch / r['epoch_seconds']:.6e} scored triples/s")
        check(np.isfinite(r["loss"]), f"{tag}: finite loss")
    log(f"[{tag}] kernel launches {counts}")
    if dev.type == "cuda":
        log(f"[{tag}] peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
        check(counts == want, f"{tag} {what}: launches {counts}, want {want}")
    for name in launches:
        launches[name] += counts[name]
    for name, p in trainer.state.params.items():
        check(p.device.type == dev.type, f"{tag}: params[{name!r}] on {dev}")
        check(bool(torch.isfinite(p).all()), f"{tag}: params[{name!r}] finite")
    return result


def warm_step(trainer, xs_np, tag, scored_per_epoch, steps=10) -> None:
    """The path's warm step on the card: host clock over `steps` steps
    after one of warm-up, from the trained state, with its scored triples/s
    (`scored_per_epoch` over the epoch's steps), then the device's busy
    time over 5 steps (`profile`). Not counted in the path's launches."""
    dev = trainer.device
    b = -(-len(xs_np) // min(trainer.config.nbatches, len(xs_np)))
    nbat = min(steps + 1, len(xs_np) // b)
    batches = torch.as_tensor(xs_np[: nbat * b], dtype=torch.int64,
                              device=dev).reshape(nbat, b, 3)
    mask = torch.ones(b, device=dev)
    step = trainer.make_step()
    state, _ = step(trainer.state, batches[0], mask)
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(steps):
        state, _ = step(state, batches[(i + 1) % nbat], mask)
    _sync(dev)
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    per_step = scored_per_epoch * b / len(xs_np)
    log(f"[{tag}] warm step {step_ms:.3f} ms (host clock, {steps} steps): "
        f"{1e3 * per_step / step_ms:.6e} scored triples/s")
    if dev.type == "cuda":
        profile(step, state, batches, mask, step_ms, tag)


def surface(dev, launches) -> dict:
    """Phase 7: the training surface at full width (FB15k's shape) through
    the CLI's `Experiment` and the `Trainer`. Returns {tag: (trainer, its
    triples)} for the steps against the CPU (5e-5g)."""
    os.makedirs(OUT, exist_ok=True)
    runs = {}
    cpu = ["--cpu"] if dev.type == "cpu" else []  # a rehearsal on the CPU

    # 7a: experiment.py's defaults (HolE, random-mode, margin 0.2, ncomp 150,
    # 100 batches), one validation, the best model's checkpoint, the metrics
    fout, metrics = f"{OUT}/7a.npz", f"{OUT}/7a.jsonl"
    for f in (fout, metrics):
        if os.path.exists(f):
            os.unlink(f)
    exp = Experiment(make_parser().parse_args(cpu + FB15K_ARGS + [
        "--aggregate", "dense_pallas", "--me", "2", "--test-all", "2",
        "--fout", fout, "--metrics", metrics]))
    ds = exp.ds
    n = len(ds.train)

    tr = exp.trainer
    result = drive(dev, "7a", "HolE random-mode margin 0.2 (CLI defaults)", tr, ds.train,
                   exp.run, _launches(200, 0, 200), 2 * 2 * n, launches)
    check(np.isfinite(result["mrr"]) and 0 < result["mrr"] <= 1, "7a: finite test MRR")
    log(f"[7a] valid MRR {exp.best_mrr:.6f}; test "
        + json.dumps({k: round(v, 6) for k, v in result.items()}))
    with open(metrics) as f:
        records = [json.loads(line) for line in f]
    check([r["epoch"] for r in records] == [1, 2], "7a: 2 metrics records")
    state, meta = load_checkpoint(fout, dev)
    check(meta["epoch"] == 2 and state.step == 200, "7a: the checkpoint of epoch 2")
    for name, p in state.params.items():
        check(p.device == dev and torch.equal(p, exp.best_params[name]),
              f"7a: checkpoint params[{name!r}] back on the card")
    warm_step(tr, ds.train, "7a", 2 * 2 * n)

    # 7b: RECIPES.md's selfadv recipe: TransE-L2, shared pool of 8,192
    exp_b = Experiment(make_parser().parse_args(cpu + FB15K_ARGS + [
        "--model", "transe", "--l2", "--selfadv", "--sampler", "shared",
        "--margin", "3.0", "--lr", "0.3", "--k", str(SELFADV_K), "--adv-alpha", "2.0",
        "--aggregate", "dense_pallas", "--me", "1", "--mode", "none"]))

    tr = exp_b.trainer
    drive(dev, "7b", "TransE-L2 selfadv k=8192", tr, ds.train, exp_b.run,
          _launches(100, 0, 100), 2 * 2 * SELFADV_K * n, launches)
    runs["5e"] = tr, ds.train
    warm_step(tr, ds.train, "7b", 2 * 2 * SELFADV_K * n)

    # 7c: RECIPES.md's sampled-CE recipe: HolE, reciprocal, Adam, a unigram pool
    dsr = add_reciprocal_relations(ds)
    nr = len(dsr.train)
    logits = unigram_logits(dsr.train, dsr.n_entities)
    tr = Trainer(HolE(dsr.n_entities, dsr.n_relations, 150),
                 SharedNegativeSampler(dsr.n_entities, k=SELFADV_K, logits=logits),
                 TrainConfig(max_epochs=1, loss="sampled_ce", ce_directions=("o",),
                             optimizer="adam", learning_rate=1e-3,
                             aggregate="dense_pallas"), device=dev)
    drive(dev, "7c", "HolE sampled CE k=8192 unigram, reciprocal, Adam", tr, dsr.train,
          lambda: tr.fit(dsr.train), _launches(100, 0, 100), (SELFADV_K + 1) * nr,
          launches)
    runs["5f"] = tr, dsr.train
    warm_step(tr, dsr.train, "7c", (SELFADV_K + 1) * nr)

    # 7d: RECIPES.md's CE recipe: RESCAL, reciprocal, Adam, label smoothing,
    # cosine schedule; 10 steps of the recipe's batch
    b = -(-nr // 100)
    tr = Trainer(RESCAL(dsr.n_entities, dsr.n_relations, 100), None,
                 TrainConfig(max_epochs=1, nbatches=10, loss="ce", ce_directions=("o",),
                             label_smoothing=0.1, optimizer="adam", learning_rate=1e-3,
                             schedule="cosine", warmup=10), device=dev)
    xs_d = dsr.train[: 10 * b]
    drive(dev, "7d", "RESCAL full CE, reciprocal, Adam, cosine", tr, xs_d,
          lambda: tr.fit(xs_d), _launches(0, 0, 0), dsr.n_entities * len(xs_d), launches)
    runs["5g"] = tr, xs_d
    warm_step(tr, xs_d, "7d", dsr.n_entities * len(xs_d), steps=5)

    # 7e: the Trainer over RESCAL's shared-pool margin step: K2 under it
    b = _batch_size(RESCAL_PAIRWISE)
    xs_e = ds.train[: 10 * b]

    def rescal_trainer(epochs, **kw):
        return Trainer(RESCAL(ds.n_entities, ds.n_relations, RESCAL_PAIRWISE.ncomp),
                       SharedNegativeSampler(ds.n_entities, k=RESCAL_PAIRWISE.k),
                       TrainConfig(max_epochs=epochs, nbatches=10,
                                   margin=RESCAL_PAIRWISE.margin,
                                   aggregate="dense_pallas", **kw), device=dev)

    tr = rescal_trainer(1)
    drive(dev, "7e", "RESCAL shared-pool margin (Trainer)", tr, xs_e,
          lambda: tr.fit(xs_e), _launches(20, 10, 10), 2 * 2 * RESCAL_PAIRWISE.k * len(xs_e),
          launches)
    warm_step(tr, xs_e, "7e", 2 * 2 * RESCAL_PAIRWISE.k * len(xs_e))

    # 7f: resume. 2 epochs with a checkpoint each; the epoch-1 file loaded and
    # fitted from epoch 1 lands within STEP_TOL. Both runs under deterministic
    # algorithms: with K1's atomics a last-bit gap can flip a pair at the
    # margin and part the runs by ~1e-3
    ck, ck1 = f"{OUT}/7f.npz", f"{OUT}/7f_epoch1.npz"
    gen_at_1 = {}

    def keep_epoch_1(trainer):
        if trainer.epoch == 1:
            shutil.copyfile(ck, ck1)
            gen_at_1["state"] = trainer.state.generator.get_state().clone()
        return True

    whole = rescal_trainer(2, checkpoint_path=ck, checkpoint_every=1)
    whole.post_epoch.append(keep_epoch_1)
    reset_counts()
    sorted_before = cuda_segment.deterministic_launches
    with deterministic():
        final = whole.fit(xs_e)
    state, meta = load_checkpoint(ck1, dev)
    check(meta["epoch"] == 1 and state.step == 10, "7f: the epoch-1 checkpoint")
    check(torch.equal(state.generator.get_state(), gen_at_1["state"]),
          "7f: the generator state after load equals epoch 1's")
    with deterministic():
        resumed = rescal_trainer(2).fit(xs_e, state=state, start_epoch=1)
    check(resumed.step == final.step == 20, "7f: 20 steps in all")
    worst = max(float((resumed.params[k] - final.params[k]).abs().max())
                for k in final.params)
    log(f"[7f] resumed from the epoch-1 checkpoint against 2 epochs in one run: "
        f"max|d param| {worst:.3e}")
    sorted_launches = cuda_segment.deterministic_launches - sorted_before
    if dev.type == "cuda":
        check(sorted_launches == 60, f"7f: {sorted_launches} of 60 K1 launches sorted")
    check(worst <= STEP_TOL, f"7f: resumed params within {STEP_TOL}")
    counts = read_counts()
    log(f"[7f] kernel launches {counts} for 30 steps")
    if dev.type == "cuda":
        check(counts == _launches(60, 30, 30), f"7f: launches {counts}")
    for name in launches:
        launches[name] += counts[name]

    # 7g: learning on the card (the recipe of .claude/skills/verify/SKILL.md)
    small = synthetic_kg(200, 8, 2000, seed=0)
    tr = Trainer(TransE(200, 8, 32), RandomModeSampler(200),
                 TrainConfig(max_epochs=15, nbatches=20, margin=0.2,
                             aggregate="dense_pallas"), device=dev)
    drive(dev, "7g", "TransE-L1 learning, 15 epochs", tr, small.train,
          lambda: tr.fit(small.train), _launches(300, 0, 300), 2 * 2 * len(small.train),
          launches)
    warm_step(tr, small.train, "7g", 2 * 2 * len(small.train))
    viol = [r["nviolations"] for r in tr.metrics.history]
    norm = float(tr.state.params["E"].norm(dim=1).max())
    log(f"[7g] violations by epoch {viol}; max row norm of E {norm:.7f}")
    check(viol[-1] <= 0.4 * viol[0], "7g: violations at epoch 15 <= 40% of epoch 1's")
    check(norm <= 1.0 + 1e-5, "7g: max row norm of E <= 1 + 1e-5")
    return runs


def loss_step_against_cpu(tag, trainer, xs_np) -> None:
    """Phases 5e-5g: one step of a phase-7 path on the card and on the CPU,
    from its initial params with the trained run's optimizer state, on the
    same batch and pool ids; params and every optimizer slot within
    STEP_TOL (slots relative to their size)."""
    dev = trainer.device
    cfg = trainer.config
    gen = torch.Generator().manual_seed(7)
    b = -(-len(xs_np) // min(cfg.nbatches, len(xs_np)))
    rows = torch.randperm(len(xs_np), generator=gen)[:b]
    batch = torch.as_tensor(xs_np, dtype=torch.int64)[rows]
    mask = torch.ones(b)
    sampler = trainer.sampler if cfg.loss != "ce" else None  # full CE draws nothing
    if sampler is not None:
        ids = sampler.draw(gen)
        sampler = FixedPool(ids, logits=sampler.logits)
    step = Trainer(trainer.model, sampler, cfg, optimizer=trainer.opt,
                   device="cpu").make_step()
    start = init_state(trainer.model, trainer.opt,
                       torch.Generator(device=dev).manual_seed(cfg.seed))
    # mid-schedule: a cosine warmup gives lr 0 at step 0
    start = start._replace(opt_state=trainer.state.opt_state,
                           step=trainer.state.step // 2)
    t0 = time.perf_counter()
    dev_state, dev_m = step(_state_on(start, dev), batch.to(dev), mask.to(dev))
    _sync(dev)
    t1 = time.perf_counter()
    cpu_state, cpu_m = step(_state_on(start, torch.device("cpu")), batch, mask)
    t2 = time.perf_counter()
    log(f"[{tag}] {cfg.loss} {trainer.model.name}: loss card {float(dev_m.loss):.9e} "
        f"cpu {float(cpu_m.loss):.9e}; step {t1 - t0:.3f} s card, {t2 - t1:.3f} s cpu")
    for name in start.params:
        want = cpu_state.params[name].to(dev)
        diff = float((dev_state.params[name] - want).abs().max())
        moved = float((want - start.params[name].to(dev)).abs().max())
        slots = []
        for slot, got in dev_state.opt_state[name].items():
            other = cpu_state.opt_state[name][slot].to(dev)
            size = float(other.abs().max())
            d = float((got - other).abs().max())
            slots.append(f"{slot} {d:.3e} (max {size:.3e})")
            check(d <= STEP_TOL * max(1.0, size),
                  f"{tag}: {name} slot {slot} card vs cpu within {STEP_TOL} of its size")
        log(f"[{tag}] max|d{name}| {diff:.3e} (max update {moved:.3e}); slots "
            + ", ".join(slots))
        check(diff <= STEP_TOL, f"{tag}: one step card vs cpu, {name} within {STEP_TOL}")


def factorization_margin(graph, dev, launches) -> None:
    """Phase 8a: each factorization model's shared-pool margin step at
    ncomp 150 with n3 (`FACT`), 10 warm steps with the counts set to 0
    just before and held to 1 K1 a step on the 16-byte path after (E and R
    in one scatter; TuckER's core W takes the dense update, no scatter),
    the busy time, `assert_finite_state`, and one step on the card against
    the CPU from warm accumulators. For ComplEx, the N3 term's device time
    over its whole tables beside the busy time."""
    for name in FACTORIZATION:
        cfg = SimpleNamespace(**{**vars(FACT), "model": name})
        model, opt, state0, state, counts, busy, _ = train(cfg, graph, dev, "8a")
        want = _launches(cfg.steps, 0, cfg.steps)
        check(dev.type != "cuda" or counts == want,
              f"8a {name}: launches {counts}, want {want}")
        for k in launches:
            launches[k] += counts[k]
        assert_finite_state(state)
        if name == "complex" and busy is not None:
            tables = {p: state.params[p] for p in model.reg_row_params}
            zeros = {p: torch.zeros_like(v) for p, v in tables.items()}
            n3_ms = device_ms(lambda: [regularized(model, p, zeros[p], v)
                                       for p, v in tables.items()], (), n=20)
            log(f"[8a] complex: the N3 term over the whole E and R tables "
                f"{n3_ms:.4f} ms a step, {100 * n3_ms / busy:.2f}% of the busy "
                f"{busy:.4f} ms")
        step_against_cpu(cfg, graph, model, opt, state0._replace(opt_state=state.opt_state),
                         dev, "8a")


def ce_recipe(dev, launches, tag, what, flags, check_model) -> None:
    """Phases 8b and 9b: a full-CE recipe (`flags`) through `Experiment`,
    `check_model(exp)` first, then 10 steps of its 9,663-triple batch (no
    scatter: full CE updates every table), the warm step, busy time and
    peak memory, `assert_finite_state`, then one step on the card against
    the CPU, every Adam slot too."""
    cpu = ["--cpu"] if dev.type == "cpu" else []
    exp = Experiment(make_parser().parse_args(cpu + FB15K_ARGS + flags + [
        "--me", "1", "--mode", "none"]))
    check_model(exp)
    tr = exp.trainer
    b = -(-len(exp.ds.train) // tr.config.nbatches)
    tr.config = dataclasses.replace(tr.config, nbatches=10)
    xs = exp.ds.train[: 10 * b]
    drive(dev, tag, what, tr, xs, lambda: tr.fit(xs), _launches(0, 0, 0),
          exp.ds.n_entities * len(xs), launches)
    assert_finite_state(tr.state)
    warm_step(tr, xs, tag, exp.ds.n_entities * len(xs), steps=5)
    loss_step_against_cpu(tag, tr, xs)


def complex_recipe(dev, launches) -> None:
    """Phase 8b: RECIPES.md:14 for ComplEx, N3 on."""
    ce_recipe(dev, launches, "8b", "ComplEx full CE, reciprocal, Adam, N3 (RECIPES.md:14)",
              RECIPE_14, lambda exp: check(exp.model.n3 == 1e-3 and exp.model.ncomp == 150,
                                           "8b: ComplEx ncomp 150, n3"))


def latent_sweep(dev) -> None:
    """Phase 8c: `latent_kg(kind='bilinear')` built on the card at the 41k
    scale, timed; then its first chunk of queries assigned again on the
    card and on the CPU: each card object scores within 1e-5 of the CPU's
    best, and equals the CPU's argmax wherever the CPU's top two are more
    than 1e-5 apart; the dataset holds the card's object for every one of
    those queries it kept."""
    kw = LATENT_41K
    _sync(dev)
    t0 = time.perf_counter()
    ds = latent_kg(**kw, device=dev)
    _sync(dev)
    dt = time.perf_counter() - t0
    check(ds.train.shape == (kw["n_train"], 3) and ds.train.dtype == np.int32,
          "8c: the latent KG's shape")
    log(f"[8c] latent_kg bilinear {kw['n_entities']} entities, {kw['n_relations']} "
        f"relations, {kw['n_train']} triples, latent_dim {kw['latent_dim']}: built in "
        f"{dt:.3f} s on {dev}")
    rng = np.random.default_rng(kw["seed"])
    Z, Rel = latent_tables(rng, kw["n_entities"], kw["n_relations"], kw["latent_dim"],
                           kw["kind"])
    s = rng.integers(0, kw["n_entities"], kw["n_train"]).astype(np.int32)[:LATENT_CHUNK]
    p = rng.integers(0, kw["n_relations"], kw["n_train"]).astype(np.int32)[:LATENT_CHUNK]
    eps = np.zeros((1, kw["latent_dim"]), np.float32)
    tables = {}
    for where in (dev, torch.device("cpu")):
        Zd, Rd = torch.as_tensor(Z, device=where), torch.as_tensor(Rel, device=where)
        tables[where.type] = (Zd, Rd, torch.sum(Zd * Zd, dim=1))
    o_dev = latent_assign(kw["kind"], *tables[dev.type], s, p, eps, None)
    Zc, Rc, znc = tables["cpu"]
    sc = latent_scores(kw["kind"], latent_queries(kw["kind"], Zc, Rc, torch.as_tensor(s).long(),
                                                  torch.as_tensor(p).long(),
                                                  torch.as_tensor(eps)), Zc, znc)
    top2 = torch.topk(sc, 2, dim=1).values
    picked = sc[torch.arange(len(s)), torch.as_tensor(o_dev).long()]
    short = float((top2[:, 0] - picked).max())
    clear = (top2[:, 0] - top2[:, 1]) > 1e-5
    o_cpu = torch.argmax(sc, dim=1).numpy()
    differ = int((o_cpu != o_dev).sum())
    differ_clear = int(((o_cpu != o_dev) & clear.numpy()).sum())
    log(f"[8c] {len(s)} queries again on {dev} and on the CPU: the card's objects at most "
        f"{short:.3e} below the CPU's best; {differ} differ, {differ_clear} of them where the "
        f"top two are more than 1e-5 apart ({int((~clear).sum())} queries are not)")
    check(short <= 1e-5, "8c: every card object within 1e-5 of the CPU's best score")
    check(differ_clear == 0, "8c: card and CPU agree wherever the top-2 gap exceeds 1e-5")
    objs = {(a, c): b for a, b, c in ds.train.tolist()}
    kept = [(objs[(a, c)], o) for a, c, o in zip(s.tolist(), p.tolist(), o_dev.tolist())
            if (a, c) in objs]
    check(all(x == y for x, y in kept), "8c: the dataset holds the card's objects")
    log(f"[8c] {len(kept)} of the chunk's queries are in the train split, each with "
        f"the card's object")


def learning_gate(dev) -> None:
    """Phase 8d: DistMult, ComplEx (n3) and TuckER under the CE recipe on
    the learning gate's bilinear KG, built on the card: each filtered MRR
    at least 5x its MRR at init (the order is printed, not gated), and
    ComplEx's triple-classification accuracy above 0.6."""
    ds = latent_kg(**LATENT_GATE, device=dev)
    dsr = add_reciprocal_relations(ds)
    known = ds.all_triples()
    mrrs = {}
    for name, kw in (("distmult", {}), ("complex", {"n3": 1e-3}), ("tucker", {})):
        model = MODELS[name](dsr.n_entities, dsr.n_relations, GATE_NCOMP, **kw)
        ev = FilteredRankingEval(ReciprocalEvalWrapper(model), ds.test, known, batch_size=512)
        tr = Trainer(model, None, TrainConfig(
            max_epochs=GATE_EPOCHS, nbatches=GATE_NB, loss="ce", ce_directions=("o",),
            label_smoothing=0.1, optimizer="adam", learning_rate=1e-3), device=dev)
        init = ev(init_state(model, tr.opt, torch.Generator(device=dev).manual_seed(0))
                  .params).mrr
        t0 = time.perf_counter()
        state = tr.fit(dsr.train)
        _sync(dev)
        dt = time.perf_counter() - t0
        assert_finite_state(state)
        mrrs[name] = ev(state.params).mrr
        log(f"[8d] {name}{' n3 1e-3' if kw else ''}: filtered MRR {init:.4f} at init, "
            f"{mrrs[name]:.4f} after {GATE_EPOCHS} epochs of {GATE_NB} CE steps "
            f"({dt:.2f} s), {mrrs[name] / init:.1f}x")
        check(mrrs[name] >= 5 * init, f"8d: {name}'s MRR at least 5x its MRR at init")
        if name == "complex":
            neg_v = classification_negatives(ds.valid, ds.n_entities, known, seed=1)
            neg_t = classification_negatives(ds.test, ds.n_entities, known, seed=2)
            acc = triple_classification(model, state.params, ds.valid, neg_v, ds.test,
                                        neg_t)["accuracy"]
            log(f"[8d] complex: triple classification accuracy {acc:.4f}")
            check(acc > 0.6, "8d: ComplEx's triple-classification accuracy above 0.6")
    log("[8d] order by filtered MRR: " + " > ".join(
        f"{n} {m:.4f}" for n, m in sorted(mrrs.items(), key=lambda x: -x[1])))


def zoo_configs() -> dict:
    """Phase 9a's paths, {tag: config}, from `ZOO` and `ZOO_MODELS`."""
    return {tag: SimpleNamespace(**{**vars(ZOO), "model": name, "label": tag,
                                   "ncomp": ncomp, "model_kw": kw, "k1": k1,
                                   "vector": vector})
            for tag, (name, ncomp, kw, k1, vector) in ZOO_MODELS.items()}


@contextlib.contextmanager
def tf32_conv_on():
    """cuDNN's TF32 switched on for the whole process, as a caller may."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def conv_guard_errors(model, state, ds, dev) -> None:
    """With cuDNN's TF32 on for the process: ConvE's guarded convolution
    and a plain `F.conv2d` on the same card inputs (4,096 positives' stacked
    images), forward and both backward products against a random output
    gradient, each against the CPU in fp64 (relative to the largest
    |value|)."""
    prm = state.params
    d, (h, w) = model.ncomp, model.grid
    tri = torch.as_tensor(ds.train[:4096], dtype=torch.int64, device=dev)
    img = torch.cat([prm["E"][tri[:, 0], :d].reshape(-1, 1, h, w),
                     prm["R"][tri[:, 2]].reshape(-1, 1, h, w)], dim=2)
    filt = prm["F"]
    gout = torch.randn(img.shape[0], filt.shape[0], *model.conv_out, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(3))

    def run(conv, x, f, g):
        x, f = x.detach().requires_grad_(), f.detach().requires_grad_()
        out = conv(x, f)
        return (out.detach(), *torch.autograd.grad(out, [x, f], g))

    want = run(torch.nn.functional.conv2d, img.double().cpu(), filt.double().cpu(),
               gout.double().cpu())
    with tf32_conv_on():
        got = {"the model's": run(conve._Conv2dFP32.apply, img, filt, gout),
               "a plain F.conv2d's": run(torch.nn.functional.conv2d, img, filt, gout)}
    errs = {what: [float((x.double().cpu() - y).abs().max() / y.abs().max())
                   for x, y in zip(outs, want)] for what, outs in got.items()}
    log("[9a] conve, cuDNN's TF32 on for the process, max|err| / max|value| against fp64 "
        "(output, input gradient, filter gradient): " + "; ".join(
            f"{what} {', '.join(f'{e:.3e}' for e in es)}" for what, es in errs.items()))
    # fp32 sums stay well under 1e-4 of the largest value; TF32's 10-bit
    # mantissa errs ~1e-3
    check(max(errs["the model's"]) <= 1e-4,
          "9a: ConvE's convolution stays fp32 under a global TF32 flag")


def zoo_margin(graph, dev, launches) -> dict:
    """Phase 9a: each model of the zoo on the shared-pool margin step
    (`ZOO`), 10 warm steps with the counts set to 0 just before and held
    to `ZOO_MODELS`' K1 counts after, busy time, idle share, peak memory,
    top operators, `assert_finite_state`, then one step on the card
    against the CPU from warm accumulators (full-rank TransR on a cut
    batch; ConvE's held at `CONVE_P2_FLOOR`); ConvE's again with cuDNN's
    TF32 on for the process. Returns
    {tag: (config, model, trained state)}."""
    trained = {}
    for tag, cfg in zoo_configs().items():
        model, opt, state0, state, counts, *_ = train(cfg, graph, dev, "9a")
        want = _launches(cfg.k1 * cfg.steps, 0, cfg.vector * cfg.steps)
        check(dev.type != "cuda" or counts == want,
              f"9a {tag}: launches {counts}, want {want}")
        for k in launches:
            launches[k] += counts[k]
        assert_finite_state(state)
        start = state0._replace(opt_state=state.opt_state)
        kw = {"positives": ZOO_CPU_POSITIVES.get(tag),
              "p2_floor": CONVE_P2_FLOOR if cfg.model == "conve" else None}
        step_against_cpu(cfg, graph, model, opt, start, dev, "9a", **kw)
        if cfg.model == "conve":
            log("[9a] conve: the step against the CPU again, cuDNN's TF32 on for the process")
            with tf32_conv_on():
                step_against_cpu(cfg, graph, model, opt, start, dev, "9a", **kw)
            if dev.type == "cuda":
                conv_guard_errors(model, state, graph, dev)
        trained[tag] = (cfg, model, state)
    return trained


def conve_recipe(dev, launches) -> None:
    """Phase 9b: RECIPES.md:14's CE recipe for ConvE at --ncomp 128: on
    reciprocal relations without asking, objects only."""
    def check_model(exp):
        check(exp.model.name == "conve" and exp.model.ncomp == 128
              and exp.model.n_relations == exp.ds.n_relations
              and exp.trainer.config.ce_directions == ("o",),
              "9b: ConvE ncomp 128 on reciprocal relations, objects only")

    ce_recipe(dev, launches, "9b", "ConvE full CE, reciprocal, Adam, label smoothing 0.1",
              RECIPE_CONVE, check_model)


def zoo_gates(dev, launches) -> None:
    """Phase 9c: the JAX package's learning gates on the card, at their
    sizes and thresholds: the margin gates (ncomp 24, shared pool of 64,
    margin 0.5, AdaGrad 0.3, 30 epochs of 10 batches, `dense_pallas`):
    violations at the last epoch below 0.7x the first's and filtered MRR
    above 5 / n_e; ConvE's CE gate (reciprocal, ncomp 24, 8 filters,
    AdaGrad 0.3, label smoothing 0.1, 25 epochs of 8 batches): mean loss at
    the last epoch below 0.8x the first's, MRR above 5 / n_e."""
    def run(tag, ds, model, opt, step, nb, epochs, metric, scatters):
        epoch = make_epoch_fn(step, len(ds.train), nb)
        xs = torch.as_tensor(ds.train, dtype=torch.int64, device=dev)
        state = init_state(model, opt, torch.Generator(device=dev).manual_seed(0))
        reset_counts()
        _sync(dev)
        t0 = time.perf_counter()
        seq = []
        for _ in range(epochs):
            state, m = epoch(state, xs)
            seq.append(metric(m))
        _sync(dev)
        dt = time.perf_counter() - t0
        counts = read_counts()
        for k in launches:
            launches[k] += counts[k]
        assert_finite_state(state)
        mrr = FilteredRankingEval(model, ds.test, ds.all_triples(), batch_size=64)(
            state.params).mrr
        log(f"[9c] {tag}: {seq[0]:.6g} at epoch 1, {seq[-1]:.6g} at epoch {epochs} "
            f"({seq[-1] / seq[0]:.3f}x), filtered MRR {mrr:.4f} (gate {5 / ds.n_entities:.4f}); "
            f"{dt:.2f} s, launches {counts}")
        check(dev.type != "cuda" or (counts["segment_sum"] > 0) == scatters,
              f"9c {tag}: the scatters went through K1")
        check(mrr > 5.0 / ds.n_entities, f"9c {tag}: filtered MRR above 5 / n_e")
        return seq

    for tag, (kw, seed) in MARGIN_GATES.items():
        ds = latent_kg(**{**MARGIN_GATE, "seed": seed}, device=dev)
        model = MODELS[tag.split()[0]](ds.n_entities, ds.n_relations, 24, **kw)
        opt = AdaGrad(lr=0.3)
        step = make_pairwise_step(model, opt, SharedNegativeSampler(ds.n_entities, k=64),
                                  margin=0.5, aggregate="dense_pallas")
        viol = run(tag, ds, model, opt, step, 10, 30,
                   lambda m: float(m.nviolations.sum()), scatters=True)
        check(viol[-1] < 0.7 * viol[0], f"9c {tag}: violations fell below 0.7x epoch 1's")
    ds = add_reciprocal_relations(latent_kg(**CONVE_GATE, device=dev))
    model = MODELS["conve"](ds.n_entities, ds.n_relations, 24, nfilters=8)
    opt = AdaGrad(lr=0.3)
    step = make_ce_step(model, opt, directions=("o",), label_smoothing=0.1)
    loss = run("conve CE", ds, model, opt, step, 8, 25, lambda m: float(m.loss.mean()),
               scatters=False)
    check(loss[-1] < 0.8 * loss[0], "9c conve: CE loss fell below 0.8x epoch 1's")


@torch.no_grad()
def zoo_ranking(graph, trained, dev) -> None:
    """Phase 9d: filtered ranking of the held-out triples with each of 9a's
    trained states (ConvE through its reciprocal routing), one filter index
    for all, seconds per 1,000 triples; then `score_all_o` and `score_all_s` of the first
    `RANK_QUERIES` of them on the card against the CPU, within 1e-4 of the
    CPU's largest |score|."""
    test = torch.as_tensor(graph.test[:RANK_QUERIES], dtype=torch.int64)
    t0 = time.perf_counter()
    ev = FilteredRankingEval(next(iter(trained.values()))[1], graph.test,
                             graph.all_triples())
    log(f"[9d] the filter index of {len(graph.all_triples())} known triples built once, "
        f"in {time.perf_counter() - t0:.2f} s on the host")
    for tag, (cfg, model, state) in trained.items():
        ev.model = model
        _sync(dev)
        t0 = time.perf_counter()
        res = ev(state.params)
        _sync(dev)
        dt = time.perf_counter() - t0
        check(bool(np.all((res.ranks >= 1) & (res.ranks <= graph.n_entities))),
              "9d: ranks lie in [1, n_entities]")
        cpu = {k: v.cpu() for k, v in state.params.items()}
        errs = []
        for fn, ent in ((model.score_all_o, test[:, 0]), (model.score_all_s, test[:, 1])):
            got = fn(state.params, ent.to(dev), test[:, 2].to(dev)).cpu()
            want = fn(cpu, ent, test[:, 2])
            errs.append((float((got - want).abs().max()), float(want.abs().max())))
        log(f"[9d] {tag}: {1e3 * dt / len(graph.test):.3f} s per 1,000 triples, filtered "
            f"MRR {res.mrr:.6f}; "
            f"{len(test)} queries card against CPU, score_all_o max|d| {errs[0][0]:.3e} "
            f"(max |score| {errs[0][1]:.3e}), score_all_s {errs[1][0]:.3e} "
            f"({errs[1][1]:.3e})")
        for (err, size), what in zip(errs, ("score_all_o", "score_all_s")):
            check(err <= 1e-4 * size, f"9d {tag}: {what} card vs CPU within 1e-4 relative")


def _ooc_steps(tr, epochs=1) -> int:
    """Step calls of `epochs` epochs: every bucket, min(nbatches, length)."""
    return epochs * len(tr.buckets) * max(1, min(tr.nbatches, tr.bucket_len))


def _ooc(model, triples, dev, opt=None, **kw) -> OutOfCoreTrainer:
    args = dict(n_parts=OOC.parts, margin=OOC.margin, k=OOC.k, nbatches=OOC.nbatches,
                seed=OOC.seed, cache_parts=OOC.cache_parts, prefetch=True, device=dev)
    args.update(kw)
    return OutOfCoreTrainer(model, opt or AdaGrad(lr=OOC.lr), triples, **args)


def _ooc_fit(tr, tag, what, want, launches, epochs=1) -> float:
    """`epochs` of `tr`, the counts set to 0 just before and held to `want`
    after (on the card), added to `launches`; returns the seconds."""
    dev = tr.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    _sync(dev)
    t0 = time.perf_counter()
    tr.fit(epochs=epochs)
    _sync(dev)
    dt = time.perf_counter() - t0
    counts = read_counts()
    steps = _ooc_steps(tr, epochs)
    m = tr.metrics[-1]
    log(f"[{tag}] {what}: {len(tr.buckets)} buckets, {steps} steps in {dt:.3f} s "
        f"({steps / dt:.2f} steps/s, {1e3 * dt / steps:.3f} ms a step): loss "
        f"{m['loss']:.6e}, violations {int(m['nviolations'])}; uploads {tr.uploads}, "
        f"{tr.bytes_uploaded / 1e6:.3f} MB up, {tr.bytes_downloaded / 1e6:.3f} MB down; "
        f"kernel launches {counts}")
    check(np.isfinite(m["loss"]), f"{tag}: finite loss")
    if dev.type == "cuda":
        check(counts == want, f"{tag} {what}: launches {counts}, want {want}")
    for name in launches:
        launches[name] += counts[name]
    return dt


def _ooc_rows_bytes(tr) -> int:
    """Bytes of one part: its rows and every optimizer slot."""
    s = tr.part_size
    return sum(v[:s].numel() * v.element_size() for v in tr.e_host.values())


def _ooc_shape_held(tr, tag) -> None:
    """The trainer's part size and batch are the ones phase 3 checked the
    kernels at (OOC_SHAPE)."""
    batch = -(-tr.bucket_len // max(1, min(tr.nbatches, tr.bucket_len)))
    check((tr.part_size, batch) == (OOC_SHAPE.part_size, OOC_SHAPE.batch),
          f"{tag}: S = {tr.part_size} and a batch of {batch} triples, as phase 3 "
          f"checked the kernels at ({OOC_SHAPE.part_size}, {OOC_SHAPE.batch})")


def _max_diff(a: dict, b: dict) -> float:
    return max(float(np.max(np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k]))))
               for k in a)


def outofcore_margin(graph, dev, launches):
    """10a-10b: the out-of-core TransE-L1 epoch at P=4, the same epoch with
    prefetch off and with 2 cached parts; then the card's busy time over one
    bucket epoch. Returns the 10a trainer."""
    model = TransE(graph.n_entities, graph.n_relations, 150)
    t0 = time.perf_counter()
    tr = _ooc(model, graph.train, dev)
    log(f"[10a] trainer built in {time.perf_counter() - t0:.2f} s (partition, "
        f"relabel, pinned tables): S = {tr.part_size} rows a part, part counts "
        f"{tr.part_counts.tolist()}, bucket length {tr.bucket_len}")
    _ooc_shape_held(tr, "10a")
    init = tr.e_host["param"].clone()
    steps = _ooc_steps(tr)
    dt = _ooc_fit(tr, "10a", "TransE-L1 margin P=4, 3 cached parts, prefetch",
                  _launches(steps, 0, steps), launches)
    check(tr.uploads <= len(tr.buckets) + 1,
          f"10a: {tr.uploads} uploads within the chained-order bound {len(tr.buckets) + 1}")
    if dev.type == "cuda":
        part = _ooc_rows_bytes(tr)
        log(f"[10a] peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} "
            f"GiB; the entity rows it should hold: {OOC.cache_parts} cached parts and a "
            f"bucket's 2S rows, {(OOC.cache_parts + 2) * part / 2**20:.1f} MiB "
            f"({part / 2**20:.2f} MiB a part, rows and p2)")
    s = tr.part_size
    touched = np.zeros(init.shape[0], bool)
    for (pi, pj), rows in tr.buckets.items():
        touched[rows[:, 0]] = touched[rows[:, 1]] = True
        for p in (pi, pj):
            touched[p * s : p * s + tr.part_counts[p]] = True
    check(bool(torch.equal(tr.e_host["param"][~touched], init[~touched])),
          f"10a: the {int((~touched).sum())} rows no bucket touches are unchanged")
    ref = tr.params()
    check(all(np.isfinite(v).all() for v in ref.values()), "10a: params finite")
    check(float(np.linalg.norm(ref["E"], axis=1).max()) <= 1 + 1e-5, "10a: normless1")
    for kw, tag in ((dict(prefetch=False), "prefetch off"), (dict(cache_parts=2),
                                                              "2 cached parts")):
        other = _ooc(model, graph.train, dev, **kw)
        _ooc_fit(other, "10b", f"TransE-L1 margin P=4, {tag}", _launches(steps, 0, steps),
                 launches)
        err = _max_diff(ref, other.params())
        log(f"[10b] {tag}: max |dparam| {err:.3e} against 10a")
        check(err <= OOC_TOL, f"10b {tag}: within {OOC_TOL} of 10a")
    if dev.type == "cuda":
        pi, pj = tr._bucket_order()[1]
        nb = max(1, min(tr.nbatches, tr.bucket_len))
        _sync(dev)
        t0 = time.perf_counter()
        tr._bucket_epoch(pi, pj)
        _sync(dev)
        host_ms = 1e3 * (time.perf_counter() - t0) / nb
        profile_run(lambda: tr._bucket_epoch(pi, pj), nb, host_ms,
                    f"10a bucket {(pi, pj)}")
        tr.flush()
    log(f"[10a] epoch {dt:.3f} s")
    return tr


def outofcore_incore(graph, dev, launches) -> None:
    """10c: P=1 against the in-core shared-pool step under `make_epoch_fn`,
    from the same initial params and the same generator seed."""
    xs = graph.train[:OOC_P1_TRIPLES]
    model = TransE(graph.n_entities, graph.n_relations, 150)
    opt = AdaGrad(lr=OOC.lr)
    tr = _ooc(model, xs, dev, n_parts=1, cache_parts=2)
    gen = torch.Generator(device=dev)
    gen.set_state(tr.generator.get_state())
    state = TrainState(
        params={"E": tr.e_host["param"].to(dev), "R": tr.dev_params["R"].clone()},
        opt_state={"E": {"p2": tr.e_host["p2"].to(dev)},
                   "R": {"p2": tr.dev_opt["R"]["p2"].clone()}},
        generator=gen, step=0)
    step = make_pairwise_step(model, opt, SharedNegativeSampler(graph.n_entities, k=OOC.k),
                              OOC.margin, aggregate="dense")
    epoch = make_epoch_fn(step, len(xs), OOC.nbatches)
    reset_counts()
    state, m = epoch(state, torch.as_tensor(xs, dtype=torch.int64, device=dev))
    _sync(dev)
    counts = read_counts()
    if dev.type == "cuda":
        check(counts == _launches(OOC.nbatches, 0, OOC.nbatches),
              f"10c in-core: launches {counts}")
    for name in launches:
        launches[name] += counts[name]
    _ooc_fit(tr, "10c", f"TransE-L1 margin P=1 on {len(xs)} triples",
             _launches(OOC.nbatches, 0, OOC.nbatches), launches)
    got = tr.params()
    err = _max_diff(got, {k: v.cpu().numpy() for k, v in state.params.items()})
    viol = int(m.nviolations.sum())
    log(f"[10c] P=1 against in-core: max |dparam| {err:.3e}; violations "
        f"{int(tr.metrics[-1]['nviolations'])} and {viol}")
    check(err <= OOC_TOL, f"10c: P=1 within {OOC_TOL} of in-core")


def outofcore_rescal(graph, dev, launches) -> None:
    """10d: out-of-core RESCAL at `--ncomp 100`, P=4: K2 for W, which stays
    on the card, and K1 for E and W's counts."""
    model = RESCAL(graph.n_entities, graph.n_relations, 100)
    tr = _ooc(model, graph.train, dev)
    _ooc_shape_held(tr, "10d")
    steps = _ooc_steps(tr)
    dt = _ooc_fit(tr, "10d", "RESCAL margin P=4", _launches(2 * steps, steps, steps),
                  launches)
    check(all(np.isfinite(v).all() for v in tr.params().values()), "10d: params finite")
    if dev.type == "cuda":
        pi, pj = tr._bucket_order()[1]
        nb = max(1, min(tr.nbatches, tr.bucket_len))
        profile_run(lambda: tr._bucket_epoch(pi, pj), nb, 1e3 * dt / steps,
                    f"10d bucket {(pi, pj)}")
        tr.flush()


class FixedBucketPools(BucketPoolSampler):
    """A bucket sampler handing out given pools, on the generator's device."""

    def __init__(self, base, pools):
        super().__init__(base.slot_stride, base.k, base.modes, base.sizes)
        self.pools = list(pools)

    def pool(self, generator, pos, mask):
        return self.pools.pop(0).to(generator.device)


def _state_to_cpu(card, model, xs) -> OutOfCoreTrainer:
    """A CPU trainer on `xs` holding `card`'s state (host table, slots, the
    card's params and optimizer state, step)."""
    cpu = _ooc(model, xs, torch.device("cpu"), cache_parts=2, prefetch=False)
    for kk, v in card.e_host.items():
        cpu.e_host[kk].copy_(v)
    cpu.dev_params = {kk: v.cpu() for kk, v in card.dev_params.items()}
    cpu.dev_opt = {kk: {sn: v.cpu() for sn, v in sl.items()}
                   for kk, sl in card.dev_opt.items()}
    cpu.step = card.step
    return cpu


def _bucket_against_cpu(tag, card, cpu, one_step) -> None:
    """One off-diagonal bucket on the card and on the CPU from the same
    state, with the same permutation and pool ids: its whole epoch, or its
    first step alone (`one_step`: the trainer's margin step on the 2S-row
    bucket model, over the epoch's first batch). Params within STEP_TOL,
    each optimizer slot within STEP_TOL of its size, the same violations."""
    pi, pj = next(b for b in card._bucket_order() if b[0] != b[1])
    gen = torch.Generator().manual_seed(1)
    perm = torch.randperm(card.bucket_len, generator=gen)
    base = card._samplers[False]
    base.sizes = (int(card.part_counts[pi]), int(card.part_counts[pj]))
    nb = max(1, min(card.nbatches, card.bucket_len))
    batch = -(-card.bucket_len // nb)
    if one_step:
        perm, nb = perm[:batch], 1
    pools = [base.pool(gen, None, None) for _ in range(nb)]
    out = []
    for tr in (card, cpu):
        sampler = tr._samplers[False] = FixedBucketPools(base, pools)
        tr._epochs.pop(False, None)
        if one_step:
            bucket_model = dataclasses.replace(tr.full_model, n_entities=2 * tr.part_size)
            tr._epochs[False] = make_bucket_epoch(make_pairwise_step(
                bucket_model, tr.opt, sampler, OOC.margin, aggregate=tr.aggregate), batch, 1)
        loss, nviol = tr._bucket_epoch(pi, pj, perm=perm)
        tr.flush()
        out.append((float(loss), int(nviol)))
    err = max(_max_diff({"E": cpu.e_host["param"].numpy()},
                        {"E": card.e_host["param"].numpy()}),
              _max_diff({k: v.numpy() for k, v in cpu.dev_params.items()},
                        {k: v.cpu().numpy() for k, v in card.dev_params.items()}))
    # each optimizer slot within STEP_TOL of its size, as in phase 5
    slots = [(cpu.e_host[sn], card.e_host[sn]) for sn in card.e_host if sn != "param"]
    slots += [(cpu.dev_opt[kk][sn], v.cpu()) for kk, sl in card.dev_opt.items()
              for sn, v in sl.items()]
    slot_err = max(float((a - b).abs().max() / max(1.0, float(b.abs().max())))
                   for a, b in slots)
    log(f"[10e] {tag} bucket {(pi, pj)}, {nb} step{'s' * (nb > 1)} of {batch} triples, "
        f"card against CPU: max |dparam| {err:.3e}, slots within {slot_err:.3e} of their "
        f"size; violations {out[0][1]} and {out[1][1]}, loss {out[0][0]:.6e} and "
        f"{out[1][0]:.6e}")
    check(err <= STEP_TOL, f"10e {tag}: card within {STEP_TOL} of the CPU")
    check(slot_err <= STEP_TOL, f"10e {tag}: slots within {STEP_TOL}")
    check(out[0][1] == out[1][1], f"10e {tag}: the same violation count")


def outofcore_against_cpu(graph, warm, dev) -> None:
    """10e: out-of-core bucket steps on the card held to the CPU. As phase
    5, the state is the initial params with warm accumulators: every pair
    then violates by a wide margin, so no margin test sits within rounding
    of its edge. From trained params a pair near the edge flips on the
    other device and moves its rows by a whole term (measured: RESCAL
    9.8e-03 with 2 of 1,127,182 violations flipped).

    - TransE-L1, the main path's model, one step at its shape (the full
      graph, P=4, a batch of OOC_SHAPE.batch) with 10a's accumulators. A
      step from equal params gives the same L1 signs on both devices, so
      only the gradient sums' rounding differs. Over a whole epoch the L1
      trajectories part (measured: 1.0e-03 in 20 steps), presumably as an
      |h + r - t| within rounding of 0 takes the other sign once the params
      differ by that rounding; that cause is inferred, not measured.
    - TransE-L2 and RESCAL, a whole bucket epoch each on a tenth of the
      triples (the CPU's time), accumulators from a warm epoch there."""
    model = TransE(graph.n_entities, graph.n_relations, 150)
    card = _ooc(model, graph.train, dev, cache_parts=2, prefetch=False)
    for kk, v in warm.e_host.items():
        if kk != "param":
            card.e_host[kk].copy_(v)
    card.dev_opt = {kk: {sn: v.clone() for sn, v in sl.items()}
                    for kk, sl in warm.dev_opt.items()}
    _bucket_against_cpu("TransE-L1", card, _state_to_cpu(card, model, graph.train), True)
    xs = graph.train[:OOC_CPU_TRIPLES]
    for tag, model in (("TransE-L2", TransE(graph.n_entities, graph.n_relations, 150,
                                            l1=False)),
                       ("RESCAL", RESCAL(graph.n_entities, graph.n_relations, 100))):
        card = _ooc(model, xs, dev, cache_parts=2, prefetch=False)
        init_e = card.e_host["param"].clone()
        init = {kk: v.clone() for kk, v in card.dev_params.items()}
        card.fit(epochs=1)  # warm accumulators
        card.e_host["param"].copy_(init_e)
        card.dev_params = init
        _bucket_against_cpu(tag, card, _state_to_cpu(card, model, xs), False)


def _min_gaps(model, params, test, dev) -> np.ndarray:
    """(2, n): each query's least |score - target score| over the other
    candidates, objects then subjects, on the card."""
    t = torch.as_tensor(test, dtype=torch.int64, device=dev)
    out = []
    for d in ("o", "s"):
        gaps = []
        for b in torch.split(t, 1024):
            sc = (model.score_all_o(params, b[:, 0], b[:, 2]) if d == "o"
                  else model.score_all_s(params, b[:, 1], b[:, 2]))
            tgt = b[:, 1] if d == "o" else b[:, 0]
            rows = torch.arange(len(b), device=dev)
            diff = torch.abs(sc - sc[rows, tgt][:, None])
            diff[rows, tgt] = float("inf")
            gaps.append(diff.min(dim=1).values)
        out.append(torch.cat(gaps).cpu().numpy())
    return np.stack(out)


def ranks_agree(tag, got, want, gaps) -> None:
    """`got` against `want` ranks (streamed against in-core, or the card's
    against the CPU's): equal wherever no candidate lies within RANK_GAP of
    the target (a (B, S) and a (B, n_e) sweep may round a score
    differently), and the MRRs within 1e-4."""
    far = gaps > RANK_GAP
    for a, b, what in ((got.ranks, want.ranks, "filtered"),
                       (got.ranks_raw, want.ranks_raw, "raw")):
        check(bool(np.array_equal(a[far], b[far])),
              f"{tag}: {what} ranks equal where no candidate lies within {RANK_GAP}")
    log(f"[{tag}] MRR {got.mrr:.6f} against {want.mrr:.6f}; "
        f"{int((~far).sum())} of {far.size} ranks with a candidate within {RANK_GAP}, "
        f"{int((got.ranks != want.ranks).sum())} ranks differ")
    check(abs(got.mrr - want.mrr) <= 1e-4, f"{tag}: MRR within 1e-4")


def outofcore_recipe(dev, launches) -> None:
    """10f: RECIPES.md's sampled-CE recipe through `Experiment` with
    `--trainer outofcore --parts 4`, one epoch and one validation; the
    validation held to the in-core ranking; the `.sharded` checkpoint
    restored into a new trainer and fitted 1 more epoch against the
    uninterrupted run."""
    cpu = ["--cpu"] if dev.type == "cpu" else []
    fout = f"{OUT}/10f.npz"
    shutil.rmtree(fout + ".sharded", ignore_errors=True)
    argv = cpu + FB15K_ARGS + OOC_RECIPE + ["--fout", fout]
    t0 = time.perf_counter()
    exp = Experiment(make_parser().parse_args(argv))
    tr = exp.scaleout
    log(f"[10f] Experiment built in {time.perf_counter() - t0:.2f} s: S = "
        f"{tr.part_size}, {len(tr.buckets)} buckets of up to {tr.bucket_len} triples")
    steps = _ooc_steps(tr)
    reset_counts()
    t0 = time.perf_counter()
    result = exp.run()
    _sync(dev)
    counts = read_counts()
    log(f"[10f] run in {time.perf_counter() - t0:.2f} s (train "
        f"{result['train_seconds']:.2f} s, {steps} steps): kernel launches {counts}; "
        "test " + json.dumps({k: round(v, 6) for k, v in result.items()}))
    if dev.type == "cuda":
        check(counts == _launches(steps, 0, steps), f"10f: launches {counts}")
    for name in launches:
        launches[name] += counts[name]
    check(np.isfinite(result["mrr"]) and 0 < result["mrr"] <= 1, "10f: finite test MRR")
    check(os.path.exists(os.path.join(fout + ".sharded", "manifest.json")),
          "10f: the .sharded checkpoint")
    params = {k: torch.as_tensor(v, device=dev) for k, v in exp.best_params.items()}
    t0 = time.perf_counter()
    wrapped = ReciprocalEvalWrapper(exp.model)
    incore = FilteredRankingEval(wrapped, exp.ds.valid, exp.ds.all_triples(),
                                 batch_size=1024)(params)
    gaps = _min_gaps(wrapped, params, exp.ds.valid, dev)
    log(f"[10f] in-core validation of {len(exp.ds.valid)} triples in "
        f"{time.perf_counter() - t0:.2f} s")
    ranks_agree("10f valid", exp.best_valid, incore, gaps)
    again = Experiment(make_parser().parse_args(argv)).scaleout.restore(fout + ".sharded")
    reset_counts()
    with deterministic():  # as 7f: no atomics' order parts the two runs
        tr.fit(epochs=1)
        again.fit(epochs=1)
    counts = read_counts()
    for name in launches:
        launches[name] += counts[name]
    err = _max_diff(tr.params(), again.params())
    log(f"[10f] resumed from the .sharded checkpoint and fitted 1 epoch: max |dparam| "
        f"{err:.3e} against the uninterrupted run")
    check(err <= OOC_TOL, f"10f: resume within {OOC_TOL}")


def host_waits(run) -> int:
    """The synchronizing CUDA calls in `run()`: each a point where the host
    waits for the card (torch's sync debug mode)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def serving(graph, params, dev) -> None:
    """10g: the serving engines on 10a's trained TransE-L1, on
    `skge_torch.serving_bench`'s query stream and timing at its defaults,
    filtered by the train triples; then `serving_bench.main()` itself at its
    defaults (random params, random known triples)."""
    model = TransE(graph.n_entities, graph.n_relations, 150)
    _, queries = serving_bench.query_stream(graph.n_entities, graph.n_relations,
                                            SERVE.nknown, SERVE.nqueries)
    known, k, n = graph.train, SERVE.k, SERVE.nqueries
    t0 = time.perf_counter()
    exact = LinkPredictor(model, params, known=known, batch_size=SERVE.batch, device=dev)
    log(f"[10g] LinkPredictor built in {time.perf_counter() - t0:.2f} s (filter index "
        f"of {len(known)} triples)")

    def filtered_like_exact(pred):  # the same filter index, built once
        pred._index = exact._index
        return pred

    def timed(pred, what):
        res, dt = serving_bench.timed_top_k(pred, queries, k, dev)
        check(res.entities.shape == (n, k) and np.isfinite(res.scores).all(),
              f"10g {what}: (n, k) finite results")
        log(f"[10g] {what}: {n} queries in {dt:.3f} s, {n / dt:.1f} queries/s "
            f"(host to host, {1e3 * dt / -(-n // SERVE.batch):.3f} ms a batch)")
        return res, dt

    res, dt = timed(exact, "LinkPredictor exact")
    if dev.type == "cuda":
        nb = SERVE.profile_batches
        profile_run(lambda: exact.top_k(queries[: nb * SERVE.batch], k), nb,
                    1e3 * dt / -(-n // SERVE.batch), "10g exact batch")
    # the rule: ids equal wherever the reference's k-th and (k+1)-th scores
    # lie more than RANK_GAP apart (as a set), in order where every gap does
    ref11 = exact.top_k(queries[: SERVE.cpu_queries], k + 1)

    def agree(tag, got, ref):
        gaps = -np.diff(ref.scores.astype(np.float64), axis=1)
        cut = gaps[:, k - 1] > RANK_GAP
        ordered = (gaps > RANK_GAP).all(axis=1)
        sets = np.sort(got.entities, axis=1) == np.sort(ref.entities[:, :k], axis=1)
        check(bool(sets[cut].all()), f"{tag}: the top {k} where the k-th gap > {RANK_GAP}")
        check(bool(np.array_equal(got.entities[ordered], ref.entities[ordered, :k])),
              f"{tag}: ids in order where every gap > {RANK_GAP}")
        fin = np.isfinite(ref.scores[:, :k])
        err = float(np.max(np.abs(got.scores - ref.scores[:, :k])[fin]))
        log(f"[{tag}] {int(cut.sum())} of {len(cut)} queries with a gap at the k-th "
            f"place, {int(ordered.sum())} with every gap > {RANK_GAP}; max |dscore| {err:.3e}")
        check(err <= RANK_GAP, f"{tag}: scores within {RANK_GAP}")

    t0 = time.perf_counter()
    cpu11 = filtered_like_exact(LinkPredictor(
        model, params, batch_size=SERVE.batch, device="cpu")).top_k(
            queries[: SERVE.cpu_queries], k + 1)
    log(f"[10g] the CPU engine on {SERVE.cpu_queries} queries in "
        f"{time.perf_counter() - t0:.2f} s")
    first = SimpleNamespace(entities=res.entities[: SERVE.cpu_queries],
                            scores=res.scores[: SERVE.cpu_queries])
    agree("10g card vs CPU", first, cpu11)
    for quantize in ("int8", "fp8", "bfloat16"):
        q, _ = timed(filtered_like_exact(LinkPredictor(
            model, params, batch_size=SERVE.batch, quantize=quantize, device=dev)),
            f"LinkPredictor {quantize}")
        overlap = np.mean([len(set(a) & set(b)) / k for a, b in zip(res.entities, q.entities)])
        log(f"[10g] {quantize}: mean top-{k} overlap with exact {overlap:.4f}")
    streamed = filtered_like_exact(StreamedLinkPredictor(
        model, params, batch_size=SERVE.batch, chunk=SERVE.chunk, device=dev))
    sres, sdt = timed(streamed, f"StreamedLinkPredictor chunk {SERVE.chunk}")
    batches = 2 * -(-n // SERVE.batch)  # the timed run and its warm-up pass
    log(f"[10g] streamed: {streamed.bytes_uploaded / batches / 1e6:.3f} MB uploaded a "
        f"query batch of {SERVE.batch}")
    if dev.type == "cuda":
        nb = SERVE.profile_batches
        profile_run(lambda: streamed.top_k(queries[: nb * SERVE.batch], k), nb,
                    1e3 * sdt / -(-n // SERVE.batch), "10g streamed batch")
        one = filtered_like_exact(StreamedLinkPredictor(
            model, params, batch_size=SERVE.batch, chunk=graph.n_entities, device=dev))
        waits = {what: host_waits(lambda: pred.top_k(queries[: SERVE.batch], k))
                 for what, pred in (("exact", exact), ("streamed", streamed),
                                    ("streamed in 1 chunk", one))}
        log(f"[10g] the host's waits on the card in one query batch: {waits}")
        check(waits["streamed"] == waits["streamed in 1 chunk"],
              "10g: the streamed engine's host waits do not grow with its chunks")
    agree("10g streamed vs in-core", SimpleNamespace(
        entities=sres.entities[: SERVE.cpu_queries],
        scores=sres.scores[: SERVE.cpu_queries]), ref11)
    argv = (["--cpu"] if dev.type == "cpu" else []) + SERVE.bench
    (line, res), _ = _run_logged("10g", serving_bench.main, argv)
    bench = serving_bench.parse_args(argv)
    check(line["metric"] == "transe_filtered_top10_queries_per_s" and line["value"] > 0
          and res.entities.shape == (bench.nqueries, bench.k), "10g: the serving bench's line")


def outofcore_gates(dev, launches) -> None:
    """10h: the JAX package's out-of-core learning gates on the card."""
    ds = latent_kg(**OOC_MARGIN_GATE, device=dev)
    model = TransE(ds.n_entities, ds.n_relations, 24, l1=False)
    tr = _ooc(model, ds.train, dev, n_parts=2, k=64, nbatches=10, cache_parts=2)
    steps = _ooc_steps(tr, 15)
    _ooc_fit(tr, "10h", "margin gate", _launches(steps, 0, steps), launches, epochs=15)
    m = tr.metrics
    params = {k: torch.as_tensor(v, device=dev) for k, v in tr.params().items()}
    mrr = FilteredRankingEval(model, ds.test, ds.all_triples(), batch_size=32)(params).mrr
    log(f"[10h] margin gate: violations {m[0]['nviolations']:.0f} -> "
        f"{m[-1]['nviolations']:.0f}, MRR {mrr:.4f}")
    check(m[-1]["nviolations"] < 0.7 * m[0]["nviolations"], "10h margin: violations")
    check(mrr > 2.0 / ds.n_entities, "10h margin: MRR over random")
    ds = latent_kg(**OOC_CE_GATE, device=dev)
    for loss in ("ce", "sampled_ce"):
        train = add_reciprocal_relations(ds) if loss == "sampled_ce" else ds
        model = DistMult(train.n_entities, train.n_relations, 16)
        kw = dict(k=64, ce_directions=("o",)) if loss == "sampled_ce" else {}
        tr = _ooc(model, train.train, dev, opt=Adam(lr=1e-2), n_parts=2, nbatches=8,
                  loss=loss, label_smoothing=0.1, cache_parts=2, **kw)
        steps = _ooc_steps(tr, 12) if loss == "sampled_ce" else 0
        _ooc_fit(tr, "10h", f"{loss} gate", _launches(steps, 0, steps), launches,
                 epochs=12)
        losses = [r["loss"] for r in tr.metrics]
        res = tr.evaluate(ds.test, train.all_triples(), batch_size=32,
                          reciprocal=loss == "sampled_ce")
        log(f"[10h] {loss} gate: loss {losses[0]:.4f} -> {losses[-1]:.4f}, streamed MRR "
            f"{res.mrr:.4f}")
        check(losses[-1] < 0.8 * losses[0], f"10h {loss}: loss")
        check(res.mrr > 3.0 / ds.n_entities, f"10h {loss}: MRR over random")


def _part_group(dev) -> "pdist.ShardGroup":
    """Phase 11's process group of one, from a file store under OUT: NCCL
    on the card (gloo when rehearsed on the CPU)."""
    store = os.path.abspath(PART_STORE)
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.unlink(store)
    pdist.initialize(coordinator_address="file://" + store, num_processes=1,
                     process_id=0, local_rank=dev.index or 0, device=dev.type)
    group = pdist.make_shard_mesh()
    backend = torch.distributed.get_backend()
    log(f"[11] process group: {backend}, rank {group.rank} of {group.size}, "
        f"device {group.device}")
    check(backend == ("nccl" if dev.type == "cuda" else "gloo") and group.size == 1,
          "11: an NCCL group of one on the card")
    return group


def _cpu_group() -> "pdist.ShardGroup":
    """A gloo group of the same one process: the CPU side of 11b-11c."""
    return pdist.ShardGroup(group=torch.distributed.new_group(backend="gloo"), rank=0,
                            size=1, device=torch.device("cpu"))


def _part_trainer(model, opt, triples, group, **kw) -> "ppart.PartitionedTrainer":
    args = dict(margin=PART.margin, k=PART.k, nbatches=PART.nbatches, seed=PART.seed)
    args.update(kw)
    return ppart.PartitionedTrainer(model, opt, triples, group, **args)


def _part_batch(tr) -> int:
    return -(-tr._batches.shape[0] // tr.nbatches)


def _part_step(loss, model, opt, sampler, group, cap, directions=("o", "s"), ls=0.0,
               margin=PART.margin, alpha=1.0):
    """The partitioned step of `loss` on `group`."""
    if loss == "margin":
        return ppart.make_partitioned_pairwise_step(model, opt, sampler, margin, group,
                                                    boundary_cap=cap)
    if loss == "selfadv":
        return ppart.make_partitioned_selfadv_step(model, opt, sampler, margin, group,
                                                   alpha=alpha, boundary_cap=cap)
    if loss == "sampled_ce":
        return ppart.make_partitioned_sampled_ce_step(model, opt, sampler, group,
                                                      directions, ls, boundary_cap=cap)
    return ppart.make_partitioned_ce_step(model, opt, group, directions, ls)


def partitioned_margin(graph, dev, group, launches):
    """11a: one epoch of the partitioned TransE-L1 trainer (20 steps of
    4,832 triples) with the dense and with the ragged exchange, from the
    same seed: exact K1 launches, host waits a step, the card's busy time
    and idle share, the first step's violations equal and the params
    within OOC_TOL. Returns (the dense trainer, its initial state, its
    triples)."""
    xs = graph.train[:PART_TRIPLES]
    runs = {}
    for exchange in ("dense", "ragged"):
        model = TransE(graph.n_entities, graph.n_relations, PART.ncomp)
        t0 = time.perf_counter()
        tr = _part_trainer(model, AdaGrad(lr=PART.lr), xs, group, exchange=exchange)
        state0 = tr._state
        steps, batch = tr.nbatches, _part_batch(tr)
        log(f"[11a] {exchange}: trainer built in {time.perf_counter() - t0:.2f} s: "
            f"S = {tr.model.n_entities}, cap {tr.cap}, {steps} steps of {batch} triples")
        check((batch, tr.cap) == (PART_SHAPE.batch, PART_SHAPE.cap),
              f"11a: a batch of {batch} and cap {tr.cap}, as phase 3 checked K1 at")
        run = lambda: tr._epoch(tr._state, tr._batches, tr._mask)  # noqa: E731
        reset_counts()
        _sync(dev)
        t0 = time.perf_counter()
        tr._state, m = run()
        _sync(dev)
        dt_first = time.perf_counter() - t0
        counts = read_counts()
        for name in launches:
            launches[name] += counts[name]
        viol = m.nviolations.cpu().numpy()
        loss = float(m.loss.sum())
        t0 = time.perf_counter()  # the second epoch, warm (NCCL's first calls set it up)
        tr._state, m2 = run()
        _sync(dev)
        dt = time.perf_counter() - t0
        log(f"[11a] {exchange}: first epoch of {steps} steps in {dt_first:.3f} s, the second "
            f"in {dt:.3f} s ({1e3 * dt / steps:.3f} ms a step): first epoch's loss {loss:.6e}, "
            f"violations {int(viol.sum())} (first step {int(viol[0])}, last "
            f"{int(viol[-1])}), second epoch's {int(m2.nviolations.sum())}; kernel launches "
            f"of the first {counts}")
        check(np.isfinite(loss) and viol[0] > 0, f"11a {exchange}: finite loss, violations")
        if dev.type == "cuda":
            check(counts == _launches(steps, 0, steps),
                  f"11a {exchange}: launches {counts}, want 1 K1 a step on the 16-byte path")
        ppart.host_waits = 0
        waits = host_waits(run) if dev.type == "cuda" else run() and 0
        own = ppart.host_waits
        log(f"[11a] {exchange}: {waits} synchronizing calls in an epoch of {steps} steps; "
            f"the ragged exchange's own reads of its splits: {own}")
        if dev.type == "cuda":
            profile_run(run, steps, 1e3 * dt / steps, f"11a {exchange}")
        runs[exchange] = (tr, state0, viol, waits, own)
    dense, ragged = runs["dense"], runs["ragged"]
    check(dense[2][0] == ragged[2][0], "11a: the first step's violations equal")
    steps = dense[0].nbatches
    if dev.type == "cuda":
        check(ragged[3] - dense[3] == 2 * steps and ragged[4] == 2 * steps and dense[4] == 0,
              f"11a: the ragged exchange waits for the host twice a step "
              f"({ragged[3]} against {dense[3]} synchronizing calls)")
    # the same epochs each now; params within OOC_TOL (K1 sums with atomics)
    err = _max_diff(dense[0].params(), ragged[0].params())
    log(f"[11a] ragged against dense after the same epochs: max |dparam| {err:.3e}")
    check(err <= OOC_TOL, f"11a: ragged within {OOC_TOL} of dense")
    params = dense[0].params()
    check(all(np.isfinite(v).all() for v in params.values()), "11a: params finite")
    check(float(np.linalg.norm(params["E"], axis=1).max()) <= 1 + 1e-5, "11a: normless1")
    return dense[0], dense[1], xs


def _held_to_cpu(tag, card_state, cpu_state, nv=None):
    """Params within STEP_TOL, each optimizer slot within STEP_TOL of its
    size, and the same violations."""
    for name in card_state.params:
        d = float((card_state.params[name].cpu() - cpu_state.params[name].cpu()).abs().max())
        worst = 0.0
        for sn, v in card_state.opt_state[name].items():
            w = cpu_state.opt_state[name][sn].cpu()
            worst = max(worst, float((v.cpu() - w).abs().max()) / max(1.0, float(w.abs().max())))
        log(f"[{tag}] max|d{name}| {d:.3e}, slots within {worst:.3e} of their size")
        check(d <= STEP_TOL and worst <= STEP_TOL, f"{tag}: {name} within {STEP_TOL}")
    if nv is not None:
        log(f"[{tag}] violations {nv[0]} and {nv[1]}")
        check(nv[0] == nv[1], f"{tag}: the same violation count")


def partitioned_against_cpu(tr, state0, dev, group, cpu_group) -> None:
    """11b: one partitioned step from the initial params with 11a's AdaGrad
    accumulators, the same batch and pool ids, on the card and on the CPU
    (a gloo group of one), then against the port's in-core
    `make_pairwise_step` on the card (at P=1 the same trajectory)."""
    start = state0._replace(opt_state=tr._state.opt_state)
    gen = torch.Generator().manual_seed(PART.seed + 2)
    b = _part_batch(tr)
    batch, mask = tr._batches[:b], torch.ones(b, device=dev)
    pool = FixedPool(torch.randint(0, tr.model.n_entities, (PART.k,), generator=gen))
    out = {}
    for what, g in (("card", group), ("cpu", cpu_group)):
        # the pool is fixed: a fresh generator on each group's device
        st = ppart.shard_state_partitioned(start, tr.model, g,
                                           generator=torch.Generator(device=g.device))
        step = _part_step("margin", tr.model, tr.opt, pool, g, tr.cap)
        t0 = time.perf_counter()
        out[what] = step(st, batch.to(g.device), mask.to(g.device))
        _sync(g.device)
        log(f"[11b] the partitioned step on the {what}: {time.perf_counter() - t0:.3f} s")
    incore = make_pairwise_step(tr.model, tr.opt, pool, PART.margin, aggregate="dense_pallas")(
        _state_on(start, dev), batch, mask)
    nv = {k: int(v[1].nviolations) for k, v in (*out.items(), ("in-core", incore))}
    _held_to_cpu("11b card vs cpu", out["card"][0], out["cpu"][0], (nv["card"], nv["cpu"]))
    _held_to_cpu("11b partitioned vs in-core", out["card"][0], incore[0],
                 (nv["card"], nv["in-core"]))


def partitioned_losses(graph, dev, group, cpu_group, launches) -> None:
    """11c: self-adversarial, sampled CE on reciprocal relations and full CE
    (DistMult), 3 epochs each on 9,664 triples: exact K1 launches, the loss
    falls, and one step on the card against the CPU from the initial params
    with the trained optimizer state."""
    xs = graph.train[:PART_SMALL]
    rec = add_reciprocal_relations(dataclasses.replace(graph, train=xs))
    e, r = graph.n_entities, graph.n_relations
    configs = (  # tag, model, optimizer, triples, nbatches, trainer keywords
        ("selfadv", TransE(e, r, PART.ncomp, l1=False), AdaGrad(lr=PART.lr), xs, 2,
         dict(loss="selfadv", margin=3.0, adv_alpha=2.0)),
        ("sampled CE, reciprocal", DistMult(e, 2 * r, PART.ncomp), Adam(lr=1e-2),
         rec.train, 4, dict(loss="sampled_ce", reciprocal=True, label_smoothing=0.1)),
        ("full CE", DistMult(e, r, PART.ncomp), Adam(lr=1e-2), xs, 2,
         dict(loss="ce", label_smoothing=0.1)),
    )
    for tag, model, opt, triples, nb, kw in configs:
        tr = _part_trainer(model, opt, triples, group, nbatches=nb, **kw)
        state0 = tr._state
        steps = PART.epochs * tr.nbatches
        check(_part_batch(tr) == PART_SHAPE.batch, f"11c {tag}: a batch of {PART_SHAPE.batch}")
        reset_counts()
        t0 = time.perf_counter()
        tr.fit(PART.epochs)
        _sync(dev)
        dt = time.perf_counter() - t0
        counts = read_counts()
        for name in launches:
            launches[name] += counts[name]
        losses = [m["loss"] for m in tr.metrics]
        log(f"[11c] {tag}: {steps} steps in {dt:.3f} s ({1e3 * dt / steps:.3f} ms a step), "
            f"epoch losses {', '.join(f'{x:.6e}' for x in losses)}; kernel launches {counts}")
        check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"11c {tag}: the loss falls")
        if dev.type == "cuda":
            check(counts == _launches(steps, 0, steps),
                  f"11c {tag}: launches {counts}, want 1 K1 a step on the 16-byte path")
        start = state0._replace(opt_state=tr._state.opt_state)
        gen = torch.Generator().manual_seed(PART.seed + 3)
        b = _part_batch(tr)
        batch, mask = tr._batches[:b], torch.ones(b, device=dev)
        pool = FixedPool(torch.randint(0, model.n_entities, (PART.k,), generator=gen))
        loss = kw["loss"]
        dirs = ("o",) if kw.get("reciprocal") else ("o", "s")
        args = dict(directions=dirs, ls=kw.get("label_smoothing", 0.0),
                    margin=kw.get("margin", PART.margin), alpha=kw.get("adv_alpha", 1.0))
        got = {}
        for what, g in (("card", group), ("cpu", cpu_group)):
            step = _part_step(loss, tr.model, opt, pool, g, min(tr.cap, b), **args)
            st = ppart.shard_state_partitioned(start, tr.model, g,
                                               generator=torch.Generator(device=g.device))
            got[what] = step(st, batch.to(g.device), mask.to(g.device))[0]
        _held_to_cpu(f"11c {tag} card vs cpu", got["card"], got["cpu"])


def partitioned_resume(tr, xs, dev, group, launches) -> None:
    """11d: 11a's dense trainer saved, one more epoch, against a new
    trainer restored from the directory and fitted one epoch."""
    d = f"{OUT}/11d.sharded"
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    tr.save(d)
    t_save = time.perf_counter() - t0
    again = _part_trainer(TransE(tr.model.n_entities, tr.model.n_relations, PART.ncomp),
                          AdaGrad(lr=PART.lr), xs, group)
    t0 = time.perf_counter()
    again.restore(d)
    t_restore = time.perf_counter() - t0
    reset_counts()
    tr.fit(1)
    again.fit(1)
    counts = read_counts()
    for name in launches:
        launches[name] += counts[name]
    err = _max_diff(tr.params(), again.params())
    log(f"[11d] saved in {t_save:.3f} s ({sorted(os.listdir(d))}), restored in "
        f"{t_restore:.3f} s; one more epoch each: max |dparam| {err:.3e}")
    check(err <= OOC_TOL, f"11d: resume within {OOC_TOL} of the uninterrupted run")


def partitioned_ranking(graph, tr, dev) -> None:
    """11e: the sharded filtered ranking against `FilteredRankingEval` on
    `params()` (gathered, original ids), by phase 10f's gap rule."""
    t0 = time.perf_counter()
    got = tr.evaluate(graph.test, graph.all_triples())
    _sync(dev)
    t_sharded = time.perf_counter() - t0
    model = tr.full_model
    params = {k: torch.as_tensor(v, device=dev) for k, v in tr.params().items()}
    t0 = time.perf_counter()
    want = FilteredRankingEval(model, graph.test, graph.all_triples())(params)
    _sync(dev)
    log(f"[11e] {len(graph.test)} test triples: sharded ranking {t_sharded:.3f} s, "
        f"in-core {time.perf_counter() - t0:.3f} s")
    ranks_agree("11e", got, want, _min_gaps(model, params, graph.test, dev))


def partitioned_cli(dev, launches) -> None:
    """11f: `python -m skge_torch.experiment --trainer partitioned` in this
    process after phase 11's group is gone, with no launch variables set:
    `initialize()` forms a world of one; 2 epochs of 10 steps, two sharded
    validations and the test ranking."""
    pdist.destroy()
    names = ("SKGE_COORDINATOR", "SKGE_NUM_PROCESSES", "SKGE_PROCESS_ID", "MASTER_ADDR",
             "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
    saved = {k: os.environ.pop(k) for k in names if k in os.environ}
    try:
        argv = (["--cpu"] if dev.type == "cpu" else []) + PART_CLI
        t0 = time.perf_counter()
        exp = Experiment(make_parser().parse_args(argv))
        check(torch.distributed.get_world_size() == 1 and exp.group.size == 1,
              "11f: initialize() formed a world of one")
        log(f"[11f] Experiment built in {time.perf_counter() - t0:.2f} s on "
            f"{exp.group.device} ({torch.distributed.get_backend()}), launch variables "
            f"unset: {sorted(saved) or 'none were set'}")
        steps = exp.args.me * exp.scaleout.nbatches
        reset_counts()
        t0 = time.perf_counter()
        result = exp.run()
        _sync(dev)
        counts = read_counts()
        for name in launches:
            launches[name] += counts[name]
        log(f"[11f] run in {time.perf_counter() - t0:.2f} s (train "
            f"{result['train_seconds']:.2f} s, {steps} steps): kernel launches {counts}; "
            "test " + json.dumps({k: round(v, 6) for k, v in result.items()}))
        check(np.isfinite(result["mrr"]) and 0 < result["mrr"] <= 1, "11f: finite test MRR")
        if dev.type == "cuda":
            check(counts == _launches(steps, 0, steps), f"11f: launches {counts}")
    finally:
        pdist.destroy()
        os.environ.update(saved)


def partitioned(graph, dev, launches) -> None:
    """Phase 11, the partitioned trainer at P=1; the process group is
    destroyed at the end whatever happens."""
    try:
        group = _part_group(dev)
        cpu_group = _cpu_group()
        tr, state0, xs = partitioned_margin(graph, dev, group, launches)
        partitioned_against_cpu(tr, state0, dev, group, cpu_group)
        partitioned_losses(graph, dev, group, cpu_group, launches)
        partitioned_resume(tr, xs, dev, group, launches)
        partitioned_ranking(graph, tr, dev)
    finally:
        pdist.destroy()
    partitioned_cli(dev, launches)


class FixedExpanded:
    """A sampler with only the expanded form (no `pool`, no `corruptions`):
    the same (positives repeated, negatives, pair mask) every call."""

    def __init__(self, pos, neg, pm):
        self.out = (pos, neg, pm)

    def __call__(self, generator, pos, mask):
        return tuple(x.to(pos.device) for x in self.out)


def _mesh_group(dev) -> "pmesh.Mesh":
    """Phase 12's (1, 1) mesh: a world of one from a file store under OUT,
    NCCL on the card (gloo when rehearsed on the CPU), and its two groups."""
    store = os.path.abspath(MESH_STORE)
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.unlink(store)
    pdist.initialize(coordinator_address="file://" + store, num_processes=1,
                     process_id=0, local_rank=dev.index or 0, device=dev.type)
    mesh = pmesh.make_mesh((1, 1), device=dev.type)
    backend = torch.distributed.get_backend()
    log(f"[12] mesh {mesh.shape} over {backend}: world rank {mesh.rank}, data rank "
        f"{mesh.data.rank} of {mesh.data.size}, model rank {mesh.model.rank} of "
        f"{mesh.model.size}, device {mesh.device}")
    check(backend == ("nccl" if dev.type == "cuda" else "gloo"),
          "12: an NCCL world of one on the card")
    return mesh


def _cpu_mesh() -> "pmesh.Mesh":
    """A (1, 1) mesh of this process on the CPU (gloo groups of one): the
    CPU side of 12b."""
    cpu = torch.device("cpu")
    groups = [pdist.ShardGroup(group=torch.distributed.new_group(backend="gloo"), rank=0,
                               size=1, device=cpu) for _ in range(2)]
    return pmesh.Mesh(shape={pmesh.DATA_AXIS: 1, pmesh.MODEL_AXIS: 1}, data=groups[0],
                      model=groups[1], rank=0, device=cpu)


def mesh_trainer(graph, dev, mesh, launches):
    """12a: `Trainer(mesh=)` on TransE-L1's shared pool, one epoch of 20
    steps, against the in-core `Trainer` from the same seed; then the warm
    step's time, the card's busy time and its host waits. Returns the mesh
    trainer."""
    xs = graph.train[:MESH_TRIPLES]
    cfg = TrainConfig(max_epochs=1, nbatches=MESH.nbatches, learning_rate=MESH.lr,
                      margin=MESH.margin, seed=MESH.seed, aggregate="dense_pallas")
    model = TransE(graph.n_entities, graph.n_relations, MESH.ncomp)
    sampler = SharedNegativeSampler(graph.n_entities, k=MESH.k)
    incore = Trainer(model, sampler, cfg, device=dev)
    t0 = time.perf_counter()
    incore.fit(xs)
    _sync(dev)
    t_incore = time.perf_counter() - t0
    tr = Trainer(model, sampler, cfg, mesh=mesh)
    steps = MESH.nbatches
    reset_counts()
    t0 = time.perf_counter()
    tr.fit(xs)
    _sync(dev)
    dt = time.perf_counter() - t0
    counts = read_counts()
    for name in launches:
        launches[name] += counts[name]
    err = max(float((tr.state.params[k] - incore.state.params[k]).abs().max())
              for k in tr.state.params)
    log(f"[12a] Trainer(mesh=(1, 1)): {steps} steps of {-(-len(xs) // steps)} triples in "
        f"{dt:.3f} s (in-core Trainer {t_incore:.3f} s), loss {tr.loss:.6e}, violations "
        f"{tr.nviolations} (in-core {incore.nviolations}); max |dparam| against in-core "
        f"{err:.3e}; kernel launches {counts}")
    check(err <= STEP_TOL, f"12a: Trainer(mesh=) within {STEP_TOL} of the in-core Trainer")
    check(tr.nviolations == incore.nviolations, "12a: the same violations")
    if dev.type == "cuda":
        check(counts == _launches(steps, 0, steps),
              f"12a: launches {counts}, want 1 K1 a step on the 16-byte path")
    # the warm epoch, from the trained state, unrecorded
    epoch = make_epoch_fn(tr.make_step(), len(xs), steps, pad_to=mesh.data.size)
    xs_dev = torch.as_tensor(xs, dtype=torch.int64, device=dev)
    run = lambda: epoch(tr.state, xs_dev)  # noqa: E731
    _sync(dev)
    t0 = time.perf_counter()
    run()
    _sync(dev)
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    waits = host_waits(run) if dev.type == "cuda" else 0
    log(f"[12a] warm: {step_ms:.3f} ms a step, {waits / steps:g} host waits a step "
        f"({waits} in {steps} steps)")
    if dev.type == "cuda":
        check(waits == 0, f"12a: {waits} host waits in an epoch, want none")
        profile_run(run, steps, step_ms, "12a")
    return tr


def mesh_steps(graph, dev, mesh, cpu_mesh, launches) -> None:
    """12b: one step of each mesh route on the card against the same step
    on the CPU (plain versions) and against the in-core step on the card,
    from the initial params with AdaGrad accumulators at 1, with the same
    batch and draws; then the pointwise pool step from cold accumulators
    (`mesh_cold_step`)."""
    e, r = graph.n_entities, graph.n_relations
    gen = torch.Generator().manual_seed(MESH.seed + 4)
    b = PART_SHAPE.batch
    batch = torch.as_tensor(graph.train, dtype=torch.int64)[
        torch.randperm(graph.train.shape[0], generator=gen)[:b]]
    mask = torch.ones(b)
    pool = FixedPool(torch.randint(0, e, (MESH.k,), generator=gen))
    cpu = torch.device("cpu")
    iid = FixedCorruptions(make_sampler(TRANSE_IID, graph, cpu).corruptions(gen, batch, mask))
    pos, neg, pm = RandomModeSampler(e)(gen, batch, mask)
    expanded = FixedExpanded(pos, neg, pm)
    ada = lambda: AdaGrad(lr=MESH.lr)  # noqa: E731
    cases = (  # tag, model, (mesh step, in-core step), K1 and K2 launches
        ("selfadv TransE-L2", TransE(e, r, MESH.ncomp, l1=False),
         lambda m, o, g: psm.make_shardmap_selfadv_step(m, o, pool, 3.0, g, alpha=2.0),
         lambda m, o: make_selfadv_step(m, o, pool, 3.0, 2.0, "dense_pallas"), 1, 0),
        ("pointwise pool TransE-L2", TransE(e, r, MESH.ncomp, l1=False),
         lambda m, o, g: psm.make_shardmap_pointwise_step(m, o, pool, g),
         lambda m, o: make_pointwise_step(m, o, pool, "dense_pallas"), 1, 0),
        ("sampled CE DistMult", DistMult(e, r, MESH.ncomp),
         lambda m, o, g: psm.make_shardmap_sampled_ce_step(m, o, pool, g,
                                                           label_smoothing=0.1),
         lambda m, o: make_sampled_ce_step(m, o, pool, label_smoothing=0.1,
                                           aggregate="dense_pallas"), 1, 0),
        ("vocab-parallel full CE DistMult", DistMult(e, r, MESH.ncomp),
         lambda m, o, g: psm.make_shardmap_ce_step(m, o, g, label_smoothing=0.1),
         lambda m, o: make_ce_step(m, o, label_smoothing=0.1), 1, 0),
        ("iid fused margin TransE-L1", TransE(e, r, MESH.ncomp),
         lambda m, o, g: psm.make_shardmap_pairwise_step(m, o, iid, MESH.margin, g),
         lambda m, o: make_pairwise_step(m, o, iid, MESH.margin, "dense_pallas"), 1, 0),
        ("sharded iid pointwise TransE-L1", TransE(e, r, MESH.ncomp),
         lambda m, o, g: psh.make_sharded_pointwise_step(m, o, expanded, g),
         lambda m, o: make_pointwise_step(m, o, expanded, "dense_pallas"), 1, 0),
        ("RESCAL shard_relations", RESCAL(e, r, MESH.rescal_ncomp),
         lambda m, o, g: psm.make_shardmap_pairwise_step(m, o, pool, MESH.margin, g,
                                                         shard_relations=True),
         lambda m, o: make_pairwise_step(m, o, pool, MESH.margin, "dense_pallas"), 2, 1),
    )
    for tag, model, mesh_step, incore_step, k1, k2 in cases:
        opt = ada()
        start = init_state(model, opt, torch.Generator().manual_seed(MESH.seed))
        # warm accumulators: a cold AdaGrad step divides by |g| itself, and
        # so magnifies the rounding of a gradient near 0 up to lr / eps
        start = start._replace(opt_state={k: {"p2": torch.ones_like(v["p2"])}
                                          for k, v in start.opt_state.items()})
        rel = tag.startswith("RESCAL")
        out = {}
        for what, g in (("card", mesh), ("cpu", cpu_mesh)):
            st = psm.shard_state_shardmap(start._replace(generator=torch.Generator(g.device)),
                                          model, g, shard_relations=rel)
            step = mesh_step(model, opt, g)
            reset_counts()
            t0 = time.perf_counter()
            out[what] = step(st, batch.to(g.device), mask.to(g.device))
            _sync(g.device)
            dt = time.perf_counter() - t0
            if what == "card":
                counts = read_counts()
                for name in launches:
                    launches[name] += counts[name]
                log(f"[12b] {tag}: the mesh step on the card in {dt:.3f} s (first call), "
                    f"kernel launches {counts}")
                if dev.type == "cuda":
                    check(counts == _launches(k1, k2, k1 - k2),
                          f"12b {tag}: launches {counts}, want {k1} K1 ({k1 - k2} on the "
                          f"16-byte path) and {k2} K2")
            else:
                log(f"[12b] {tag}: the mesh step on the CPU in {dt:.3f} s")
        t0 = time.perf_counter()
        ref = incore_step(model, opt)(_state_on(start, dev), batch.to(dev), mask.to(dev))
        _sync(dev)
        log(f"[12b] {tag}: the in-core step on the card in {time.perf_counter() - t0:.3f} s; "
            f"loss card {float(out['card'][1].loss):.6e}, cpu {float(out['cpu'][1].loss):.6e}, "
            f"in-core {float(ref[1].loss):.6e}")
        nv = [int(x[1].nviolations) for x in (out["card"], out["cpu"], ref)]
        _held_to_cpu(f"12b {tag} card vs cpu", out["card"][0], out["cpu"][0], nv[:2])
        _held_to_cpu(f"12b {tag} mesh vs in-core", out["card"][0], ref[0], nv[::2])
    mesh_cold_step(graph, mesh, cpu_mesh, batch, mask, pool)


@dataclasses.dataclass(frozen=True)
class _UnconstrainedTransE(TransE):
    """TransE without its post-constraint: a step's move is the optimizer's
    alone."""

    post_constraints = {}


def mesh_cold_step(graph, mesh, cpu_mesh, batch, mask, pool) -> None:
    """12b cold: the pointwise pool step (TransE-L2) from `init_state`'s
    cold AdaGrad state (accumulators at 0), the mesh step and the in-core
    step, each on the card and on the CPU. A cold step moves an element by
    lr * g / max(|g|, eps): where |g| < eps that is lr / eps (1e5) times its
    gradient, so a rounding gap in g shows magnified. With the post-
    constraint off, the move is the optimizer's alone, and each element's
    gradient is read back from the step: |g| is the root of the new
    accumulator, its sign opposite to the move. Checks: the gradients agree
    within STEP_TOL (of their size when above 1), and every param gap is
    within lr / eps of its gradient gap, plus the rounding of the update."""
    model = _UnconstrainedTransE(graph.n_entities, graph.n_relations, MESH.ncomp, l1=False)
    opt = AdaGrad(lr=MESH.lr)
    start = init_state(model, opt, torch.Generator().manual_seed(MESH.seed))
    runs = {}
    for what, g in (("card", mesh), ("cpu", cpu_mesh)):
        b, m = batch.to(g.device), mask.to(g.device)
        st = psm.shard_state_shardmap(start._replace(generator=torch.Generator(g.device)),
                                      model, g)
        runs["mesh " + what] = psm.make_shardmap_pointwise_step(model, opt, pool, g)(st, b, m)[0]
        runs["in-core " + what] = make_pointwise_step(model, opt, pool, "dense_pallas")(
            _state_on(start, g.device), b, m)[0]

    def grads(state):
        return {k: (-torch.sign(v.cpu() - start.params[k])
                    * torch.sqrt(state.opt_state[k]["p2"].cpu())) for k, v in state.params.items()}

    got = {name: (st, grads(st)) for name, st in runs.items()}
    ratio = MESH.lr / EPS
    for a, b in (("mesh card", "mesh cpu"), ("in-core card", "in-core cpu"),
                 ("mesh card", "in-core card")):
        for k in start.params:
            pa, pb = got[a][0].params[k].cpu(), got[b][0].params[k].cpu()
            ga, gb = got[a][1][k], got[b][1][k]
            dp, dg = (pa - pb).abs(), (ga - gb).abs()
            i = int(dp.argmax())
            flat = lambda x: x.reshape(-1)[i]  # noqa: E731
            log(f"[12b cold] {a} vs {b} {k}: max|dparam| {float(dp.max()):.3e} at element {i}: "
                f"g {float(flat(ga)):.3e} / {float(flat(gb)):.3e}, accumulator "
                f"{float(flat(got[a][0].opt_state[k]['p2'].cpu())):.3e} / "
                f"{float(flat(got[b][0].opt_state[k]['p2'].cpu())):.3e}; max|dg| "
                f"{float(dg.max()):.3e} (|g| up to {float(ga.abs().max()):.3e})")
            check(float(dg.max()) <= STEP_TOL * max(1.0, float(ga.abs().max())),
                  f"12b cold {a} vs {b}: {k}'s gradients within {STEP_TOL}")
            slack = 4 * torch.finfo(pa.dtype).eps * torch.maximum(
                torch.maximum(pa.abs(), pb.abs()), torch.tensor(MESH.lr))
            check(bool((dp <= ratio * dg + slack).all()),
                  f"12b cold {a} vs {b}: {k}'s gaps within lr / eps of the gradients'")


def mesh_pad_to(graph, dev, launches) -> None:
    """12c: an epoch of iid TransE-L1 (16 negatives) through
    `make_epoch_fn(pad_to=4)` against `pad_to=1` on the card, from the same
    state and generator: 10 steps of 4,831 triples, padded to 4,832."""
    xs = torch.as_tensor(graph.train[:MESH_PAD_TRIPLES], dtype=torch.int64, device=dev)
    model = TransE(graph.n_entities, graph.n_relations, MESH.ncomp)
    sampler = make_sampler(TRANSE_IID, graph, dev)
    steps = 10
    runs = {}
    for pad_to in (1, 4):
        opt = AdaGrad(lr=MESH.lr)
        state = init_state(model, opt, torch.Generator(device=dev).manual_seed(MESH.seed))
        epoch = make_epoch_fn(make_pairwise_step(model, opt, sampler, MESH.margin,
                                                 "dense_pallas"), len(xs), steps, pad_to)
        reset_counts()
        t0 = time.perf_counter()
        state, m = epoch(state, xs)
        _sync(dev)
        dt = time.perf_counter() - t0
        counts = read_counts()
        if pad_to > 1:
            for name in launches:
                launches[name] += counts[name]
            if dev.type == "cuda":
                check(counts == _launches(steps, 0, steps), f"12c: launches {counts}")
        runs[pad_to] = (state, m.nviolations.cpu().numpy())
        log(f"[12c] pad_to={pad_to}: {steps} steps of {-(-len(xs) // steps)} triples "
            f"(padded to {-(-len(xs) // steps) + (-(-(-len(xs) // steps)) % pad_to)}) in "
            f"{dt:.3f} s, violations {int(runs[pad_to][1].sum())}; kernel launches {counts}")
    err = max(float((runs[4][0].params[k] - runs[1][0].params[k]).abs().max())
              for k in runs[1][0].params)
    log(f"[12c] pad_to=4 against pad_to=1: max |dparam| {err:.3e}, violations a step "
        f"equal: {bool(np.array_equal(runs[4][1], runs[1][1]))}")
    check(np.array_equal(runs[4][1], runs[1][1]), "12c: the same violations every step")
    check(err <= STEP_TOL, f"12c: pad_to=4 within {STEP_TOL} of pad_to=1")


def mesh_serving(graph, tr, dev, mesh) -> None:
    """12d: the mesh's serving engine and ranking on 12a's params against
    the single-device ones."""
    model, params = tr.model, tr.state.params
    rng = np.random.default_rng(0)  # scripts/serving_bench.py's queries
    queries = np.stack([rng.integers(0, graph.n_entities, SERVE.nqueries),
                        rng.integers(0, graph.n_relations, SERVE.nqueries)],
                       axis=1)[:MESH_QUERIES]
    for quant in ("", "int8"):
        got, want = (LinkPredictor(model, params, known=graph.train, batch_size=SERVE.batch,
                                   quantize=quant, **kw).top_k(queries, SERVE.k)
                     for kw in (dict(mesh=mesh), dict(device=dev)))
        same = (np.array_equal(got.entities, want.entities)
                and np.array_equal(got.scores, want.scores))
        log(f"[12d] LinkPredictor(mesh=) {quant or 'exact'}: {MESH_QUERIES} queries, top-"
            f"{SERVE.k} ids and values equal to LinkPredictor(): {same}")
        check(same, f"12d: the mesh engine's top-{SERVE.k} ({quant or 'exact'})")
    t0 = time.perf_counter()
    got = FilteredRankingEval(model, graph.test, graph.all_triples(), mesh=mesh)(params)
    _sync(dev)
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = FilteredRankingEval(model, graph.test, graph.all_triples())(params)
    _sync(dev)
    log(f"[12d] {len(graph.test)} test triples: mesh ranking {t_mesh:.3f} s, unsharded "
        f"{time.perf_counter() - t0:.3f} s")
    ranks_agree("12d", got, want, _min_gaps(model, params, graph.test, dev))


def mesh_phase(graph, dev, launches) -> None:
    """Phase 12, the 2-D mesh at (1, 1); the process group is destroyed at
    the end whatever happens."""
    try:
        m = _mesh_group(dev)
        tr = mesh_trainer(graph, dev, m, launches)
        mesh_steps(graph, dev, m, _cpu_mesh(), launches)
        mesh_pad_to(graph, dev, launches)
        mesh_serving(graph, tr, dev, m)
    finally:
        pdist.destroy()



class _NoHostDraws:
    """A host sampler's `rng` that fails every draw: the compat trainers
    must take the device path for the port's own sampler classes."""

    def __getattr__(self, name):
        raise RuntimeError("FAILED: a compat trainer drew negatives on the host")


def _cut(graph, steps, nbatches=COMPAT.nbatches):
    """(batch size of `nbatches` over the whole graph, the first `steps`
    batches' worth of its triples as (s, o, p) tuples)."""
    b = -(-len(graph.train) // nbatches)
    return b, [tuple(map(int, t)) for t in graph.train[: steps * b]]


def _compat_fit(dev, tag, what, trainer, xs, ys, want, launches) -> list:
    """`trainer.fit` with the counts set to 0 just before and read just
    after, held to `want` on the card; the params written back to the
    model's numpy mirrors. Returns [(violations, loss, seconds)] an epoch."""
    epochs = []
    trainer.post_epoch.append(lambda t: epochs.append(
        (t.nviolations, t.loss, timeit.default_timer() - t.epoch_start)) or True)
    _sync(dev)
    reset_counts()
    trainer.fit(xs, ys)
    _sync(dev)
    counts = read_counts()
    b = -(-len(xs) // min(trainer.nbatches, len(xs)))
    for e, (nv, loss, dt) in enumerate(epochs):
        log(f"[{tag}] {what} epoch {e + 1}: violations {nv}  loss {loss:.6e}  {dt:.3f} s  "
            f"step {1e3 * dt / min(trainer.nbatches, len(xs)):.3f} ms (batch {b})")
    log(f"[{tag}] kernel launches {counts}")
    check(dev.type != "cuda" or counts == want, f"{tag} {what}: launches {counts}, want {want}")
    for k in launches:
        launches[k] += counts[k]
    for name, p in trainer._state.params.items():
        check(p.device.type == dev.type and bool(torch.isfinite(p).all()),
              f"{tag}: params[{name!r}] finite on {dev}")
        check(np.array_equal(trainer.model.params[name], p.cpu().numpy()),
              f"{tag}: params[{name!r}] written back to the model")
    return epochs


def _compat_against_cpu(tag, trainer, sampler, xs, dev) -> None:
    """One step of the trainer's own step function from its trained state
    (warm accumulators) on the card and on the CPU, the same batch and the
    same expanded pairs (drawn once on the CPU): within STEP_TOL, the same
    violations."""
    b = -(-len(xs) // trainer.nbatches)
    batch = torch.as_tensor(np.asarray(xs[:b]), dtype=torch.int64)
    mask = torch.ones(b)
    pairs = sampler(torch.Generator().manual_seed(COMPAT.seed + 3), batch, mask)
    step = trainer.make_step(FixedExpanded(*pairs))
    out = {}
    for where in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        out[where.type] = step(_state_on(trainer._state, where), batch.to(where),
                               mask.to(where))
        _sync(where)
        log(f"[{tag}] the step on the {where.type}: {time.perf_counter() - t0:.3f} s")
    (card, card_m), (cpu, cpu_m) = out[dev.type], out["cpu"]
    _held_to_cpu(tag + " card vs cpu", card, cpu,
                 (int(card_m.nviolations), int(cpu_m.nviolations)))


def compat_readme(graph, dev, launches):
    """13a: README's class-API example on WN18's shape: HolE ncomp 150,
    rparam 0.1, `PairwiseStochasticTrainer` (100 batches' batch, margin 0.2)
    with `sample.RandomModeSampler(1, [0, 1], xs, sz).sample`, 2 epochs at
    cut depth, a `post_epoch` callback: the device path (no host draw), 1 K1
    a step on the 16-byte path, then one step against the CPU. On this
    uniform graph every pair still violates the sigmoid margin after 2 such
    epochs (in both packages), so the learning check is `compat_learning`'s.
    Returns the trained model."""
    sz = (graph.n_entities, graph.n_entities, graph.n_relations)
    full = [tuple(map(int, t)) for t in graph.train]
    _, xs = _cut(graph, COMPAT.steps)
    sampler = host_sample.RandomModeSampler(1, [0, 1], full, sz)
    sampler.rng = _NoHostDraws()
    model = compat.HolE(sz, 150, rparam=0.1, device=dev)
    trainer = compat.PairwiseStochasticTrainer(
        model, nbatches=COMPAT.steps, max_epochs=COMPAT.epochs, margin=0.2,
        samplef=sampler.sample, aggregate="dense_pallas", device=dev)
    n = COMPAT.steps * COMPAT.epochs
    epochs = _compat_fit(dev, "13a", "HolE README example", trainer, xs, [1.0] * len(xs),
                         _launches(n, 0, n), launches)
    check(len(epochs) == COMPAT.epochs and all(np.isfinite(e[1]) for e in epochs),
          "13a: a finite loss every epoch")
    dev_sampler = compat._device_sampler(sampler.sample, sz, torch.device("cpu"))
    check(isinstance(dev_sampler, RandomModeSampler), "13a: the device sampler")
    _compat_against_cpu("13a", trainer, dev_sampler, xs, dev)
    return model


def compat_learning(dev, launches) -> None:
    """13a: tests/test_compat.py's README-style flow on the card: TransE
    ncomp 24 on `synthetic_kg(80, 5, 600, seed=11)`, random-mode negatives,
    10 batches, 15 epochs, margin 0.3: the last epoch's violations below
    0.6 x the first's, E's rows in the unit ball (normless1)."""
    g = synthetic_kg(80, 5, 600, seed=11)
    sz = (80, 80, 5)
    xs = [tuple(map(int, t)) for t in g.train]
    sampler = host_sample.RandomModeSampler(1, [0, 1], xs, sz)
    sampler.rng = _NoHostDraws()
    model = compat.TransE(sz, 24, device=dev)
    trainer = compat.PairwiseStochasticTrainer(
        model, nbatches=10, max_epochs=15, margin=0.3, samplef=sampler.sample,
        aggregate="dense_pallas", device=dev)
    epochs = _compat_fit(dev, "13a", "TransE learning", trainer, xs, [1.0] * len(xs),
                         _launches(150, 0, 150), launches)
    norm = float(np.linalg.norm(model.E, axis=1).max())
    log(f"[13a] TransE learning: violations {epochs[0][0]} -> {epochs[-1][0]}, max row "
        f"norm of E {norm:.7f}")
    check(epochs[-1][0] < 0.6 * epochs[0][0], "13a: violations below 0.6 x epoch 1's")
    check(norm <= 1.0 + 1e-5, "13a: normless1: max row norm of E <= 1 + 1e-5")


def compat_rescal(graph, dev, launches) -> None:
    """13b: compat RESCAL ncomp 100 on FB15k's shape with
    `sample.LCWASampler(1, [0, 1], xs, sz)` over every train triple, one
    epoch at cut depth: the iid RESCAL path, whose W gradient (d^2 =
    10,000-wide rows) goes through K1's two-scatter branch: 3 K1 a step,
    2 on the 16-byte path (E, W) and W's counts on the scalar one; then
    the step's busy time and top operators, and one step against the CPU."""
    sz = (graph.n_entities, graph.n_entities, graph.n_relations)
    full = [tuple(map(int, t)) for t in graph.train]
    b, xs = _cut(graph, COMPAT.steps)
    check(b == _batch_size(RESCAL_PAIRWISE),
          f"13b: W's T = 4 x the batch of {b}, as phase 3 checked K1 at")
    t0 = time.perf_counter()
    sampler = host_sample.LCWASampler(1, [0, 1], full, sz)
    sampler.rng = _NoHostDraws()
    log(f"[13b] the LCWA sampler over {len(full)} triples in {time.perf_counter() - t0:.2f} s")
    model = compat.RESCAL(sz, 100, device=dev)
    trainer = compat.PairwiseStochasticTrainer(
        model, nbatches=COMPAT.steps, max_epochs=1, samplef=sampler.sample,
        aggregate="dense_pallas", device=dev)
    n = COMPAT.steps
    epochs = _compat_fit(dev, "13b", "RESCAL LCWA", trainer, xs, [1.0] * len(xs),
                         _launches(3 * n, 0, 2 * n), launches)
    if dev.type == "cuda":
        step = trainer.make_step(compat._device_sampler(sampler.sample, sz, dev))
        batches = torch.as_tensor(np.asarray(xs[: 5 * b]), dtype=torch.int64,
                                  device=dev).reshape(5, b, 3)
        profile(step, trainer._state, batches, torch.ones(b, device=dev),
                1e3 * epochs[0][2] / n, "13b")
    cpu_sampler = compat._device_sampler(sampler.sample, sz, torch.device("cpu"))
    _compat_against_cpu("13b", trainer, cpu_sampler, xs, dev)


def compat_entry_points(graph, model, dev, launches) -> None:
    """13c: the class API's other entry points on WN18's shape, `few` steps
    each at the 13a batch: `StochasticTrainer` with the LCWA sampler, the
    host loop for an arbitrary callable, the pre-split pairs (TransE,
    normless1), and `Model` / `Config` save and load round trips on the
    card (13a's model)."""
    sz = (graph.n_entities, graph.n_entities, graph.n_relations)
    full = [tuple(map(int, t)) for t in graph.train]
    b, xs = _cut(graph, COMPAT.few)
    few = COMPAT.few
    lcwa = host_sample.LCWASampler(1, [0, 1], full, sz)
    lcwa.rng = _NoHostDraws()
    tr = compat.StochasticTrainer(compat.HolE(sz, 150, rparam=0.1, device=dev),
                                  nbatches=few, max_epochs=1, samplef=lcwa.sample,
                                  aggregate="dense_pallas", device=dev)
    _compat_fit(dev, "13c", "StochasticTrainer LCWA", tr, xs, [1.0] * len(xs),
                _launches(few, 0, few), launches)

    inner = host_sample.RandomModeSampler(1, [0, 1], full, sz)
    inner.rng = np.random.default_rng(COMPAT.seed)
    calls = []

    def samplef(xys):  # any callable: the host loop
        calls.append(len(xys))
        return inner.sample(xys)

    tr = compat.PairwiseStochasticTrainer(compat.HolE(sz, 150, device=dev), nbatches=few,
                                          max_epochs=1, margin=0.2, samplef=samplef,
                                          aggregate="dense_pallas", device=dev)
    _compat_fit(dev, "13c", "host samplef", tr, xs, [1.0] * len(xs),
                _launches(few, 0, few), launches)
    check(sum(calls) == len(xs), "13c: the host loop called samplef for every positive")

    rng = np.random.default_rng(COMPAT.seed)
    neg = [(int(rng.integers(sz[0])), int(rng.integers(sz[0])), p) for _, _, p in xs]
    tr = compat.PairwiseStochasticTrainer(compat.TransE(sz, 150, device=dev), nbatches=few,
                                          max_epochs=1, margin=1.0,
                                          aggregate="dense_pallas", device=dev)
    _compat_fit(dev, "13c", "pre-split pairs", tr, xs + neg, [1.0] * len(xs) + [-1.0] * len(neg),
                _launches(few, 0, few), launches)
    norm = float(np.linalg.norm(tr.model.E, axis=1).max())
    log(f"[13c] pre-split pairs: max row norm of E {norm:.7f}")
    check(norm <= 1.0 + 1e-5, "13c: normless1: max row norm of E <= 1 + 1e-5")

    os.makedirs(OUT, exist_ok=True)
    test = graph.test[:1000]
    want = model.score_triples(test)
    model.save(f"{OUT}/13c_model.bin")
    loaded = compat.Model.load(f"{OUT}/13c_model.bin", device=dev)
    check(type(loaded) is compat.HolE and loaded.device == model.device
          and np.array_equal(loaded.score_triples(test), want), "13c: Model save/load")
    compat.Config(model, tr).save(f"{OUT}/13c_config.bin")
    cfg = compat.Config.load(f"{OUT}/13c_config.bin", device=dev)
    check(type(cfg.trainer) is compat.PairwiseStochasticTrainer
          and cfg.trainer.hyperparams == tr.hyperparams and cfg.trainer.device == dev
          and np.array_equal(cfg.model.score_triples(test), want), "13c: Config save/load")
    log(f"[13c] Model and Config saved and loaded on the {dev.type}: the same scores of "
        f"{len(test)} test triples")


def _score_gaps(tag, what, make, params, score, dev) -> float:
    """The largest gap of bf16 scores to fp32's on the card, beside the JAX
    package's bound, and of the card's bf16 scores to the CPU's bf16 path
    (the same bf16 inputs: fp32 sums in another order). Returns the first."""
    on = {"cuda": {k: v.to(dev) for k, v in params.items()},
          "cpu": {k: v.cpu() for k, v in params.items()}}
    with torch.no_grad():
        exact = score(make(""), on[dev.type]).float()
        fast = score(make("bfloat16"), on[dev.type]).float()
        cpu = score(make("bfloat16"), on["cpu"]).float()
    gap = float((fast - exact).abs().max())
    gap_cpu = float((fast.cpu() - cpu).abs().max())
    top = float(exact.abs().max())
    log(f"[{tag}] {what}: largest |bf16 - fp32| score gap {gap:.3e} (the JAX package's "
        f"bound {BF16_BOUND}; largest |score| {top:.3e}); card bf16 against the CPU's "
        f"bf16 path {gap_cpu:.3e}")
    check(gap_cpu <= 1e-4 * max(1.0, top), f"{tag} {what}: card bf16 within 1e-4 of the CPU's")
    return gap


def bf16_step(tag, what, make, graph, positives, want, dev, launches) -> None:
    """13d: one shared-pool margin step in fp32 and in bf16 from the same
    state, batch and pool, `steps` timed calls each with the counts held to
    `want` a step; params and accumulators stay fp32."""
    gen = torch.Generator().manual_seed(COMPAT.seed + 4)
    batch = torch.as_tensor(graph.train[:positives], dtype=torch.int64, device=dev)
    mask = torch.ones(positives, device=dev)
    pool = torch.randint(0, graph.n_entities, (BF16.k,), generator=gen)
    opt = AdaGrad(lr=0.1)
    state = init_state(make(""), opt, torch.Generator(device=dev).manual_seed(COMPAT.seed))
    ms = {}
    for cd in ("", "bfloat16"):
        step = make_pairwise_step(make(cd), opt, FixedPool(pool), margin=1.0,
                                  aggregate="dense_pallas")
        step(state, batch, mask)  # warm-up
        _sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(BF16.steps):
            new, m = step(state, batch, mask)
        _sync(dev)
        ms[cd or "fp32"] = 1e3 * (time.perf_counter() - t0) / BF16.steps
        counts = read_counts()
        check(dev.type != "cuda" or counts == {k: v * BF16.steps for k, v in want.items()},
              f"{tag} {what} {cd or 'fp32'}: launches {counts}, want {want} a step")
        for k in launches:
            launches[k] += counts[k]
        for name, p in new.params.items():
            check(p.dtype == torch.float32 and new.opt_state[name]["p2"].dtype == torch.float32
                  and bool(torch.isfinite(p).all()), f"{tag} {what}: fp32 finite {name}")
        log(f"[{tag}] {what} {cd or 'fp32'}: violations {int(m.nviolations)}, kernel "
            f"launches {counts} over {BF16.steps} steps")
    log(f"[{tag}] {what}: step fp32 {ms['fp32']:.3f} ms, bf16 {ms['bfloat16']:.3f} ms "
        f"(host clock, {BF16.steps} calls, {positives} positives, k = {BF16.k})")

    def score(model, params):
        b = batch[: min(positives, 1024)].to(params["E"].device)
        rows = model.gather_rows(params, b[:, 0], b[:, 1], b[:, 2])
        pool_rows = params["E"][pool.to(b.device)]
        dense = model.dense_params(params)
        return torch.cat([model.score_pool(rows, pool_rows, dense, mode) for mode in (0, 1)])

    _score_gaps(tag, what, make, state.params, score, dev)


def bf16_serving(graph, dev) -> None:
    """13d: `LinkPredictor` top-10 over HolE ncomp 150 at WN18's shape (its
    initial params, seeded), filtered by the train triples, exact (fp32)
    against compute_dtype bfloat16: batch time, top-10 overlap, score
    gaps."""
    hole = lambda cd: HolE(graph.n_entities, graph.n_relations, 150,  # noqa: E731
                           compute_dtype=cd)
    params = hole("").init_params(torch.Generator(device=dev).manual_seed(COMPAT.seed))
    rng = np.random.default_rng(0)
    queries = np.stack([rng.integers(0, graph.n_entities, BF16.queries),
                        rng.integers(0, graph.n_relations, BF16.queries)], axis=1)
    exact = LinkPredictor(hole(""), params, known=graph.train,
                          batch_size=SERVE.batch, device=dev)
    fast = LinkPredictor(hole("bfloat16"), params, batch_size=SERVE.batch, device=dev)
    fast._index = exact._index
    res, ms = {}, {}
    for what, pred in (("fp32", exact), ("bf16", fast)):
        pred.top_k(queries[: SERVE.batch], SERVE.k)  # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        res[what] = pred.top_k(queries, SERVE.k)
        _sync(dev)
        ms[what] = 1e3 * (time.perf_counter() - t0) / (BF16.queries // SERVE.batch)
        check(np.isfinite(res[what].scores).all(), f"13d serving {what}: finite scores")
    overlap = np.mean([len(set(a) & set(b)) / SERVE.k
                       for a, b in zip(res["fp32"].entities, res["bf16"].entities)])
    log(f"[13d] LinkPredictor top-{SERVE.k} over HolE (WN18's shape), {BF16.queries} "
        f"queries: fp32 {ms['fp32']:.3f} ms a batch of {SERVE.batch}, bf16 "
        f"{ms['bf16']:.3f} ms; mean top-{SERVE.k} overlap with exact {overlap:.4f}")

    def score(m, p):
        q = torch.as_tensor(queries[: SERVE.batch], dtype=torch.int64, device=p["E"].device)
        rows = m.gather_rows(p, q[:, 0], q[:, 0], q[:, 1])
        return m.score_pool(rows, p["E"], m.dense_params(p), 1)

    gap = _score_gaps("13d", "HolE serving", hole, params, score, dev)
    check(gap <= BF16_BOUND, f"13d HolE serving: bf16 scores within {BF16_BOUND} of fp32")


def compat_phase(fb15k, wn18, dev, launches) -> None:
    """Phase 13: the reference class API and compute_dtype."""
    model = compat_readme(wn18, dev, launches)
    compat_learning(dev, launches)
    compat_rescal(fb15k, dev, launches)
    compat_entry_points(wn18, model, dev, launches)
    transr = lambda cd: MODELS["transr"](fb15k.n_entities, fb15k.n_relations,  # noqa: E731
                                         150, compute_dtype=cd)
    rescal = lambda cd: RESCAL(fb15k.n_entities, fb15k.n_relations,  # noqa: E731
                               ncomp=100, compute_dtype=cd)
    bf16_step("13d", "full-rank TransR", transr, fb15k, BF16.transr_positives,
              _launches(3, 0, 2), dev, launches)
    bf16_step("13d", "RESCAL", rescal, fb15k, _batch_size(RESCAL_PAIRWISE),
              _launches(2, 1, 1), dev, launches)
    bf16_serving(wn18, dev)


def _suite_argv(argv, dev) -> list:
    return QUALITY_KG + argv + (["--cpu"] if dev.type == "cpu" else [])


def quality_row(tag, what, argv, per_step, gate, dev, launches) -> dict:
    """14a-b: one row of `skge_torch.quality_suite.main` as a user runs it,
    its `--out` line under build/chip_smoke/, the counts set to 0 just
    before it and held to `per_step` times its steps (on the card) after;
    its filtered MRR at least `gate`."""
    argv = _suite_argv(argv + ["--out", f"{OUT}/quality.md"], dev)
    nbatches = quality_suite.parse_args(argv).nbatches
    os.makedirs(OUT, exist_ok=True)
    reset_counts()
    _sync(dev)
    t0 = time.perf_counter()
    (row,) = quality_suite.main(argv)
    _sync(dev)
    dt = time.perf_counter() - t0
    counts = read_counts()
    steps = row["epochs_run"] * nbatches
    want = {name: n * steps for name, n in per_step.items()}
    log(f"[{tag}] {what}: {json.dumps(row)}; {dt:.2f} s with the KG and the rankings; "
        f"launches {counts} for {steps} steps")
    for key in ("mrr", "mrr_raw", "hits1", "hits3", "hits10", "mr", "train_s"):
        check(np.isfinite(row[key]), f"{tag}: finite {key}")
    check(1 <= row["epochs"] <= row["epochs_run"], f"{tag}: the best epoch was run")
    check(dev.type != "cuda" or counts == want, f"{tag} {what}: launches {counts}, want {want}")
    check(row["mrr"] >= gate, f"{tag} {what}: filtered MRR {row['mrr']} at least {gate}")
    for name in launches:
        launches[name] += counts[name]
    return row


def geometry_gates(dev, launches) -> None:
    """14c: tests/test_quality_gates.py's 2,000-entity geometry gates at
    their sizes and thresholds, KGs built on the card: RESCAL wins the
    bilinear KG (MRR > 0.08, H@10 > 0.15) and beats TransE there by 1.2x
    (TransE > 0.03); RotatE wins the rotational KG (MRR > 0.20, H@10 >
    0.45). Each run's launches held to their exact counts: selfadv RESCAL
    scatters W's d^2-wide rows through K1 (no K2), RotatE its E and its
    phases in two K1 calls."""
    runs = (("RESCAL bilinear", "bilinear", "rescal", 0.5, {"rparam": 0.0},
             _launches(2, 0, 2)),
            ("TransE bilinear", "bilinear", "transe", 6.0, {}, _launches(1, 0, 1)),
            ("RotatE rotational", "rotational", "rotate", 3.0, {}, _launches(2, 0, 2)))
    res = {}
    for tag, kg, name, gamma, kw, per_step in runs:
        ds = latent_kg(**GEOMETRY_KG[kg], device=dev)
        model = MODELS[name](ds.n_entities, ds.n_relations, GEOMETRY.ncomp, **kw)
        opt = AdaGrad(lr=GEOMETRY.lr)
        step = make_selfadv_step(model, opt, SharedNegativeSampler(ds.n_entities, k=GEOMETRY.k),
                                 margin=gamma, alpha=GEOMETRY.alpha, aggregate="dense")
        epoch = make_epoch_fn(step, len(ds.train), GEOMETRY.nbatches)
        state = init_state(model, opt, torch.Generator(device=dev).manual_seed(GEOMETRY.seed))
        xs = torch.as_tensor(ds.train, dtype=torch.int64, device=dev)
        reset_counts()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(GEOMETRY.epochs):
            state, _ = epoch(state, xs)
        _sync(dev)
        dt = time.perf_counter() - t0
        counts = read_counts()
        steps = GEOMETRY.epochs * GEOMETRY.nbatches
        want = {k: n * steps for k, n in per_step.items()}
        check(dev.type != "cuda" or counts == want, f"14c {tag}: launches {counts}, want {want}")
        for k in launches:
            launches[k] += counts[k]
        assert_finite_state(state)
        res[tag] = r = FilteredRankingEval(model, ds.test, ds.all_triples(), batch_size=512)(
            state.params)
        log(f"[14c] {tag}: filtered MRR {r.mrr:.4f}, H@10 {r.hits[10]:.4f} after "
            f"{GEOMETRY.epochs} epochs of {GEOMETRY.nbatches} selfadv steps ({dt:.2f} s, "
            f"{1e3 * dt / steps:.3f} ms a step), launches {counts}")
    rescal, trans, rot = (res[t] for t, *_ in runs)
    check(rescal.mrr > 0.08 and rescal.hits[10] > 0.15, "14c: RESCAL wins the bilinear KG")
    check(trans.mrr > 0.03, "14c: TransE learns the bilinear KG")
    check(rescal.mrr > 1.2 * trans.mrr, "14c: RESCAL beats TransE by 1.2x on the bilinear KG")
    check(rot.mrr > 0.20 and rot.hits[10] > 0.45, "14c: RotatE wins the rotational KG")


def quality_iid_step(dev, launches) -> None:
    """14d: the suite's iid RESCAL (`--sampler random-mode --negatives 5`,
    margin 0.2, AdaGrad 0.1) at WN18's shape: one epoch on the card (3 K1
    a step: E's rows and W's 10,000-wide rows on the 16-byte path, W's
    counts; no K2), then one step from the initial params with those
    accumulators, held at >= 1e-6 as ConvE's (a row the epoch left cold
    magnifies the rounding of a gradient below eps = 1e-6 up to lr/eps
    times), on the card against the CPU, within 1e-5 and with the same
    violations."""
    args = quality_suite.parse_args(_suite_argv(QUALITY_IID, dev))
    ds = quality_suite.load_kg(args, dev)
    suite = quality_suite.Suite(args, ds, dev)
    name, model, margin, lr, k = next(
        c for c in quality_suite.configs(args, ds.n_entities, ds.n_relations)
        if c[0] == "RESCAL")
    model, step, xs, opt, _ = suite.build(name, model, margin, lr, k, args.adv_alpha, 0.0)
    state0 = init_state(model, opt, torch.Generator(device=dev).manual_seed(args.train_seed))
    epoch = make_epoch_fn(step, len(xs), args.nbatches)
    reset_counts()
    _sync(dev)
    t0 = time.perf_counter()
    state, m = epoch(state0, xs)
    _sync(dev)
    dt = time.perf_counter() - t0
    counts = read_counts()
    want = _launches(3 * args.nbatches, 0, 2 * args.nbatches)
    log(f"[14d] the suite's iid RESCAL x{args.negatives}: one epoch of {args.nbatches} "
        f"steps in {dt:.3f} s, violations {int(m.nviolations[0])} at the first step, "
        f"{int(m.nviolations[-1])} at the last; launches {counts}")
    check(dev.type != "cuda" or counts == want, f"14d: launches {counts}, want {want}")
    for key in launches:
        launches[key] += counts[key]
    assert_finite_state(state)
    cfg = SimpleNamespace(model="rescal", label="quality-suite iid RESCAL", loss="pairwise",
                          sampler="random-mode", negatives=args.negatives, margin=margin,
                          nbatches=args.nbatches, seed=args.train_seed)
    step_against_cpu(cfg, ds, model, opt, state0._replace(opt_state=state.opt_state), dev,
                     "14d", p2_floor=CONVE_P2_FLOOR)


def quality(dev, launches) -> dict:
    """Phase 14: the quality suite on the card; returns its sub-phases'
    seconds."""
    t = [time.perf_counter()]
    quality_row("14a", "selfadv TransE-L2, k 8,192, alpha 2", QUALITY_SELFADV,
                _launches(1, 0, 1), QUALITY_SELFADV_GATE, dev, launches)
    t.append(time.perf_counter())
    quality_row("14b", "margin RESCAL, k 8,192", QUALITY_RESCAL, _launches(2, 1, 1),
                QUALITY_RESCAL_GATE, dev, launches)
    t.append(time.perf_counter())
    geometry_gates(dev, launches)
    t.append(time.perf_counter())
    quality_iid_step(dev, launches)
    t.append(time.perf_counter())
    return {sub: b - a for sub, a, b in zip("abcd", t, t[1:])}


def _run_logged(tag, fn, *args, **kw):
    """`fn(*args, **kw)` with its standard output captured, then logged
    line by line under `tag`; returns (its result, its JSON lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kw)
    lines = []
    for line in out.getvalue().splitlines():
        log(f"[{tag}] {line}")
        if line.startswith("{") and line.endswith("}"):
            lines.append(json.loads(line))
    return result, lines


def flagship_1m(dev, launches):
    """15a: `flagship.run` at JAX's 1M shape; returns (trainer, args)."""
    cpu = ["--cpu"] if dev.type == "cpu" else []
    args = flagship.parse_args(cpu + FLAGSHIP_1M + ["--ckpt", f"{OUT}/15a_ckpt"])
    shutil.rmtree(args.ckpt, ignore_errors=True)
    reset_counts()
    t0 = time.perf_counter()
    (report, tr), lines = _run_logged("15a", flagship.run, args, dev)
    dt = time.perf_counter() - t0
    counts = read_counts()
    log(f"[15a] report {json.dumps(report)}; {dt:.1f} s; kernel launches {counts}")
    phases = [line.get("phase") for line in lines]
    check(phases == ["build", "init"] + ["train"] * args.epochs + ["eval"],
          f"15a: every phase line, in order ({phases})")
    check(np.isfinite(report["losses"]).all(), "15a: finite losses")
    check(report["ckpt_bit_equal"], "15a: the restored tables equal the saved ones")
    check(report["partitioner"] == "native", "15a: the native partitioner")
    check(np.isfinite(report["mrr"]) and 0 < report["mrr"] <= 1, "15a: a finite MRR")
    batch = -(-tr.bucket_len // max(1, min(tr.nbatches, tr.bucket_len)))
    check((tr.part_size, batch) == (FLAGSHIP_1M_SHAPE.part_size, FLAGSHIP_1M_SHAPE.batch),
          f"15a: S = {tr.part_size} and a batch of {batch}, as phase 3 checked K1 at")
    if dev.type == "cuda":
        steps = report["steps_per_epoch"]
        check(report["k1_launches"] == [steps] * args.epochs,
              f"15a: K1 launches {report['k1_launches']} equal the steps ({steps} an epoch)")
        total = steps * args.epochs + 2 * report["profile"]["steps"]  # 2 profiled epochs
        check(counts == _launches(total, 0, total), f"15a: launches {counts}, want {total}")
    for name in launches:
        launches[name] += counts[name]
    return tr, args


def flagship_host_buckets(args, dev, launches) -> None:
    """15b: one off-diagonal bucket epoch at 15a's shape with the bucket
    stack in pinned host memory and on the card, from the same state,
    permutation and pools."""
    ds, _ = flagship.load_kg(args, dev)
    aug = add_reciprocal_relations(ds)
    trs = [flagship.make_trainer(args, aug, dev, host_buckets=hb) for hb in (True, False)]
    host, resident = trs
    check(host._all_local.device.type == "cpu" and resident._all_local.device.type
          == dev.type, "15b: the stack in host memory and on the device")
    pi, pj = next(b for b in host._bucket_order() if b[0] != b[1])
    bi = host._bucket_row[(pi, pj)]
    check(bool(torch.equal(host._all_local[bi].to(dev), resident._all_local[bi]))
          and bool(torch.equal(host._all_valid[bi].to(dev), resident._all_valid[bi])),
          "15b: the bucket's uploaded ids and mask bit-equal to the device stack's")
    perm = torch.randperm(host.bucket_len, generator=torch.Generator().manual_seed(1))
    nb = max(1, min(host.nbatches, host.bucket_len))
    seen = []  # the ids and mask each epoch receives on the card

    def spied(epoch):
        def run(state, xs, valid, perm=None):
            seen.append((xs, valid))
            return epoch(state, xs, valid, perm)
        return run

    reset_counts()
    sorted_before = cuda_segment.deterministic_launches
    losses = []
    with deterministic():
        for tr in trs:
            tr._epochs[False] = spied(tr._epoch_fn(False))
            losses.append(float(tr._bucket_epoch(pi, pj, perm=perm)[0]))
            tr.flush()
    counts = read_counts()
    sorted_launches = cuda_segment.deterministic_launches - sorted_before
    check(all(bool(torch.equal(a, b)) for a, b in zip(*seen)) and seen[0][0].dtype
          == torch.int64, "15b: the epoch's ids and mask bit-equal from either stack")
    if dev.type == "cuda":
        check(counts == _launches(2 * nb, 0, 2 * nb) and sorted_launches == 2 * nb,
              f"15b: launches {counts}, {sorted_launches} sorted")
    for name in launches:
        launches[name] += counts[name]
    pairs = [(host.e_host[kk], resident.e_host[kk]) for kk in host.e_host]
    pairs += [(host.dev_params[kk], resident.dev_params[kk]) for kk in host.dev_params]
    pairs += [(host.dev_opt[kk][sn], resident.dev_opt[kk][sn])
              for kk in host.dev_opt for sn in host.dev_opt[kk]]
    equal = all(bool(torch.equal(a, b)) for a, b in pairs)
    err = max(float((a.double() - b.double()).abs().max()) for a, b in pairs)
    log(f"[15b] bucket {(pi, pj)}, {nb} steps, host_buckets=True against False, "
        f"deterministic algorithms: the same ids and mask, loss {losses[0]:.9e} and "
        f"{losses[1]:.9e}; tables, params and slots "
        f"{'bit-equal' if equal else f'DIFFER by up to {err:.3e}'}")
    check(losses[0] == losses[1], "15b: the same loss bit for bit")
    check(equal, "15b: the tables, params and slots bit-equal")


def flagship_ranks(tr, args, dev) -> None:
    """15c: 15a's streamed ranks against `FilteredRankingEval` on the same
    params (filtered by the known triples whose keys the queries ask for),
    by the RANK_GAP rule."""
    ds, _ = flagship.load_kg(args, dev)
    test = ds.test[: args.eval_n]
    t0 = time.perf_counter()
    got = tr.evaluate(test, add_reciprocal_relations(ds).all_triples(),
                      batch_size=args.eval_batch, reciprocal=True)
    t1 = time.perf_counter()
    params = {k: torch.as_tensor(v, device=dev) for k, v in tr.params().items()}
    wrapped = ReciprocalEvalWrapper(tr.full_model)
    known = ds.all_triples()
    known = np.concatenate([rows_with_keys(known, test, 0), rows_with_keys(known, test, 1)])
    want = FilteredRankingEval(wrapped, test, known, batch_size=args.eval_batch)(params)
    gaps = _min_gaps(wrapped, params, test, dev)
    log(f"[15c] streamed ranking of {len(test)} queries in {t1 - t0:.2f} s, in-core in "
        f"{time.perf_counter() - t1:.2f} s")
    ranks_agree("15c", got, want, gaps)


def profile_step_phase(dev, launches) -> None:
    """15d: `python -m skge_torch.profile_step` at its defaults, one epoch."""
    argv = (["--cpu"] if dev.type == "cpu" else []) + PROFILE_STEP
    reset_counts()
    report, _ = _run_logged("15d", profile_step.main, argv)
    counts = read_counts()
    args = profile_step.parse_args(argv)
    steps = (1 + args.epochs) * args.nbatches  # the full phase's warm-up and timed epochs
    if dev.type == "cuda":
        check(counts == _launches(steps, 0, steps), f"15d: launches {counts}")
    for name in launches:
        launches[name] += counts[name]
    ms = report["epoch_ms"]
    check(all(v > 0 for v in ms.values()) and ms["sample"] < ms["full"],
          f"15d: the phases' epochs ({ms})")


def ooc_ce_ab_phase(dev, launches) -> None:
    """15e: `python -m skge_torch.ooc_ce_ab`, full CE at P=1 and sampled CE
    at P=2, two epochs each with a validation each."""
    argv = (["--cpu"] if dev.type == "cpu" else []) + OOC_CE_AB
    reset_counts()
    rows, _ = _run_logged("15e", ooc_ce_ab.main, argv)
    counts = read_counts()
    args = ooc_ce_ab.parse_args(argv)
    aug = add_reciprocal_relations(ooc_ce_ab.load_kg(args, dev))
    sampled = ooc_ce_ab.make_trainer(args, aug, "sampled_ce", 2, dev)
    steps = args.epochs * _ooc_steps(sampled)  # full CE launches none
    if dev.type == "cuda":
        check(counts == _launches(steps, 0, steps), f"15e: launches {counts}, want {steps}")
    for name in launches:
        launches[name] += counts[name]
    check([r["arm"] for r in rows] == args.arms.split(",")
          and all(0 < r["mrr"] <= 1 for r in rows), "15e: a finite row per arm")


def flagship_phase(dev, launches) -> dict:
    """Phase 15: the out-of-core flagship and the three entry points beside
    it; returns its sub-phases' seconds."""
    t = [time.perf_counter()]
    tr, args = flagship_1m(dev, launches)
    t.append(time.perf_counter())
    flagship_host_buckets(args, dev, launches)
    t.append(time.perf_counter())
    flagship_ranks(tr, args, dev)
    del tr
    t.append(time.perf_counter())
    profile_step_phase(dev, launches)
    t.append(time.perf_counter())
    ooc_ce_ab_phase(dev, launches)
    t.append(time.perf_counter())
    return {sub: b - a for sub, a, b in zip("abcde", t, t[1:])}


def _cpu_flag(dev) -> list:
    return ["--cpu"] if dev.type == "cpu" else []


def _counted(tag, what, want, dev, launches) -> None:
    """The counts since the last `reset_counts`, held to `want` on the card
    and added to `launches`."""
    counts = read_counts()
    log(f"[{tag}] {what}: kernel launches {counts}")
    if dev.type == "cuda":
        check(counts == want, f"{tag} {what}: launches {counts}, want {want}")
    for name in launches:
        launches[name] += counts[name]


def bench_default(dev, launches, phase4_ms) -> None:
    """16a: `python -m skge_torch.bench` at its defaults; `phase4_ms`, phase
    4's warm step on the same path, is logged beside its step."""
    argv = _cpu_flag(dev) + BENCH_DEFAULT
    args = bench.parse_args(argv)
    reset_counts()
    _, (rec,) = _run_logged("16a", bench.main, argv)
    steps = (1 + args.epochs) * args.nbatches
    _counted("16a", "bench.py's defaults", _launches(steps, 0, steps), dev,
             launches)
    check(rec["metric"] == "transe_fb15k_scored_triples_per_s_per_chip"
          and rec["unit"] == "triples/s", "16a: bench.py's metric and unit")
    check(np.isfinite(rec["value"]) and rec["value"] > 0, "16a: a finite positive value")
    # bench.py's work units an epoch: 2 scores a pair, 2k pairs a positive
    # (the FB15k-shaped graph keeps all of its --ntrain triples)
    step_ms = 1e3 * 2 * 2 * args.k * args.ntrain / rec["value"] / args.nbatches
    log(f"[16a] {rec['value']:.1f} scored triples/s (vs_baseline {rec['vs_baseline']}): "
        f"{step_ms:.3f} ms a step; phase 4's warm run {phase4_ms:.3f} ms "
        "(host clock, no gate)")


def bench_all(dev, launches) -> None:
    """16b: `python -m skge_torch.bench --all --epochs 1`'s rows
    (`bench.all_rows`), each row's kernel calls read around its `run`."""
    args = bench.parse_args(_cpu_flag(dev) + BENCH_ALL)
    steps = (1 + args.epochs) * args.nbatches
    rows = bench.all_rows(args)
    check([config for config, _ in rows] == [" ".join(r) for r in bench.ALL_ROWS],
          "16b: one row a row of ALL_ROWS, in order")
    for config, row_args in rows:
        reset_counts()
        t0 = time.perf_counter()
        rec = {**bench.run(row_args), "config": config}
        log(f"[16b] {json.dumps(rec)}")
        _counted("16b", f"{config} ({time.perf_counter() - t0:.1f} s)",
                 bench_launches(config, steps), dev, launches)
        check(np.isfinite(rec["value"]) and rec["value"] > 0,
              f"16b: a finite positive value ({config})")


def verify_drivers(dev, launches) -> None:
    """16c: the loss verify drivers."""
    reset_counts()
    _run_logged("16c", verify_selfadv.main, _cpu_flag(dev))  # its own asserts
    ds = verify_selfadv.load(dev)
    results = {"ce": verify_ce.run(ds, 0.3, 0.0, 0, dev),
               "n3": verify_n3.run(ds, 1e-3, 0, dev, lr=1.0)}
    _counted("16c", "verify_selfadv, verify_ce and verify_n3", _launches(0, 0, 0), dev,
             launches)
    for name, (mrr, h10) in results.items():
        log(f"[16c] verify_{name}.run, seed 0: MRR {mrr:.4f} hits@10 {h10:.4f}")
        check(0 < mrr <= 1, f"16c: verify_{name}'s MRR finite and positive")


def rotate_probe_phase(dev, launches) -> None:
    """16d: `python -m skge_torch.rotate_probe`, depth cut."""
    argv = _cpu_flag(dev) + ROTATE_PROBE
    args = rotate_probe.parse_args(argv)
    rotate_probe.load_kg(args, dev)  # the KG built (or read) outside the counts
    reset_counts()
    rows, _ = _run_logged("16d", rotate_probe.main, argv)
    steps = len(rows) * args.epochs * args.nbatches  # no variant stops early at 2 epochs
    _counted("16d", "rotate_probe", _launches(2 * steps, 0, 2 * steps), dev,
             launches)
    check([r["tag"] for r in rows] == ["paper-init g=6.0", "nunif g=6.0",
                                       "oracle-init g=6.0"], "16d: a row a variant")
    check(all(0 < r["mrr"] <= 1 for r in rows), "16d: finite MRRs")
    # the generator's own latents, no training: JAX's reading at this shape
    reset_counts()
    (oracle,), _ = _run_logged("16d", rotate_probe.main,
                               _cpu_flag(dev) + ROTATE_PROBE_ORACLE)
    _counted("16d", "rotate_probe's oracle, no epoch", _launches(0, 0, 0), dev, launches)
    log(f"[16d] the oracle's test MRR {oracle['mrr']}, H@10 {oracle['hits10']}, MR "
        f"{oracle['mr']} at the generator's latents (JAX {ORACLE_JAX}); after {args.epochs} "
        f"epochs MRR {rows[-1]['mrr']}, H@10 {rows[-1]['hits10']}, MR {rows[-1]['mr']}")
    if dev.type == "cuda":
        check(oracle["mrr"] >= ORACLE_JAX["mrr"] and oracle["hits10"] >= 0.999,
              f"16d: the oracle's MRR {oracle['mrr']} and H@10 {oracle['hits10']} "
              f"at least JAX's {ORACLE_JAX}")
        # the same ranking on the CPU, of the card's KG
        args = rotate_probe.parse_args(ROTATE_PROBE_ORACLE)
        ds = rotate_probe.load_kg(args, dev)
        model = RotatE(ds.n_entities, ds.n_relations, args.ncomp)
        latents = rotate_probe.oracle_params(args.entities, args.relations,
                                             args.latent_dim, args.ncomp)
        res = {}
        for d in (dev, torch.device("cpu")):
            params = {k: torch.as_tensor(v, device=d) for k, v in latents.items()}
            res[d.type] = FilteredRankingEval(model, ds.test, ds.all_triples(),
                                              batch_size=1024)(params)
        params = {k: torch.as_tensor(v, device=dev) for k, v in latents.items()}
        ranks_agree("16d oracle, card against CPU", res["cuda"], res["cpu"],
                    _min_gaps(model, params, ds.test, dev))


def density_point(dev, launches) -> None:
    """16e: one `python -m skge_torch.density_curve` point."""
    out = f"{OUT}/16e.jsonl"
    if os.path.exists(out):
        os.unlink(out)
    reset_counts()
    rows, _ = _run_logged("16e", density_curve.main,
                          _cpu_flag(dev) + DENSITY_POINT + ["--out", out])
    _counted("16e", "density_curve, full CE", _launches(0, 0, 0), dev, launches)
    check([(r["model"], r["role"]) for r in rows]
          == [("TransE-L2", "matched"), ("ComplEx", "contrast")]
          and all(0 < r["mrr"] <= 1 for r in rows), "16e: a finite row a model")


def run_rescal_phase(dev, launches) -> None:
    """16f: `python -m skge_torch.run_rescal`, one epoch."""
    argv = _cpu_flag(dev) + FB15K_ARGS + RUN_RESCAL
    nb = make_parser().parse_args(argv).nb
    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        code = run_rescal.main(argv)
    for line in out.getvalue().splitlines():
        log(f"[16f] {line}")
    _counted("16f", "run_rescal, shared pool", _launches(2 * nb, nb, nb), dev,
             launches)
    check(code == 0, "16f: run_rescal exits 0")


def bench_phase(dev, launches, phase4_ms) -> dict:
    """Phase 16: `python -m skge_torch.bench` and the last entry points;
    returns its sub-phases' seconds."""
    t = [time.perf_counter()]
    bench_default(dev, launches, phase4_ms)
    t.append(time.perf_counter())
    for sub in (bench_all, verify_drivers, rotate_probe_phase, density_point,
                run_rescal_phase):
        sub(dev, launches)
        t.append(time.perf_counter())
    return {sub: b - a for sub, a, b in zip("abcdef", t, t[1:])}


def main(argv) -> int:
    if argv not in ([], ["--kernel-times"]):
        print("usage: python3 chip_smoke.py [--kernel-times]", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    smi = environment()
    dev = torch.device("cuda", 0)
    build()
    t_build = time.perf_counter()
    verify = not argv
    checks = {"segment_sum": segment_sum_checks(dev, verify),
              "segment_outer_sum": segment_outer_sum_checks(dev, verify)}
    t_kernels = time.perf_counter()
    if not verify:  # phase 3's timings alone: no check, no result line
        log(json.dumps({name: shapes for name, (_, shapes) in checks.items()}))
        log(smi)
        return 0
    graphs = {name: synthetic_kg(g.n_entities, g.n_relations, g.n_train,
                                 n_test=g.n_test, seed=g.seed, clustered=False)
              for name, g in (("fb15k", DATA), ("wn18", WN18))}
    launches = dict.fromkeys([*KERNELS, VECTOR], 0)
    trained = {}
    for cfg, tag in PATHS:
        *run, counts, _, step_ms = train(cfg, graphs[cfg.data], dev, tag)
        if tag == "4":
            phase4_ms = step_ms[-1]  # its warm run, for 16a
        check(counts == expected_launches(cfg),
              f"{cfg.model} {cfg.loss} {cfg.sampler}: launches {counts}, "
              f"want {expected_launches(cfg)}")
        for name in launches:
            launches[name] += counts[name]
        trained.setdefault(cfg.model, (cfg, *run))
    t_train = time.perf_counter()
    for (cfg, model, opt, state0, state), tag in zip(trained.values(),
                                                     ("", "b", "c", "d")):
        start = state0._replace(opt_state=state.opt_state)
        ds = graphs[cfg.data]
        step_against_cpu(cfg, ds, model, opt, start, dev, "5" + tag,
                         unique_too=cfg.model == "hole")
        evaluate(ds, model, state, dev, "6" + tag)
    t_eval = time.perf_counter()
    fb15k, wn18 = graphs["fb15k"], graphs["wn18"]
    del graphs, trained
    runs = surface(dev, launches)
    t_surface = time.perf_counter()
    for tag, (trainer, xs) in runs.items():
        loss_step_against_cpu(tag, trainer, xs)
    t_5e = time.perf_counter()
    factorization_margin(fb15k, dev, launches)
    t_8a = time.perf_counter()
    complex_recipe(dev, launches)
    t_8b = time.perf_counter()
    latent_sweep(dev)
    t_8c = time.perf_counter()
    learning_gate(dev)
    t_8d = time.perf_counter()
    trained = zoo_margin(fb15k, dev, launches)
    t_9a = time.perf_counter()
    conve_recipe(dev, launches)
    t_9b = time.perf_counter()
    zoo_gates(dev, launches)
    t_9c = time.perf_counter()
    zoo_ranking(fb15k, trained, dev)
    t_9 = time.perf_counter()
    ooc = outofcore_margin(fb15k, dev, launches)
    t_10a = time.perf_counter()
    outofcore_incore(fb15k, dev, launches)
    t_10c = time.perf_counter()
    outofcore_rescal(fb15k, dev, launches)
    t_10d = time.perf_counter()
    outofcore_against_cpu(fb15k, ooc, dev)
    t_10e = time.perf_counter()
    outofcore_recipe(dev, launches)
    t_10f = time.perf_counter()
    serving(fb15k, ooc.params(), dev)
    t_10g = time.perf_counter()
    outofcore_gates(dev, launches)
    t_10 = time.perf_counter()
    partitioned(fb15k, dev, launches)
    t_11 = time.perf_counter()
    mesh_phase(fb15k, dev, launches)
    t_12 = time.perf_counter()
    compat_phase(fb15k, wn18, dev, launches)
    t_13 = time.perf_counter()
    t_14 = quality(dev, launches)
    t_15s = time.perf_counter()
    t_15 = flagship_phase(dev, launches)
    t_16s = time.perf_counter()
    t_16 = bench_phase(dev, launches, phase4_ms)
    t_end = time.perf_counter()
    log(f"[time] phases 1-2 {t_build - t0:.1f} s, 3 {t_kernels - t_build:.1f} s, "
        f"4 {t_train - t_kernels:.1f} s (graphs included), 5-6 {t_eval - t_train:.1f} s, "
        f"7 {t_surface - t_eval:.1f} s (graphs included), 5e-5g {t_5e - t_surface:.1f} s, "
        f"8 {t_8d - t_5e:.1f} s (8a {t_8a - t_5e:.1f}, 8b {t_8b - t_8a:.1f}, "
        f"8c {t_8c - t_8b:.1f}, 8d {t_8d - t_8c:.1f}), 9 {t_9 - t_8d:.1f} s "
        f"(9a {t_9a - t_8d:.1f}, 9b {t_9b - t_9a:.1f}, 9c {t_9c - t_9b:.1f}, "
        f"9d {t_9 - t_9c:.1f}), 10 {t_10 - t_9:.1f} s (10a-b {t_10a - t_9:.1f}, "
        f"10c {t_10c - t_10a:.1f}, 10d {t_10d - t_10c:.1f}, 10e {t_10e - t_10d:.1f}, "
        f"10f {t_10f - t_10e:.1f}, 10g {t_10g - t_10f:.1f}, 10h {t_10 - t_10g:.1f}), "
        f"11 {t_11 - t_10:.1f} s, 12 {t_12 - t_11:.1f} s, 13 {t_13 - t_12:.1f} s, "
        f"14 {t_15s - t_13:.1f} s (" + ", ".join(f"14{sub} {s:.1f}" for sub, s in t_14.items())
        + f"), 15 {t_16s - t_15s:.1f} s ("
        + ", ".join(f"15{sub} {s:.1f}" for sub, s in t_15.items())
        + f"), 16 {t_end - t_16s:.1f} s ("
        + ", ".join(f"16{sub} {s:.1f}" for sub, s in t_16.items()) + ")")
    # each kernel at the TransE or RESCAL slice's shape, its other timed
    # shapes under "shapes"
    log(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": checks[name][0],
        **{key: checks[name][1][0].get(key) for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_call",
            "bound_share")},
        "shapes": checks[name][1],
    } for name, (_, source, replaces) in KERNELS.items()]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
