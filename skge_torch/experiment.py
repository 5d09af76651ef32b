"""The port's experiment CLI, `skge_tpu.experiment`'s counterpart:
argparse flags, training with periodic filtered-ranking validation,
best-MRR retention with patience, the best model's checkpoint (`--fout`)
and a final test evaluation.

    python -m skge_torch.experiment --model hole --me 100 --nb 100

The flags and their defaults are the JAX package's. It runs on the GPU;
`--cpu` selects the CPU, and without a GPU and without `--cpu` it exits
with an error. ConvE trains on reciprocal relations whether or not
`--reciprocal` is given, as in the JAX package.

`--trainer outofcore --parts P` trains with `outofcore.OutOfCoreTrainer`
(the entity table in pinned host memory, P partitions), validates through
its streamed ranking every `--test-all` epochs, keeps the best params
(and `--fout`.sharded, its checkpoint directory) and ranks the test split
on them; the flags that trainer does not use are logged as ignored, as in
the JAX package. `--trainer partitioned` trains with
`parallel.partitioned.PartitionedTrainer`, one process per shard: the
process group is joined (`parallel.distributed.initialize`, from the
SKGE_* or torchrun variables, a world of one without them) before any
work on the device, over NCCL on `cuda:LOCAL_RANK` or, with `--cpu`, over
gloo; validation and the test ranking run on the sharded table.
"""

from __future__ import annotations

import argparse
import logging
import sys
import timeit
from typing import Optional

import torch

from skge_torch import sampling
from skge_torch.data import (
    Dataset,
    add_reciprocal_relations,
    bernoulli_probs,
    latent_kg,
    load_dataset,
    load_tsv,
    sorted_train_keys,
    synthetic_kg,
    type_index_arrays,
)
from skge_torch.evaluation import (FilteredRankingEval, ReciprocalEvalWrapper,
                                   evaluate)
from skge_torch.models import MODELS
from skge_torch.outofcore import OutOfCoreTrainer
from skge_torch.parallel.distributed import initialize, make_shard_mesh
from skge_torch.parallel.partitioned import PartitionedTrainer
from skge_torch.trainer import TrainConfig, Trainer, make_optimizer
from skge_torch.utils.checkpoint import save_checkpoint

log = logging.getLogger("skge_torch.experiment")

# the models that take `rparam`, and the factorization models that take `n3`
RPARAM_MODELS = ("hole", "rescal", "distmult", "complex", "tucker", "simple", "quate",
                 "rotate", "conve")
N3_MODELS = ("distmult", "complex", "tucker", "simple", "quate")


def build_sampler(name: str, ds: Dataset, ntries: int = 100, k: int = 1024,
                  modes: tuple = (0, 1), device="cuda"):
    """The sampler `name` for `ds`, its index arrays on `device`."""
    def on(a):
        return torch.as_tensor(a, device=device)

    if name == "shared":
        return sampling.SharedNegativeSampler(ds.n_entities, k=k, modes=modes)
    if name == "random-mode":
        return sampling.RandomModeSampler(ds.n_entities, modes=modes)
    if name == "lcwa":
        return sampling.LCWASampler(ds.n_entities, ds.n_relations,
                                    on(sorted_train_keys(ds)), ntries=ntries)
    if name == "bernoulli":
        return sampling.BernoulliSampler(
            ds.n_entities, on(bernoulli_probs(ds.train, ds.n_relations)))
    if name == "corrupted":
        return sampling.CorruptedSampler(
            ds.n_entities, *map(on, type_index_arrays(ds.train, ds.n_relations)))
    raise ValueError(f"unknown sampler {name!r}")


def _ignored_by_scaleout(args: argparse.Namespace) -> list:
    """The flags the partitioned and out-of-core trainers do not use, as
    the JAX CLI lists them."""
    ignored = []
    if args.sampler != "shared":
        ignored.append(f"--sampler {args.sampler} (shared pool only)")
    if args.aggregate != "unique":
        ignored.append(f"--aggregate {args.aggregate}")
    if args.no_pairwise:
        ignored.append("--no-pairwise (pointwise: single/mesh trainers only; "
                       "CE/selfadv dominate it everywhere measured)")
    if args.metrics:
        ignored.append("--metrics (use trainer.metrics)")
    return ignored


class Experiment:
    """Train + periodically validate + keep best params + final test eval."""

    def __init__(self, args: argparse.Namespace):
        self.args = args
        if not args.cpu and not torch.cuda.is_available():
            raise SystemExit("error: no CUDA device; skge_torch.experiment runs "
                             "on the GPU, pass --cpu to run on the CPU")
        self.device = torch.device("cpu" if args.cpu else "cuda")
        self.group = None
        if args.trainer == "partitioned":
            # before any work on the device: this process's card is the
            # group's (cuda:LOCAL_RANK)
            initialize(device=self.device)
            self.group = make_shard_mesh()
            self.device = self.group.device
        if args.tsv:
            self.ds = load_tsv(*args.tsv, order=args.tsv_order)
        elif args.fin:
            self.ds = load_dataset(args.fin)
        else:
            kw = ({"latent_dim": args.latent_dim, "device": self.device}
                  if args.synthetic_kind == "latent" else {})
            gen = latent_kg if args.synthetic_kind == "latent" else synthetic_kg
            self.ds = gen(
                n_entities=args.synthetic_entities,
                n_relations=args.synthetic_relations,
                n_train=args.synthetic_train,
                n_valid=max(50, args.synthetic_train // 20),
                n_test=max(50, args.synthetic_train // 20),
                seed=args.seed,
                **kw,
            )
            log.info("using %s synthetic KG (no --fin given)", args.synthetic_kind)
        # ConvE is directional (models/conve.py): always reciprocal
        reciprocal = args.model == "conve" or args.reciprocal
        if reciprocal:
            if (args.reciprocal and args.model != "conve"
                    and not (args.ce or args.sampled_ce)):
                raise SystemExit("--reciprocal requires --ce or --sampled-ce")
            self.ds = add_reciprocal_relations(self.ds)
            log.info("reciprocal-relation augmentation (n_relations doubled to "
                     "%d, train doubled to %d)", self.ds.n_relations, len(self.ds.train))
            if (args.trainer != "single" and args.model == "conve"
                    and not (args.ce or args.sampled_ce)):
                # the scale-out pools corrupt both roles; directional ConvE
                # scores candidate objects only
                raise SystemExit(
                    "ConvE on --trainer partitioned/outofcore requires "
                    "--ce or --sampled-ce (its canonical scheme); the "
                    "pairwise pool path is --trainer single")
        kw = {}
        if args.model in RPARAM_MODELS:
            kw["rparam"] = args.rparam
        if args.n3:
            if args.model not in N3_MODELS:
                raise SystemExit(
                    f"--n3 is not supported for --model {args.model} "
                    "(factorization models only: distmult, complex, "
                    "tucker, simple, quate)"
                )
            kw["n3"] = args.n3
        if args.model == "ermlp":
            kw["nhidden"] = args.nhidden
        if args.model == "hole":
            kw["af"] = args.af
        if args.model == "transe":
            kw["l1"] = not args.l2
        self.model = MODELS[args.model](
            self.ds.n_entities, self.ds.n_relations, args.ncomp, init=args.init, **kw)
        if args.sampled_ce and args.sampler != "shared" and args.trainer == "single":
            # the out-of-core trainer always draws a pool
            raise SystemExit("--sampled-ce needs --sampler shared")
        cfg = TrainConfig(
            max_epochs=args.me,
            nbatches=args.nb,
            learning_rate=args.lr,
            optimizer=args.optimizer,
            schedule=None if args.schedule == "constant" else args.schedule,
            warmup=args.warmup,
            schedule_min=args.schedule_min,
            margin=args.margin,
            pairwise=not args.no_pairwise,
            loss=("ce" if args.ce else "sampled_ce" if args.sampled_ce
                  else "selfadv" if args.selfadv else "margin"),
            adv_alpha=args.adv_alpha,
            label_smoothing=args.label_smoothing,
            ce_directions=("o",) if reciprocal else ("o", "s"),
            aggregate=args.aggregate,
            seed=args.seed,
            metrics_jsonl=args.metrics,
        )
        self.trainer = None
        if args.trainer == "single":
            sampler = build_sampler(args.sampler, self.ds, args.ntries, args.k,
                                    modes=(1,) if args.model == "conve" else (0, 1),
                                    device=self.device)
            self.trainer = Trainer(self.model, sampler, cfg,
                                   post_epoch=[self._callback], device=self.device)
        else:
            ignored = _ignored_by_scaleout(args)
            if ignored:
                log.warning("--trainer %s ignores: %s", args.trainer, "; ".join(ignored))
        if args.trainer == "partitioned":
            # a reciprocal run has a CE loss here (both refusals above)
            self.scaleout = PartitionedTrainer(
                self.model, make_optimizer(cfg), self.ds.train, self.group,
                margin=cfg.margin, k=args.k, nbatches=cfg.nbatches, seed=cfg.seed,
                loss=cfg.loss, adv_alpha=cfg.adv_alpha, reciprocal=reciprocal,
                label_smoothing=cfg.label_smoothing)
        elif args.trainer == "outofcore":
            self._ooc_reciprocal = reciprocal
            self.scaleout = OutOfCoreTrainer(
                self.model, make_optimizer(cfg), self.ds.train, n_parts=args.parts,
                margin=cfg.margin, k=args.k, nbatches=cfg.nbatches, seed=cfg.seed,
                loss=cfg.loss, adv_alpha=cfg.adv_alpha,
                label_smoothing=cfg.label_smoothing, ce_directions=cfg.ce_directions,
                device=self.device)
        # head queries of a reciprocal-trained model rank through the inverse
        # relation (ConvE routes them itself)
        self._eval_model = (ReciprocalEvalWrapper(self.model)
                            if reciprocal and args.model != "conve" else self.model)
        self.best_mrr = -1.0
        self.best_params = None
        self.evals_without_improvement = 0
        self._valid_ev: Optional[FilteredRankingEval] = None

    def _callback(self, trainer: Trainer) -> bool:
        last = trainer.metrics.last()
        log.info("epoch %d  loss=%.4f  violations=%d  (%.2fs, %.0f triples/s)",
                 trainer.epoch, trainer.loss, trainer.nviolations,
                 last.get("epoch_seconds", 0.0), last.get("triples_per_second", 0.0))
        if (self.args.test_all <= 0 or trainer.epoch % self.args.test_all != 0
                or len(self.ds.valid) == 0):
            return True
        if self._valid_ev is None:
            self._valid_ev = FilteredRankingEval(
                self._eval_model, self.ds.valid, self.ds.all_triples(),
                batch_size=self.args.eval_batch)
        res = self._valid_ev(trainer.state.params)
        log.info("  VALID epoch %d: MRR=%.4f (raw %.4f) Hits@10=%.3f MR=%.1f",
                 trainer.epoch, res.mrr, res.mrr_raw, res.hits[10], res.mean_rank)
        if res.mrr > self.best_mrr:
            self.best_mrr = res.mrr
            self.best_params = {k: v.clone() for k, v in trainer.state.params.items()}
            self.evals_without_improvement = 0
            if self.args.fout:
                save_checkpoint(self.args.fout, trainer.state, meta={
                    "model": self.model.name,
                    "epoch": trainer.epoch,
                    "valid_mrr": res.mrr,
                    "config": trainer.config.to_meta(),
                })
        else:
            self.evals_without_improvement += 1
            if self.evals_without_improvement >= self.args.patience:
                log.info("early stop: no valid-MRR improvement")
                return False
        return True

    def _run_scaleout(self) -> dict:
        """`--trainer partitioned|outofcore`: the scale-out trainers under
        the same protocol (validation every `--test-all` epochs through
        their own ranking, sharded or streamed, best-MRR retention with
        patience, the test ranking on the best params), as the JAX CLI's
        `_run_scaleout`."""
        args, tr = self.args, self.scaleout

        def eval_split(split):
            kw = ({} if args.trainer == "partitioned"
                  else {"reciprocal": self._ooc_reciprocal})
            return tr.evaluate(split, self.ds.all_triples(), batch_size=args.eval_batch,
                               **kw)

        best_params = None
        t0 = timeit.default_timer()
        chunk = args.test_all if args.test_all > 0 else args.me
        epoch = 0
        while epoch < args.me:
            n = min(chunk, args.me - epoch)
            tr.fit(epochs=n)
            epoch += n
            m = tr.metrics[-1]
            log.info("epoch %d  loss=%.4f  violations=%d", epoch, m["loss"],
                     int(m.get("nviolations", 0)))
            if args.test_all <= 0 or len(self.ds.valid) == 0:
                continue
            res = eval_split(self.ds.valid)
            log.info("  VALID epoch %d: MRR=%.4f Hits@10=%.3f MR=%.1f",
                     epoch, res.mrr, res.hits[10], res.mean_rank)
            if res.mrr > self.best_mrr:
                self.best_mrr = res.mrr
                self.best_valid = res
                self.evals_without_improvement = 0
                best_params = self.best_params = tr.params()  # ORIGINAL ids, host
                if args.fout:
                    tr.save(args.fout + ".sharded")
            else:
                self.evals_without_improvement += 1
                if self.evals_without_improvement >= args.patience:
                    log.info("early stop: no valid-MRR improvement")
                    break
        result = {"train_seconds": timeit.default_timer() - t0, "epochs": epoch}
        if len(self.ds.test) > 0 and args.mode == "rank":
            if best_params is not None:
                # the best validation params, as the single path keeps them
                res = evaluate(self._eval_model,
                               {k: torch.as_tensor(v, device=self.device)
                                for k, v in best_params.items()},
                               self.ds.test, self.ds.all_triples(),
                               batch_size=args.eval_batch)
            else:
                res = eval_split(self.ds.test)
            result.update(res.summary())
            log.info("TEST: MRR=%.4f (raw %.4f)  Hits@10=%.3f  MR=%.1f",
                     res.mrr, res.mrr_raw, res.hits[10], res.mean_rank)
        return result

    def run(self) -> dict:
        if self.args.trainer != "single":
            return self._run_scaleout()
        t0 = timeit.default_timer()
        state = self.trainer.fit(self.ds.train)
        result = {"train_seconds": timeit.default_timer() - t0,
                  "epochs": self.trainer.epoch}
        params = state.params if self.best_params is None else self.best_params
        if len(self.ds.test) > 0 and self.args.mode == "rank":
            res = FilteredRankingEval(self._eval_model, self.ds.test,
                                      self.ds.all_triples(),
                                      batch_size=self.args.eval_batch)(params)
            result.update(res.summary())
            log.info("TEST: MRR=%.4f (raw %.4f)  Hits@1/3/10=%.3f/%.3f/%.3f  MR=%.1f",
                     res.mrr, res.mrr_raw, res.hits[1], res.hits[3], res.hits[10],
                     res.mean_rank)
        return result


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="KGE training/evaluation with PyTorch on the GPU "
        "(scikit-kge capabilities)")
    p.add_argument("--fin", default=None, help="dataset pickle (reference format)")
    p.add_argument("--tsv", nargs=3, default=None,
                   metavar=("TRAIN", "VALID", "TEST"),
                   help="raw triple text files (native C++ loader)")
    p.add_argument("--tsv-order", default="spo",
                   help="column order of the --tsv files over {s,p,o}")
    p.add_argument("--fout", default=None, help="best-model checkpoint path")
    p.add_argument("--model", default="hole", choices=sorted(MODELS))
    p.add_argument("--test-all", dest="test_all", type=int, default=10,
                   help="validate every N epochs (reference --test-all)")
    p.add_argument("--me", type=int, default=500, help="max epochs")
    p.add_argument("--nb", type=int, default=100, help="number of batches")
    p.add_argument("--lr", type=float, default=0.1, help="learning rate")
    p.add_argument("--optimizer", default="adagrad", choices=["adagrad", "sgd", "adam"])
    p.add_argument("--schedule", default="constant",
                   choices=["constant", "linear", "cosine"],
                   help="lr schedule over --me * --nb total steps "
                   "(checkpoint-safe: position = the global step count)")
    p.add_argument("--warmup", type=int, default=0,
                   help="[--schedule] linear warmup steps")
    p.add_argument("--schedule-min", type=float, default=0.0,
                   help="[--schedule] final lr as a fraction of --lr")
    p.add_argument("--ncomp", type=int, default=150, help="embedding dim")
    p.add_argument("--margin", type=float, default=0.2, help="pairwise margin")
    p.add_argument("--sampler", default="random-mode",
                   choices=["random-mode", "lcwa", "corrupted", "bernoulli", "shared"])
    p.add_argument("--k", type=int, default=1024,
                   help="shared-pool size (--sampler shared)")
    p.add_argument("--aggregate", default="unique",
                   choices=["unique", "dense", "dense_pallas", "dense_sorted"],
                   help="gradient aggregation (the dense modes scatter through "
                   "the CUDA segment-sum kernel)")
    p.add_argument("--mode", default="rank", choices=["rank", "none"])
    p.add_argument("--no-pairwise", action="store_true",
                   help="use pointwise logistic loss")
    p.add_argument("--selfadv", action="store_true",
                   help="self-adversarial loss (Sun et al. 2019; needs --sampler shared)")
    p.add_argument("--adv-alpha", type=float, default=1.0,
                   help="self-adversarial softmax temperature")
    p.add_argument("--ce", action="store_true",
                   help="full 1-vs-all cross-entropy loss (no sampler; "
                   "overrides --sampler/--selfadv)")
    p.add_argument("--sampled-ce", dest="sampled_ce", action="store_true",
                   help="sampled softmax cross-entropy over a --k shared pool "
                   "(importance-corrected; needs --sampler shared)")
    p.add_argument("--label-smoothing", type=float, default=0.0,
                   help="cross-entropy label smoothing (ConvE uses 0.1)")
    p.add_argument("--rparam", type=float, default=0.0)
    p.add_argument("--n3", type=float, default=0.0,
                   help="nuclear-3-norm coefficient (Lacroix et al. 2018) on the "
                   "touched rows; factorization models only (distmult, complex, "
                   "tucker, simple, quate)")
    p.add_argument("--reciprocal", action="store_true",
                   help="[with --ce or --sampled-ce] reciprocal-relation "
                   "training: doubled relation ids, object-direction-only CE, "
                   "inverse-routed head evaluation")
    p.add_argument("--nhidden", type=int, default=10)
    p.add_argument("--af", default="sigmoid")
    p.add_argument("--init", default="nunif", choices=["nunif", "normal"])
    p.add_argument("--l2", action="store_true", help="TransE: squared-L2 distance")
    p.add_argument("--ntries", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trainer", default="single",
                   choices=["single", "partitioned", "outofcore"],
                   help="'single', 'partitioned' (the entity table split over "
                   "the processes of a torch.distributed group) or 'outofcore' "
                   "(the entity table in host memory)")
    p.add_argument("--parts", type=int, default=2,
                   help="[outofcore] number of entity partitions")
    p.add_argument("--patience", type=int, default=3)
    p.add_argument("--eval-batch", dest="eval_batch", type=int, default=1024)
    p.add_argument("--metrics", default=None, help="JSONL metrics path")
    p.add_argument("--synthetic-entities", type=int, default=500)
    p.add_argument("--synthetic-relations", type=int, default=10)
    p.add_argument("--synthetic-train", type=int, default=5000)
    p.add_argument("--synthetic-kind", default="random", choices=["random", "latent"],
                   help="'latent' = learnable translational-geometry KG "
                   "(data.latent_kg) for quality experiments")
    p.add_argument("--latent-dim", type=int, default=32,
                   help="[--synthetic-kind latent] latent dimension")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the GPU)")
    return p


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = make_parser().parse_args(argv)
    result = Experiment(args).run()
    print(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
