"""Reference-scale quality suite of the port: the model zoo on a WN18-sized
learnable synthetic KG (`data.latent_kg`), trained with the shared negative
pool (or the reference's iid scheme, the self-adversarial loss, or cross
entropy) and evaluated with the filtered ranking protocol, on the GPU.

The JAX package's `scripts/quality_suite.py` is the reference: the same
flags and defaults, the same 15 configurations and their rewrites per loss
and sampler, the same successive-halving sweep, the same JSON lines and
the same `--out` markdown line, so the port's rows stand beside the JAX
suite's rows of RESULTS.md on the same KG.

- `--eval-every N` + `--patience P`: filtered-MRR validation every N
  epochs (and at the last), a copy of the best-validation parameters, a
  stop after P consecutive non-improving validations; the row is the TEST
  evaluation of the best checkpoint, with its epoch.
- `--sweep`: per-model successive halving over the loss's lever grid
  (margin: gamma x lr; selfadv: gamma x alpha; CE: lr x label smoothing)
  by validation MRR, then one full early-stopped run of the winner.

The latent KG is built on the run's device and cached in `CACHE_DIR`
under a name of the port's own that carries the device type: the card's
build can part from the CPU's (and from the JAX package's) at near-ties
of its argmax sweep, so no other build's file is ever read.

Usage:
    python -m skge_torch.quality_suite [--epochs 100] [--out table.md]
    python -m skge_torch.quality_suite --loss selfadv --sweep --eval-every 10
    python -m skge_torch.quality_suite --cpu --entities 600 --relations 8 \\
        --ntrain 2000 --latent-dim 8 --nbatches 5 --models TransE-L2 \\
        --epochs 4 --k 64

Without `--cpu` it runs on the GPU and exits when there is none.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time
from dataclasses import replace
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from skge_torch.data import Dataset, add_reciprocal_relations, latent_kg
from skge_torch.evaluation import FilteredRankingEval, ReciprocalEvalWrapper
from skge_torch.models import (ERMLP, RESCAL, ComplEx, ConvE, DistMult, HolE,
                               PairRE, QuatE, RotatE, SimplE, TransE, TransH,
                               TransR, TuckER)
from skge_torch.optim import AdaGrad, Adam
from skge_torch.sampling import RandomModeSampler, SharedNegativeSampler
from skge_torch.training import (init_state, make_ce_step, make_epoch_fn,
                                 make_pairwise_step, make_sampled_ce_step,
                                 make_selfadv_step)

# where the latent KGs are cached; tests point it at a temporary directory
CACHE_DIR = Path(__file__).resolve().parents[1] / "build" / "quality_suite"


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--k", type=int, default=None,
                    help="pool size (default 1024; 8192 for --loss selfadv "
                    "and sampled_ce)")
    ap.add_argument("--nbatches", type=int, default=100)
    ap.add_argument("--entities", type=int, default=40943)   # WN18 shape
    ap.add_argument("--relations", type=int, default=18)
    ap.add_argument("--ntrain", type=int, default=141442)
    ap.add_argument("--latent-dim", type=int, default=32)
    ap.add_argument("--dim", type=int, default=None,
                    help="override the model embedding dim d0 (default 150 "
                    "above 2,000 entities, else 32)")
    ap.add_argument("--kg", default="translational",
                    choices=["translational", "bilinear", "rotational"],
                    help="latent-KG geometry (data.latent_kg kind)")
    ap.add_argument("--out", default=None, help="append results to this md file")
    ap.add_argument("--models", default=None,
                    help="comma-separated subset, e.g. 'TransE-L1,HolE'")
    ap.add_argument(
        "--sampler", default="shared", choices=["shared", "random-mode"],
        help="'random-mode' = the reference scheme (iid corruption per "
        "positive) at the reference hyperparameters margin=0.2 lr=0.1",
    )
    ap.add_argument("--negatives", type=int, default=2,
                    help="[random-mode] negatives per (positive, mode)")
    ap.add_argument(
        "--loss", default="margin",
        choices=["margin", "selfadv", "ce", "sampled_ce"],
        help="'selfadv' = the self-adversarial loss over the shared pool "
        "(per-model gammas, lr 0.3, k 8192 unless --k overrides); 'ce' = "
        "reciprocal relations + object-direction 1-vs-all cross entropy "
        "(ls=0.1) + Adam lr=1e-3 for every model; 'sampled_ce' = the same "
        "protocol with the sampled softmax over a shared k-entity pool",
    )
    ap.add_argument("--adv-alpha", type=float, default=1.0,
                    help="[--loss selfadv] softmax temperature (--sweep "
                    "searches 1.0 and 2.0)")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="validate (filtered MRR) every N epochs and keep "
                    "the best parameters; 0 = train the full --epochs")
    ap.add_argument("--patience", type=int, default=3,
                    help="[--eval-every] stop after P consecutive "
                    "non-improving validations")
    ap.add_argument("--sweep", action="store_true",
                    help="successive-halving lever sweep per model "
                    "(validation-MRR selection), then one full run of the "
                    "winning config")
    ap.add_argument("--sweep-rung0", type=int, default=0,
                    help="[--sweep] rung-0 epoch budget (default "
                    "max(epochs//8, 5))")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU, which must exist)")
    ap.add_argument("--train-seed", type=int, default=0,
                    help="training seed (init + sampling); the KG stays "
                    "seed 0, so seeds measure training variance")
    args = ap.parse_args(argv)
    if args.loss == "selfadv" and args.sampler != "shared":
        ap.error("--loss selfadv needs the shared-pool sampler")
    if args.k is None:
        args.k = 8192 if args.loss in ("selfadv", "sampled_ce") else 1024
    if args.sweep and not args.eval_every:
        args.eval_every = 10  # sweep selection needs validation evals
    return args


def successive_halving(grid, run_fn, rung0, full_epochs):
    """`grid` is a list of config dicts, `run_fn(cfg, epochs) -> score`
    (higher better). Each rung keeps the top half by score (ties to the
    earlier config) and doubles the budget until one survives or the
    budget reaches `full_epochs`. Returns (best_cfg, history)."""
    alive = list(grid)
    budget = max(1, rung0)
    history = []
    while len(alive) > 1 and budget < full_epochs:
        scored = [(run_fn(cfg, budget), i, cfg) for i, cfg in enumerate(alive)]
        scored.sort(key=lambda x: (-x[0], x[1]))
        keep = max(1, math.ceil(len(alive) / 2))
        history.append({
            "budget": budget,
            "scores": [{"cfg": c, "score": round(s, 4)} for s, _, c in scored],
        })
        alive = [c for _, _, c in scored[:keep]]
        budget *= 2
    return alive[0], history


def held_out(ntrain: int) -> int:
    """Validation and test triples each: scales down to tiny test KGs."""
    return min(5000, max(50, ntrain // 10))


def cache_path(args, device: torch.device) -> Path:
    n_held = held_out(args.ntrain)
    key = (f"{args.kg}-e{args.entities}-r{args.relations}-t{args.ntrain}"
           f"-h{n_held}-l{args.latent_dim}-s0")
    return Path(CACHE_DIR) / f"latent_kg_torch-{device.type}-{key}.npz"


def load_kg(args, device: torch.device) -> Dataset:
    """The suite's latent KG, built on `device` or read from the port's
    cache. A new cache file is written whole under a temporary name and
    renamed, so a concurrent run sees it complete or not at all."""
    path = cache_path(args, device)
    t0 = time.perf_counter()
    if path.exists():
        with np.load(path) as z:
            ds = Dataset(train=z["train"], valid=z["valid"], test=z["test"],
                         n_entities=args.entities, n_relations=args.relations)
        print(f"  loaded from cache in {time.perf_counter() - t0:.0f}s", flush=True)
        return ds
    n_held = held_out(args.ntrain)
    ds = latent_kg(
        n_entities=args.entities, n_relations=args.relations,
        n_train=args.ntrain, n_valid=n_held, n_test=n_held,
        latent_dim=args.latent_dim, seed=0, kind=args.kg, device=device,
    )
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".npz.tmp", dir=path.parent)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, train=ds.train, valid=ds.valid, test=ds.test)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    print(f"  built in {time.perf_counter() - t0:.0f}s", flush=True)
    return ds


def model_dim(args) -> int:
    """d0: 150 at WN18's scale, 32 below 2,000 entities, or --dim."""
    return args.dim or (150 if args.entities > 2000 else 32)


def configs(args, n_entities: int, n_relations: int) -> List[Tuple]:
    """(name, model, margin, lr, k or None = args.k) of every model the
    run trains, in the reference's order, rewritten for --sampler and
    --loss and filtered by --models. ConvE's model is built in `build`
    (on the reciprocal relations)."""
    n_e, n_r = n_entities, n_relations
    d0 = model_dim(args)
    small = args.dim or (100 if d0 == 150 else 16)
    # HolE's sigmoid caps its gradient and large pools swamp it: margin
    # 0.5 / lr 0.3 / k 2048; the multiplicative models train without
    # rparam (it collapses their embeddings on this KG)
    table = [
        ("TransE-L1", TransE(n_e, n_r, d0), 2.0, 0.1, None),
        ("TransE-L2", TransE(n_e, n_r, d0, l1=False), 1.0, 0.1, None),
        ("HolE", HolE(n_e, n_r, d0, rparam=0.0), 0.5, 0.3, 2048),
        ("RESCAL", RESCAL(n_e, n_r, small, rparam=0.01), 1.0, 0.1, None),
        ("ER-MLP", ERMLP(n_e, n_r, d0, nhidden=10), 1.0, 0.1, None),
        ("DistMult", DistMult(n_e, n_r, d0), 0.5, 0.3, 2048),
        ("ComplEx", ComplEx(n_e, n_r, d0 // 2), 0.5, 0.3, 2048),
        ("RotatE", RotatE(n_e, n_r, d0 // 2), 0.5, 0.3, 2048),
        ("TransH", TransH(n_e, n_r, d0), 1.0, 0.1, None),
        ("TransR", TransR(n_e, n_r, args.dim or (64 if d0 == 150 else 16)),
         1.0, 0.1, None),
        ("PairRE", PairRE(n_e, n_r, d0), 1.0, 0.1, None),
        ("TuckER", TuckER(n_e, n_r, small, rparam=0.01), 1.0, 0.1, None),
        ("SimplE", SimplE(n_e, n_r, d0 // 2), 0.5, 0.3, 2048),
        ("QuatE", QuatE(n_e, n_r, 38 if d0 == 150 else max(d0 // 4, 4)),
         0.5, 0.3, 2048),
        ("ConvE", None, 0.0, 1e-3, None),
    ]
    if args.sampler == "random-mode":
        # the reference operating point: iid corruption, margin 0.2, lr 0.1
        table = [(n, m, 0.2, 0.1, None) for n, m, _, _, _ in table if n != "ConvE"]
    if args.loss in ("ce", "sampled_ce"):
        # every model through its all-entity sweep on the doubled relations,
        # rparam stripped (full-table updates decay every row); ComplEx with
        # N3, TuckER at d0 with rcomp 30
        def ce_model(n, m):
            if n == "ConvE":
                return None
            if n == "TuckER":
                return TuckER(n_e, 2 * n_r, d0, rcomp=30 if d0 == 150 else 8)
            kw = {"n3": 1e-3} if n == "ComplEx" else {}
            if hasattr(m, "rparam"):
                kw["rparam"] = 0.0
            return replace(m, n_relations=2 * n_r, **kw)

        table = [
            (n, ce_model(n, m), 0.0, 1e-3, None)
            for n, m, _, _, _ in table
            # ConvE's own scheme is full CE: no sampled-CE row
            if not (args.loss == "sampled_ce" and n == "ConvE")
        ]
    if args.loss == "selfadv":
        # per-family gammas, lr 0.3, k = args.k, rparam stripped
        gammas = {"TransE-L1": 6.0, "TransE-L2": 3.0, "TransH": 3.0,
                  "PairRE": 3.0, "HolE": 1.0, "RESCAL": 0.5, "TuckER": 0.5}
        table = [
            (n, replace(m, rparam=0.0) if hasattr(m, "rparam") else m,
             gammas.get(n, 3.0), 0.3, args.k)
            for n, m, _, _, _ in table if n != "ConvE"
        ]
    if args.models:
        want = {m.strip() for m in args.models.split(",")}
        table = [c for c in table if c[0] in want]
    return table


def out_line(args, name: str, cfg: dict, row: dict) -> str:
    """The markdown table line of one row, as the JAX suite writes it."""
    tag = (
        f"iid x{args.negatives} m=0.2 lr=0.1"
        if args.sampler == "random-mode"
        else f"k={cfg['k'] or args.k}"
    )
    if args.loss == "selfadv":
        tag = f"selfadv g={cfg['margin']} a={cfg['alpha']} lr={cfg['lr']} {tag}"
    elif args.loss == "sampled_ce" and name != "ConvE":
        tag = (f"sampledCE+Adam reciprocal k={cfg['k'] or args.k} "
               f"lr={cfg['lr']} ls={cfg['ls']}")
    elif args.loss == "ce" or name == "ConvE":
        tag = f"CE+Adam reciprocal lr={cfg['lr']} ls={cfg['ls']}"
    elif args.sweep:
        tag = f"m={cfg['margin']} lr={cfg['lr']} {tag}"
    if args.eval_every:
        tag += f" best@{row['epochs']}"
    if args.train_seed:
        tag += f" seed={args.train_seed}"
    return (
        f"| {name} {tag} ep={args.epochs} | {row['mrr']} | "
        f"{row['mrr_raw']} | {row['hits1']} | {row['hits3']} | "
        f"{row['hits10']} | {row['mr']} | {row['train_s']} |\n"
    )


class Suite:
    """One run's dataset, device and evaluators; `train_eval` trains and
    ranks one configuration."""

    def __init__(self, args, ds: Dataset, device: torch.device):
        self.args = args
        self.ds = ds
        self.device = torch.device(device)
        self.d0 = model_dim(args)
        self.all_triples = ds.all_triples()
        self.xs = torch.as_tensor(ds.train, dtype=torch.int64, device=self.device)
        self.aug = self.aug_xs = None
        # evaluator cache: the filter index is host work over ~3x the train
        # set, reused across the sweep's and early stopping's runs
        self._evals: dict = {}

    def _reciprocal(self):
        if self.aug is None:
            self.aug = add_reciprocal_relations(self.ds)
            self.aug_xs = torch.as_tensor(self.aug.train, dtype=torch.int64,
                                          device=self.device)
        return self.aug, self.aug_xs

    def build(self, name, model, margin, lr, k, alpha, ls, sampler=None):
        """-> (trainable model, step fn, train xs, opt, eval model or None).
        `sampler` replaces the configuration's own (tests replay draws)."""
        args = self.args
        if name == "ConvE" or args.loss in ("ce", "sampled_ce"):
            aug, aug_xs = self._reciprocal()
            opt = Adam(lr=lr)
            eval_model = None
            if name == "ConvE":
                model = ConvE(aug.n_entities, aug.n_relations, self.d0)
            else:
                # head queries rank through the inverse relation, the
                # direction CE trained, as ConvE does internally
                eval_model = ReciprocalEvalWrapper(model)
            if args.loss == "sampled_ce" and name != "ConvE":
                sampler = sampler or SharedNegativeSampler(self.ds.n_entities,
                                                           k=k or args.k)
                step = make_sampled_ce_step(model, opt, sampler, directions=("o",),
                                            label_smoothing=ls)
            else:
                step = make_ce_step(model, opt, directions=("o",), label_smoothing=ls)
            return model, step, aug_xs, opt, eval_model
        opt = AdaGrad(lr=lr)
        if sampler is None:
            if args.sampler == "random-mode":
                sampler = RandomModeSampler(self.ds.n_entities,
                                            modes=(0, 1) * args.negatives)
            else:
                sampler = SharedNegativeSampler(self.ds.n_entities, k=k or args.k)
        if args.loss == "selfadv":
            step = make_selfadv_step(model, opt, sampler, margin=margin,
                                     alpha=alpha, aggregate="dense")
        else:
            step = make_pairwise_step(model, opt, sampler, margin=margin,
                                      aggregate="dense")
        return model, step, self.xs, opt, None

    def get_eval(self, eval_model, which: str) -> FilteredRankingEval:
        ev = self._evals.get((eval_model, which))  # models are frozen dataclasses
        if ev is None:
            data = self.ds.valid if which == "valid" else self.ds.test
            ev = self._evals[eval_model, which] = FilteredRankingEval(
                eval_model, data, self.all_triples, batch_size=1024)
        return ev

    def train_eval(self, name, model, margin, lr, k, alpha, ls, epochs,
                   eval_on="test", eval_every=0, patience=0, sampler=None,
                   perms: Optional[Callable[[int], torch.Tensor]] = None):
        """Train and return (metrics row dict, RankingResult). With
        eval_every > 0 it validates on the valid split, keeps a copy of the
        best parameters and stops after `patience` non-improving
        validations; the row is the best checkpoint's evaluation on
        `eval_on`. `sampler` (see `build`) and `perms(epoch) ->
        permutation`, for `make_epoch_fn`'s `perm=`, replace the run's own
        draws (tests replay the JAX package's)."""
        args = self.args
        model, step, train_xs, opt, eval_model = self.build(
            name, model, margin, lr, k, alpha, ls, sampler)
        epoch = make_epoch_fn(step, int(train_xs.shape[0]), args.nbatches)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(args.train_seed)
        state = init_state(model, opt, gen)
        val_ev = self.get_eval(eval_model or model, "valid") if eval_every else None
        best = (-1.0, 0, None)  # (valid mrr, epoch, params)
        bad = 0
        t_val = 0.0
        t0 = time.perf_counter()
        e = 0
        while e < epochs:
            state, _ = epoch(state, train_xs,
                             perm=None if perms is None else perms(e))
            e += 1
            if eval_every and (e % eval_every == 0 or e == epochs):
                tv = time.perf_counter()
                vm = val_ev(state.params).mrr
                t_val += time.perf_counter() - tv
                if vm > best[0]:
                    # a copy no later step can write into
                    best = (vm, e, {n: p.clone() for n, p in state.params.items()})
                    bad = 0
                else:
                    bad += 1
                    if patience and bad >= patience:
                        break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t_train = time.perf_counter() - t0
        print(f"  {name}: {e * args.nbatches} steps in {t_train:.3f} s, "
              f"{t_val:.3f} s of it validating", flush=True)
        params = best[2] if best[2] is not None else state.params
        best_epoch = best[1] if best[2] is not None else e
        r = self.get_eval(eval_model or model, eval_on)(params)
        row = {
            "model": name, "epochs": best_epoch, "epochs_run": e,
            "train_s": round(t_train, 1),
            "mrr": round(float(r.mrr), 4), "mrr_raw": round(float(r.mrr_raw), 4),
            "hits1": round(float(r.hits[1]), 3), "hits3": round(float(r.hits[3]), 3),
            "hits10": round(float(r.hits[10]), 3), "mr": round(float(r.mean_rank), 1),
        }
        return row, r

    def sweep_grid(self, name, margin, lr, k, ls):
        """The loss's lever grid for --sweep."""
        args = self.args
        if args.loss == "selfadv":
            return [{"margin": g, "alpha": a, "lr": lr, "k": k, "ls": ls}
                    for g in (margin * 0.5, margin, margin * 2.0)
                    for a in (1.0, 2.0)]
        if args.loss in ("ce", "sampled_ce") or name == "ConvE":
            return [{"margin": margin, "alpha": args.adv_alpha, "lr": r,
                     "k": k, "ls": s}
                    for r in (5e-4, 1e-3, 2e-3)
                    for s in (0.0, 0.1)]
        return [{"margin": g, "alpha": args.adv_alpha, "lr": r, "k": k, "ls": ls}
                for g in (margin * 0.5, margin, margin * 2.0)
                for r in (0.1, 0.3)]

    def run(self, name, model, margin, lr, k) -> dict:
        """One configuration's row: the sweep first under --sweep, then the
        full early-stopped run; appended to --out as it comes."""
        args = self.args
        ls = 0.1 if (args.loss in ("ce", "sampled_ce") or name == "ConvE") else 0.0
        cfg = {"margin": margin, "alpha": args.adv_alpha, "lr": lr, "k": k, "ls": ls}
        if args.sweep:
            def run_fn(c, epochs):
                row, _ = self.train_eval(name, model, c["margin"], c["lr"], c["k"],
                                         c["alpha"], c["ls"], epochs, eval_on="valid")
                print(json.dumps({"sweep": name, "budget": epochs, "cfg": c,
                                  "valid_mrr": row["mrr"]}), flush=True)
                return row["mrr"]

            rung0 = args.sweep_rung0 or max(args.epochs // 8, 5)
            cfg, _ = successive_halving(self.sweep_grid(name, margin, lr, k, ls),
                                        run_fn, rung0, args.epochs)
            print(json.dumps({"sweep_winner": name, "cfg": cfg}), flush=True)
        row, _ = self.train_eval(name, model, cfg["margin"], cfg["lr"], cfg["k"],
                                 cfg["alpha"], cfg["ls"], args.epochs,
                                 eval_every=args.eval_every, patience=args.patience)
        if args.sweep:
            row["cfg"] = cfg
        print(json.dumps(row), flush=True)
        if args.out:  # appended row by row, so a cut run keeps its rows
            with open(args.out, "a") as f:
                f.write(out_line(args, name, cfg, row))
        return row


def run_device(args) -> torch.device:
    """The GPU unless --cpu; never a quiet fallback to the CPU."""
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device; skge_torch.quality_suite runs on "
                         "the GPU, pass --cpu to run on the CPU")
    return torch.device("cpu" if args.cpu else "cuda")


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    device = run_device(args)
    print("building latent KG...", flush=True)
    ds = load_kg(args, device)
    suite = Suite(args, ds, device)
    rows = [suite.run(*c) for c in configs(args, ds.n_entities, ds.n_relations)]
    if args.out:
        print(f"appended to {args.out}")
    return rows


if __name__ == "__main__":
    main()
