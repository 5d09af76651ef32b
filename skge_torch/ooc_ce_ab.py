"""The out-of-core CE A/B of the port: `scripts/ooc_ce_ab.py`'s
counterpart, `python -m skge_torch.ooc_ce_ab`.

`OutOfCoreTrainer(loss='ce')` computes the softmax over the RESIDENT
parts' candidates: exact at P=1 (the whole table is resident), an
approximation at P>1. This A/B measures that cost on the learnable
translational latent KG at WN18's shape, with one budget and protocol for
every arm (reciprocal relations, object-direction CE with label smoothing
0.1, Adam 1e-3, DistMult d=150, the validation-selected checkpoint), and
whether out-of-core sampled CE (the pool drawn from the resident parts)
recovers it. The A/B decided `outofcore.choose_ce_loss`.

Arms: P=1 full CE (the in-core full-CE trajectory), P=2 and P=4 resident
CE, P=2 and P=4 sampled CE (k=8192). Each arm validates every
`--eval-every` epochs with the streamed filtered ranking, keeps a host
copy of the best parameters, stops after `--patience` validations without
a gain, and ranks the test split with the best parameters. One JSON line a
validation and one a finished arm, the JAX script's.

The latent KG is built on the run's device and cached in `CACHE_DIR`
under a name of the port's own that carries the device type, written
whole under a temporary name and renamed; no other build's file is read.

Usage:
    python -m skge_torch.ooc_ce_ab [--epochs 200] [--eval-every 20]
    python -m skge_torch.ooc_ce_ab --cpu --entities 400 --relations 8 \\
        --ntrain 1500 --latent-dim 8 --dim 16 --k 64 --nbatches 5 \\
        --epochs 4 --eval-every 2                      # seconds

Without `--cpu` it runs on the GPU and exits when there is none.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import List

import torch

from skge_torch.data import Dataset, add_reciprocal_relations, cached_dataset, latent_kg
from skge_torch.models import DistMult
from skge_torch.optim import Adam
from skge_torch.outofcore import OutOfCoreTrainer

# where the latent KGs are cached; tests point it at a temporary directory
CACHE_DIR = Path(__file__).resolve().parents[1] / "build" / "ooc_ce_ab"


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--entities", type=int, default=40943)
    ap.add_argument("--relations", type=int, default=18)
    ap.add_argument("--ntrain", type=int, default=141442)
    ap.add_argument("--latent-dim", type=int, default=32)
    ap.add_argument("--dim", type=int, default=150)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--eval-every", type=int, default=20)
    ap.add_argument("--patience", type=int, default=3)
    ap.add_argument("--k", type=int, default=8192)
    ap.add_argument("--nbatches", type=int, default=100)
    ap.add_argument("--arms", default="ce:1,ce:2,ce:4,sampled_ce:2,sampled_ce:4")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU, which must exist)")
    ap.add_argument("--out", default=None, help="append each arm's row to this file")
    return ap.parse_args(argv)


def run_device(args) -> torch.device:
    """The GPU unless --cpu; never a quiet fallback to the CPU."""
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device; skge_torch.ooc_ce_ab runs on the "
                         "GPU, pass --cpu to run on the CPU")
    return torch.device("cpu" if args.cpu else "cuda")


def held_out(ntrain: int) -> int:
    """Validation and test triples each."""
    return min(5000, max(50, ntrain // 10))


def load_kg(args, device: torch.device) -> Dataset:
    """The A/B's translational latent KG, built on `device` or read from the
    port's cache (`data.cached_dataset`)."""
    n_held = held_out(args.ntrain)
    key = (f"translational-e{args.entities}-r{args.relations}"
           f"-t{args.ntrain}-h{n_held}-l{args.latent_dim}-s0")
    return cached_dataset(
        Path(CACHE_DIR) / f"latent_kg_torch-{device.type}-{key}.npz",
        args.entities, args.relations,
        lambda: latent_kg(n_entities=args.entities, n_relations=args.relations,
                          n_train=args.ntrain, n_valid=n_held, n_test=n_held,
                          latent_dim=args.latent_dim, seed=0, device=device))[0]


def make_trainer(args, aug: Dataset, loss: str, n_parts: int, device,
                 dtype: str = "float32") -> OutOfCoreTrainer:
    """One arm's trainer, as the JAX script builds it (`dtype` for the
    tests' fp64)."""
    model = DistMult(aug.n_entities, aug.n_relations, args.dim, dtype=dtype)
    return OutOfCoreTrainer(
        model, Adam(lr=1e-3), aug.train, n_parts=n_parts, k=args.k,
        nbatches=args.nbatches, seed=0, loss=loss, label_smoothing=0.1,
        ce_directions=("o",), device=device,
    )


def run_arm(args, arm: str, ds: Dataset, aug: Dataset, device) -> dict:
    """Train one arm with validation every `--eval-every` epochs and early
    stopping; returns its row (the test ranking of the best parameters)."""
    loss, p = arm.split(":")
    p = int(p)
    all_triples = aug.all_triples()
    tr = make_trainer(args, aug, loss, p, device)
    best_mrr, best_epoch, best_host, best_dev = -1.0, 0, None, None
    bad, e = 0, 0
    t0 = time.perf_counter()
    while e < args.epochs:
        tr.fit(epochs=args.eval_every)
        e += args.eval_every
        vm = tr.evaluate(ds.valid, all_triples, batch_size=1024, reciprocal=True).mrr
        print(json.dumps({"arm": arm, "epoch": e, "valid_mrr": round(float(vm), 4)}),
              flush=True)
        if vm > best_mrr:
            # host copies: the full table is small at this shape
            best_mrr, best_epoch = vm, e
            best_host = {kk: v.clone() for kk, v in tr.e_host.items()}
            best_dev = {kk: v.detach().clone() for kk, v in tr.dev_params.items()}
            bad = 0
        else:
            bad += 1
            if bad >= args.patience:
                break
    if best_host is not None:  # the best checkpoint for the test ranking
        tr.flush()
        for kk, v in best_host.items():
            tr.e_host[kk].copy_(v)
        tr.dev_params = best_dev
    r = tr.evaluate(ds.test, all_triples, batch_size=1024, reciprocal=True)
    return {
        "arm": arm, "n_parts": p, "best_epoch": best_epoch,
        "train_eval_s": round(time.perf_counter() - t0, 1),
        "mrr": round(r.mrr, 4), "hits10": round(r.hits[10], 3),
        "mr": round(r.mean_rank, 1),
    }


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    device = run_device(args)
    ds = load_kg(args, device)
    aug = add_reciprocal_relations(ds)
    rows = []
    for arm in args.arms.split(","):
        row = run_arm(args, arm, ds, aug, device)
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return rows


if __name__ == "__main__":
    main()
