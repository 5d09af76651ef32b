"""RotatE's init-scale probe on the rotational latent KG, `scripts/
rotate_probe.py`'s counterpart, `python -m skge_torch.rotate_probe`.

Trains RotatE under the self-adversarial loss over a shared pool (k =
8,192, alpha 2, AdaGrad 0.3) on `latent_kg(kind="rotational")` at WN18's
shape (40,943 entities, 18 relations, 327,544 train triples, latent dim
16), for each gamma of `--gammas` and each variant of `--variants`:

- `paper`: the paper's init (`RotatE(gamma_init=gamma)`: entities
  U(-b, b) with b = (gamma + 2) / d, phases U(-pi, pi));
- `nunif`: the default entity init with nunif phases;
- `mixed`: the default entity init with uniform(-pi, pi) phases;
- `oracle`: the generator's own latents as the parameters
  (`oracle_params`), trained from there.

Each run validates every `--eval-every` epochs (filtered MRR), keeps the
best parameters, stops after `--patience` non-improving validations, and
prints one JSON line a validation and one row (the test ranking of the
best parameters, with the entity norm and phase spread of `diag` at init
and at the end) in the JAX script's keys.

The KG is built on the run's device and cached under the port's own name
(`quality_suite.cache_path`, the device type in it).

Usage:
    python -m skge_torch.rotate_probe                  # full scale
    python -m skge_torch.rotate_probe --cpu --entities 2000 --ntrain 16000

Without `--cpu` it runs on the GPU and raises when there is none.
"""

from __future__ import annotations

import argparse
import json
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from skge_torch import quality_suite
from skge_torch.data import Dataset, cached_dataset, latent_kg
from skge_torch.evaluation import FilteredRankingEval
from skge_torch.models import RotatE
from skge_torch.optim import AdaGrad
from skge_torch.sampling import SharedNegativeSampler
from skge_torch.training import init_state, make_epoch_fn, make_selfadv_step
from skge_torch.utils.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--entities", type=int, default=40943)
    ap.add_argument("--relations", type=int, default=18)
    ap.add_argument("--ntrain", type=int, default=327544)
    ap.add_argument("--latent-dim", type=int, default=16)
    ap.add_argument("--ncomp", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--patience", type=int, default=3)
    ap.add_argument("--k", type=int, default=8192)
    ap.add_argument("--gammas", default="3,6,12")
    ap.add_argument("--variants", default="paper,nunif",
                    help="comma subset of paper,nunif,mixed,oracle")
    ap.add_argument("--alpha", type=float, default=2.0)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--nbatches", type=int, default=100)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU, which must exist)")
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def load_kg(args, device: torch.device) -> Dataset:
    """The rotational latent KG, read from the port's cache or built on
    `device` and written there (`data.cached_dataset`)."""
    n_held = quality_suite.held_out(args.ntrain)
    key = SimpleNamespace(kg="rotational", entities=args.entities,
                          relations=args.relations, ntrain=args.ntrain,
                          latent_dim=args.latent_dim)
    ds, _ = cached_dataset(
        quality_suite.cache_path(key, device), args.entities, args.relations,
        lambda: latent_kg(n_entities=args.entities, n_relations=args.relations,
                          n_train=args.ntrain, n_valid=n_held, n_test=n_held,
                          latent_dim=args.latent_dim, seed=0, kind="rotational",
                          device=device))
    return ds


def diag(params) -> Dict[str, float]:
    """The mean entity-row norm and the spread of the phases."""
    E, R = params["E"].detach().cpu().numpy(), params["R"].detach().cpu().numpy()
    return {
        "e_norm": round(float(np.linalg.norm(E, axis=1).mean()), 4),
        "phase_sd": round(float(R.std()), 4),
    }


def oracle_params(entities: int, relations: int, latent_dim: int,
                  ncomp: int) -> Dict[str, np.ndarray]:
    """The GENERATOR's latents as RotatE parameters, drawn from
    `default_rng(0)` in `latent_kg(kind="rotational")`'s order: the
    entities' complex latents (in the unit ball) and the relations'
    phases. Complex dims beyond latent_dim / 2 are zeros: rotations act on
    zeros, distances unchanged."""
    rng = np.random.default_rng(0)
    Z = rng.normal(size=(entities, latent_dim)).astype(np.float32)
    Z /= np.maximum(np.linalg.norm(Z, axis=1, keepdims=True), 1.0)
    Rel = rng.uniform(-np.pi, np.pi, size=(relations, latent_dim // 2)).astype(
        np.float32)
    h = latent_dim // 2
    pad = ncomp - h
    if pad < 0:
        raise SystemExit("--ncomp must be >= latent_dim/2 for oracle")
    a, b = Z[:, :h], Z[:, h:]
    ze = np.zeros((entities, pad), np.float32)
    zr = np.zeros((relations, pad), np.float32)
    return {"E": np.concatenate([a, ze, b, ze], axis=1),
            "R": np.concatenate([Rel, zr], axis=1)}


def run_variant(args, ds: Dataset, device: torch.device, tag: str, model: RotatE,
                gamma: float, oracle: bool = False) -> dict:
    """One (variant, gamma) run: its validation lines and its row."""
    opt = AdaGrad(lr=args.lr)
    sampler = SharedNegativeSampler(ds.n_entities, k=args.k)
    step = make_selfadv_step(model, opt, sampler, margin=gamma, alpha=args.alpha,
                             aggregate="dense")
    xs = torch.as_tensor(ds.train, dtype=torch.int64, device=device)
    epoch = make_epoch_fn(step, int(xs.shape[0]), args.nbatches)
    state = init_state(model, opt, torch.Generator(device=device).manual_seed(0))
    if oracle:
        params = oracle_params(args.entities, args.relations, args.latent_dim,
                               args.ncomp)
        state = state._replace(params={k: torch.as_tensor(v, device=device)
                                       for k, v in params.items()})
    d0 = diag(state.params)
    all_triples = ds.all_triples()
    val_ev = FilteredRankingEval(model, ds.valid, all_triples, batch_size=1024)
    best = (-1.0, 0, None)
    bad, e, t0 = 0, 0, time.perf_counter()
    while e < args.epochs:
        state, _ = epoch(state, xs)
        e += 1
        if e % args.eval_every == 0 or e == args.epochs:
            vm = val_ev(state.params).mrr
            print(json.dumps({"tag": tag, "epoch": e,
                              "valid_mrr": round(float(vm), 4),
                              **diag(state.params)}), flush=True)
            if vm > best[0]:
                best = (vm, e, {k: v.clone() for k, v in state.params.items()})
                bad = 0
            else:
                bad += 1
                if bad >= args.patience:
                    break
    params = best[2] if best[2] is not None else state.params
    r = FilteredRankingEval(model, ds.test, all_triples, batch_size=1024)(params)
    row = {
        "tag": tag, "gamma": gamma, "best_epoch": best[1],
        "train_s": round(time.perf_counter() - t0, 1),
        "mrr": round(float(r.mrr), 4), "hits10": round(float(r.hits[10]), 3),
        "mr": round(float(r.mean_rank), 1),
        "init": d0, "final": diag(params),
    }
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda", verb="probes")
    ds = load_kg(args, device)
    n_e, n_r, d = ds.n_entities, ds.n_relations, args.ncomp
    gammas = [float(g) for g in args.gammas.split(",")]
    variants = [v for v in args.variants.split(",") if v]
    rows = []
    for g in gammas:
        if "paper" in variants:
            rows.append(run_variant(args, ds, device, f"paper-init g={g}",
                                    RotatE(n_e, n_r, d, gamma_init=g), g))
        if "nunif" in variants:
            rows.append(run_variant(args, ds, device, f"nunif g={g}",
                                    RotatE(n_e, n_r, d, phase_init="nunif"), g))
        if "mixed" in variants:
            # isolate the phase-spread mechanism: entities keep the nunif
            # scale, ONLY phases start at the generator's uniform(-pi, pi)
            rows.append(run_variant(args, ds, device, f"uniform-phase g={g}",
                                    RotatE(n_e, n_r, d, phase_init="uniform"), g))
        if "oracle" in variants:
            # train selfadv FROM the generator's own latents: does the loss
            # hold the realizable optimum or walk away from it?
            rows.append(run_variant(args, ds, device, f"oracle-init g={g}",
                                    RotatE(n_e, n_r, d), g, oracle=True))
    if args.out:
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return rows


if __name__ == "__main__":
    main()
