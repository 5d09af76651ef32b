"""Verify driver: the self-adversarial loss end to end through the port's
public API, `scripts/_verify_selfadv.py`'s counterpart, `python -m
skge_torch.verify_selfadv [--cpu]`.

Trains TransE (L2, ncomp 32) with `Trainer(loss='selfadv')` over a shared
pool of 64 on the latent KG `latent_kg(500, 16, 4000, n_test=100,
latent_dim=10, seed=0)`, prints the first and last epoch's loss and the
final filtered MRR, and fails unless the loss dropped 40% and the MRR
exceeds 0.05. The Trainer keeps `TrainConfig`'s default aggregation,
`unique`, as the JAX script does.

JAX's script takes `cpu` as its first argument; here that is `--cpu`.
Without it the driver runs on the GPU and raises when there is none.
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

import torch

from skge_torch.data import Dataset, latent_kg
from skge_torch.evaluation import FilteredRankingEval, RankingResult
from skge_torch.models import TransE
from skge_torch.sampling import SharedNegativeSampler
from skge_torch.trainer import TrainConfig, Trainer
from skge_torch.utils.device import resolve_device


def parse_args(argv=None, sweep: bool = False) -> argparse.Namespace:
    """`--cpu`, and with `sweep` the loss A/B drivers' `--sweep`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU, which must exist)")
    if sweep:
        ap.add_argument("--sweep", action="store_true",
                        help="the lever grid instead of the 3-seed A/B")
    return ap.parse_args(argv)


def load(device: torch.device) -> Dataset:
    """The loss A/B drivers' latent KG, built on `device`."""
    return latent_kg(n_entities=500, n_relations=16, n_train=4000, n_valid=0,
                     n_test=100, latent_dim=10, seed=0, device=device)


def run(ds: Dataset, device: torch.device) -> Tuple[List[float], RankingResult]:
    """(each epoch's loss, the final filtered ranking of the test split)."""
    model = TransE(ds.n_entities, ds.n_relations, 32, l1=False)
    cfg = TrainConfig(max_epochs=40, nbatches=16, learning_rate=0.3,
                      margin=3.0, loss="selfadv", adv_alpha=1.0)
    tr = Trainer(model, SharedNegativeSampler(ds.n_entities, k=64), cfg, device=device)
    tr.fit(ds.train)
    losses = [m["loss"] for m in tr.metrics.history]
    r = FilteredRankingEval(model, ds.test, ds.all_triples(), batch_size=100)(
        tr.state.params)
    return losses, r


def main(argv=None) -> Tuple[List[float], RankingResult]:
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda", verb="verifies")
    print("backend:", device.type, flush=True)
    losses, r = run(load(device), device)
    print("loss first/last:", round(losses[0], 3), round(losses[-1], 3), flush=True)
    print("final filtered MRR:", round(float(r.mrr), 4),
          "hits@10:", round(float(r.hits[10]), 4), flush=True)
    if not losses[-1] < losses[0] * 0.6:
        raise AssertionError("loss did not drop 40%")
    if not r.mrr > 0.05:
        raise AssertionError("MRR degenerate")
    print("OK", flush=True)
    return losses, r


if __name__ == "__main__":
    main()
