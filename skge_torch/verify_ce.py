"""Verify driver: full cross entropy end to end through the port's public
API, `scripts/_verify_ce.py`'s counterpart, `python -m
skge_torch.verify_ce [--cpu] [--sweep]`.

Trains TransE (L2, ncomp 32) with `Trainer(loss='ce')` on the self-
adversarial driver's latent KG (`verify_selfadv.load`) and prints the
filtered MRR: by default at lr 0.3 with label smoothing 0 and 0.1, the
mean and spread over seeds 0-2; with `--sweep` one line a configuration
over lr {0.1, 0.3, 0.5, 1.0} x label smoothing {0, 0.1}, seed 0.

JAX's script takes `cpu` as its first argument; here that is `--cpu`.
Without it the driver runs on the GPU and raises when there is none.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from skge_torch.data import Dataset
from skge_torch.evaluation import FilteredRankingEval
from skge_torch.models import TransE
from skge_torch.trainer import TrainConfig, Trainer
from skge_torch.utils.device import resolve_device
from skge_torch.verify_selfadv import load, parse_args


def run(ds: Dataset, lr: float, ls: float, seed: int,
        device: torch.device) -> Tuple[float, float]:
    """(filtered MRR, hits@10) of one CE run."""
    model = TransE(ds.n_entities, ds.n_relations, 32, l1=False)
    cfg = TrainConfig(max_epochs=40, nbatches=16, learning_rate=lr,
                      loss="ce", label_smoothing=ls, seed=seed)
    tr = Trainer(model, sampler=None, config=cfg, device=device)
    tr.fit(ds.train)
    r = FilteredRankingEval(model, ds.test, ds.all_triples(),
                            batch_size=100)(tr.state.params)
    return float(r.mrr), float(r.hits[10])


def main(argv=None) -> None:
    args = parse_args(argv, sweep=True)
    device = resolve_device("cpu" if args.cpu else "cuda", verb="verifies")
    print("backend:", device.type, flush=True)
    ds = load(device)
    if args.sweep:
        for lr in (0.1, 0.3, 0.5, 1.0):
            for ls in (0.0, 0.1):
                mrr, h10 = run(ds, lr, ls, 0, device)
                print(f"lr={lr} ls={ls}: MRR {mrr:.4f} hits@10 {h10:.4f}",
                      flush=True)
    else:
        for ls in (0.0, 0.1):
            ms = [run(ds, 0.3, ls, s, device)[0] for s in (0, 1, 2)]
            print(f"ls={ls}: MRR {np.mean(ms):.4f} +- {np.std(ms):.4f}",
                  flush=True)
        print("OK", flush=True)


if __name__ == "__main__":
    main()
