"""Verify driver: the N3 regularization A/B through the port's public API,
`scripts/_verify_n3.py`'s counterpart, `python -m skge_torch.verify_n3
[--cpu] [--sweep]`.

Trains ComplEx (ncomp 16) with full cross entropy and label smoothing 0.1
(its canonical pairing, Lacroix et al. 2018) on the self-adversarial
driver's latent KG (`verify_selfadv.load`) at several N3 strengths and
prints the filtered MRR: by default n3 {0, 1e-4, 1e-3} at lr 1.0, the
mean and spread over seeds 0-2; with `--sweep` one line a configuration
over n3 {0, 1e-4, 1e-3, 1e-2, 3e-2} x lr {0.3, 1.0}, seed 0.

JAX's script takes `cpu` as its first argument; here that is `--cpu`.
Without it the driver runs on the GPU and raises when there is none.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from skge_torch.data import Dataset
from skge_torch.evaluation import FilteredRankingEval
from skge_torch.models import ComplEx
from skge_torch.trainer import TrainConfig, Trainer
from skge_torch.utils.device import resolve_device
from skge_torch.verify_selfadv import load, parse_args


def run(ds: Dataset, n3: float, seed: int, device: torch.device,
        lr: float = 0.3) -> Tuple[float, float]:
    """(filtered MRR, hits@10) of one CE run of ComplEx with `n3`."""
    model = ComplEx(ds.n_entities, ds.n_relations, 16, n3=n3)
    cfg = TrainConfig(max_epochs=40, nbatches=16, learning_rate=lr,
                      loss="ce", label_smoothing=0.1, seed=seed)
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
        for n3 in (0.0, 1e-4, 1e-3, 1e-2, 3e-2):
            for lr in (0.3, 1.0):
                mrr, h10 = run(ds, n3, 0, device, lr)
                print(f"n3={n3} lr={lr}: MRR {mrr:.4f} hits@10 {h10:.4f}",
                      flush=True)
    else:
        # lr=1.0 from the --sweep (CE on this KG prefers hot AdaGrad rates)
        for n3 in (0.0, 1e-4, 1e-3):
            ms = [run(ds, n3, s, device, lr=1.0)[0] for s in (0, 1, 2)]
            print(f"n3={n3}: MRR {np.mean(ms):.4f} +- {np.std(ms):.4f}",
                  flush=True)
        print("OK", flush=True)


if __name__ == "__main__":
    main()
