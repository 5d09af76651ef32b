"""Training throughput of the port: scored triples a second through the
full training step on FB15k-shaped data, the root `bench.py`'s
counterpart, `python -m skge_torch.bench`.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "triples/s", "vs_baseline": N}

`value` counts REFERENCE-EQUIVALENT scored triples per second in the full
training step (gather -> score -> margin ranking -> duplicate-averaged
gradients -> sparse AdaGrad + normless1 -> negative sampling on the
device), exactly as `bench.py` counts them: the reference evaluates 2
scores per margin-ranked pair, so work units = 2 * (pairs ranked per
epoch); full and sampled CE count one scoring per candidate.

The default is `bench.py`'s: TransE (L1), ncomp 150, a shared negative
pool of k = 1,024 entities a step (`--sampler shared`), which ranks each
positive against the k pool entities in both corruption modes, 2k pairs a
positive, 4 * k * n_train work units an epoch. `--sampler random-mode` is
the reference-exact iid corruption, 2 * negatives pairs a positive.

`--aggregate` keeps the JAX package's four names. The three dense modes
(`dense`, `dense_pallas`, `dense_sorted`) all scatter the occurrence
gradients through the port's CUDA kernel `segment_sum`
(skge_torch/csrc/segment_sum.cu; RESCAL's factored W through
`segment_outer_sum`); `unique` averages over `torch.unique` with
`index_add_`, as does the sampled-CE step, which takes that mode as in the
JAX package. `--compute-dtype bfloat16` runs the batched scoring matmuls
on the card's bf16 tensor cores (`KGEModel.compute_dtype`); parameters,
gradients outside those products and the optimizer stay fp32.

`vs_baseline` is value / 50e6, the BASELINE.md north-star target.

`--all` runs the curated (model, loss, k) matrix `ALL_ROWS`: one JSON
line per row, with its argv fragment under `config`.

Usage:
    python -m skge_torch.bench                      # TransE-L1, k=1,024
    python -m skge_torch.bench --all --epochs 1
    python -m skge_torch.bench --cpu --entities 200 --relations 8 \\
        --ntrain 2000 --ncomp 16 --k 64 --nbatches 5 --epochs 1

One untimed warm-up epoch, then `--epochs` timed epochs; the clock stops
after a host read of the last epoch's losses, which waits for the device.
Without `--cpu` it runs on the GPU and raises when there is none.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from skge_torch.data import synthetic_kg
from skge_torch.models import MODELS
from skge_torch.optim import AdaGrad
from skge_torch.sampling import RandomModeSampler, SharedNegativeSampler
from skge_torch.training import (init_state, make_ce_step, make_epoch_fn,
                                 make_pairwise_step, make_sampled_ce_step,
                                 make_selfadv_step)
from skge_torch.utils.device import resolve_device

# The curated --all matrix (bench.py's): argv fragments over this parser.
ALL_ROWS = [
    ["--model", "transe"],                                  # flagship L1
    ["--model", "transe", "--l2"],
    ["--model", "transe", "--l2", "--k", "4096"],
    ["--model", "hole", "--k", "4096"],
    ["--model", "rescal", "--ncomp", "100"],
    ["--model", "ermlp"],
    ["--model", "distmult"],
    ["--model", "complex", "--ncomp", "75"],
    ["--model", "rotate"],
    ["--model", "transh"],
    ["--model", "transr", "--factored"],
    ["--model", "pairre"],
    ["--model", "tucker", "--ncomp", "100"],
    ["--model", "simple"],
    ["--model", "quate"],
    ["--model", "conve", "--ncomp", "128"],
    ["--model", "transe", "--selfadv"],
    ["--model", "distmult", "--ce"],
    ["--model", "distmult", "--sampled-ce", "--k", "8192"],
    ["--model", "conve", "--ncomp", "128", "--ce"],
]

BASELINE = 50e6  # triples/s, BASELINE.md's north-star target


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU, which must exist)")
    ap.add_argument("--all", action="store_true",
                    help="run the curated model x loss matrix (ALL_ROWS); "
                    "one JSON line per row")
    ap.add_argument("--l2", action="store_true",
                    help="[transe] squared-L2 score instead of L1")
    ap.add_argument(
        "--model", default="transe",
        choices=["transe", "hole", "rescal", "ermlp", "distmult", "complex",
                 "rotate", "transh", "transr", "tucker", "simple", "quate",
                 "pairre", "conve"],
    )
    ap.add_argument("--ncomp", type=int, default=150)
    ap.add_argument("--nbatches", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=3, help="timed epochs")
    ap.add_argument("--entities", type=int, default=14951)  # FB15k
    ap.add_argument("--relations", type=int, default=1345)
    ap.add_argument("--ntrain", type=int, default=483142)
    ap.add_argument(
        "--aggregate", default="dense",
        choices=["unique", "dense", "dense_pallas", "dense_sorted"],
        help="gradient aggregation. The three dense modes scatter through "
        "the CUDA kernel segment_sum (skge_torch/csrc/segment_sum.cu); "
        "'unique' averages over torch.unique with index_add_",
    )
    ap.add_argument(
        "--sampler", default="shared", choices=["shared", "random-mode"],
        help="'shared': K-entity shared negative pool per step (PBG/DGL-KE "
        "scheme). 'random-mode': reference-exact iid corruption per positive.",
    )
    ap.add_argument(
        "--k", type=int, default=1024,
        help="shared-pool size (pairs per positive = 2*k).",
    )
    ap.add_argument(
        "--negatives", type=int, default=8,
        help="[random-mode] negatives per (positive, mode); the reference "
        "Sampler's `n` (skge/sample.py). 8 => 16 ranked pairs per positive.",
    )
    ap.add_argument(
        "--ce", action="store_true",
        help="full 1-vs-all cross-entropy loss instead of pairwise margin "
        "(no sampler; every positive scored against ALL entities — work "
        "units = n_entities per positive per direction)",
    )
    ap.add_argument(
        "--compute-dtype", default="", choices=["", "bfloat16", "float32"],
        help="input precision of the batched scoring matmuls "
        "(KGEModel.compute_dtype). Parameters/optimizer/updates stay fp32; "
        "'' (default) keeps exact fp32 scoring; 'bfloat16' runs them on the "
        "card's bf16 tensor cores.",
    )
    ap.add_argument(
        "--factored", action="store_true",
        help="[transr] rank-1 factored projections M_p = I + u_p v_p^T "
        "(TransD-style) instead of full (d, d) matrices (models/transr.py).",
    )
    ap.add_argument(
        "--selfadv", action="store_true",
        help="self-adversarial loss (Sun et al. 2019) over the shared pool "
        "instead of pairwise margin (same work units: 2 scores per "
        "(positive, pool, mode) element)",
    )
    ap.add_argument(
        "--sampled-ce", action="store_true",
        help="importance-corrected sampled-softmax CE over the shared pool "
        "(training.sampled_ce_grads_shared) at O(B*k*d) instead of "
        "O(B*n_e*d) work; work units = (k+1) candidate scorings per "
        "positive per direction",
    )
    return ap


def parse_args(argv=None, ap=None) -> argparse.Namespace:
    """`bench.py`'s flags and its argument errors."""
    ap = ap or make_parser()
    args = ap.parse_args(argv)
    if args.negatives < 1:
        ap.error("--negatives must be >= 1")
    if args.k < 1:
        ap.error("--k must be >= 1")
    if sum((args.ce, args.selfadv, args.sampled_ce)) > 1:
        ap.error("--ce / --selfadv / --sampled-ce are mutually exclusive")
    return args


def all_rows(args, ap=None) -> list:
    """The `--all` matrix: (config, the row's args) for each ALL_ROWS row,
    over `args`' --cpu, --epochs, --nbatches and graph sizes."""
    ap = ap or make_parser()
    base = ["--cpu"] if args.cpu else []
    for flag in ("--epochs", "--nbatches", "--entities", "--relations", "--ntrain"):
        base += [flag, str(getattr(args, flag.strip("-")))]
    return [(" ".join(row), ap.parse_args(base + row)) for row in ALL_ROWS]


def main(argv=None) -> None:
    ap = make_parser()
    args = parse_args(argv, ap)
    if args.all:
        for config, row_args in all_rows(args, ap):
            rec = run(row_args)
            rec["config"] = config
            print(json.dumps(rec), flush=True)
        return
    print(json.dumps(run(args)))


def run(args) -> dict:
    """One row: the step of `args` over `--epochs` timed epochs after one
    warm-up epoch; returns the JSON record."""
    device = resolve_device("cpu" if args.cpu else "cuda", verb="benchmarks")
    ds = synthetic_kg(args.entities, args.relations, args.ntrain, seed=0,
                      clustered=False)
    # ConvE is directional: reciprocal relation ids + object-side corruption
    # only; each positive ranks against the pool in ONE mode
    modes = (1,) if args.model == "conve" else (0, 1)
    n_rel = 2 * ds.n_relations if args.model == "conve" else ds.n_relations
    mkw = {"compute_dtype": args.compute_dtype}
    if args.l2:
        if args.model != "transe":
            raise SystemExit("--l2 is a TransE option")
        mkw["l1"] = False
    if args.factored:
        if args.model != "transr":
            raise SystemExit("--factored is a TransR option")
        mkw["factored"] = True
    model = MODELS[args.model](ds.n_entities, n_rel, args.ncomp, **mkw)
    opt = AdaGrad(lr=0.1)
    directions = ("o",) if args.model == "conve" else ("o", "s")
    if args.ce:
        step = make_ce_step(model, opt, directions=directions)
        pairs_per_positive = len(directions) * ds.n_entities
    elif args.selfadv:
        sampler = SharedNegativeSampler(ds.n_entities, k=args.k, modes=modes)
        step = make_selfadv_step(model, opt, sampler, margin=1.0, alpha=1.0,
                                 aggregate="dense")
        pairs_per_positive = len(modes) * args.k
    elif args.sampled_ce:
        sampler = SharedNegativeSampler(ds.n_entities, k=args.k, modes=modes)
        step = make_sampled_ce_step(model, opt, sampler, directions=directions)
        pairs_per_positive = len(directions) * (args.k + 1)
    else:
        if args.sampler == "shared":
            sampler = SharedNegativeSampler(ds.n_entities, k=args.k, modes=modes)
            pairs_per_positive = len(modes) * args.k
        else:
            sampler = RandomModeSampler(ds.n_entities, modes=modes * args.negatives)
            pairs_per_positive = len(modes) * args.negatives
        step = make_pairwise_step(model, opt, sampler, margin=1.0,
                                  aggregate=args.aggregate)
    n = ds.train.shape[0]
    epoch = make_epoch_fn(step, n, args.nbatches)
    state = init_state(model, opt, torch.Generator(device=device).manual_seed(0))
    xs = torch.as_tensor(ds.train, dtype=torch.int64, device=device)

    state, m = epoch(state, xs)  # warm-up
    m.loss.cpu()  # the host read waits for the device

    t0 = time.perf_counter()
    for _ in range(args.epochs):
        state, m = epoch(state, xs)
    m.loss.cpu()
    dt = time.perf_counter() - t0

    # 2 reference-equivalent scores (pos+neg) per margin-ranked pair;
    # CE / sampled-CE work units are single candidate scorings (no pairing)
    per_pair = 1 if (args.ce or args.sampled_ce) else 2
    value = per_pair * pairs_per_positive * n * args.epochs / dt
    return {
        "metric": (
            f"{args.model}"
            f"{'_l2' if args.l2 else ''}"
            f"{'_ce' if args.ce else ''}"
            f"{'_selfadv' if args.selfadv else ''}"
            f"{'_sampled_ce' if args.sampled_ce else ''}"
            "_fb15k_scored_triples_per_s_per_chip"
        ),
        "value": round(value, 1),
        "unit": "triples/s",
        "vs_baseline": round(value / BASELINE, 4),
    }


if __name__ == "__main__":
    main()
