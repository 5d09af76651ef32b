"""Train-step profiler of the port: `scripts/profile_step.py`'s
counterpart, `python -m skge_torch.profile_step`.

Runs the real pairwise step (`training.make_pairwise_step` through
`make_epoch_fn`): one warm-up epoch, then `--epochs` epochs under
`torch.profiler`, and reads the step's own spans
(`utils.metrics.span_totals`): on the card the stream's time inside each
span, on the CPU the host's. `breakdown_ms` is an epoch's milliseconds in
the sampler (`sampling`: `skge_torch.train.sample`), the sweep and its
backward (`fwd+bwd`: `skge_torch.train.score`) and the aggregation and
optimizer update (`apply`: `skge_torch.train.aggregate` +
`skge_torch.train.update`); `epoch_ms` adds them up in that order
(`sample`, `grads`, `full`: the traced epochs' whole step). `--trace DIR`
writes the same profile to `DIR/trace.json` as a Chrome trace
(chrome://tracing, Perfetto), the spans with the kernels on one clock.

The defaults are the main path: TransE (L1), ncomp 150, a shared pool of
k = 1,024, at FB15k's shape (14,951 entities, 1,345 relations, 483,142
train triples), 100 batches an epoch, AdaGrad 0.1, the dense aggregation
(the segment-sum kernel on the card).

Usage:
    python -m skge_torch.profile_step                  # the main path
    python -m skge_torch.profile_step --sampler random-mode --negatives 8
    python -m skge_torch.profile_step --cpu --entities 200 --relations 8 \\
        --ntrain 2000 --ncomp 16 --k 64 --nbatches 5 --trace /tmp/trace

Without `--cpu` it runs on the GPU and exits when there is none.
"""

from __future__ import annotations

import argparse
import json
import os
from itertools import accumulate

import torch

from skge_torch.data import synthetic_kg
from skge_torch.models import MODELS
from skge_torch.optim import AdaGrad
from skge_torch.sampling import RandomModeSampler, SharedNegativeSampler
from skge_torch.training import init_state, make_epoch_fn, make_pairwise_step
from skge_torch.utils.metrics import span_totals

# breakdown_ms's phases and the spans each sums, in the step's order
PHASES = {
    "sampling": ("skge_torch.train.sample",),
    "fwd+bwd": ("skge_torch.train.score",),
    "apply": ("skge_torch.train.aggregate", "skge_torch.train.update"),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU, which must exist)")
    ap.add_argument("--model", default="transe")
    ap.add_argument("--ncomp", type=int, default=150)
    ap.add_argument("--entities", type=int, default=14951)
    ap.add_argument("--relations", type=int, default=1345)
    ap.add_argument("--ntrain", type=int, default=483142)
    ap.add_argument("--nbatches", type=int, default=100)
    ap.add_argument("--sampler", default="shared", choices=["shared", "random-mode"])
    ap.add_argument("--k", type=int, default=1024)
    ap.add_argument("--negatives", type=int, default=8)
    ap.add_argument("--aggregate", default="dense",
                    choices=["unique", "dense", "dense_pallas"])
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace into DIR")
    return ap.parse_args(argv)


def run_device(args) -> torch.device:
    """The GPU unless --cpu; never a quiet fallback to the CPU."""
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device; skge_torch.profile_step runs on the "
                         "GPU, pass --cpu to run on the CPU")
    return torch.device("cpu" if args.cpu else "cuda")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = run_device(args)
    ds = synthetic_kg(args.entities, args.relations, args.ntrain, seed=0,
                      clustered=False)
    model = MODELS[args.model](ds.n_entities, ds.n_relations, args.ncomp)
    opt = AdaGrad(lr=0.1)
    shared = args.sampler == "shared"
    if shared:
        sampler = SharedNegativeSampler(ds.n_entities, k=args.k)
    else:
        sampler = RandomModeSampler(ds.n_entities, modes=(0, 1) * args.negatives)
    xs = torch.as_tensor(ds.train, dtype=torch.int64, device=device)
    step = make_pairwise_step(model, opt, sampler, margin=1.0, aggregate=args.aggregate)
    epoch = make_epoch_fn(step, ds.train.shape[0], args.nbatches)
    state = init_state(model, opt, torch.Generator(device=device).manual_seed(0))
    state, _ = epoch(state, xs)  # warm-up
    _sync(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.epochs):
            state, _ = epoch(state, xs)
        _sync(device)
    totals = span_totals()
    clock = 2 if device.type == "cuda" else 1  # stream_s on the card, host_s here
    phase_ms = {ph: sum(totals[name][clock] for name in names) * 1e3 / args.epochs
                for ph, names in PHASES.items()}
    report = {
        "config": {
            "model": args.model, "sampler": args.sampler,
            "aggregate": args.aggregate,
            "k": args.k if shared else None,
            "negatives": None if shared else args.negatives,
        },
        "epoch_ms": {key: round(t, 3) for key, t in zip(("sample", "grads", "full"),
                                                       accumulate(phase_ms.values()))},
        "breakdown_ms": {ph: round(t, 3) for ph, t in phase_ms.items()},
    }
    print(json.dumps(report, indent=2))

    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        path = os.path.join(args.trace, "trace.json")
        prof.export_chrome_trace(path)
        print(f"trace written to {path}")
        report["trace"] = path
    return report


if __name__ == "__main__":
    main()
