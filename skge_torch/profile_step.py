"""Train-step profiler of the port: `scripts/profile_step.py`'s
counterpart, `python -m skge_torch.profile_step`.

1. **Phase ablation** (always): times three growing fragments of the
   pairwise train step over whole epochs -- negative sampling alone
   (`sample`), then the forward and backward gradients (`grads`), then the
   optimizer's apply (`full`) -- and reports each epoch's milliseconds and
   their differences (`breakdown_ms`). Each timing starts and ends in
   `torch.cuda.synchronize()` on the card.
2. **Trace** (`--trace DIR`): one more epoch of the full step under
   `torch.profiler`, written to `DIR/trace.json` as a Chrome trace
   (chrome://tracing, Perfetto). A failure to trace raises.

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
import time

import torch

from skge_torch.data import synthetic_kg
from skge_torch.models import MODELS
from skge_torch.ops.aggregate import FactoredOcc
from skge_torch.optim import AdaGrad
from skge_torch.sampling import RandomModeSampler, SharedNegativeSampler
from skge_torch.training import (StepMetrics, TrainState, apply_gradients,
                                 init_state, make_epoch_fn, pairwise_grads_fused,
                                 select_shared_pairwise_fn)

PHASES = ("sample", "grads", "full")


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
    n = ds.train.shape[0]

    def grads_of(state, batch, mask):
        if shared:
            pool = sampler.pool(state.generator, batch, mask)
            return select_shared_pairwise_fn(model)(
                model, state.params, batch, pool, mask, 1.0, modes=sampler.modes)
        corr = sampler.corruptions(state.generator, batch, mask)
        return pairwise_grads_fused(model, state.params, batch, corr, mask, 1.0)

    def make_variant(phase):
        def step(state: TrainState, batch, mask, rows=None):
            nxt = TrainState(state.params, state.opt_state, state.generator,
                             state.step + 1)
            if phase == "sample":
                if shared:
                    probe = torch.sum(sampler.pool(state.generator, batch, mask))
                else:
                    probe = sum(torch.sum(r) for _, r, _ in
                                sampler.corruptions(state.generator, batch, mask))
                loss = probe.to(torch.float32)
                return nxt, StepMetrics(loss=loss, nviolations=loss)
            loss, nviol, occ, g_dense = grads_of(state, batch, mask)
            if phase == "grads":
                probe = 0.0
                for entry in occ.values():
                    if isinstance(entry, FactoredOcc):
                        probe += sum(torch.sum(u) for u in entry.us)
                        probe += sum(torch.sum(v) for v in entry.vs)
                    else:
                        probe += torch.sum(entry[1])
                return nxt, StepMetrics(loss=loss + probe, nviolations=nviol)
            params, opt_state = apply_gradients(
                model, opt, state.params, state.opt_state, occ, g_dense,
                args.aggregate, premasked=True, step=state.step)
            return (TrainState(params, opt_state, state.generator, state.step + 1),
                    StepMetrics(loss=loss, nviolations=nviol))

        return make_epoch_fn(step, n, args.nbatches)

    def fresh():
        return init_state(model, opt, torch.Generator(device=device).manual_seed(0))

    def timed(fn):
        state, m = fn(fresh(), xs)  # warm-up epoch
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(args.epochs):
            state, m = fn(state, xs)
        _sync(device)
        return (time.perf_counter() - t0) / args.epochs

    times = {ph: timed(make_variant(ph)) for ph in PHASES}
    report = {
        "config": {
            "model": args.model, "sampler": args.sampler,
            "aggregate": args.aggregate,
            "k": args.k if shared else None,
            "negatives": None if shared else args.negatives,
        },
        "epoch_ms": {ph: round(t * 1e3, 1) for ph, t in times.items()},
        "breakdown_ms": {
            "sampling": round(times["sample"] * 1e3, 1),
            "fwd+bwd": round((times["grads"] - times["sample"]) * 1e3, 1),
            "apply": round((times["full"] - times["grads"]) * 1e3, 1),
        },
    }
    print(json.dumps(report, indent=2))

    if args.trace:
        fn = make_variant("full")
        state, _ = fn(fresh(), xs)
        _sync(device)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            fn(state, xs)
            _sync(device)
        os.makedirs(args.trace, exist_ok=True)
        path = os.path.join(args.trace, "trace.json")
        prof.export_chrome_trace(path)
        print(f"trace written to {path}")
        report["trace"] = path
    return report


if __name__ == "__main__":
    main()
