"""Weak scaling of the port's SPMD pairwise step over a growing
('data', 'model') mesh at a fixed batch a device, `scripts/scaling_bench.py`'s
counterpart, `python -m skge_torch.scaling_bench`.

Each size N (1, 2, 4, ... up to `--devices`) runs as one world of N
processes (`parallel.distributed.launch_local`), one process a device, on
the mesh's default shape ((N/2, 2) for even N, `mesh.make_mesh`):

- on GPUs (the default) over NCCL, one card a process (N <= the cards
  there are). Per-device work is constant, so the weak-scaling
  efficiency(N) = step(1) / step(N), held to 0.85 at N >= 2. With one card
  only N=1 runs: its efficiency is 1.0 and the summary's `worst`
  defaults to 1.0, so one card measures no scaling;
- with `--cpu` over gloo, the processes sharing this host's cores, so
  efficiency means nothing. The code-path metric is the SPMD overhead:
  the sharded step on N processes over the unsharded step on the same
  total batch, which runs as its own world of one on a (1, 1) mesh. It is
  gated by `--max-overhead` (by default 2.8 for shardmap, 4.5 for gspmd,
  the JAX script's gates), which catches only gross regressions.

Every worker runs `WORKER_THREADS` intra-op threads, in the sharded and the
unsharded world alike. Each world's rank 0 reports its step seconds (the
mean of `--steps` steps after one untimed step, ending in a host read of
the loss); the records and the summary are a function of those seconds
alone (`summarize`). Prints one JSON record a size, then the summary, with
the JAX script's keys; `backend` and `note` say what ran. Exits 1 when
the summary does not pass.

Usage:
    python -m skge_torch.scaling_bench --cpu --devices 4
    python -m skge_torch.scaling_bench --cpu --sampler shared --k 256
    python -m skge_torch.scaling_bench            # on the GPUs: efficiency
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from skge_torch.models import MODELS
from skge_torch.optim import AdaGrad
from skge_torch.parallel import distributed
from skge_torch.parallel.mesh import Mesh, make_mesh, shard_state
from skge_torch.parallel.sharded import make_sharded_pairwise_step
from skge_torch.parallel.shardmap_step import (make_shardmap_pairwise_step,
                                               shard_state_shardmap)
from skge_torch.sampling import RandomModeSampler, SharedNegativeSampler
from skge_torch.training import init_state

SIZES = (1, 2, 4, 8, 16, 32)
WORKER_THREADS = 1
WORLD_TIMEOUT_S = 1800.0
GATES = {"shardmap": 2.8, "gspmd": 4.5}  # --max-overhead's defaults
EFFICIENCY_TARGET = 0.85


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m skge_torch.scaling_bench")
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="run each world as N gloo processes on this host's CPU, "
                    f"each worker at {WORKER_THREADS} intra-op thread(s), the sharded "
                    "and the unsharded world alike")
    ap.add_argument("--model", default="transe")
    ap.add_argument("--ncomp", type=int, default=64)
    ap.add_argument("--entities", type=int, default=20000)
    ap.add_argument("--relations", type=int, default=200)
    ap.add_argument("--per-device-batch", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--sampler", default="random-mode",
                    choices=["random-mode", "shared"])
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--negatives", type=int, default=4)
    ap.add_argument("--impl", default="shardmap",
                    choices=["shardmap", "gspmd"],
                    help="shardmap: the explicit collectives of "
                    "parallel/shardmap_step.py; gspmd: torch has no GSPMD, so "
                    "parallel/sharded.py's single-device-equal step "
                    "(make_sharded_pairwise_step + mesh.shard_state), which runs "
                    "the shardmap step for the pool and iid samplers")
    ap.add_argument("--max-overhead", type=float, default=None,
                    help="[--cpu] pass gate on the SPMD overhead against the "
                    "unsharded step; default per impl: shardmap 2.8, gspmd 4.5 "
                    "(the JAX script's)")
    # a worker of one world: the size N whose batch it runs, and whether it
    # is the unsharded reference (a world of one on a (1, 1) mesh)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--unsharded", action="store_true", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def sizes(args) -> List[int]:
    """The mesh sizes to run: SIZES up to `--devices` and the devices there
    are (the GPUs; with `--cpu`, `--devices` processes)."""
    n_avail = args.devices if args.cpu else torch.cuda.device_count()
    return [n for n in SIZES if n <= min(args.devices, n_avail)]


def pairs_per_positive(args) -> int:
    return 2 * args.k if args.sampler == "shared" else 2 * args.negatives


def make_batch(args, n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Size n's global batch and mask: the JAX script's draws, one batch a
    size in order from default_rng(0)."""
    rng = np.random.default_rng(0)
    for m in SIZES:
        b = args.per_device_batch * m
        batch = np.stack([rng.integers(0, args.entities, b),
                          rng.integers(0, args.entities, b),
                          rng.integers(0, args.relations, b)], axis=1).astype(np.int32)
        if m == n:
            break
    return (torch.as_tensor(batch, dtype=torch.int64, device=device),
            torch.ones(b, dtype=torch.float32, device=device))


def step_seconds(args, n: int, mesh: Mesh) -> float:
    """One world's worker, called on every rank of `mesh`: size n's batch
    through `--impl`'s pairwise step, its seconds a step over `--steps`
    steps after one untimed step."""
    model = MODELS[args.model](args.entities, args.relations, args.ncomp)
    opt = AdaGrad(lr=0.1)
    if args.sampler == "shared":
        sampler = SharedNegativeSampler(args.entities, k=args.k)
    else:
        sampler = RandomModeSampler(args.entities, modes=(0, 1) * args.negatives)
    if args.impl == "shardmap":
        make_step, place = make_shardmap_pairwise_step, shard_state_shardmap
    else:
        make_step, place = make_sharded_pairwise_step, shard_state
    step = make_step(model, opt, sampler, 1.0, mesh)
    batch, mask = make_batch(args, n, mesh.device)
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    state = place(init_state(model, opt, gen), model, mesh)
    state, m = step(state, batch, mask)  # allocations, the collectives' setup
    float(m.loss)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, m = step(state, batch, mask)
    float(m.loss)
    return (time.perf_counter() - t0) / args.steps


def _worker(args) -> int:
    torch.set_num_threads(WORKER_THREADS)
    mesh = make_mesh((1, 1) if args.unsharded else None,
                     device="cpu" if args.cpu else None)
    try:
        dt = step_seconds(args, args.world, mesh)
        if mesh.rank == 0:
            print(json.dumps({"step_s": dt}), flush=True)
    finally:
        distributed.destroy()
    return 0


def run_world(argv: List[str], n: int, unsharded: bool = False) -> float:
    """Size n's step seconds, from a world of n processes (one with
    `unsharded`) of this module on `argv`."""
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    cmd = [sys.executable, "-m", "skge_torch.scaling_bench", *argv, "--world", str(n)]
    procs = distributed.launch_local(cmd + (["--unsharded"] if unsharded else []),
                                     1 if unsharded else n, WORLD_TIMEOUT_S, env=env)
    for rank, (rc, _, err) in enumerate(procs):
        if rc != 0:
            raise RuntimeError(f"scaling_bench: rank {rank} of the world of size {n}"
                               f"{' (unsharded)' if unsharded else ''} exited with "
                               f"{rc}:\n{err[-3000:]}")
    return float(json.loads(procs[0][1].strip().splitlines()[-1])["step_s"])


def summarize(args, seconds: List[Tuple[int, float, Optional[float]]]):
    """(records, summary, exit code) from [(N, sharded step s, unsharded
    step s or None)] in order of N: the JAX script's arithmetic."""
    pairs = pairs_per_positive(args)
    t1 = None
    results = []
    for n, dt, dt1 in seconds:
        b = args.per_device_batch * n
        rec = {
            "devices": n,
            "total_batch": b,
            "step_ms": round(dt * 1e3, 2),
            "scored_triples_per_s": round(2 * pairs * b / dt, 1),
        }
        if args.cpu:
            rec["spmd_overhead"] = round(dt / dt1, 4)
        else:
            t1 = dt if t1 is None else t1
            rec["efficiency"] = round(t1 / dt, 4)
        results.append(rec)
    if args.cpu:
        worst = max(r["spmd_overhead"] for r in results)
        gate = args.max_overhead
        if gate is None:
            gate = GATES[args.impl]
        ok = worst <= gate
        summary = {
            "metric": "spmd_overhead_vs_unsharded",
            "impl": args.impl,
            "backend": "gloo",
            "target": gate,
            "worst": worst,
            "pass": ok,
            "note": f"N gloo processes of {WORKER_THREADS} thread(s) each share this "
            "host's cores, the unsharded step one process: efficiency is not "
            "measurable here; run on N GPUs for weak-scaling efficiency",
        }
    else:
        worst = min((r["efficiency"] for r in results[1:]), default=1.0)
        ok = worst >= EFFICIENCY_TARGET
        summary = {
            "metric": "weak_scaling_efficiency",
            "impl": args.impl,
            "backend": "cuda",
            "target": EFFICIENCY_TARGET,
            "worst": worst,
            "pass": ok,
            "note": "one process a GPU over NCCL; with one GPU only N=1 runs, whose "
            "efficiency is 1.0 by definition",
        }
    return results, summary, 0 if ok else 1


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if args.world is not None:
        return _worker(args)
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: scaling_bench runs one process a GPU "
                           "over NCCL; pass --cpu for gloo processes")
    seconds = []
    for n in sizes(args):
        dt = run_world(argv, n)
        seconds.append((n, dt, run_world(argv, n, unsharded=True) if args.cpu else None))
    records, summary, code = summarize(args, seconds)
    for rec in records + [summary]:
        print(json.dumps(rec), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
