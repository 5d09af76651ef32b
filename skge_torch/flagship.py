"""The 10^7-entity out-of-core flagship of the port on one GPU:
`scripts/flagship_10m.py`'s counterpart, `python -m skge_torch.flagship`.

Composes the out-of-core pieces at the JAX system's headline scale, with
wall-clock seconds per phase, each phase printing its JSON line as it
finishes:

1. BUILD  -- `data.latent_kg` at 11,390,625 entities ('lattice' geometry,
   density 4: the closed-form nearest-neighbour assignment, O(total) host
   work; `--kind translational` runs the exact argmax sweep on the device,
   feasible to ~1-2M entities). Cached in `CACHE_DIR` under a name of the
   port's own that carries the device type, written whole under a
   temporary name and renamed.
2. INIT   -- `OutOfCoreTrainer(loss='sampled_ce')` on the reciprocal
   train triples: the entity partition (the native partitioner; a run
   above 2M entities without it raises), the relabeling, the pinned host
   entity table and its Adam slots, the bucket stack in pinned host memory
   (`host_buckets`) above 2M entities.
3. TRAIN  -- object-direction sampled softmax over a k-entity pool drawn
   from the resident parts, lazy Adam, `--cache-parts` parts on the device.
4. EVAL   -- the streamed filtered ranking of `--eval-n` held-out triples
   (candidates one part at a time, head queries through the inverse
   relations).
5. CKPT   -- the sharded per-part checkpoint saved and restored.

The report carries the JAX script's keys and work unit (`scored_per_s` =
epochs x reciprocal train triples x (k + 1) / train seconds) and the
card's own: the partitioner's backend, the share of bucket padding, per
epoch the parts uploaded, the bytes moved each way and the segment-sum
kernel's launches, peak device memory, the host's peak RSS, whether the
restored tables equal the saved ones bit for bit, and (on the card) the
busy and idle share of one profiled bucket epoch, run after the
checkpoint so it changes no reported number.

Usage:
    python -m skge_torch.flagship                      # the full run
    python -m skge_torch.flagship --cpu --entities 729 --latent-dim 6 \\
        --relations 4 --ntrain 2916 --nheld 40 --dim 16 --parts 2 --k 64 \\
        --epochs 1 --nbatches 4 --eval-n 32            # seconds

Without `--cpu` it runs on the GPU and exits when there is none. The full
run holds ~25 GB of host memory (the 9 GB pinned table and its slots, the
91 M reciprocal triples in their copies, the bucket stack) and writes
~9.6 GB to disk (the KG cache and the checkpoint).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import resource
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from skge_torch.data import Dataset, add_reciprocal_relations, cached_dataset, latent_kg
from skge_torch.models import DistMult, TransE
from skge_torch.native import native_available
from skge_torch.ops import cuda_segment
from skge_torch.optim import Adam
from skge_torch.outofcore import OutOfCoreTrainer

ROOT = Path(__file__).resolve().parents[1]
# where the KG is cached; tests point it at a temporary directory
CACHE_DIR = ROOT / "build" / "flagship"
# above this entity count the bucket stack stays in host memory and the
# Python partitioner (hours at 91 M triples) is refused
HOST_BUCKETS_ABOVE = 2_000_000


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    # 15^6 = 11,390,625 entities (the 'lattice' geometry needs a perfect
    # power), density 4 triples an entity
    ap.add_argument("--entities", type=int, default=11_390_625)
    ap.add_argument("--relations", type=int, default=64)
    ap.add_argument("--ntrain", type=int, default=45_562_500)
    ap.add_argument("--nheld", type=int, default=5000)
    ap.add_argument("--kind", default="lattice",
                    help="latent_kg geometry; 'lattice' builds in O(total) "
                    "host work, 'translational' runs the exact blocked "
                    "device sweep (feasible to ~1-2M entities)")
    ap.add_argument("--latent-dim", type=int, default=6)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--cache-parts", type=int, default=3,
                    help=">2 gives prefetch a free slot")
    ap.add_argument("--k", type=int, default=8192)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--nbatches", type=int, default=400,
                    help="minibatches per bucket epoch")
    ap.add_argument("--eval-batch", type=int, default=512)
    ap.add_argument("--eval-n", type=int, default=1000,
                    help="held-out queries to rank (streamed eval cost is "
                    "queries x n_entities x d)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--model", default="transe-l2",
                    choices=["transe-l2", "distmult"],
                    help="TransE-L2 is the JAX system's measured sampled-CE "
                    "leader on translational KGs")
    ap.add_argument("--ckpt", default=str(ROOT / "build" / "flagship" / "ckpt"),
                    help="the sharded checkpoint's directory")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU, which must exist)")
    ap.add_argument("--out", default=None, help="append the report to this file")
    return ap.parse_args(argv)


def run_device(args) -> torch.device:
    """The GPU unless --cpu; never a quiet fallback to the CPU."""
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device; skge_torch.flagship runs on the "
                         "GPU, pass --cpu to run on the CPU")
    return torch.device("cpu" if args.cpu else "cuda")


def cache_path(args, device: torch.device) -> Path:
    key = (f"{args.kind}-e{args.entities}-r{args.relations}-t{args.ntrain}"
           f"-h{args.nheld}-l{args.latent_dim}-s0")
    return Path(CACHE_DIR) / f"latent_kg_torch-{device.type}-{key}.npz"


def load_kg(args, device: torch.device):
    """(dataset, seconds or {"cached": seconds}): the KG read from the
    port's cache, or built and cached (`data.cached_dataset`)."""
    t0 = time.perf_counter()
    ds, cached = cached_dataset(
        cache_path(args, device), args.entities, args.relations,
        lambda: latent_kg(n_entities=args.entities, n_relations=args.relations,
                          n_train=args.ntrain, n_valid=args.nheld, n_test=args.nheld,
                          latent_dim=args.latent_dim, seed=0, kind=args.kind,
                          device=device))
    seconds = round(time.perf_counter() - t0, 1)
    return ds, {"cached": seconds} if cached else seconds


def make_trainer(args, aug: Dataset, device: torch.device, dtype: str = "float32",
                 host_buckets: Optional[bool] = None) -> OutOfCoreTrainer:
    """The flagship's trainer on the reciprocal dataset `aug`, as the JAX
    script builds it (`dtype` for the tests' fp64; `host_buckets` replaces
    the entity-count rule)."""
    if host_buckets is None:
        host_buckets = args.entities > HOST_BUCKETS_ABOVE
    if args.model == "transe-l2":
        model = TransE(aug.n_entities, aug.n_relations, args.dim, l1=False,
                       dtype=dtype)
    else:
        model = DistMult(aug.n_entities, aug.n_relations, args.dim, dtype=dtype)
    return OutOfCoreTrainer(
        model, Adam(lr=args.lr), aug.train, n_parts=args.parts, k=args.k,
        nbatches=args.nbatches, seed=0, loss="sampled_ce", label_smoothing=0.1,
        ce_directions=("o",), host_buckets=host_buckets,
        cache_parts=min(args.cache_parts, args.parts), device=device,
    )


def padding_share(tr: OutOfCoreTrainer) -> float:
    """The share of the bucket rows an epoch steps over that are padding."""
    real = sum(len(rows) for rows in tr.buckets.values())
    return 1.0 - real / (len(tr.buckets) * tr.bucket_len)


def steps_per_epoch(tr: OutOfCoreTrainer) -> int:
    return len(tr.buckets) * max(1, min(tr.nbatches, tr.bucket_len))


def state_digest(tr: OutOfCoreTrainer) -> str:
    """A hash of every table of the trainer's state, bit for bit."""
    tr.flush()
    h = hashlib.blake2b(digest_size=16)
    tables = [tr.e_host[k] for k in sorted(tr.e_host)]
    tables += [tr.dev_params[k] for k in sorted(tr.dev_params)]
    tables += [tr.dev_opt[k][s] for k in sorted(tr.dev_opt) for s in sorted(tr.dev_opt[k])]
    for t in tables:
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_bucket(tr: OutOfCoreTrainer) -> dict:
    """One bucket epoch timed on the host clock, then again under
    `torch.profiler`: the card's busy time a step, its idle share and the
    operators' shares of the busy time (the 8 largest). The second bucket
    of the chained order (an off-diagonal one when P > 1)."""
    dev = tr.device
    pi, pj = tr._bucket_order()[min(1, len(tr.buckets) - 1)]
    nb = max(1, min(tr.nbatches, tr.bucket_len))
    _sync(dev)
    t0 = time.perf_counter()
    tr._bucket_epoch(pi, pj)
    _sync(dev)
    host_ms = 1e3 * (time.perf_counter() - t0) / nb
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        tr._bucket_epoch(pi, pj)
        _sync(dev)
    busy = sum(e.device_time for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / nb / 1e3
    if busy <= 0:
        raise RuntimeError("the profiler saw no kernel of the bucket epoch")
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in ops)
    tr.flush()
    return {"bucket": [pi, pj], "steps": nb, "step_ms": round(host_ms, 4),
            "busy_ms": round(busy, 4), "idle_share": round(1.0 - busy / host_ms, 4),
            "top_ops": {e.key: round(e.self_device_time_total / total, 4) for e in ops[:8]}}


def run(args, device: Optional[torch.device] = None):
    """The five phases; returns (report, trainer)."""
    device = run_device(args) if device is None else device
    report = {"config": {
        "entities": args.entities, "relations": args.relations,
        "ntrain": args.ntrain, "dim": args.dim, "parts": args.parts,
        "k": args.k, "epochs": args.epochs,
    }}

    # ---- phase 1: build -------------------------------------------------
    ds, report["build_s"] = load_kg(args, device)
    print(json.dumps({"phase": "build", **report}), flush=True)

    # ---- phase 2: trainer init (partition + relabel + host tables) ------
    t0 = time.perf_counter()
    partitioner = "native" if native_available() else "python"
    if args.entities > HOST_BUCKETS_ABOVE and partitioner != "native":
        raise RuntimeError(
            f"{args.entities} entities need the native partitioner (g++ could "
            "not build native/src/partitioner.cpp); the Python one takes hours")
    aug = add_reciprocal_relations(ds)
    tr = make_trainer(args, aug, device)
    report["config"]["model"] = args.model
    host_bytes = sum(v.nbytes for v in tr.e_host.values())
    report["init_s"] = round(time.perf_counter() - t0, 1)
    report["host_table_gb"] = round(host_bytes / 1e9, 2)
    report["device_rows_resident"] = min(args.cache_parts, args.parts) * tr.part_size
    report["buckets"] = len(tr.buckets)
    report["partitioner"] = partitioner
    report["bucket_len"] = tr.bucket_len
    report["padding_share"] = round(padding_share(tr), 4)
    print(json.dumps({"phase": "init", "init_s": report["init_s"],
                      "host_table_gb": report["host_table_gb"],
                      "part_size": tr.part_size, "buckets": report["buckets"],
                      "partitioner": partitioner, "bucket_len": tr.bucket_len,
                      "padding_share": report["padding_share"]}), flush=True)

    # ---- phase 3: train --------------------------------------------------
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    epochs = []
    t0 = time.perf_counter()
    for e in range(args.epochs):
        before = (tr.uploads, tr.bytes_uploaded, tr.bytes_downloaded,
                  cuda_segment.launches)
        te = time.perf_counter()
        tr.fit(epochs=1)
        _sync(device)
        m = tr.metrics[-1]
        line = {"phase": "train", "epoch": e, "loss": round(m["loss"], 2),
                "epoch_s": round(time.perf_counter() - te, 1), "uploads": tr.uploads,
                "epoch_uploads": tr.uploads - before[0],
                "gb_uploaded": round((tr.bytes_uploaded - before[1]) / 1e9, 3),
                "gb_downloaded": round((tr.bytes_downloaded - before[2]) / 1e9, 3),
                "steps": steps_per_epoch(tr),
                "k1_launches": cuda_segment.launches - before[3]}
        epochs.append(line)
        print(json.dumps(line), flush=True)
    train_s = time.perf_counter() - t0
    report["train_s"] = round(train_s, 1)
    # work units: (k+1) candidate scorings per positive per direction
    report["scored_per_s"] = round(args.epochs * len(aug.train) * (args.k + 1) / train_s)
    report["losses"] = [line["loss"] for line in epochs]
    report["k1_launches"] = [line["k1_launches"] for line in epochs]
    report["steps_per_epoch"] = steps_per_epoch(tr)
    if device.type == "cuda":
        report["peak_device_gb"] = round(torch.cuda.max_memory_allocated(device) / 1e9, 3)

    # ---- phase 4: streamed eval ------------------------------------------
    t0 = time.perf_counter()
    res = tr.evaluate(ds.test[: args.eval_n], aug.all_triples(),
                      batch_size=args.eval_batch, reciprocal=True)
    report["eval_s"] = round(time.perf_counter() - t0, 1)
    report["mrr"] = round(res.mrr, 5)
    report["hits10"] = round(res.hits[10], 4)
    report["mr"] = round(res.mean_rank, 1)
    # E[1/rank] under uniform ranks ~ ln(n)/n
    report["random_mrr"] = round(float(np.log(args.entities) / args.entities), 9)
    print(json.dumps({"phase": "eval", "eval_s": report["eval_s"], "mrr": report["mrr"],
                      "hits10": report["hits10"], "mr": report["mr"]}), flush=True)

    # ---- phase 5: sharded checkpoint --------------------------------------
    saved = state_digest(tr)
    t0 = time.perf_counter()
    tr.save(args.ckpt)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr.restore(args.ckpt)
    report["ckpt_save_s"] = round(save_s, 1)
    report["ckpt_restore_s"] = round(time.perf_counter() - t0, 1)
    report["ckpt_gb"] = round(sum(
        os.path.getsize(os.path.join(args.ckpt, f)) for f in os.listdir(args.ckpt)
    ) / 1e9, 2)
    report["ckpt_bit_equal"] = state_digest(tr) == saved

    if device.type == "cuda":
        report["profile"] = profile_bucket(tr)
    # ru_maxrss is in KiB on Linux
    report["peak_host_rss_gb"] = round(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9, 2)
    return report, tr


def main(argv=None) -> dict:
    args = parse_args(argv)
    report, _ = run(args)
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(report) + "\n")
    return report


if __name__ == "__main__":
    main()
