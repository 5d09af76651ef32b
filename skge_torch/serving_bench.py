"""Serving throughput of the port: filtered top-K link-prediction queries
a second, `scripts/serving_bench.py`'s counterpart, `python -m
skge_torch.serving_bench`.

FB15k-shaped table by default (14,951 entities, d=150). Measures the
steady-state batched path of `serving.LinkPredictor` -- one pool sweep and
a top-k per query batch -- after a warm-up pass over the same stream, host
to host (query ids in, entity ids out), the filter pairs' host lookup
included. The params are the model's random init from seed 0; the known
triples (the filter) and the (s, p) query stream are drawn from
`numpy.random.default_rng(0)`, in the JAX script's order
(`query_stream`).

Usage:
    python -m skge_torch.serving_bench [--model transe] [--k 10]
    python -m skge_torch.serving_bench --quantize int8 --recall
    python -m skge_torch.serving_bench --cpu --entities 500 --relations 8 \\
        --nqueries 300 --nknown 2000 --ncomp 16 --batch 64

Without `--cpu` it runs on the GPU and exits when there is none.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Tuple

import numpy as np
import torch

from skge_torch.models import MODELS
from skge_torch.serving import LinkPredictor, TopKResult


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU, which must exist)")
    ap.add_argument("--model", default="transe")
    ap.add_argument("--l2", action="store_true",
                    help="[transe] L2 distance instead of L1")
    ap.add_argument("--ncomp", type=int, default=150)
    ap.add_argument("--entities", type=int, default=14951)
    ap.add_argument("--relations", type=int, default=1345)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--nqueries", type=int, default=59071)  # FB15k test size
    ap.add_argument("--nknown", type=int, default=483142)
    ap.add_argument("--bf16", action="store_true",
                    help="compute_dtype='bfloat16' for the sweep matmuls "
                    "(params stay fp32; the top-K set is not exact at bf16 -- "
                    "measure the recall trade)")
    ap.add_argument("--quantize", default="", choices=["", "int8", "fp8", "bfloat16"],
                    help="entity-table quantization: 'int8' (4x less memory "
                    "and upload), 'fp8' (the same 4x, e4m3 rounding), "
                    "'bfloat16' (2x); approximate scores, pair with --recall")
    ap.add_argument("--recall", action="store_true",
                    help="also run the exact engine and report the mean top-k "
                    "overlap of the quantized results with it")
    return ap.parse_args(argv)


def run_device(args) -> torch.device:
    """The GPU unless --cpu; never a quiet fallback to the CPU."""
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device; skge_torch.serving_bench runs on "
                         "the GPU, pass --cpu to run on the CPU")
    return torch.device("cpu" if args.cpu else "cuda")


def query_stream(n_entities: int, n_relations: int, nknown: int,
                 nqueries: int) -> Tuple[np.ndarray, np.ndarray]:
    """(known (nknown, 3) int32 random triples, queries (nqueries, 2) int32
    (s, p) pairs), drawn from `default_rng(0)` in that order."""
    rng = np.random.default_rng(0)
    known = np.stack([rng.integers(0, n_entities, nknown),
                      rng.integers(0, n_entities, nknown),
                      rng.integers(0, n_relations, nknown)], axis=1).astype(np.int32)
    queries = np.stack([rng.integers(0, n_entities, nqueries),
                        rng.integers(0, n_relations, nqueries)],
                       axis=1).astype(np.int32)
    return known, queries


def make_model(args):
    kw = {"l1": not args.l2} if args.model == "transe" else {}
    if args.bf16:
        kw["compute_dtype"] = "bfloat16"
    return MODELS[args.model](args.entities, args.relations, args.ncomp, **kw)


def timed_top_k(pred: LinkPredictor, queries: np.ndarray, k: int,
                device: torch.device) -> Tuple[TopKResult, float]:
    """The stream's top k objects after a warm-up pass over it; returns
    (result, seconds host to host)."""
    pred.top_k(queries, k, direction="o")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    res = pred.top_k(queries, k, direction="o")
    return res, time.perf_counter() - t0


def metric_name(args) -> str:
    return f"{args.model}{'_l2' if args.l2 else ''}_filtered_top{args.k}_queries_per_s"


def main(argv=None, params: Optional[dict] = None):
    """Prints the JSON line and returns (line, result). `params` replaces
    the model's random init (tests carry another package's params in)."""
    args = parse_args(argv)
    device = run_device(args)
    model = make_model(args)
    if params is None:
        params = model.init_params(torch.Generator().manual_seed(0))
    known, queries = query_stream(args.entities, args.relations, args.nknown,
                                  args.nqueries)
    pred = LinkPredictor(model, params, known=known, batch_size=args.batch,
                         quantize=args.quantize, device=device)
    res, dt = timed_top_k(pred, queries, args.k, device)
    assert res.entities.shape == (args.nqueries, args.k)
    rec = {
        "metric": metric_name(args),
        "value": round(args.nqueries / dt, 1),
        "unit": "queries/s",
        "batch": args.batch,
        "entities": args.entities,
    }
    if args.quantize:
        rec["quantize"] = args.quantize
    if args.recall and args.quantize:
        exact = LinkPredictor(model, params, known=known, batch_size=args.batch,
                              device=device).top_k(queries, args.k, direction="o")
        rec["recall_vs_exact"] = round(float(np.mean([
            len(set(a) & set(b)) / args.k
            for a, b in zip(exact.entities, res.entities)])), 4)
    print(json.dumps(rec))
    return rec, res


if __name__ == "__main__":
    main()
