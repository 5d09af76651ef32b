"""The rotate_probe oracle's ranking, by where its KG is built and where
and at what precision it is ranked: `python -m skge_torch.oracle_precision`.

`rotate_probe --variants oracle --epochs 0` ranks the test triples of the
rotational latent KG with the generator's own latents (`oracle_params`).
This tool builds that KG (`rotate_probe.load_kg`, the port's cache) on the
card and on the CPU, prints how many triples of each split lie in one of
them only, then ranks each KG's test split with the oracle's parameters:
on the CPU in fp32 and with bf16 scoring inputs, on the card in fp32,
with TF32 matmuls and with bf16 scoring inputs (`KGEModel.compute_dtype`).
It takes rotate_probe's flags (WN18's shape by default) and prints one
JSON line a split and a ranking.

Usage:
    python -m skge_torch.oracle_precision            # rotate_probe's defaults
    python -m skge_torch.oracle_precision --cpu --entities 300 --ntrain 3000

Without `--cpu` it runs on the GPU and raises when there is none; with it,
the CPU's KG and rankings alone.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List

import torch

from skge_torch import rotate_probe
from skge_torch.evaluation import FilteredRankingEval
from skge_torch.models import RotatE
from skge_torch.utils.device import resolve_device

PRECISIONS = {"cpu": ("float32", "bfloat16"), "cuda": ("float32", "tf32", "bfloat16")}


def rank(args, ds, device: torch.device, precision: str) -> dict:
    """The oracle's filtered test ranking of `ds` on `device` at `precision`."""
    model = RotatE(ds.n_entities, ds.n_relations, args.ncomp)
    if precision == "bfloat16":
        model = dataclasses.replace(model, compute_dtype="bfloat16")
    params = {k: torch.as_tensor(v, device=device) for k, v in rotate_probe.oracle_params(
        args.entities, args.relations, args.latent_dim, args.ncomp).items()}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        r = FilteredRankingEval(model, ds.test, ds.all_triples(), batch_size=1024)(params)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"rank_on": device.type, "precision": precision,
            "mrr": round(float(r.mrr), 4), "hits1": round(float(r.hits[1]), 4),
            "hits10": round(float(r.hits[10]), 4), "mr": round(float(r.mean_rank), 3)}


def main(argv=None) -> List[dict]:
    args = rotate_probe.parse_args(argv)
    card = resolve_device("cpu" if args.cpu else "cuda", verb="probes")
    devices = [card] + ([torch.device("cpu")] if card.type != "cpu" else [])
    kgs = {d.type: rotate_probe.load_kg(args, d) for d in devices}
    rows = []
    if len(kgs) == 2:
        for split in ("train", "valid", "test"):
            a, b = ({tuple(t) for t in getattr(kgs[d], split).tolist()} for d in ("cpu", "cuda"))
            rows.append({"split": split, "cpu": len(a), "cuda": len(b),
                         "in_one_only": len(a ^ b)})
            print(json.dumps(rows[-1]), flush=True)
    for kg, ds in kgs.items():
        for d in devices:
            for precision in PRECISIONS[d.type]:
                rows.append({"kg": kg, **rank(args, ds, d, precision)})
                print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
