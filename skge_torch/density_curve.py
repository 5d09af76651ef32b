"""Learnability against train density for each latent-KG geometry,
`scripts/density_curve.py`'s counterpart, `python -m
skge_torch.density_curve`.

Filtered test MRR as a function of train triples per entity, for each
geometry's MATCHED family and a translational CONTRAST model, under the
quality suite's CE protocol (reciprocal relations, object-direction full
CE with label smoothing 0.1, Adam 1e-3). Each point is one in-process
`skge_torch.quality_suite.main(argv)` call with the JAX script's argv;
its rows come back as JSON lines (with the point's `kg`, `density`,
`ntrain`, `role` and `point_s`), appended to `--out`, and the curve ends
with one markdown table a geometry.

Defaults: 10,000 entities, densities {2, 3.45, 5, 8, 12}. The JAX script
appends to /tmp/density_curve.jsonl by default; the port to
build/density_curve.jsonl in the repository.

Usage:
    python -m skge_torch.density_curve [--out curve.jsonl]
    python -m skge_torch.density_curve --cpu --entities 300 --densities 2,8 \\
        --epochs 4 --eval-every 2     # smoke

Without `--cpu` it runs on the GPU and exits when there is none.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time
from pathlib import Path
from typing import List

from skge_torch import quality_suite

# geometry -> (latent_dim, matched model, contrast model): translational 32,
# bilinear 8 (rank-4 relations), rotational 16
GEOMETRIES = {
    "translational": (32, "TransE-L2", "ComplEx"),
    "bilinear": (8, "RESCAL", "TransE-L2"),
    "rotational": (16, "RotatE", "TransE-L2"),
}

OUT = Path(__file__).resolve().parents[1] / "build" / "density_curve.jsonl"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--entities", type=int, default=10000)
    ap.add_argument("--relations", type=int, default=18)
    ap.add_argument("--densities", default="2,3.45,5,8,12")
    ap.add_argument("--geometries", default="translational,bilinear,rotational")
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--eval-every", type=int, default=15)
    ap.add_argument("--patience", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU, which must exist)")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    for kg in args.geometries.split(","):
        if kg not in GEOMETRIES:
            ap.error(f"unknown geometry {kg!r}; choices: "
                     f"{', '.join(sorted(GEOMETRIES))}")
    return args


def point_argv(args, kg: str, ntrain: int) -> List[str]:
    """The quality suite's argv for one (geometry, density) point."""
    latent, matched, contrast = GEOMETRIES[kg]
    qs_argv = [
        "--kg", kg, "--entities", str(args.entities),
        "--relations", str(args.relations),
        "--ntrain", str(ntrain), "--latent-dim", str(latent),
        "--dim", str(args.dim), "--loss", "ce",
        "--epochs", str(args.epochs),
        "--eval-every", str(args.eval_every),
        "--patience", str(args.patience),
        "--models", f"{matched},{contrast}",
    ]
    if args.cpu:
        qs_argv.append("--cpu")
    return qs_argv


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    densities = [float(d) for d in args.densities.split(",")]
    geometries = args.geometries.split(",")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    rows = []
    for kg in geometries:
        matched = GEOMETRIES[kg][1]
        for dens in densities:
            ntrain = int(round(dens * args.entities))
            t0 = time.perf_counter()
            buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(buf):
                    point = quality_suite.main(point_argv(args, kg, ntrain))
            except SystemExit as e:
                print(buf.getvalue()[-2000:], file=sys.stderr)
                raise SystemExit(f"point failed: {kg} density={dens}: {e}") from e
            for r in point:
                r.update({
                    "kg": kg, "density": dens, "ntrain": ntrain,
                    "role": "matched" if r["model"] == matched else "contrast",
                    "point_s": round(time.perf_counter() - t0, 1),
                })
                rows.append(r)
                print(json.dumps(r), flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(r) + "\n")

    # markdown summary: one table per geometry, densities as rows
    for kg in geometries:
        latent, matched, contrast = GEOMETRIES[kg]
        print(f"\n**{kg}** (latent {latent}, d={args.dim}, CE protocol):\n")
        print(f"| triples/entity | {matched} MRR (best@) | "
              f"{contrast} MRR (best@) |")
        print("|---|---|---|")
        for dens in densities:
            cells = []
            for name in (matched, contrast):
                hit = [r for r in rows
                       if r["kg"] == kg and r["density"] == dens
                       and r["model"] == name]
                cells.append(
                    f"{hit[0]['mrr']:.4f} ({hit[0]['epochs']})"
                    if hit else "—"
                )
            print(f"| {dens} | {cells[0]} | {cells[1]} |")
    return rows


if __name__ == "__main__":
    main()
