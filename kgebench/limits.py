"""The readings the limits of `correct` are set from, for one cell:

    python3 -m kgebench.limits --workload <cell> --seeds 1 2 3 ... [--seconds 2]

For each seed, in one process, it sets the cell up as a run does
(a serving cell also serves a short window) and prints one JSON line:

- `program`: the program's numbers against the reference;
- `control`: the reference computed in the cell's `control` precision
  (the one just below the configuration's), put in the program's place;
- `half_batch` (training): the reference with the second half of every
  batch left out, put in the program's place;
- `altered` (serving): the program's answers with one entity of the
  first sampled query replaced by the lowest-scored entity.

A state left unchanged reads 1 on `change_gap` by its definition and
needs no run. The limits themselves are in the cell's file.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from kgebench import check, gen, reference, registry


def train_readings(sess, control: str) -> dict:
    spec, dev = sess.spec, sess.device
    cfg, traffic, model = spec.config, spec.traffic, spec.model

    def steps(prec, half=False):
        return reference.train_steps(model, cfg, traffic, sess.p0, sess.xs,
                                     gen.draw_generator(sess.seed, dev), 3,
                                     reference.PRECISIONS[prec], half_batch=half)

    ref = steps("fp64")
    return {
        "program": check.train_numbers(sess.recorder.record(), ref, sess.p0),
        "control": check.train_numbers(steps(control), ref, sess.p0),
        "half_batch": check.train_numbers(steps("fp64", half=True), ref, sess.p0),
    }


def serve_readings(sess, control: str) -> dict:
    q, ids, scores = sess.sample()
    full, top = sess.reference_top(q, "fp64")
    n_e, k = sess.spec.config["entities"], sess.spec.traffic["top_k"]
    _, ctop = sess.reference_top(q, control)
    altered = ids.copy()
    altered[0, -1] = int(torch.argmin(full[0]))
    return {
        "program": check.serve_numbers(ids, scores, top.values, full, n_e, k),
        "control": check.serve_numbers(ctop.indices.cpu().numpy(),
                                       ctop.values.double().cpu().numpy(),
                                       top.values, full, n_e, k),
        "altered": check.serve_numbers(altered, scores, top.values, full, n_e, k),
    }


def main(argv=None, root=registry.ROOT) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m kgebench.limits")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    spec = registry.spec(registry.load_json(registry.BENCHMARK), args.workload, root)
    device = torch.device("cpu" if args.cpu else "cuda")
    torch.backends.cuda.matmul.allow_tf32 = bool(spec.config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(spec.config["tf32"])
    driver = importlib.import_module(f"kgebench.drivers.{spec.kind}")
    for seed in args.seeds:
        t0 = time.perf_counter()
        sess = driver.Session(spec, seed, device)
        if spec.kind == "serve":
            sess.window(args.seconds)
        sess.release()
        reads = (train_readings if spec.kind == "train" else serve_readings)(
            sess, spec.cell["control"])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **reads}), flush=True)
        del sess
    return 0


if __name__ == "__main__":
    sys.exit(main())
