"""One run of one benchmark cell of the PyTorch and CUDA port (`skge_torch`):

    python3 -m kgebench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for (`BENCHMARK.json`). Set-up makes the cell's inputs from the seed and
warms up its shapes; the window measures for `--seconds`; then the
window's output is held to the plain reference (`check.py`). With
`--trace 1`, a fixed span of the same work after the window runs under
`torch.profiler`, and the run reports the cell's per-layer metrics
instead of its end-to-end ones.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` `breakdown`,
and last `checks`, each compared number beside its limit; the last lines
of standard error repeat the checks. Exits 3 without enough CUDA
devices and 4 when JAX, its libraries or the JAX package were imported,
printing no result in either case.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from kgebench import check, profiling, registry  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "skge_tpu", "skge")


def forbidden_modules() -> list:
    """The forbidden top-level names among the imported modules."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m kgebench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _number(x):
    return x if isinstance(x, int) or math.isfinite(x) else repr(x)


def _log_times(sess, **seconds) -> None:
    """One line of where the run's time went, on standard error."""
    parts = {**seconds, **sess.phases}
    print("times: " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items()), file=sys.stderr)
    if getattr(sess, "epoch_s", None):
        e = sorted(sess.epoch_s)
        print(f"window epochs {len(e)}: {e[0]:.4f} / {e[len(e) // 2]:.4f} / {e[-1]:.4f} s "
              "(min / median / max)", file=sys.stderr)


def run_cell(spec: registry.Spec, seed: int, seconds: float, trace: bool, device,
             t0: float) -> dict:
    """Set up, measure, check; returns the result record. `t0` is the
    host clock at the process's start."""
    tf32 = bool(spec.config["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t_imports = time.perf_counter() - t0
    driver = importlib.import_module(f"kgebench.drivers.{spec.kind}")
    sess = driver.Session(spec, seed, device)
    setup_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    win = sess.window(seconds)
    t2 = time.perf_counter()
    span = sess.traced() if trace else None
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    sess.release()
    t3 = time.perf_counter()
    numbers = sess.check()
    _log_times(sess, setup=setup_s, imports=t_imports, window=t2 - t1,
               traced_span=t3 - t2, check=time.perf_counter() - t3)
    limits = spec.cell["limits"]
    card = torch.cuda.get_device_name(device) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": card, "count": spec.chips,
           "memory_peak_bytes": peak}
    if trace:
        span.card = card
        span.window = sess.window_figures()
        metrics = {}
        for entry, reader in spec.per_layer:
            value = reader.read(span)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
        dev.update(busy_s=span.busy_s, window_s=span.window_s)
        if cuda:
            dev["power_limit_w"] = profiling.power_limit_w()
        print(f"traced span: {len(span.kernels)} device operations, {len(span.k1_calls)} K1 "
              "calls", file=sys.stderr)
    else:
        measured = dict(win["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": measured[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end}
    result = {"correct": check.judge(numbers, limits), "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": span.device_ops, "idle_gaps": span.idle_gaps}
    result["checks"] = {k: {"value": _number(numbers[k]), "limit": lim}
                        for k, lim in limits.items() if k in numbers}
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    spec = registry.spec(registry.load_json(registry.BENCHMARK), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"error: {args.workload} needs {spec.chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda"), T0)
    found = forbidden_modules()
    if found:
        print(f"error: imported {', '.join(found)}; the benchmark runs the port alone",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
