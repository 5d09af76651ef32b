"""The port's training-throughput bench (skge_torch/bench.py) against the
root bench.py, on the CPU at tiny sizes, under a fixed clock (0 s, then
1 s, for each row's timed epochs), so that `value` is each row's work
units exactly:

- every ALL_ROWS row, and the iid sampler with `dense_pallas`: the metric
  name, the unit, `config`, and the work units counted independently;
- six rows through the JAX package's `bench.run` under the same clock:
  equal lines;
- the same argument errors, and the GPU by default;
- each row's gradient scatters a step (`segment_sum`, `segment_outer_sum`,
  the 16-byte path's widths) as `chip_smoke.py` phase 16 expects them on
  the card.
"""

import contextlib
import io
import itertools
import json
import os
import sys

import pytest
import torch

import skge_torch.ops.aggregate as aggregate
from skge_torch import bench
from skge_torch.data import synthetic_kg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench as jbench  # noqa: E402
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

TINY = ["--cpu", "--entities", "40", "--relations", "3", "--ntrain", "60",
        "--nbatches", "2", "--epochs", "2"]
N_TRAIN = synthetic_kg(40, 3, 60, seed=0, clustered=False).train.shape[0]

# the rows held line for line to the JAX package's bench
JAX_ROWS = [
    ["--model", "transe"],
    ["--model", "transe", "--l2"],
    ["--model", "rescal", "--ncomp", "100"],
    ["--model", "conve", "--ncomp", "128", "--ce"],
    ["--model", "distmult", "--sampled-ce", "--k", "8192"],
    ["--model", "transe", "--selfadv"],
]


class FixedClock:
    """`time` for a bench module: perf_counter reads 0, 1, 0, 1, ..."""

    def __init__(self):
        self._reads = itertools.cycle([0.0, 1.0])

    def perf_counter(self):
        return next(self._reads)


def run_main(module, argv, rows, monkeypatch):
    """`module.main` on `argv` with ALL_ROWS = `rows` under a fixed clock;
    returns its JSON lines."""
    monkeypatch.setattr(module, "time", FixedClock())
    monkeypatch.setattr(module, "ALL_ROWS", rows)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if module is jbench:
            monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
            module.main()
        else:
            module.main(argv)
    return [json.loads(line) for line in out.getvalue().splitlines()]


def work_units(row, epochs=2):
    """bench.py's work units of `row` at TINY, counted from its flags."""
    args = bench.parse_args(TINY + row)
    dirs = 1 if args.model == "conve" else 2
    if args.ce:
        per, pairs = 1, dirs * 40
    elif args.sampled_ce:
        per, pairs = 1, dirs * (args.k + 1)
    elif args.selfadv or args.sampler == "shared":
        per, pairs = 2, dirs * args.k
    else:
        per, pairs = 2, dirs * args.negatives
    return per * pairs * N_TRAIN * epochs


def metric_of(row):
    args = bench.parse_args(TINY + row)
    suffix = "".join(s for flag, s in ((args.l2, "_l2"), (args.ce, "_ce"),
                                       (args.selfadv, "_selfadv"),
                                       (args.sampled_ce, "_sampled_ce")) if flag)
    return f"{args.model}{suffix}_fb15k_scored_triples_per_s_per_chip"


@pytest.mark.parametrize("row", bench.ALL_ROWS, ids=" ".join)
def test_every_row_counts_its_work_units(row, monkeypatch):
    (line,) = run_main(bench, ["--all"] + TINY, [row], monkeypatch)
    units = work_units(row)
    assert line == {"metric": metric_of(row), "value": round(float(units), 1),
                    "unit": "triples/s", "vs_baseline": round(units / 50e6, 4),
                    "config": " ".join(row)}


def test_iid_dense_pallas_counts_its_work_units(monkeypatch):
    row = ["--sampler", "random-mode", "--aggregate", "dense_pallas"]
    (line,) = run_main(bench, TINY + ["--ncomp", "8"] + row, [], monkeypatch)
    units = work_units(row)
    assert units == 2 * 2 * 8 * N_TRAIN * 2  # 16 pairs a positive, 2 scores each
    assert line == {"metric": "transe_fb15k_scored_triples_per_s_per_chip",
                    "value": round(float(units), 1), "unit": "triples/s",
                    "vs_baseline": round(units / 50e6, 4)}


def test_lines_equal_jax(monkeypatch):
    want = run_main(jbench, ["--all"] + TINY, JAX_ROWS, monkeypatch)
    got = run_main(bench, ["--all"] + TINY, JAX_ROWS, monkeypatch)
    assert len(want) == len(JAX_ROWS)
    assert got == want


@pytest.mark.parametrize("argv,message", [
    (["--negatives", "0"], "--negatives must be >= 1"),
    (["--k", "0"], "--k must be >= 1"),
    (["--ce", "--selfadv"], "mutually exclusive"),
    (["--selfadv", "--sampled-ce"], "mutually exclusive"),
    (["--model", "bogus"], "invalid choice"),
])
def test_argument_errors_equal_jax(argv, message, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    with pytest.raises(SystemExit) as want:
        jbench.main()
    want_err = capsys.readouterr().err.splitlines()[-1]
    with pytest.raises(SystemExit) as got:
        bench.main(argv)
    got_err = capsys.readouterr().err.splitlines()[-1]
    assert got.value.code == want.value.code == 2
    assert message in want_err
    assert got_err.split(": ", 1)[1] == want_err.split(": ", 1)[1]


@pytest.mark.parametrize("argv,message", [
    (["--model", "hole", "--l2"], "--l2 is a TransE option"),
    (["--model", "transe", "--factored"], "--factored is a TransR option"),
])
def test_model_option_errors_equal_jax(argv, message):
    want_args = bench.parse_args(TINY + argv)
    with pytest.raises(SystemExit, match=message):
        jbench.run(want_args)
    with pytest.raises(SystemExit, match=message):
        bench.run(bench.parse_args(TINY + argv))


def test_gpu_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        bench.main(["--entities", "60", "--relations", "4", "--ntrain", "300"])


@pytest.mark.parametrize("row", bench.ALL_ROWS, ids=" ".join)
def test_scatters_a_step_as_chip_smoke_expects(row, monkeypatch):
    """The row's calls of both kernels' wrappers a step, counted on the
    CPU (the plain versions run here), against phase 16's table."""
    calls = {"segment_sum": 0, "segment_outer_sum": 0, chip_smoke.VECTOR: 0}

    def counted(name, fn):
        def wrapper(idx, grads, *rest):
            calls[name] += 1
            if name == "segment_sum" and grads.shape[1] % 4 == 0:
                calls[chip_smoke.VECTOR] += 1
            return fn(idx, grads, *rest)
        return wrapper

    monkeypatch.setattr(aggregate, "segment_sum",
                        counted("segment_sum", aggregate.segment_sum))
    monkeypatch.setattr(aggregate, "segment_outer_sum",
                        counted("segment_outer_sum", aggregate.segment_outer_sum))
    run_main(bench, ["--all"] + TINY, [row], monkeypatch)
    steps = (1 + 2) * 2  # a warm-up and 2 timed epochs of 2 steps
    want = chip_smoke.bench_launches(" ".join(row), steps)
    assert calls == want
