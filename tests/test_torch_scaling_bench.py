"""The port's weak-scaling bench (`python -m skge_torch.scaling_bench`)
against the JAX package's `scripts/scaling_bench.py`, on the CPU:

- JAX's `main` runs in this process under the conftest's 8 virtual
  devices, with `--cpu`, tiny sizes, one timed step and a clock that reads
  each size's step seconds; the port runs the same argv with the same
  seconds as its worlds' reports. Every line is equal but `backend` and
  `note`, and so is the exit code: both samplers and both impls at
  `--devices 2` (one with a gate of its own that fails), and `--devices 4`,
  where shardmap's gate fails;
- one real run of the port at N = 1, 2 and 4 in gloo worlds (a subprocess,
  started first, which runs while JAX compiles): the records' keys, and
  exit code 0 exactly when the summary passes (no wall-clock ratio is held
  to the gate here, under the test runner's load);
- the same argument errors.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import pytest

from skge_torch import scaling_bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--cpu", "--entities", "300", "--relations", "6", "--ncomp", "8",
        "--per-device-batch", "16", "--steps", "1", "--k", "8", "--negatives", "2"]
# each size's step seconds: sharded, then the unsharded reference
SHARDED = {1: 0.0123, 2: 0.0251, 4: 0.0377}
UNSHARDED = {1: 0.0119, 2: 0.0117, 4: 0.0121}
RECORD_KEYS = {"devices", "total_batch", "step_ms", "scored_triples_per_s", "spmd_overhead"}
CASES = [
    ["--devices", "2"],
    ["--devices", "2", "--sampler", "shared"],
    ["--devices", "2", "--impl", "gspmd"],
    ["--devices", "2", "--sampler", "shared", "--impl", "gspmd", "--max-overhead", "2.0"],
    ["--devices", "4"],  # the overhead at 4 fails shardmap's 2.8
]


def _jax_module():
    spec = importlib.util.spec_from_file_location(
        "jax_scaling_bench", os.path.join(ROOT, "scripts", "scaling_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jsb = _jax_module()


class StepClock:
    """`time` for the JAX script: each timed run reads 0, then its step
    seconds (one step), sharded then unsharded, size by size."""

    def __init__(self, ns):
        self._reads = [x for n in ns for x in (0.0, SHARDED[n], 0.0, UNSHARDED[n])]

    def perf_counter(self):
        return self._reads.pop(0)


def lines_of(text):
    return [json.loads(line) for line in text.splitlines()]


@pytest.fixture(scope="module", autouse=True)
def real_run():
    """The port's CLI at N = 1, 2 and 4 in gloo worlds, started before the
    other tests and read by the last."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "skge_torch.scaling_bench", *TINY, "--devices", "4",
         "--steps", "2"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=ROOT)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def run_jax(argv, monkeypatch):
    n_max = int(argv[argv.index("--devices") + 1])
    monkeypatch.setattr(jsb, "time", StepClock([n for n in scaling_bench.SIZES
                                                if n <= n_max]))
    monkeypatch.setattr(sys, "argv", ["scaling_bench.py", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        jsb.main()
    return lines_of(out.getvalue()), e.value.code


def run_port(argv, monkeypatch):
    def fake_world(argv_, n, unsharded=False):
        assert argv_ == argv
        return (UNSHARDED if unsharded else SHARDED)[n]

    monkeypatch.setattr(scaling_bench, "run_world", fake_world)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = scaling_bench.main(argv)
    return lines_of(out.getvalue()), code


@pytest.mark.parametrize("case", CASES, ids=" ".join)
def test_lines_and_exit_code_equal_jax(case, monkeypatch):
    argv = TINY + case
    want, want_code = run_jax(argv, monkeypatch)
    got, code = run_port(argv, monkeypatch)
    assert code == want_code
    assert len(got) == len(want) >= 2
    assert got[:-1] == want[:-1]
    summary, jsummary = got[-1], want[-1]
    assert (summary["backend"], jsummary["backend"]) == ("gloo", "cpu-virtual")
    assert "gloo processes" in summary["note"]
    for key in ("backend", "note"):
        summary.pop(key), jsummary.pop(key)
    assert summary == jsummary
    assert want_code == (0 if jsummary["pass"] else 1)


def test_cases_cover_a_failed_gate(monkeypatch):
    codes = {run_port(TINY + case, monkeypatch)[1] for case in CASES}
    assert codes == {0, 1}


@pytest.mark.parametrize("bad", [["--impl", "xla"], ["--sampler", "bernoulli"]],
                         ids=lambda b: b[0])
def test_argument_errors_equal_jax(bad, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["scaling_bench.py", *bad])
    with pytest.raises(SystemExit) as e:
        jsb.main()
    want = capsys.readouterr().err.splitlines()[-1]
    with pytest.raises(SystemExit) as e2:
        scaling_bench.main(bad)
    got = capsys.readouterr().err.splitlines()[-1]
    assert e.value.code == e2.value.code == 2
    assert got.split("error: ", 1)[1] == want.split("error: ", 1)[1]


def test_real_gloo_worlds_at_1_2_4(real_run):
    out, err = real_run.communicate(timeout=300)
    lines = lines_of(out)
    assert [r["devices"] for r in lines[:-1]] == [1, 2, 4], err[-3000:]
    for rec, n in zip(lines, (1, 2, 4)):
        assert set(rec) == RECORD_KEYS
        assert rec["total_batch"] == 16 * n
        assert rec["step_ms"] > 0 and rec["spmd_overhead"] > 0
    summary = lines[-1]
    assert summary["metric"] == "spmd_overhead_vs_unsharded"
    assert summary["backend"] == "gloo" and summary["target"] == 2.8
    assert summary["worst"] == max(r["spmd_overhead"] for r in lines[:-1])
    assert real_run.returncode == (0 if summary["pass"] else 1), err[-3000:]
