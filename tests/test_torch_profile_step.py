"""The port's train-step profiler (skge_torch/profile_step.py) against the
JAX package's (scripts/profile_step.py), on the CPU at tiny sizes: the
same report (config, `epoch_ms` and `breakdown_ms` keys) for the shared
pool and the iid sampler, TransE and RESCAL; the `--trace` Chrome trace
written on the CPU; the GPU default.
"""

import contextlib
import io
import json
import os
import sys

import pytest
import torch

from skge_torch import profile_step as ps

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts")
)

import profile_step as jps  # noqa: E402

torch.set_num_threads(1)

TINY = ["--cpu", "--entities", "200", "--relations", "8", "--ntrain", "2000",
        "--ncomp", "16", "--k", "64", "--nbatches", "5", "--epochs", "1"]


def _report(text):
    return json.JSONDecoder().raw_decode(text[text.index("{"):])[0]


def _jax_report(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["profile_step.py", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jps.main()
    return _report(out.getvalue())


CASES = {
    "transe shared": [],
    "transe random-mode": ["--sampler", "random-mode", "--negatives", "2"],
    "rescal shared": ["--model", "rescal"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_report_equals_jax(monkeypatch, case):
    want = _jax_report(monkeypatch, TINY + CASES[case])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = ps.main(TINY + CASES[case])
    assert _report(out.getvalue()) == got
    assert got["config"] == want["config"]
    for key in ("epoch_ms", "breakdown_ms"):
        assert list(got[key]) == list(want[key])
    assert all(v > 0 for v in got["epoch_ms"].values())
    b, e = got["breakdown_ms"], got["epoch_ms"]
    assert b["sampling"] == e["sample"]
    assert abs(b["fwd+bwd"] - (e["grads"] - e["sample"])) <= 0.11
    assert abs(b["apply"] - (e["full"] - e["grads"])) <= 0.11


def test_trace_written_on_the_cpu(tmp_path):
    trace = tmp_path / "trace"
    got = ps.main(TINY + ["--trace", str(trace)])
    assert got["trace"] == str(trace / "trace.json")
    with open(got["trace"]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_gpu_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--cpu"):
        ps.main(["--entities", "200"])
