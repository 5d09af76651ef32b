"""The port's last one-chip tools against the JAX system's scripts, on the
CPU at tiny sizes:

- the loss verify drivers (skge_torch/verify_{selfadv,ce,n3}.py against
  scripts/_verify_*.py): with `Trainer.fit` and `FilteredRankingEval`
  stubbed on both sides, the same dataset, the same (model, sampler,
  `TrainConfig`) in the same order, and the same printed lines, with and
  without `--sweep`;
- density_curve: with `quality_suite.main` stubbed on both sides, the same
  argv for every point, the same rows, `--out` lines and markdown tables;
- rotate_probe: `--variants oracle --epochs 0` on both sides (no training,
  both rank the generator's own latents): `oracle_params` equal to JAX's
  bit for bit, the same `init` and `final` diag, and the same ranks, MRR,
  H@10 and MR wherever no candidate lies within 1e-5 of the target;
- the run_* wrappers: the same argv to `experiment.main`;
- each driver on the GPU by default.
"""

import contextlib
import dataclasses
import io
import json
import os
import runpy
import shutil
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import skge_tpu.evaluation as jevaluation
import skge_tpu.experiment as jexperiment
import skge_tpu.trainer as jtrainer
from skge_torch import (density_curve, experiment, oracle_precision, quality_suite,
                        rotate_probe, run_ermlp, run_hole, run_rescal, run_transe,
                        trainer, verify_ce, verify_n3, verify_selfadv)
from skge_torch.models import RotatE

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "scripts")
sys.path.insert(0, SCRIPTS)

import density_curve as jdensity  # noqa: E402
import rotate_probe as jrotate  # noqa: E402

torch.set_num_threads(1)

GAP = 1e-5


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _sampler(s):
    if s is None:
        return None
    return type(s).__name__, s.n_entities, s.k, tuple(s.modes)


@pytest.fixture
def stubbed_training(monkeypatch):
    """`Trainer.fit` and `FilteredRankingEval` of both packages replaced:
    each fit is recorded as (model class, model fields, sampler, config
    fields) and leaves a falling loss; each ranking reports MRR 0.25 and
    H@10 0.5. Returns the list of records."""
    built = []

    def fit(self, xs, *a, **kw):
        built.append((type(self.model).__name__, _fields(self.model),
                      _sampler(self.sampler), _fields(self.config), len(xs)))
        self.metrics.history.extend([{"loss": 2.0}, {"loss": 1.0}])
        self.state = SimpleNamespace(params={})
        return self.state

    class Ranking:
        def __init__(self, model, test, known, batch_size=1024, **kw):
            built.append(("eval", len(test), len(known), batch_size))

        def __call__(self, params):
            return SimpleNamespace(mrr=0.25, hits={10: 0.5})

    for mod in (jtrainer.Trainer, trainer.Trainer):
        monkeypatch.setattr(mod, "fit", fit)
    monkeypatch.setattr(jevaluation, "FilteredRankingEval", Ranking)
    for mod in (verify_selfadv, verify_ce, verify_n3):
        monkeypatch.setattr(mod, "FilteredRankingEval", Ranking)
    return built


@pytest.mark.parametrize("name,port,sweep", [
    ("selfadv", verify_selfadv, False),
    ("ce", verify_ce, False),
    ("ce", verify_ce, True),
    ("n3", verify_n3, False),
    ("n3", verify_n3, True),
])
def test_verify_driver_equals_jax(name, port, sweep, stubbed_training, monkeypatch):
    flags = ["--sweep"] if sweep else []
    monkeypatch.setattr(sys, "argv", [f"_verify_{name}.py", "cpu", *flags])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        script = runpy.run_path(os.path.join(SCRIPTS, f"_verify_{name}.py"))
    want_lines, want = out.getvalue(), list(stubbed_training)
    stubbed_training.clear()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port.main(["--cpu", *flags])
    assert out.getvalue() == want_lines
    assert stubbed_training == want
    runs = {"selfadv": 1, "ce": 8 if sweep else 6, "n3": 10 if sweep else 9}[name]
    assert len(want) == 2 * runs
    ds = verify_selfadv.load(torch.device("cpu"))
    for split in ("train", "test"):
        np.testing.assert_array_equal(getattr(ds, split), getattr(script["ds"], split))


@pytest.mark.parametrize("port,model", [(run_transe, "transe"), (run_hole, "hole"),
                                        (run_rescal, "rescal"), (run_ermlp, "ermlp")])
def test_run_wrapper_equals_jax(port, model, monkeypatch):
    calls = []

    def main(argv=None):
        calls.append(list(argv))
        return 0

    monkeypatch.setattr(jexperiment, "main", main)
    monkeypatch.setattr(experiment, "main", main)
    flags = ["--me", "3", "--ncomp", "16"]
    monkeypatch.setattr(sys, "argv", [f"run_{model}.py", *flags])
    with pytest.raises(SystemExit) as done:
        runpy.run_path(os.path.join(SCRIPTS, f"run_{model}.py"), run_name="__main__")
    assert done.value.code == 0
    assert port.main(flags) == 0
    assert calls == [["--model", model, *flags]] * 2


def _suite_stub(calls):
    """A quality suite `main` that records its argv and prints and returns
    one row a model, its numbers made from the point's argv."""
    def main(argv):
        calls.append(list(argv))
        a = dict(zip(argv[::2], argv[1::2]))
        rows = []
        for i, name in enumerate(a["--models"].split(",")):
            rows.append({"model": name, "epochs": 3 + i,
                         "mrr": round(int(a["--ntrain"]) / 1e5 + i / 100, 4)})
            print(json.dumps(rows[-1]))
        return rows
    return main


def _no_point_s(text):
    lines = []
    for line in text.splitlines():
        if line.startswith("{"):
            row = json.loads(line)
            assert isinstance(row.pop("point_s"), float)
            line = json.dumps(row)
        lines.append(line)
    return lines


def test_density_curve_equals_jax(tmp_path, monkeypatch):
    want_calls, got_calls = [], []
    monkeypatch.setattr(jdensity.quality_suite, "main", _suite_stub(want_calls))
    monkeypatch.setattr(quality_suite, "main", _suite_stub(got_calls))
    flags = ["--cpu", "--entities", "300", "--densities", "2,3.45,8", "--epochs", "4",
             "--eval-every", "2"]
    outs = []
    for run, out in ((jdensity.main, tmp_path / "jax.jsonl"),
                     (density_curve.main, tmp_path / "port.jsonl")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run(flags + ["--out", str(out)])
        outs.append((buf.getvalue(), out.read_text()))
    assert got_calls == want_calls
    assert len(want_calls) == 9 and want_calls[1][want_calls[1].index("--ntrain") + 1] == "1035"
    (want_out, want_file), (got_out, got_file) = outs
    assert _no_point_s(got_out) == _no_point_s(want_out)
    assert _no_point_s(got_file) == _no_point_s(want_file)
    assert "| 3.45 | 0.0103 (3) | 0.0204 (4) |" in got_out


def test_density_curve_errors_equal_jax(capsys):
    errs = []
    for run in (jdensity.main, density_curve.main):
        with pytest.raises(SystemExit) as done:
            run(["--geometries", "translational,hyperbolic"])
        assert done.value.code == 2
        errs.append(capsys.readouterr().err.splitlines()[-1])
    assert errs[0] == errs[1]
    assert errs[0].endswith("unknown geometry 'hyperbolic'; choices: bilinear, "
                            "rotational, translational")


class _TmpPath:
    """`os.path` with the JAX script's hard-coded /tmp moved to `tmp`."""

    def __init__(self, tmp):
        self.tmp = str(tmp)

    def join(self, first, *rest):
        return os.path.join(self.tmp if first == "/tmp" else first, *rest)

    def __getattr__(self, name):
        return getattr(os.path, name)


class _TmpOs:
    def __init__(self, tmp):
        self.path = _TmpPath(tmp)

    def __getattr__(self, name):
        return getattr(os, name)


PROBE = ["--cpu", "--entities", "300", "--relations", "6", "--ntrain", "1200",
         "--latent-dim", "8", "--ncomp", "8", "--k", "64", "--nbatches", "5",
         "--epochs", "0", "--gammas", "6", "--variants", "oracle"]


def _recording(base, seen):
    class Recorded(base):
        def __call__(self, params):
            res = super().__call__(params)
            seen.append((params, res))
            return res
    return Recorded


def test_rotate_probe_oracle_equals_jax(tmp_path, monkeypatch):
    jax_seen, port_seen = [], []
    monkeypatch.setattr(jrotate, "os", _TmpOs(tmp_path))
    monkeypatch.setattr(jevaluation, "FilteredRankingEval",
                        _recording(jevaluation.FilteredRankingEval, jax_seen))
    monkeypatch.setattr(rotate_probe, "FilteredRankingEval",
                        _recording(rotate_probe.FilteredRankingEval, port_seen))
    monkeypatch.setattr(quality_suite, "CACHE_DIR", tmp_path / "port")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jrotate.main(PROBE)
    (want,) = [json.loads(line) for line in out.getvalue().splitlines()]
    # the port ranks the same KG: JAX's npz copied into the port's cache
    (npz,) = tmp_path.glob("latent_kg_rotational-*.npz")
    args = rotate_probe.parse_args(PROBE)
    key = SimpleNamespace(kg="rotational", entities=300, relations=6, ntrain=1200,
                          latent_dim=8)
    cache = quality_suite.cache_path(key, torch.device("cpu"))
    cache.parent.mkdir(parents=True)
    shutil.copy(npz, cache)
    (got,) = rotate_probe.main(PROBE)

    oracle = rotate_probe.oracle_params(300, 6, 8, 8)
    (jax_params, jax_res), = jax_seen
    for k in ("E", "R"):
        assert oracle[k].dtype == np.float32
        np.testing.assert_array_equal(oracle[k], np.asarray(jax_params[k]))
    assert got["init"] == want["init"] and got["final"] == want["final"]
    assert got["init"] == got["final"]
    for key_ in ("tag", "gamma", "best_epoch"):
        assert got[key_] == want[key_]

    (params, res), = port_seen
    ds = rotate_probe.load_kg(args, torch.device("cpu"))
    model = RotatE(300, 6, 8)
    p64 = {k: v.double() for k, v in params.items()}
    test = torch.as_tensor(ds.test, dtype=torch.int64)
    gaps = []
    for d, (score, tgt) in {"o": (model.score_all_o(p64, test[:, 0], test[:, 2]), test[:, 1]),
                            "s": (model.score_all_s(p64, test[:, 1], test[:, 2]),
                                  test[:, 0])}.items():
        rows = torch.arange(len(test))
        diff = (score - score[rows, tgt][:, None]).abs()
        diff[rows, tgt] = float("inf")
        gaps.append(diff.min(dim=1).values.numpy())
    far = np.stack(gaps) > GAP
    assert far.mean() > 0.99
    np.testing.assert_array_equal(res.ranks[far], np.asarray(jax_res.ranks)[far])
    if far.all():
        assert (got["mrr"], got["hits10"], got["mr"]) == \
            (want["mrr"], want["hits10"], want["mr"])
    assert got["mrr"] > 0.3  # the generator's latents rank far above random


def test_oracle_precision_ranks_the_probes_oracle(tmp_path, monkeypatch):
    """On the CPU: the fp32 ranking is rotate_probe's oracle row at no
    epoch on the same KG; bf16 scoring inputs rank close to it."""
    monkeypatch.setattr(quality_suite, "CACHE_DIR", tmp_path)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rows = oracle_precision.main(PROBE)
    assert [json.loads(line) for line in out.getvalue().splitlines()] == rows
    assert [(r["kg"], r["rank_on"], r["precision"]) for r in rows] == [
        ("cpu", "cpu", "float32"), ("cpu", "cpu", "bfloat16")]
    with contextlib.redirect_stdout(io.StringIO()):
        (probe,) = rotate_probe.main(PROBE)
    fp32, bf16 = rows
    assert (fp32["mrr"], round(fp32["hits10"], 3)) == (probe["mrr"], probe["hits10"])
    assert probe["mrr"] > 0.3 and abs(bf16["mrr"] - fp32["mrr"]) < 0.05


@pytest.mark.parametrize("run", [
    lambda: verify_selfadv.main([]),
    lambda: verify_ce.main(["--sweep"]),
    lambda: verify_n3.main([]),
    lambda: rotate_probe.main(["--epochs", "0"]),
    lambda: oracle_precision.main([]),
])
def test_gpu_is_the_default(run, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        run()


def test_density_curve_gpu_is_the_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--cpu"):
        density_curve.main(["--densities", "2", "--geometries", "translational",
                            "--out", str(tmp_path / "c.jsonl")])
