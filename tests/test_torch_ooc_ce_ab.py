"""The port's out-of-core CE A/B (skge_torch/ooc_ce_ab.py) against the JAX
package's (scripts/ooc_ce_ab.py), on the CPU at tiny sizes:

- both mains with the trainers' `fit` and `evaluate` scripted, every arm:
  the same validation lines, early stops, best epochs and rows;
- P=1 full CE (the A/B's first arm) equal bit for bit to the in-core
  full-CE step under `make_epoch_fn`, in fp32 and fp64;
- the real arms at a tiny size, the `--out` rows, the port's KG cache and
  the GPU default.
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import skge_tpu.outofcore as jooc
from skge_torch import (Adam, DistMult, init_state, make_ce_step, make_epoch_fn)
from skge_torch import ooc_ce_ab as ab
from skge_torch import outofcore as ooc
from skge_torch.data import add_reciprocal_relations

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts")
)

import ooc_ce_ab as jab  # noqa: E402
from test_torch_flagship import _TmpOs  # noqa: E402  (the scripts' /tmp moved)

torch.set_num_threads(1)

TINY = ["--cpu", "--entities", "400", "--relations", "8", "--ntrain", "1500",
        "--latent-dim", "8", "--dim", "16", "--k", "64", "--nbatches", "5"]


@pytest.fixture(autouse=True)
def caches(tmp_path, monkeypatch):
    monkeypatch.setattr(ab, "CACHE_DIR", tmp_path / "port_cache")
    monkeypatch.setattr(jab, "os", _TmpOs(tmp_path))
    return tmp_path


class _Result:
    def __init__(self, mrr, h10, mr):
        self.mrr, self.hits, self.mean_rank = mrr, {10: h10}, mr


# validation MRR by (arm's parts, epochs trained): rising, or peaking early
SCRIPTS = {
    "peak": lambda p, e: 0.2 + 0.01 * p - 0.002 * abs(e - 4 * p),
    "rising": lambda p, e: 0.1 + 0.0123 * e + 0.001 * p,
}


def _scripted(monkeypatch, cls, script):
    """`fit` counts epochs; an `evaluate` after a fit is a validation (the
    script's MRR), one with no fit since the last is the test ranking."""
    def fit(self, epochs=1, verbose=False):
        self._scripted_e = getattr(self, "_scripted_e", 0) + epochs
        return self

    def evaluate(self, test, known=None, batch_size=512, **kw):
        e = getattr(self, "_scripted_e", 0)
        p = self.n_parts
        if getattr(self, "_scripted_seen", None) != e:
            self._scripted_seen = e
            return _Result(SCRIPTS[script](p, e), 0.0, 0.0)
        return _Result(0.31 + 0.001 * e + 0.01 * p, 0.45 + 0.01 * p, 123.4 + e)

    monkeypatch.setattr(cls, "fit", fit)
    monkeypatch.setattr(cls, "evaluate", evaluate)


def _lines(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(argv)
    lines = [json.loads(line) for line in out.getvalue().splitlines()
             if line.startswith("{")]
    for line in lines:
        line.pop("train_eval_s", None)
    return lines


@pytest.mark.parametrize("patience", [1, 3])
@pytest.mark.parametrize("script", list(SCRIPTS))
def test_arm_lines_equal_jax(monkeypatch, script, patience):
    _scripted(monkeypatch, jooc.OutOfCoreTrainer, script)
    _scripted(monkeypatch, ooc.OutOfCoreTrainer, script)
    argv = TINY + ["--epochs", "12", "--eval-every", "2", "--patience", str(patience)]
    want = _lines(jab.main, argv)
    got = _lines(ab.main, argv)
    assert got == want
    rows = [line for line in got if "n_parts" in line]
    assert [r["arm"] for r in rows] == "ce:1,ce:2,ce:4,sampled_ce:2,sampled_ce:4".split(",")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_p1_full_ce_is_the_incore_step_bit_for_bit(dtype):
    args = ab.parse_args(TINY + ["--epochs", "2"])
    ds = ab.load_kg(args, torch.device("cpu"))
    aug = add_reciprocal_relations(ds)
    tr = ab.make_trainer(args, aug, "ce", 1, torch.device("cpu"), dtype=dtype)
    tr.fit(epochs=2)
    model = DistMult(aug.n_entities, aug.n_relations, args.dim, dtype=dtype)
    opt = Adam(lr=1e-3)
    state = init_state(model, opt, torch.Generator().manual_seed(0))
    epoch = make_epoch_fn(make_ce_step(model, opt, ("o",), 0.1), len(aug.train),
                          args.nbatches)
    xs = torch.as_tensor(aug.train, dtype=torch.int64)
    losses = []
    for _ in range(2):
        state, m = epoch(state, xs)
        losses.append(float(m.loss.sum()))
    got = tr.params()
    for name in ("E", "R"):
        np.testing.assert_array_equal(got[name], state.params[name].numpy(), err_msg=name)
    for slot in ("m", "v"):
        np.testing.assert_array_equal(tr.e_host[slot].numpy(),
                                      state.opt_state["E"][slot].numpy(), err_msg=slot)
    assert [m["loss"] for m in tr.metrics] == losses


def test_tiny_arms_train_and_append_rows(tmp_path):
    out = tmp_path / "rows.jsonl"
    argv = TINY + ["--epochs", "2", "--eval-every", "1", "--arms", "ce:1,sampled_ce:2",
                   "--out", str(out)]
    lines = _lines(ab.main, argv)
    vals = [line for line in lines if "valid_mrr" in line]
    assert [(v["arm"], v["epoch"]) for v in vals] == [
        ("ce:1", 1), ("ce:1", 2), ("sampled_ce:2", 1), ("sampled_ce:2", 2)]
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["arm"] for r in rows] == ["ce:1", "sampled_ce:2"]
    for r in rows:
        assert set(r) == {"arm", "n_parts", "best_epoch", "train_eval_s", "mrr", "hits10",
                          "mr"}
        assert 0 < r["mrr"] <= 1 and r["best_epoch"] in (1, 2)


def test_kg_cache_is_the_ports_own(monkeypatch, caches):
    args = ab.parse_args(TINY)
    first = ab.load_kg(args, torch.device("cpu"))
    files = os.listdir(caches / "port_cache")
    assert files == ["latent_kg_torch-cpu-translational-e400-r8-t1500-h150-l8-s0.npz"]
    monkeypatch.setattr(ab, "latent_kg", lambda **kw: pytest.fail("rebuilt"))
    again = ab.load_kg(args, torch.device("cpu"))
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(getattr(again, split), getattr(first, split))


def test_gpu_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--cpu"):
        ab.main(["--entities", "400"])
