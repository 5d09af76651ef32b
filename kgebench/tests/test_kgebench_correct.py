"""`correct` at a tiny size on the CPU: the program against the plain
reference, each cell's control (the reference one precision below, in the
program's place), and the faults planted under a run."""

import time

import numpy as np
import pytest
import torch

from kgebench import check, limits, registry, run
from kgebench.drivers import serve, train

CPU = torch.device("cpu")
TRAIN = ["transe_l1_fb15k.pool", "hole_wn18.iid", "hole_wn18.pool"]


def session(bench, root, name, seed=9):
    spec = registry.spec(bench, name, root)
    drv = train if spec.kind == "train" else serve
    sess = drv.Session(spec, seed, CPU)
    if spec.kind == "serve":
        sess.window(0.2)
    return spec, sess


@pytest.mark.parametrize("name", TRAIN + ["transe_l1_fb15k.serve"])
def test_program_passes_and_control_fails(bench, tiny_root, name):
    spec, sess = session(bench, tiny_root, name)
    reads = (limits.train_readings if spec.kind == "train" else limits.serve_readings)(
        sess, spec.cell["control"])
    lim = spec.cell["limits"]
    assert check.judge(reads["program"], lim), reads["program"]
    assert not check.judge(reads["control"], lim), reads["control"]
    fault = "half_batch" if spec.kind == "train" else "altered"
    assert not check.judge(reads[fault], lim), reads[fault]


def broken_run(bench, root, name):
    spec = registry.spec(bench, name, root)
    return run.run_cell(spec, 13, 0.3, False, CPU, time.perf_counter())


@pytest.mark.parametrize("name", TRAIN)
def test_unchanged_state_fails(bench, tiny_root, name, monkeypatch):
    real = train.make_pairwise_step

    def unchanged(*a, **kw):
        step = real(*a, **kw)
        return lambda state, batch, mask, **k: (state, step(state, batch, mask, **k)[1])

    monkeypatch.setattr(train, "make_pairwise_step", unchanged)
    assert broken_run(bench, tiny_root, name)["correct"] is False


@pytest.mark.parametrize("name", TRAIN)
def test_half_batch_fails(bench, tiny_root, name, monkeypatch):
    real = train.make_pairwise_step

    def half(*a, **kw):
        step = real(*a, **kw)

        def s(state, batch, mask, **k):
            keep = torch.arange(mask.shape[0]) < mask.shape[0] // 2
            return step(state, batch, mask * keep, **k)
        return s

    monkeypatch.setattr(train, "make_pairwise_step", half)
    assert broken_run(bench, tiny_root, name)["correct"] is False


def test_altered_answer_fails(bench, tiny_root, monkeypatch):
    class Altered(serve.LinkPredictor):
        def top_k(self, queries, k, direction="o", filtered=True):
            res = super().top_k(queries, k, direction, filtered)
            res.entities[:, -1] = (res.entities[:, -1] + 1) % self.model.n_entities
            return res

    monkeypatch.setattr(serve, "LinkPredictor", Altered)
    assert broken_run(bench, tiny_root, "transe_l1_fb15k.serve")["correct"] is False


def test_serve_numbers_by_hand():
    ref = torch.tensor([[0.0, -1.0, -float("inf"), -3.0, -3.0]], dtype=torch.float64)
    top = torch.tensor([[0.0, -1.0, -3.0]], dtype=torch.float64)
    good = check.serve_numbers(np.array([[0, 1, 3]]), np.array([[0.0, -1.0, -3.0]]), top, ref, 5, 3)
    assert good == {"rank_gap": 0.0, "score_gap": 0.0, "filtered": 0, "invalid": 0,
                    "missing": 0, "ties": 0}
    tie_wrong = check.serve_numbers(np.array([[0, 1, 4]]), np.array([[0.0, -1.0, -3.0]]),
                                    top, ref, 5, 3)
    assert tie_wrong["invalid"] == 0 and tie_wrong["rank_gap"] == 0.0
    order = check.serve_numbers(np.array([[0, 4, 3]]), np.array([[0.0, -3.0, -3.0]]), top, ref, 5, 3)
    assert order["invalid"] == 1 and order["rank_gap"] == 2.0
    known = check.serve_numbers(np.array([[0, 2, 1]]), np.array([[0.0, -1.0, -1.0]]), top, ref, 5, 3)
    assert known["filtered"] == 1
