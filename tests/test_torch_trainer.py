"""The port's `Trainer` (skge_torch/trainer.py) against the JAX package's,
and its contract: full-CE training from the same initial state agrees
with JAX's `Trainer` at 1e-9 in fp64 (one batch an epoch, so the
permutation only reorders a sum); early stop through `post_epoch`; one
metrics record an epoch in the JSONL file; checkpoints every N epochs; no
silent CPU fallback.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from skge_tpu import training as jtraining
from skge_tpu.models import RESCAL as JRESCAL
from skge_tpu.models import TransE as JTransE
from skge_tpu.optim import OPTIMIZERS as JOPTIMIZERS
from skge_tpu.optim import make_schedule as jmake_schedule
from skge_tpu.trainer import TrainConfig as JTrainConfig
from skge_tpu.trainer import Trainer as JTrainer
from skge_torch import (RESCAL, RandomModeSampler, TrainConfig, Trainer, TransE,
                        load_checkpoint)
from skge_torch.convert import state_from_numpy
from skge_torch.data import synthetic_kg
from skge_torch.parallel import Mesh, ShardGroup
from skge_torch.utils.metrics import profile_trace

torch.set_num_threads(1)

TOL = dict(rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("model, opt", [("transe", "sgd"), ("rescal", "adam")])
def test_ce_trainer_matches_jax_trainer(model, opt):
    ds = synthetic_kg(30, 4, 120, seed=3)
    kw = dict(max_epochs=3, nbatches=1, loss="ce", label_smoothing=0.1,
              optimizer=opt, learning_rate=0.05 if opt == "adam" else 0.2)
    if opt == "adam":
        kw.update(schedule="cosine", warmup=1, schedule_min=0.1)
    if model == "transe":
        jm, tm = JTransE(30, 4, 6, dtype="float64"), TransE(30, 4, 6, dtype="float64")
    else:
        jm = JRESCAL(30, 4, 6, dtype="float64", rparam=0.02)
        tm = RESCAL(30, 4, 6, dtype="float64", rparam=0.02)
    jcfg = JTrainConfig(**kw)
    jopt = JOPTIMIZERS[opt](lr=jcfg.learning_rate, schedule=jmake_schedule(
        jcfg.schedule, jcfg.warmup, 3, jcfg.schedule_min))
    jstate0 = jtraining.init_state(jm, jopt, jax.random.PRNGKey(2))
    jtr = JTrainer(jm, None, jcfg)
    jstate = jtr.fit(ds.train, state=jstate0)
    ttr = Trainer(tm, None, TrainConfig(**kw), device="cpu")
    tstate = ttr.fit(ds.train, state=state_from_numpy(jax.device_get(jstate0), "cpu"))
    assert tstate.step == int(jstate.step) == 3
    np.testing.assert_allclose([r["loss"] for r in ttr.metrics.history],
                               [r["loss"] for r in jtr.metrics.history], **TOL)
    for k in jstate.params:
        np.testing.assert_allclose(tstate.params[k].numpy(), np.asarray(jstate.params[k]),
                                   **TOL, err_msg=k)
        for s in jstate.opt_state[k]:
            np.testing.assert_allclose(tstate.opt_state[k][s].numpy(),
                                       np.asarray(jstate.opt_state[k][s]), **TOL,
                                       err_msg=f"{k} {s}")
    if model == "transe":
        assert float(tstate.params["E"].norm(dim=1).max()) <= 1.0 + 1e-12


def _small():
    ds = synthetic_kg(40, 5, 200, seed=1)
    return ds, TransE(40, 5, 8), RandomModeSampler(40)


def test_post_epoch_metrics_and_checkpoints(tmp_path):
    ds, model, sampler = _small()
    seen = []
    cfg = TrainConfig(max_epochs=10, nbatches=4, margin=0.2,
                      checkpoint_path=str(tmp_path / "ck.npz"), checkpoint_every=2,
                      metrics_jsonl=str(tmp_path / "m.jsonl"))
    saves = []

    def watch(tr):
        seen.append((tr.epoch, tr.loss, tr.nviolations))
        path = cfg.checkpoint_path
        saves.append(load_checkpoint(path, "cpu")[1]["epoch"] if os.path.exists(path)
                     else None)
        return tr.epoch < 5  # stop after epoch 5

    tr = Trainer(model, sampler, cfg, post_epoch=[watch], device="cpu")
    state = tr.fit(ds.train)
    assert [e for e, _, _ in seen] == [1, 2, 3, 4, 5] and tr.epoch == 5
    assert state.step == 5 * 4
    # checkpoints at epochs 2 and 4, before the callbacks; the last at the stop
    assert saves == [None, 2, 2, 4, 4]
    assert load_checkpoint(cfg.checkpoint_path, "cpu")[1]["epoch"] == 5
    with open(cfg.metrics_jsonl) as f:
        records = [json.loads(line) for line in f]
    assert [r["epoch"] for r in records] == [1, 2, 3, 4, 5]
    for r, (e, loss, nv) in zip(records, seen):
        assert r["loss"] == loss and r["nviolations"] == nv
        assert r["epoch_seconds"] > 0 and r["triples_per_second"] > 0
    assert tr.metrics.history == [{k: v for k, v in r.items()} for r in records]
    assert records[-1]["nviolations"] < records[0]["nviolations"]


def test_profile_trace_writes_a_trace(tmp_path):
    ds, model, sampler = _small()
    tr = Trainer(model, sampler, TrainConfig(max_epochs=1, nbatches=2), device="cpu")
    with profile_trace(None):
        pass
    with profile_trace(str(tmp_path / "prof")):
        tr.fit(ds.train)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any("index_add" in str(e.get("name", "")) for e in trace["traceEvents"])


def test_no_silent_cpu_fallback(monkeypatch):
    ds, model, sampler = _small()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model, sampler, TrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model, sampler, TrainConfig(), device="cuda")
    assert Trainer(model, sampler, TrainConfig(), device="cpu").device.type == "cpu"
    # a mesh trainer runs on the mesh's device, never on another
    cpu = torch.device("cpu")
    mesh = Mesh(shape={"data": 1, "model": 1}, data=ShardGroup(None, 0, 1, cpu),
                model=ShardGroup(None, 0, 1, cpu), rank=0, device=cpu)
    assert Trainer(model, sampler, TrainConfig(), mesh=mesh).device == cpu
    with pytest.raises(ValueError, match="the mesh runs on cpu"):
        Trainer(model, sampler, TrainConfig(), device="cuda", mesh=mesh)
    with pytest.raises(ValueError, match="unknown loss"):
        Trainer(model, sampler, TrainConfig(loss="hinge"), device="cpu")
