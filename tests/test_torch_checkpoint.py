"""The port's npz checkpoints (skge_torch/utils/checkpoint.py) against the
JAX package's: a file of either package loads in the other with the same
params, optimizer slots and step; a round trip keeps the generator; the
write is atomic; an asynchronous write error surfaces on `wait()`; and a
resumed `fit` is `torch.equal` to an uninterrupted one on the CPU.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from skge_tpu import training as jtraining
from skge_tpu.models import RESCAL as JRESCAL
from skge_tpu.optim import Adam as JAdam
from skge_tpu.utils import checkpoint as jckpt
from skge_torch import (AsyncCheckpointer, HolE, RandomModeSampler, TrainConfig, Trainer,
                        TransE, init_state, load_checkpoint, save_checkpoint)
from skge_torch.data import synthetic_kg
from skge_torch.optim import Adam, AdaGrad

torch.set_num_threads(1)


def _state(opt, seed=0):
    model = TransE(30, 4, 6, dtype="float64")
    state = init_state(model, opt, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    opt_state = {k: {s: torch.as_tensor(rng.random(tuple(v.shape))) for s, v in slots.items()}
                 for k, slots in state.opt_state.items()}
    return state._replace(opt_state=opt_state, step=17)


@pytest.mark.parametrize("opt", [AdaGrad(), Adam()])
def test_port_file_loads_in_jax(tmp_path, opt):
    state = _state(opt)
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, state, meta={"epoch": 3})
    jstate, meta = jckpt.load_checkpoint(path)
    assert meta == {"epoch": 3}
    assert int(jstate.step) == 17
    assert jax.random.key_data(jstate.key).shape == (2,)
    for k, v in state.params.items():
        np.testing.assert_array_equal(np.asarray(jstate.params[k]), v.numpy())
        for s, sv in state.opt_state[k].items():
            np.testing.assert_array_equal(np.asarray(jstate.opt_state[k][s]), sv.numpy())
    assert set(jstate.opt_state["E"]) == set(state.opt_state["E"])
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".npz.tmp")]


def test_jax_file_loads_in_port(tmp_path):
    jopt = JAdam(lr=0.01)
    jstate = jtraining.init_state(JRESCAL(20, 3, 4, dtype="float64"), jopt,
                                  jax.random.PRNGKey(5))
    jstate = jstate._replace(
        opt_state=jax.tree.map(lambda a: a + 0.25, jstate.opt_state),
        step=jstate.step + 9)
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, jstate, meta={"config": {"seed": 4}})
    state, meta = load_checkpoint(path, "cpu")
    assert state.step == 9 and meta == {"config": {"seed": 4}}
    for k in ("E", "W"):
        np.testing.assert_array_equal(state.params[k].numpy(), np.asarray(jstate.params[k]))
        for s in ("m", "v", "t"):
            np.testing.assert_array_equal(state.opt_state[k][s].numpy(),
                                          np.asarray(jstate.opt_state[k][s]))
    # no generator in a JAX file: a fresh one from the config seed and step
    again, _ = load_checkpoint(path, "cpu")
    assert torch.equal(state.generator.get_state(), again.generator.get_state())
    other = load_checkpoint(path, "cpu")[0].generator
    assert torch.equal(torch.rand(4, generator=other),
                       torch.rand(4, generator=again.generator))


def test_round_trip_keeps_the_generator(tmp_path):
    state = _state(AdaGrad(), seed=3)
    torch.rand(5, generator=state.generator)  # move it off its seed
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, state)
    loaded, meta = load_checkpoint(path, "cpu")
    assert meta == {} and loaded.step == 17
    assert torch.equal(loaded.generator.get_state(), state.generator.get_state())
    assert torch.equal(torch.randperm(50, generator=loaded.generator),
                       torch.randperm(50, generator=state.generator))
    for k in state.params:
        assert torch.equal(loaded.params[k], state.params[k])
        assert torch.equal(loaded.opt_state[k]["p2"], state.opt_state[k]["p2"])


def test_async_checkpointer(tmp_path):
    state = _state(AdaGrad())
    with AsyncCheckpointer() as ck:
        ck.save(str(tmp_path / "a.npz"), state, meta={"n": 1})
        ck.save(str(tmp_path / "b.npz"), state, meta={"n": 2})
    assert load_checkpoint(str(tmp_path / "b.npz"), "cpu")[1] == {"n": 2}
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    ck = AsyncCheckpointer()
    ck.save(str(blocker / "c.npz"), state)
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()  # the error is raised once
    assert sorted(os.listdir(tmp_path)) == ["a.npz", "b.npz", "not_a_dir"]


def test_resumed_fit_equals_uninterrupted_fit(tmp_path):
    """fit 2 epochs == fit stopped after epoch 1 (its checkpoint written),
    load, fit(start_epoch=1); Adam under a cosine schedule over the 2
    epochs."""
    ds = synthetic_kg(40, 5, 300, seed=2)
    model = HolE(40, 5, 8, rparam=0.01)
    path = str(tmp_path / "e1.npz")
    cfg = TrainConfig(max_epochs=2, nbatches=4, margin=0.2, optimizer="adam",
                      learning_rate=0.01, schedule="cosine", warmup=2,
                      aggregate="dense_pallas", seed=1)

    def trainer(config, post_epoch=()):
        return Trainer(model, RandomModeSampler(40), config, post_epoch, device="cpu")

    whole = trainer(cfg).fit(ds.train)
    trainer(dataclasses.replace(cfg, checkpoint_path=path),
            post_epoch=[lambda tr: tr.epoch < 1]).fit(ds.train)
    state, meta = load_checkpoint(path, "cpu")
    assert meta["epoch"] == 1 and meta["config"]["optimizer"] == "adam"
    assert state.step == 4
    resumed = trainer(cfg).fit(ds.train, state=state, start_epoch=1)
    assert resumed.step == whole.step == 8
    for k in whole.params:
        assert torch.equal(resumed.params[k], whole.params[k]), k
        for s in whole.opt_state[k]:
            assert torch.equal(resumed.opt_state[k][s], whole.opt_state[k][s]), (k, s)
