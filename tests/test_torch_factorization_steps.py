"""Train steps of the factorization family (DistMult, ComplEx, SimplE,
TuckER, QuatE) in the port against the JAX package's, fp64 at 1e-9: for
each model one shared-pool margin step (`dense_pallas`, AdaGrad) and one
full cross-entropy step (Adam), with `rparam` and `n3` on, two steps from
warm optimizer state. The
JAX package's `TrainState` is carried over by `state_from_numpy` (TuckER's
3-D core W and its optimizer slots with it), and the pool ids are drawn by
JAX's sampler and injected into both steps. The sampled cross-entropy
steps: test_torch_factorization_sampled_ce.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skge_tpu import training as jtraining
from skge_tpu.models import MODELS as JMODELS
from skge_tpu.optim import AdaGrad as JAdaGrad
from skge_tpu.optim import Adam as JAdam
from skge_tpu.sampling import SharedNegativeSampler as JShared
from skge_torch import MODELS, AdaGrad, Adam, training
from skge_torch.convert import params_to_numpy, state_from_numpy

torch.set_num_threads(1)

N_E, N_R, D, B, K = 17, 4, 5, 10, 6
TOL = dict(rtol=1e-9, atol=1e-11)
NAMES = ("distmult", "complex", "simple", "tucker", "quate")


class JFixedPool:
    modes = (0, 1)

    def __init__(self, ids):
        self.ids = jnp.asarray(ids)

    def pool(self, key, pos, mask):
        return self.ids


class TFixedPool:
    modes = (0, 1)

    def __init__(self, ids):
        self.ids = torch.as_tensor(np.array(ids))

    def pool(self, generator, pos, mask):
        return self.ids


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL, err_msg=what)


def _start(jm, loss):
    """(params, optimizer slots) as JAX arrays, made by numpy from a seed
    (JAX's `init_params` draws would compile anew for every shape): rows of
    scaled normals, warm AdaGrad accumulators, or warm Adam moments with
    per-row counts that differ."""
    rng = np.random.default_rng(7)
    shapes = {k: v.shape for k, v in jax.eval_shape(
        jm.init_params, jax.random.PRNGKey(0)).items()}
    params = {k: rng.normal(size=shape) * 0.5 for k, shape in shapes.items()}
    if loss == "margin":
        slots = {k: {"p2": rng.random(v.shape)} for k, v in params.items()}
    else:
        slots = {k: {"m": rng.normal(size=v.shape) * 0.1, "v": rng.random(v.shape),
                     "t": rng.integers(0, 4, v.shape[0]).astype(np.float64)}
                 for k, v in params.items()}
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: {s: jnp.asarray(v) for s, v in sl.items()} for k, sl in slots.items()})


def step_matches_jax(name, loss):
    kw = {"rcomp": 3} if name == "tucker" else {}
    jm = JMODELS[name](N_E, N_R, D, dtype="float64", rparam=0.01, n3=0.03, **kw)
    tm = MODELS[name](N_E, N_R, D, dtype="float64", rparam=0.01, n3=0.03, **kw)
    rng = np.random.default_rng(11)
    pos = np.stack([rng.integers(0, N_E // 2, B), rng.integers(0, N_E, B),
                    rng.integers(0, N_R, B)], axis=1)
    mask = np.ones(B)
    mask[-2:] = 0.0
    ids = np.asarray(JShared(N_E, k=K).pool(jax.random.PRNGKey(5), jnp.asarray(pos),
                                            jnp.asarray(mask)))
    jopt, topt = ((JAdaGrad(lr=0.1), AdaGrad(lr=0.1)) if loss == "margin"
                  else (JAdam(lr=0.05), Adam(lr=0.05)))
    if loss == "margin":
        jstep = jtraining.make_pairwise_step(jm, jopt, JFixedPool(ids), 0.5,
                                             aggregate="dense")
        tstep = training.make_pairwise_step(tm, topt, TFixedPool(ids), 0.5,
                                            aggregate="dense_pallas")
    elif loss == "ce":
        jstep = jtraining.make_ce_step(jm, jopt, ("o", "s"), 0.1)
        tstep = training.make_ce_step(tm, topt, ("o", "s"), 0.1)
    else:
        jstep = jtraining.make_sampled_ce_step(jm, jopt, JFixedPool(ids),
                                               label_smoothing=0.1)
        tstep = training.make_sampled_ce_step(tm, topt, TFixedPool(ids),
                                              label_smoothing=0.1)
    jstep = jax.jit(jstep)
    jstate = jtraining.TrainState(*_start(jm, loss), jax.random.PRNGKey(3),
                                  jnp.asarray(1, jnp.int32))
    tstate = state_from_numpy(jax.device_get(jstate), "cpu")
    if name == "tucker":
        assert tstate.params["W"].shape == (3, D, D)
        for slot, v in tstate.opt_state["W"].items():
            assert v.shape == jstate.opt_state["W"][slot].shape, slot
    for _ in range(2):
        jstate, jmet = jstep(jstate, jnp.asarray(pos), jnp.asarray(mask))
        tstate, tmet = tstep(tstate, torch.as_tensor(pos), torch.as_tensor(mask))
        close(tmet.loss, jmet.loss, "loss")
        close(tmet.nviolations, jmet.nviolations, "violations")
    if loss == "margin":
        assert float(tmet.nviolations) > 0
    assert tstate.step == int(jstate.step) == 3
    for k in jstate.params:
        close(tstate.params[k], jstate.params[k], k)
        for s in jstate.opt_state[k]:
            close(tstate.opt_state[k][s], jstate.opt_state[k][s], f"{k} {s}")


@pytest.mark.parametrize("loss", ["margin", "ce"])
@pytest.mark.parametrize("name", NAMES)
def test_step_matches_jax(name, loss):
    step_matches_jax(name, loss)


@pytest.mark.parametrize("name", ["complex", "quate", "tucker"])
def test_state_crosses_from_jax(name):
    """ComplEx's 2d rows, QuatE's 4d rows and TuckER's 3-D core W, each
    with its Adam slots, cross `state_from_numpy` and `params_to_numpy`
    unchanged."""
    kw = {"rcomp": 3} if name == "tucker" else {}
    jm = JMODELS[name](N_E, N_R, D, dtype="float64", **kw)
    jstate = jax.device_get(jtraining.TrainState(
        *_start(jm, "ce"), jax.random.PRNGKey(0), jnp.asarray(4, jnp.int32)))
    tstate = state_from_numpy(jstate, "cpu", seed=1)
    assert tstate.step == 4
    width = {"complex": 2 * D, "quate": 4 * D, "tucker": D}[name]
    assert tstate.params["E"].shape == (N_E, width)
    if name == "tucker":
        assert tstate.params["W"].shape == (3, D, D)
    for k, v in jstate.params.items():
        assert tstate.params[k].dtype == torch.float64
        np.testing.assert_array_equal(params_to_numpy(tstate.params)[k], v)
        assert set(tstate.opt_state[k]) == {"m", "v", "t"}
        for s, sv in jstate.opt_state[k].items():
            np.testing.assert_array_equal(tstate.opt_state[k][s].numpy(), sv)
