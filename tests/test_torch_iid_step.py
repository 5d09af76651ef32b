"""The port's iid train steps (`make_pairwise_step` / `make_pointwise_step`
with an iid sampler, inside `make_epoch_fn`) against the JAX package's.

The port is fed JAX's epoch permutations and its samplers' raw draws,
replayed from the JAX key splits (`make_epoch_fn` splits once per epoch,
the step once per batch, the sampler as in `tests/test_torch_samplers.py`)
and must follow JAX's trajectory: fp64 at 1e-9, identical violation
counts.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skge_tpu import training as jtraining
from skge_tpu.models import ERMLP as JERMLP
from skge_tpu.models import HolE as JHolE
from skge_tpu.models import RESCAL as JRESCAL
from skge_tpu.models import TransE as JTransE
from skge_tpu.optim import AdaGrad as JAdaGrad
from skge_torch import (ERMLP, RESCAL, AdaGrad, HolE, TransE, make_epoch_fn,
                        make_pairwise_step, make_pointwise_step)
from skge_torch.convert import state_from_numpy
from skge_torch.data import synthetic_kg
from test_torch_samplers import as_draws, build

torch.set_num_threads(1)

N_E, N_R, D, N_TRAIN, NB, EPOCHS = 40, 6, 12, 150, 4, 2
TOL = dict(rtol=1e-9, atol=1e-11)

MODELS = {
    "transe": (lambda: JTransE(N_E, N_R, D, dtype="float64"),
               lambda: TransE(N_E, N_R, D, dtype="float64")),
    "hole": (lambda: JHolE(N_E, N_R, D, dtype="float64", rparam=0.01),
             lambda: HolE(N_E, N_R, D, dtype="float64", rparam=0.01)),
    "rescal": (lambda: JRESCAL(N_E, N_R, D, dtype="float64", rparam=0.02),
               lambda: RESCAL(N_E, N_R, D, dtype="float64", rparam=0.02)),
    "ermlp": (lambda: JERMLP(N_E, N_R, D, dtype="float64", nhidden=7),
              lambda: ERMLP(N_E, N_R, D, dtype="float64", nhidden=7)),
}


class ReplayDraws:
    """A sampler that hands its pure part the given raw draws in order,
    through both protocols."""

    def __init__(self, sampler, draws):
        self.sampler, self.draws = sampler, list(draws)

    def corruptions(self, generator, pos, mask):
        return self.sampler.corrupt(pos, mask, self.draws.pop(0))

    def __call__(self, generator, pos, mask):
        return self.sampler.expand(pos, mask, self.draws.pop(0))


def assert_same_state(tstate, jstate):
    for name in jstate.params:
        np.testing.assert_allclose(tstate.params[name].numpy(),
                                   np.asarray(jstate.params[name]), **TOL, err_msg=name)
        np.testing.assert_allclose(tstate.opt_state[name]["p2"].numpy(),
                                   np.asarray(jstate.opt_state[name]["p2"]), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("model, sampler, fused", [
    ("hole", "random-mode", True),
    ("ermlp", "bernoulli", True),
    ("transe", "lcwa", True),
    ("rescal", "corrupted", True),
    ("hole", "random-mode", False),
])
def test_pairwise_trajectory_with_jax_draws_matches_jax(model, sampler, fused):
    """2 epochs x 4 steps of the iid pairwise step."""
    ds = synthetic_kg(N_E, N_R, N_TRAIN, seed=4)
    jm, tm = (f() for f in MODELS[model])
    jsampler, tsampler, raw = build(sampler, ds)
    jopt = JAdaGrad(lr=0.1)
    jepoch = jax.jit(jtraining.make_epoch_fn(
        jtraining.make_pairwise_step(jm, jopt, jsampler, 0.2, aggregate="dense",
                                     fused=fused),
        N_TRAIN, NB,
    ))
    jstate = jtraining.init_state(jm, jopt, jax.random.PRNGKey(7))

    b = -(-N_TRAIN // NB)
    key, perms, draws = jstate.key, [], []
    for _ in range(EPOCHS):
        key, pk = jax.random.split(key)
        perms.append(np.array(jax.random.permutation(pk, N_TRAIN)))
        for _ in range(NB):
            key, sk = jax.random.split(key)
            draws.append(as_draws(raw(sk, b)))

    tepoch = make_epoch_fn(
        make_pairwise_step(tm, AdaGrad(lr=0.1), ReplayDraws(tsampler, draws), 0.2,
                           aggregate="dense_pallas", fused=fused),
        N_TRAIN, NB,
    )
    tstate = state_from_numpy(jax.device_get(jstate), "cpu")
    xs_j, xs_t = jnp.asarray(ds.train), torch.as_tensor(ds.train, dtype=torch.int64)
    for e in range(EPOCHS):
        jstate, jmet = jepoch(jstate, xs_j)
        tstate, tmet = tepoch(tstate, xs_t, perm=torch.as_tensor(perms[e]))
        np.testing.assert_array_equal(tmet.nviolations.numpy(),
                                      np.asarray(jmet.nviolations))
        np.testing.assert_allclose(tmet.loss.numpy(), np.asarray(jmet.loss), **TOL)
        assert_same_state(tstate, jstate)
    assert tstate.step == int(jstate.step) == EPOCHS * NB
    assert int(tmet.nviolations.sum()) > 0


@pytest.mark.parametrize("model, sampler", [
    ("hole", "random-mode"), ("ermlp", "bernoulli"), ("rescal", "lcwa"),
])
def test_pointwise_step_with_jax_draws_matches_jax(model, sampler):
    """Two iid pointwise steps: negatives appended with y = -1."""
    ds = synthetic_kg(N_E, N_R, N_TRAIN, seed=5)
    jm, tm = (f() for f in MODELS[model])
    jsampler, tsampler, raw = build(sampler, ds)
    jopt = JAdaGrad(lr=0.1)
    jstep = jtraining.make_pointwise_step(jm, jopt, jsampler, aggregate="dense")
    jstate = jtraining.init_state(jm, jopt, jax.random.PRNGKey(8))
    tstate = state_from_numpy(jax.device_get(jstate), "cpu")

    rng = np.random.default_rng(9)
    batches = [ds.train[rng.permutation(N_TRAIN)[:30]] for _ in range(2)]
    mask = np.ones(30, np.float32)
    mask[-4:] = 0.0
    key, draws = jstate.key, []
    for _ in batches:
        key, sk = jax.random.split(key)
        draws.append(as_draws(raw(sk, 30)))
    tstep = make_pointwise_step(tm, AdaGrad(lr=0.1), ReplayDraws(tsampler, draws),
                                aggregate="dense_pallas")
    for batch in batches:
        jstate, jmet = jstep(jstate, jnp.asarray(batch), jnp.asarray(mask))
        tstate, tmet = tstep(tstate, torch.as_tensor(batch, dtype=torch.int64),
                             torch.as_tensor(mask))
        np.testing.assert_allclose(float(tmet.loss), float(jmet.loss), **TOL)
        assert float(tmet.nviolations) == 0.0
        assert_same_state(tstate, jstate)
