"""Train steps of RotatE, TransH, PairRE, TransR (factored and full rank)
and ConvE in the port against the JAX package's, fp64 at 1e-9, two steps
from warm optimizer state, the JAX package's state carried over by
`state_from_numpy`:

- the shared-pool margin step of each (ConvE corrupting objects only,
  pool `modes=(1,)`), under `unique` and under `dense_pallas` (the
  kernel's plain version on the CPU), against JAX's `dense` trajectory,
  the pool ids drawn by JAX's sampler and injected into both;
- the fused iid step (random-mode) of full-rank TransR and of ConvE with
  `modes=(1,)`, fed JAX's raw draws as `ReplayDraws` does;
- ConvE's full cross-entropy step, objects only, label smoothing 0.1,
  under Adam;
- TransH's self-adversarial step.

JAX's states are made by numpy from a seed (its `init_params` draws would
compile anew for every shape), and each JAX step is jitted once a model.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skge_tpu import training as jtraining
from skge_tpu.models import MODELS as JMODELS
from skge_tpu.optim import AdaGrad as JAdaGrad
from skge_tpu.optim import Adam as JAdam
from skge_tpu.sampling import RandomModeSampler as JRandomMode
from skge_tpu.sampling import SharedNegativeSampler as JShared
from skge_torch import MODELS, AdaGrad, Adam, RandomModeSampler, training
from skge_torch.convert import state_from_numpy
from test_torch_iid_step import ReplayDraws

torch.set_num_threads(1)

N_E, N_R, D, B, K = 17, 4, 6, 10, 6
TOL = dict(rtol=1e-9, atol=1e-11)
# name: (model, constructor keywords)
CONFIGS = {
    "rotate": ("rotate", {"rparam": 0.01}),
    "transh": ("transh", {}),
    "pairre": ("pairre", {}),
    "transr-factored": ("transr", {"factored": True}),
    "transr": ("transr", {"rcomp": 4}),
    "conve": ("conve", {"rparam": 0.01, "nfilters": 3}),
}


class FixedPool:
    """The same pool ids at every step, for either package."""

    def __init__(self, ids, modes, as_array):
        self.ids, self.modes = as_array(np.array(ids)), modes

    def pool(self, key, pos, mask):
        return self.ids


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL, err_msg=what)


def models(config):
    name, kw = CONFIGS[config]
    return (JMODELS[name](N_E, N_R, D, dtype="float64", **kw),
            MODELS[name](N_E, N_R, D, dtype="float64", **kw))


def jax_state(jm, adam=False, seed=7):
    """Params of scaled normals (TransR's M near the identity), warm AdaGrad
    accumulators or warm Adam moments with per-row counts that differ."""
    rng = np.random.default_rng(seed)
    shapes = {k: v.shape for k, v in jax.eval_shape(
        jm.init_params, jax.random.PRNGKey(0)).items()}
    params = {k: rng.normal(size=shape) * 0.5 for k, shape in shapes.items()}
    if "M" in params:
        params["M"] = params["M"] * 0.5 + np.eye(*shapes["M"][1:])
    if adam:
        slots = {k: {"m": rng.normal(size=v.shape) * 0.1, "v": rng.random(v.shape),
                     "t": rng.integers(0, 4, v.shape[0]).astype(np.float64)}
                 for k, v in params.items()}
    else:
        slots = {k: {"p2": rng.random(v.shape)} for k, v in params.items()}
    return jtraining.TrainState(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: {s: jnp.asarray(v) for s, v in sl.items()} for k, sl in slots.items()},
        jax.random.PRNGKey(3), jnp.asarray(1, jnp.int32))


def batch(seed=11):
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.integers(0, N_E // 2, B), rng.integers(0, N_E, B),
                    rng.integers(0, N_R, B)], axis=1)
    mask = np.ones(B)
    mask[-2:] = 0.0
    return pos, mask


def modes_of(config):
    return (1,) if config == "conve" else (0, 1)


def assert_same_state(tstate, jstate, steps):
    assert tstate.step == int(jstate.step) == 1 + steps
    for k in jstate.params:
        close(tstate.params[k], jstate.params[k], k)
        for s in jstate.opt_state[k]:
            close(tstate.opt_state[k][s], jstate.opt_state[k][s], f"{k} {s}")


@functools.lru_cache(maxsize=None)
def jax_margin_run(config):
    """JAX's two shared-pool margin steps (`dense`): (pool ids, start,
    [(state, metrics) after each step])."""
    jm, _ = models(config)
    pos, mask = batch()
    modes = modes_of(config)
    ids = np.asarray(JShared(N_E, k=K, modes=modes).pool(
        jax.random.PRNGKey(5), jnp.asarray(pos), jnp.asarray(mask)))
    jstep = jax.jit(jtraining.make_pairwise_step(
        jm, JAdaGrad(lr=0.1), FixedPool(ids, modes, jnp.asarray), 0.5,
        aggregate="dense"))
    start = jstate = jax_state(jm)
    out = []
    for _ in range(2):
        jstate, jmet = jstep(jstate, jnp.asarray(pos), jnp.asarray(mask))
        out.append(jax.device_get((jstate, jmet)))
    return ids, jax.device_get(start), out


@pytest.mark.parametrize("aggregate", ["unique", "dense_pallas"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_shared_pool_margin_step_matches_jax(config, aggregate):
    _, tm = models(config)
    ids, start, jout = jax_margin_run(config)
    pos, mask = batch()
    tstep = training.make_pairwise_step(
        tm, AdaGrad(lr=0.1), FixedPool(ids, modes_of(config), torch.as_tensor), 0.5,
        aggregate=aggregate)
    tstate = state_from_numpy(start, "cpu")
    for jstate, jmet in jout:
        tstate, tmet = tstep(tstate, torch.as_tensor(pos), torch.as_tensor(mask))
        close(tmet.loss, jmet.loss, "loss")
        close(tmet.nviolations, jmet.nviolations, "violations")
    assert float(tmet.nviolations) > 0
    assert_same_state(tstate, jstate, 2)


@pytest.mark.parametrize("config", ["transr", "conve"])
def test_fused_iid_step_with_jax_draws_matches_jax(config):
    """Two random-mode steps of the fused pairwise path (ConvE: objects
    only), the corruptions scored as (n, B, ·) stacks."""
    jm, tm = models(config)
    modes = modes_of(config) * 2  # two negatives per mode
    pos, mask = batch(seed=12)
    jstep = jax.jit(jtraining.make_pairwise_step(
        jm, JAdaGrad(lr=0.1), JRandomMode(N_E, modes), 0.5, aggregate="dense"))
    jstate = jax_state(jm, seed=8)
    key, draws = jstate.key, []
    for _ in range(2):
        key, sk = jax.random.split(key)
        draws.append(torch.as_tensor(np.stack(
            [np.asarray(jax.random.randint(k, (B,), 0, N_E))
             for k in jax.random.split(sk, len(modes))])))
    tstep = training.make_pairwise_step(
        tm, AdaGrad(lr=0.1), ReplayDraws(RandomModeSampler(N_E, modes), draws), 0.5,
        aggregate="dense_pallas")
    tstate = state_from_numpy(jax.device_get(jstate), "cpu")
    for _ in range(2):
        jstate, jmet = jstep(jstate, jnp.asarray(pos), jnp.asarray(mask))
        tstate, tmet = tstep(tstate, torch.as_tensor(pos), torch.as_tensor(mask))
        close(tmet.loss, jmet.loss, "loss")
        close(tmet.nviolations, jmet.nviolations, "violations")
    assert float(tmet.nviolations) > 0
    assert_same_state(tstate, jstate, 2)


def test_conve_ce_step_with_label_smoothing_under_adam_matches_jax():
    """Full cross entropy over every entity, objects only, every table
    under `apply_full`, `rparam` over the whole table but E's bias
    column."""
    jm, tm = models("conve")
    pos, mask = batch(seed=13)
    jstep = jax.jit(jtraining.make_ce_step(jm, JAdam(lr=0.05), ("o",), 0.1))
    tstep = training.make_ce_step(tm, Adam(lr=0.05), ("o",), 0.1)
    jstate = jax_state(jm, adam=True, seed=9)
    tstate = state_from_numpy(jax.device_get(jstate), "cpu")
    for _ in range(2):
        jstate, jmet = jstep(jstate, jnp.asarray(pos), jnp.asarray(mask))
        tstate, tmet = tstep(tstate, torch.as_tensor(pos), torch.as_tensor(mask))
        close(tmet.loss, jmet.loss, "loss")
    assert_same_state(tstate, jstate, 2)


def test_transh_selfadv_step_matches_jax():
    jm, tm = models("transh")
    pos, mask = batch(seed=14)
    ids = np.asarray(JShared(N_E, k=K).pool(jax.random.PRNGKey(6), jnp.asarray(pos),
                                            jnp.asarray(mask)))
    jstep = jax.jit(jtraining.make_selfadv_step(
        jm, JAdaGrad(lr=0.1), FixedPool(ids, (0, 1), jnp.asarray), 0.5, alpha=2.0,
        aggregate="dense"))
    tstep = training.make_selfadv_step(
        tm, AdaGrad(lr=0.1), FixedPool(ids, (0, 1), torch.as_tensor), 0.5, alpha=2.0,
        aggregate="dense_pallas")
    jstate = jax_state(jm, seed=10)
    tstate = state_from_numpy(jax.device_get(jstate), "cpu")
    for _ in range(2):
        jstate, jmet = jstep(jstate, jnp.asarray(pos), jnp.asarray(mask))
        tstate, tmet = tstep(tstate, torch.as_tensor(pos), torch.as_tensor(mask))
        close(tmet.loss, jmet.loss, "loss")
    assert_same_state(tstate, jstate, 2)
