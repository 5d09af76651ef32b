"""One step of the port's self-adversarial, full-CE and sampled-CE
factories (skge_torch/training.py) against the JAX package's, and
`apply_gradients(combine="sum")`, fp64 at 1e-9, from warm optimizer state
and an injected pool.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skge_tpu import training as jtraining
from skge_tpu.optim import AdaGrad as JAdaGrad
from skge_tpu.optim import Adam as JAdam
from skge_tpu.optim import make_schedule as jmake_schedule
from skge_torch import AdaGrad, Adam, make_schedule, training
from skge_torch.convert import params_from_numpy
from skge_torch.ops.aggregate import FactoredOcc
from test_torch_losses import D, MODELS, close, inputs, jparams, jx, th

torch.set_num_threads(1)


class JFixedPool:
    modes = (0, 1)

    def __init__(self, ids):
        self.ids = jx(ids)

    def pool(self, key, pos, mask):
        return self.ids


class TFixedPool:
    modes = (0, 1)

    def __init__(self, ids):
        self.ids = th(ids)

    def pool(self, generator, pos, mask):
        return self.ids


def _states(params, seed):
    """AdaGrad with warm accumulators, Adam with warm moments and per-row
    counts that differ."""
    rng = np.random.default_rng(seed)
    p2 = {k: rng.random(v.shape) for k, v in params.items()}
    adam = {k: {"m": rng.normal(size=v.shape) * 0.1, "v": rng.random(v.shape),
                "t": rng.integers(0, 5, v.shape[0]).astype(np.float64)}
            for k, v in params.items()}
    return {"adagrad": {k: {"p2": v} for k, v in p2.items()}, "adam": adam}


@pytest.mark.parametrize("factory, name, opt, aggregate", [
    ("selfadv", "hole", "adagrad", "unique"),
    ("selfadv", "hole", "adagrad", "dense_pallas"),
    ("sampled_ce", "rescal", "adam", "unique"),
    ("sampled_ce", "rescal", "adam", "dense_pallas"),
    ("sampled_ce", "transe-l1", "adagrad", "unique"),
    ("sampled_ce", "transe-l1", "adagrad", "dense_pallas"),
    ("ce", "transe-l1", "adam", None),
    ("ce", "ermlp", "adagrad", None),
])
def test_step_matches_jax(factory, name, opt, aggregate):
    """Two steps from warm optimizer state; Adam under a cosine schedule
    with warmup (steps 3 and 4 of 8). JAX's dense aggregate is its XLA
    scatter."""
    jm, tm = (f() for f in MODELS[name])
    jagg = "unique" if aggregate == "unique" else "dense"
    params, pos, pool, mask = inputs(name, seed=6)
    slots = _states(params, 7)[opt]
    if opt == "adam":
        jopt = JAdam(lr=0.05, schedule=jmake_schedule("cosine", 2, 8, 0.1))
        topt = Adam(lr=0.05, schedule=make_schedule("cosine", 2, 8, 0.1))
    else:
        jopt, topt = JAdaGrad(lr=0.1), AdaGrad(lr=0.1)
    if factory == "selfadv":
        jstep = jtraining.make_selfadv_step(jm, jopt, JFixedPool(pool), 0.6, 1.5,
                                            aggregate=jagg)
        tstep = training.make_selfadv_step(tm, topt, TFixedPool(pool), 0.6, 1.5,
                                           aggregate=aggregate)
    elif factory == "sampled_ce":
        jstep = jtraining.make_sampled_ce_step(jm, jopt, JFixedPool(pool),
                                               label_smoothing=0.1, aggregate=jagg)
        tstep = training.make_sampled_ce_step(tm, topt, TFixedPool(pool),
                                              label_smoothing=0.1, aggregate=aggregate)
    else:
        jstep = jtraining.make_ce_step(jm, jopt, ("o", "s"), 0.1)
        tstep = training.make_ce_step(tm, topt, ("o", "s"), 0.1)
    jstep = jax.jit(jstep)
    jstate = jtraining.TrainState(
        jparams(params),
        {k: {s: jx(v) for s, v in sl.items()} for k, sl in slots.items()},
        jax.random.PRNGKey(0), jnp.asarray(3, jnp.int32))
    tstate = training.TrainState(
        params_from_numpy(params, "cpu"),
        {k: params_from_numpy(sl, "cpu") for k, sl in slots.items()},
        torch.Generator(), 3)
    for _ in range(2):
        jstate, jmet = jstep(jstate, jx(pos), jx(mask))
        tstate, tmet = tstep(tstate, th(pos), th(mask))
        close(tmet.loss, jmet.loss, "loss")
    assert tstate.step == int(jstate.step) == 5
    for k in params:
        close(tstate.params[k], jstate.params[k], k)
        for s in slots[k]:
            close(tstate.opt_state[k][s], jstate.opt_state[k][s], f"{k} {s}")


@pytest.mark.parametrize("aggregate", ["unique", "dense_pallas"])
def test_apply_gradients_sum_matches_jax(aggregate):
    """Duplicate ids add up; masked occurrences add nothing; RESCAL's W as a
    factored occurrence list."""
    jm, tm = (f() for f in MODELS["rescal"])
    params, _, _, _ = inputs("rescal", seed=8)
    rng = np.random.default_rng(9)
    t = 17
    idx = rng.integers(0, 6, t)
    g = rng.normal(size=(t, D))
    cnt = rng.integers(0, 3, t).astype(np.float64)
    widx = rng.integers(0, 3, 5)
    us = [rng.normal(size=(5, D)) for _ in range(2)]
    vs = [rng.normal(size=(5, D)) for _ in range(2)]
    wcnt = np.array([1.0, 0.0, 2.0, 1.0, 1.0])
    p2 = {k: rng.random(v.shape) for k, v in params.items()}
    jocc = {"E": (jx(idx), jx(g), jx(cnt)),
            "W": jtraining.FactoredOcc(jx(widx), tuple(map(jx, us)), tuple(map(jx, vs)),
                                       jx(wcnt))}
    tocc = {"E": (th(idx), th(g), th(cnt)),
            "W": FactoredOcc(th(widx), tuple(map(th, us)), tuple(map(th, vs)), th(wcnt))}
    jp, js = jax.jit(lambda *a: jtraining.apply_gradients(
        jm, JAdaGrad(lr=0.1), *a, {}, "unique" if aggregate == "unique" else "dense",
        premasked=True, combine="sum"))(
        jparams(params), {k: {"p2": jx(v)} for k, v in p2.items()}, jocc)
    tp, ts = training.apply_gradients(
        tm, AdaGrad(lr=0.1), params_from_numpy(params, "cpu"),
        {k: {"p2": th(v)} for k, v in p2.items()}, tocc, {},
        aggregate, premasked=True, combine="sum")
    for k in params:
        close(tp[k], jp[k], k)
        close(ts[k]["p2"], js[k]["p2"], k)
    # a summed row differs from the averaged one where a row repeats
    mp, _ = training.apply_gradients(
        tm, AdaGrad(lr=0.1), params_from_numpy(params, "cpu"),
        {k: {"p2": th(v)} for k, v in p2.items()}, tocc, {}, aggregate, premasked=True)
    assert not torch.equal(mp["E"], tp["E"])
