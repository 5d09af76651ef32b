"""The port's generic iid gradient paths (skge_torch/training.py), the
expanded pair list of `pairwise_grads` and the appended negatives of
`pointwise_grads`, against the JAX package's, fp64 at 1e-9 with identical
occurrence counts, for the models of `tests/test_parity.py`; and the fused
and generic train steps against each other.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skge_tpu import training as jtraining
from skge_torch import AdaGrad, TrainState, make_pairwise_step, training
from skge_torch.convert import params_from_numpy
from test_parity import B, CASES, N_E, N_R, make_batch
from test_torch_fused import (MARGIN, TOL, assert_same_update, batch_mask, jax_apply,
                              start, t, torch_apply)

torch.set_num_threads(1)


@pytest.mark.parametrize("aggregate", ["unique", "dense_pallas"])
@pytest.mark.parametrize("case", list(CASES))
def test_generic_pairwise_grads_match_jax(case, aggregate):
    jm, tm, prm, p2 = start(case, seed=1)
    pos = make_batch(seed=19)
    neg = make_batch(seed=20)
    neg[:, 2] = pos[:, 2]
    mask = np.where(np.random.default_rng(21).random(B) < 0.8, 1.0, 0.0)
    jl, jn, jocc, jg = jtraining.pairwise_grads(
        jm, {k: jnp.asarray(v) for k, v in prm.items()}, jnp.asarray(pos),
        jnp.asarray(neg), jnp.asarray(mask), MARGIN,
    )
    tl, tn, tocc, tg = training.pairwise_grads(
        tm, params_from_numpy(prm, "cpu"), t(pos), t(neg), t(mask), MARGIN
    )
    assert int(tn) == int(jn) > 0
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-9)
    assert_same_update(
        jm, jax_apply(jm, prm, p2, jocc, jg, aggregate, False),
        torch_apply(tm, prm, p2, tocc, tg, aggregate, False), jocc, tocc,
    )


@pytest.mark.parametrize("aggregate", ["unique", "dense_pallas"])
@pytest.mark.parametrize("case", list(CASES))
def test_pointwise_grads_match_jax(case, aggregate):
    jm, tm, prm, p2 = start(case, seed=2)
    rng = np.random.default_rng(22)
    triples = make_batch(seed=23)
    ys = np.where(rng.random(B) < 0.5, 1.0, -1.0)
    mask = np.where(rng.random(B) < 0.8, 1.0, 0.0)
    jl, jocc, jg = jtraining.pointwise_grads(
        jm, {k: jnp.asarray(v) for k, v in prm.items()}, jnp.asarray(triples),
        jnp.asarray(ys), jnp.asarray(mask),
    )
    tl, tocc, tg = training.pointwise_grads(
        tm, params_from_numpy(prm, "cpu"), t(triples), t(ys), t(mask)
    )
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-9)
    assert_same_update(
        jm, jax_apply(jm, prm, p2, jocc, jg, aggregate, False),
        torch_apply(tm, prm, p2, tocc, tg, aggregate, False), jocc, tocc,
    )


def port_sampler(name):
    """Each iid sampler of the port over a small training set of the
    parity sizes."""
    from skge_torch import (BernoulliSampler, CorruptedSampler, LCWASampler,
                            RandomModeSampler)
    from skge_torch.data import bernoulli_probs, encode_keys_np, type_index_arrays

    train = make_batch(seed=30, b=60)
    if name == "random-mode":
        return RandomModeSampler(N_E, modes=(0, 1, 1))
    if name == "bernoulli":
        return BernoulliSampler(N_E, t(bernoulli_probs(train, N_R)))
    if name == "lcwa":
        keys = np.sort(encode_keys_np(train, N_E, N_R))
        return LCWASampler(N_E, N_R, t(keys), ntries=3)
    return CorruptedSampler(N_E, *map(t, type_index_arrays(train, N_R)))


@pytest.mark.parametrize("case, sampler", [
    ("transe", "random-mode"), ("hole", "random-mode"), ("hole", "lcwa"),
    ("ermlp", "bernoulli"), ("rescal", "corrupted"), ("transe_l2", "bernoulli"),
])
def test_fused_step_equals_generic_step(case, sampler):
    """The same generator seed: `make_pairwise_step(fused=True)` and
    `fused=False` draw the same negatives and take the same 3 steps."""
    _, tm, prm, _ = start(case, seed=4)
    smp = port_sampler(sampler)
    pos, mask = t(make_batch(seed=31)), t(batch_mask())
    outs = {}
    for fused in (True, False):
        step = make_pairwise_step(tm, AdaGrad(lr=0.1), smp, MARGIN,
                                  aggregate="dense_pallas", fused=fused)
        params = params_from_numpy(prm, "cpu")
        state = TrainState(params, AdaGrad(lr=0.1).init(params),
                           torch.Generator().manual_seed(5), 0)
        nviol = []
        for _ in range(3):
            state, m = step(state, pos, mask)
            nviol.append(int(m.nviolations))
        outs[fused] = state, nviol
    assert outs[True][1] == outs[False][1] and sum(outs[True][1]) > 0
    for k in prm:
        np.testing.assert_allclose(outs[True][0].params[k].numpy(),
                                   outs[False][0].params[k].numpy(), **TOL, err_msg=k)
