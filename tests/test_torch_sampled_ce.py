"""The port's sampled cross-entropy gradients
(`skge_torch.training.sampled_ce_grads_shared`) against the JAX package's,
fp64 at 1e-9, for TransE-L1, TransE-L2, RESCAL, HolE and ER-MLP, with and
without a proposal `log_q`, padded rows and a pool that holds labels; and
over the pool `arange(n_e)` against the port's own full CE (the identity
tests/test_sampled_ce.py pins in JAX).
"""

import numpy as np
import pytest
import torch

from skge_tpu import training as jtraining
from skge_torch import training
from skge_torch.convert import params_from_numpy
from test_torch_losses import (MODELS, N_E, assert_same_occ, close, inputs, jit_call,
                               jparams, jx, th)

torch.set_num_threads(1)


@pytest.mark.parametrize("with_log_q, ls", [(False, 0.0), (True, 0.1)])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_sampled_ce_grads_match_jax(name, with_log_q, ls):
    """The pool holds the first positive's object and subject: their
    logits are -inf, with a zero (not NaN) gradient."""
    jm, tm = (f() for f in MODELS[name])
    params, pos, pool, mask = inputs(name, seed=3)
    log_q = None
    if with_log_q:
        q = np.random.default_rng(4).random(N_E) + 0.1
        log_q = np.log(q / q.sum())[pool]
    jl, jocc, jgd = jit_call(
        lambda p, a, b, c, lq: jtraining.sampled_ce_grads_shared(
            jm, p, a, b, c, label_smoothing=ls, log_q=lq),
        jparams(params), jx(pos), jx(pool), jx(mask),
        None if log_q is None else jx(log_q))
    tl, tocc, tgd = training.sampled_ce_grads_shared(
        tm, params_from_numpy(params, "cpu"), th(pos), th(pool), th(mask),
        label_smoothing=ls, log_q=None if log_q is None else th(log_q))
    assert np.isfinite(float(tl))
    for idx, g, c in tocc.values():
        assert bool(torch.isfinite(g).all())
    close(tl, jl, "loss")
    assert_same_occ(tocc, jocc)
    for k in jgd:
        close(tgd[k], jgd[k], k)


def _table(occ, gd, params):
    """Occurrence gradients summed into full tables."""
    out = {k: torch.zeros_like(v) for k, v in params.items()}
    for p, (idx, g, _) in occ.items():
        out[p].index_add_(0, idx, g)
    for p, g in gd.items():
        out[p] = out[p] + g
    return out


@pytest.mark.parametrize("directions, ls", [(("o", "s"), 0.0), (("o",), 0.1)])
@pytest.mark.parametrize("name", ["transe-l2", "rescal", "ermlp"])
def test_sampled_ce_over_every_entity_is_full_ce(name, directions, ls):
    _, tm = MODELS[name]
    tm = tm()
    params, pos, _, mask = inputs(name, seed=5)
    params = params_from_numpy(params, "cpu")
    sl, socc, sgd = training.sampled_ce_grads_shared(
        tm, params, th(pos), torch.arange(N_E), th(mask), directions, ls)
    cl, cg = training.ce_grads_all(tm, params, th(pos), th(mask), directions, ls)
    close(sl, cl, "loss")
    got = _table(socc, sgd, params)
    for k in cg:
        close(got[k], cg[k], k)
