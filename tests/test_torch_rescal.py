"""The port's RESCAL (skge_torch/models/rescal.py) against the JAX package's,
in fp64 at 1e-9: triple scores, pool scores and their gradients (modes 0
and 1), the all-entity sweeps, and the model's static metadata.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skge_tpu.models import RESCAL as JRESCAL
from skge_torch.models import MODELS, RESCAL

torch.set_num_threads(1)

N_E, N_R, D, B, K = 31, 5, 12, 9, 13
TOL = dict(rtol=1e-9, atol=1e-9)


def make_inputs(seed=0):
    rng = np.random.default_rng(seed)
    E = rng.normal(size=(N_E, D)) * 0.5
    W = rng.normal(size=(N_R, D, D)) * 0.3
    s, o, p = rng.integers(0, N_E, B), rng.integers(0, N_E, B), rng.integers(0, N_R, B)
    rows = {"es": E[s], "eo": E[o], "wp": W[p]}
    pool = rng.normal(size=(K, D)) * 0.5
    weights = rng.normal(size=(B, K))
    return {"E": E, "W": W}, (s, o, p), rows, pool, weights


def models(rparam=0.0):
    return (JRESCAL(N_E, N_R, D, dtype="float64", rparam=rparam),
            RESCAL(N_E, N_R, D, dtype="float64", rparam=rparam))


def t(x):
    return torch.as_tensor(np.asarray(x))


def test_triple_scores_and_grads_match_jax():
    jm, tm = models()
    _, _, rows, _, _ = make_inputs()
    w = np.linspace(-1.0, 2.0, B)

    def jloss(r):
        return jnp.sum(jnp.asarray(w) * jm.score_from_rows(r, {}))

    jrows = {k: jnp.asarray(v) for k, v in rows.items()}
    want_score = jm.score_from_rows(jrows, {})
    want_grads = jax.grad(jloss)(jrows)

    trows = {k: t(v).requires_grad_() for k, v in rows.items()}
    score = tm.score_from_rows(trows, {})
    grads = torch.autograd.grad(torch.sum(t(w) * score), list(trows.values()))
    assert score.shape == (B,) and score.dtype == torch.float64
    np.testing.assert_allclose(score.detach().numpy(), np.asarray(want_score), **TOL)
    for k, g in zip(trows, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_grads[k]), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("mode", [0, 1])
def test_score_pool_values_and_grads_match_jax(mode):
    jm, tm = models()
    _, _, rows, pool, w = make_inputs(seed=1 + mode)

    def jloss(r, pl):
        return jnp.sum(jnp.asarray(w) * jm.score_pool(r, pl, {}, mode))

    jrows = {k: jnp.asarray(v) for k, v in rows.items()}
    want = jm.score_pool(jrows, jnp.asarray(pool), {}, mode)
    want_gr, want_gp = jax.grad(jloss, argnums=(0, 1))(jrows, jnp.asarray(pool))

    trows = {k: t(v).requires_grad_() for k, v in rows.items()}
    tpool = t(pool).requires_grad_()
    got = tm.score_pool(trows, tpool, {}, mode)
    assert got.shape == (B, K)
    grads = torch.autograd.grad(torch.sum(t(w) * got), [*trows.values(), tpool],
                                materialize_grads=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for k, g in zip(trows, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_gr[k]), **TOL,
                                   err_msg=k)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(want_gp), **TOL)


@pytest.mark.parametrize("direction", ["o", "s"])
def test_score_all_matches_jax(direction):
    jm, tm = models()
    prm, (s, o, p), _, _, _ = make_inputs(seed=3)
    jprm = {k: jnp.asarray(v) for k, v in prm.items()}
    tprm = {k: t(v) for k, v in prm.items()}
    if direction == "o":
        want = jm.score_all_o(jprm, jnp.asarray(s), jnp.asarray(p))
        got = tm.score_all_o(tprm, t(s), t(p))
    else:
        want = jm.score_all_s(jprm, jnp.asarray(o), jnp.asarray(p))
        got = tm.score_all_s(tprm, t(o), t(p))
    assert got.shape == (B, N_E)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("rparam", [0.0, 0.02])
def test_static_metadata_matches_jax(rparam):
    jm, tm = models(rparam)
    assert tm.slot_spec() == jm.slot_spec()
    assert tm.reg_row_params == jm.reg_row_params == ("E", "W")
    assert tm.regularization == jm.regularization == rparam
    assert tm.factored_pool_grads and jm.factored_pool_grads
    assert tm.pairwise_af == jm.pairwise_af == "linear"
    assert (tm.num_rows("E"), tm.num_rows("W")) == (N_E, N_R)
    assert MODELS["rescal"] is RESCAL
    rows = torch.ones(2, D, D)
    assert tm.reg_grad_rows("W", rows) is rows


def test_init_params_shapes_and_bounds():
    tm = RESCAL(N_E, N_R, D)
    prm = tm.init_params(torch.Generator().manual_seed(0))
    assert prm["E"].shape == (N_E, D) and prm["W"].shape == (N_R, D, D)
    assert all(v.dtype == torch.float32 for v in prm.values())
    # nunif's bound uses the first two axes, as in the JAX package
    assert float(prm["E"].abs().max()) <= np.sqrt(6.0) / np.sqrt(N_E + D)
    assert float(prm["W"].abs().max()) <= np.sqrt(6.0) / np.sqrt(N_R + D)
    again = tm.init_params(torch.Generator().manual_seed(0))
    assert all(torch.equal(prm[k], again[k]) for k in prm)
