"""The port's TransE (skge_torch/models/transe.py) against the JAX package's,
in fp64 at 1e-9: triple scores, pool scores and their gradients (L1 and
L2, modes 0 and 1), and the all-entity sweeps. The inputs hold exact-zero
differences, where |x|'s gradient must be +1 as under jax.grad.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skge_tpu.models import TransE as JTransE
from skge_torch.models import TransE
from skge_torch.models import transe as ttransE

torch.set_num_threads(1)

N_E, N_R, D, B, K = 31, 5, 12, 9, 13
TOL = dict(rtol=1e-9, atol=1e-9)


def make_inputs(seed=0):
    rng = np.random.default_rng(seed)
    E = rng.normal(size=(N_E, D)) * 0.5
    R = rng.normal(size=(N_R, D)) * 0.5
    s, o, p = rng.integers(0, N_E, B), rng.integers(0, N_E, B), rng.integers(0, N_R, B)
    rows = {"es": E[s], "eo": E[o], "rp": R[p]}
    # exact zeros: triple 0 has es + rp - eo == 0; pool row 0 equals the
    # mode-1 query of positive 1, pool row 1 the mode-0 query of positive 2
    rows["eo"][0] = rows["es"][0] + rows["rp"][0]
    pool = rng.normal(size=(K, D)) * 0.5
    pool[0] = rows["es"][1] + rows["rp"][1]
    pool[1] = rows["eo"][2] - rows["rp"][2]
    weights = rng.normal(size=(B, K))
    return {"E": E, "R": R}, (s, o, p), rows, pool, weights


def models(l1):
    return (JTransE(N_E, N_R, D, dtype="float64", l1=l1),
            TransE(N_E, N_R, D, dtype="float64", l1=l1))


def t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("l1", [True, False])
def test_triple_scores_and_grads_match_jax(l1):
    jm, tm = models(l1)
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
    np.testing.assert_allclose(score.detach().numpy(), np.asarray(want_score), **TOL)
    for k, g in zip(trows, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_grads[k]), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("l1", [True, False])
def test_score_pool_values_and_grads_match_jax(l1, mode, monkeypatch):
    monkeypatch.setattr(ttransE, "POOL_CHUNK", 5)  # ragged chunks of the pool
    jm, tm = models(l1)
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
@pytest.mark.parametrize("l1", [True, False])
def test_score_all_matches_jax(l1, direction, monkeypatch):
    monkeypatch.setattr(ttransE, "ALL_CHUNK", 7)  # ragged chunks of the entities
    jm, tm = models(l1)
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


def test_l1_gradient_at_zero_is_plus_one():
    """jax.grad(jnp.abs) is +1 at 0 and torch.abs's backward is 0; the port
    follows JAX."""
    x = torch.zeros(3, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(ttransE._abs(x).sum(), [x])
    want = jax.grad(lambda v: jnp.abs(v).sum())(jnp.zeros(3))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    np.testing.assert_array_equal(g.numpy(), np.ones(3))


def test_init_params_shapes_and_bounds():
    tm = TransE(N_E, N_R, D)
    prm = tm.init_params(torch.Generator().manual_seed(0))
    bnd = np.sqrt(6.0) / np.sqrt(N_E + D)
    assert prm["E"].shape == (N_E, D) and prm["R"].shape == (N_R, D)
    assert prm["E"].dtype == torch.float32
    assert float(prm["E"].abs().max()) <= bnd
    again = tm.init_params(torch.Generator().manual_seed(0))
    assert all(torch.equal(prm[k], again[k]) for k in prm)
