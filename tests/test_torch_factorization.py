"""The port's factorization family (skge_torch/models/: DistMult, ComplEx,
SimplE, TuckER, QuatE) against the JAX package's, fp64 at 1e-9:

- triple, pool (modes 0 and 1) and all-entity scores, with gradients;
- scores over stacked (n, B, ·) rows, as the fused iid step gives them;
- QuatE's relation norm at its 1e-12 floor (the gradient of the tie);
- the static metadata and the init shapes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skge_tpu.models import MODELS as JMODELS
from skge_torch import MODELS
from skge_torch.convert import params_from_numpy

torch.set_num_threads(1)

N_E, N_R, D, RC, B, K = 19, 4, 6, 5, 7, 9
TOL = dict(rtol=1e-9, atol=1e-11)
NAMES = ("distmult", "complex", "simple", "tucker", "quate")
# row width over ncomp: ComplEx and SimplE hold two halves, QuatE four blocks
WIDTH = {"complex": 2, "simple": 2, "quate": 4}


def t(x):
    return torch.as_tensor(np.asarray(x))


def models(name):
    kw = {"rcomp": RC} if name == "tucker" else {}
    return (JMODELS[name](N_E, N_R, D, dtype="float64", rparam=0.01, n3=0.02, **kw),
            MODELS[name](N_E, N_R, D, dtype="float64", rparam=0.01, n3=0.02, **kw))


def make_params(name, seed=0):
    rng = np.random.default_rng(seed)
    w = WIDTH.get(name, 1) * D
    prm = {"E": rng.normal(size=(N_E, w)) * 0.5,
           "R": rng.normal(size=(N_R, RC if name == "tucker" else w)) * 0.5}
    if name == "tucker":
        prm["W"] = rng.normal(size=(RC, D, D)) * 0.3
    return prm


def make_rows(name, seed=1):
    prm = make_params(name, seed)
    rng = np.random.default_rng(seed + 100)
    s, o, p = rng.integers(0, N_E, B), rng.integers(0, N_E, B), rng.integers(0, N_R, B)
    rows = {"es": prm["E"][s], "eo": prm["E"][o], "rp": prm["R"][p]}
    dense = {"W": prm["W"]} if name == "tucker" else {}
    pool = rng.normal(size=(K, prm["E"].shape[1])) * 0.5
    return prm, (s, o, p), rows, dense, pool


def leaves(d):
    return {k: t(v).requires_grad_() for k, v in d.items()}


@pytest.mark.parametrize("name", NAMES)
def test_triple_scores_and_grads_match_jax(name):
    jm, tm = models(name)
    _, _, rows, dense, _ = make_rows(name)
    w = np.linspace(-1.0, 2.0, B)
    jrows = {k: jnp.asarray(v) for k, v in rows.items()}
    jdense = {k: jnp.asarray(v) for k, v in dense.items()}
    want = jm.score_from_rows(jrows, jdense)
    want_gr, want_gd = jax.jit(jax.grad(
        lambda r, dn: jnp.sum(jnp.asarray(w) * jm.score_from_rows(r, dn)),
        argnums=(0, 1)))(jrows, jdense)
    trows, tdense = leaves(rows), leaves(dense)
    got = tm.score_from_rows(trows, tdense)
    grads = torch.autograd.grad(torch.sum(t(w) * got), [*trows.values(), *tdense.values()])
    assert got.shape == (B,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for k, g in zip([*trows, *tdense], grads):
        want_g = want_gr[k] if k in want_gr else want_gd[k]
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g), **TOL, err_msg=k)


@pytest.mark.parametrize("slot", ["es", "eo", "rp"])
@pytest.mark.parametrize("name", NAMES)
def test_scores_broadcast_over_stacked_rows(name, slot):
    """A (n, B, ·) stack of rows scores as n separate batches; TuckER
    flattens the leading axes of its relation rows and restores them."""
    _, tm = models(name)
    _, _, rows, dense, _ = make_rows(name, seed=2)
    trows = {k: t(v) for k, v in rows.items()}
    tdense = {k: t(v) for k, v in dense.items()}
    stack = t(np.random.default_rng(3).normal(size=(4, B, rows[slot].shape[1])))
    got = tm.score_from_rows({**trows, slot: stack}, tdense)
    assert got.shape == (4, B)
    for i in range(4):
        want = tm.score_from_rows({**trows, slot: stack[i]}, tdense)
        np.testing.assert_allclose(got[i].numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("name", NAMES)
def test_score_pool_values_and_grads_match_jax(name, mode):
    jm, tm = models(name)
    _, _, rows, dense, pool = make_rows(name, seed=4 + mode)
    w = np.random.default_rng(mode).normal(size=(B, K))
    args = ({k: jnp.asarray(v) for k, v in rows.items()}, jnp.asarray(pool),
            {k: jnp.asarray(v) for k, v in dense.items()})
    want = jm.score_pool(*args, mode)
    want_g = jax.jit(jax.grad(
        lambda r, pl, dn: jnp.sum(jnp.asarray(w) * jm.score_pool(r, pl, dn, mode)),
        argnums=(0, 1, 2)))(*args)
    trows, tpool, tdense = leaves(rows), t(pool).requires_grad_(), leaves(dense)
    got = tm.score_pool(trows, tpool, tdense, mode)
    assert got.shape == (B, K)
    grads = torch.autograd.grad(torch.sum(t(w) * got),
                                [*trows.values(), tpool, *tdense.values()],
                                materialize_grads=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    wants = [*(want_g[0][k] for k in trows), want_g[1], *(want_g[2][k] for k in tdense)]
    for g, wg in zip(grads, wants):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **TOL)


@pytest.mark.parametrize("direction", ["o", "s"])
@pytest.mark.parametrize("name", NAMES)
def test_score_all_and_score_triples_match_jax(name, direction):
    jm, tm = models(name)
    prm, (s, o, p), _, _, _ = make_rows(name, seed=6)
    jprm = {k: jnp.asarray(v) for k, v in prm.items()}
    tprm = params_from_numpy(prm, "cpu")
    if direction == "o":
        want = jm.score_all_o(jprm, jnp.asarray(s), jnp.asarray(p))
        got = tm.score_all_o(tprm, t(s), t(p))
    else:
        want = jm.score_all_s(jprm, jnp.asarray(o), jnp.asarray(p))
        got = tm.score_all_s(tprm, t(o), t(p))
    assert got.shape == (B, N_E)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    triples = np.stack([s, o, p], axis=1)
    np.testing.assert_allclose(tm.score_triples(tprm, t(triples)).numpy(),
                               np.asarray(jm.score_triples(jprm, jnp.asarray(triples))),
                               **TOL)


def test_quate_norm_floor_matches_jax():
    """QuatE's relation norm held at 1e-12 by a maximum: at a tie the
    gradient is split between the two sides, as `jnp.maximum`'s is (a
    clamp would give all of it to the norm); below the floor the norm
    gets none."""
    jm, tm = models("quate")
    r = np.random.default_rng(8).normal(size=(3, 4 * D))
    r[0, 0::D] = [1e-12, 0.0, 0.0, 0.0]  # the floor exactly
    r[1, 0::D] = [4e-13, 0.0, 0.0, 0.0]  # below it
    w = np.random.default_rng(9).normal(size=r.shape)
    want = jm._unit(jnp.asarray(r))
    want_g = jax.grad(lambda x: jnp.sum(jnp.asarray(w) * jm._unit(x)))(jnp.asarray(r))
    tr = t(r).requires_grad_()
    got = tm._unit(tr)
    (g,) = torch.autograd.grad(torch.sum(t(w) * got), [tr])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), **TOL)
    # the tie's share: d(a / max(n, eps))/da = 1/eps - a * 0.5 / eps^2
    assert float(g[0, 0] / t(w)[0, 0]) == pytest.approx(0.5e12, rel=1e-9)


@pytest.mark.parametrize("name", NAMES)
def test_static_metadata_and_init(name):
    jm, tm = models(name)
    assert tm.name == jm.name == name
    assert MODELS[name] is type(tm)
    assert tm.slot_spec() == jm.slot_spec()
    assert tm.reg_row_params == jm.reg_row_params
    assert tm.regularization == jm.regularization
    assert tm.regularization_n3 == jm.regularization_n3 == 0.02
    assert tm.dense_param_names == jm.dense_param_names
    assert tm.pairwise_af == jm.pairwise_af
    assert tm.post_constraints == jm.post_constraints == {}
    prm = tm.init_params(torch.Generator().manual_seed(0))
    jprm = jm.init_params(jax.random.PRNGKey(0))
    assert set(prm) == set(jprm)
    for k, v in jprm.items():
        assert prm[k].shape == v.shape and prm[k].dtype == torch.float64, k
        # nunif: the bound of the table's first two axes (the core's is its
        # (rcomp, ncomp^2) flattening)
        shape = (v.shape[0], int(np.prod(v.shape[1:])))
        assert float(prm[k].abs().max()) <= np.sqrt(6.0 / sum(shape)), k
