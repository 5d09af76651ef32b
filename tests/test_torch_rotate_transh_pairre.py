"""The port's RotatE, TransH and PairRE (skge_torch/models/) against the JAX
package's, fp64 at 1e-9:

- triple scores and their row gradients (autograd against `jax.grad`);
- pool scores for each mode with gradients, `score_pool_modes`, and the
  all-entity sweeps with `score_triples`;
- scores over stacked (n, B, ·) rows, as the fused iid step gives them;
- TransH's normal at its 1e-12 floor (the gradient of the tie);
- RotatE's phases outside `rparam`, and its three inits;
- the static metadata and the init shapes.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skge_tpu.models import MODELS as JMODELS
from skge_torch import MODELS, training
from skge_torch.convert import params_from_numpy

torch.set_num_threads(1)

N_E, N_R, D, B, K = 19, 4, 6, 7, 9
TOL = dict(rtol=1e-9, atol=1e-11)
NAMES = ("rotate", "transh", "pairre")
# (entity width, relation tables and their widths) over ncomp
WIDTHS = {"rotate": (2, {"R": 1}), "transh": (1, {"R": 1, "W": 1}),
          "pairre": (1, {"R": 2})}


def t(x):
    return torch.as_tensor(np.asarray(x))


def models(name):
    kw = {"rparam": 0.01} if name == "rotate" else {}
    return (JMODELS[name](N_E, N_R, D, dtype="float64", **kw),
            MODELS[name](N_E, N_R, D, dtype="float64", **kw))


def make_params(name, seed=0):
    rng = np.random.default_rng(seed)
    we, rel = WIDTHS[name]
    prm = {"E": rng.normal(size=(N_E, we * D)) * 0.5}
    for k, w in rel.items():
        prm[k] = rng.normal(size=(N_R, w * D)) * (1.5 if name == "rotate" else 0.5)
    return prm


def make_rows(name, seed=1):
    prm = make_params(name, seed)
    rng = np.random.default_rng(seed + 100)
    s, o, p = rng.integers(0, N_E, B), rng.integers(0, N_E, B), rng.integers(0, N_R, B)
    rows = {"es": prm["E"][s], "eo": prm["E"][o], "rp": prm["R"][p]}
    if name == "transh":
        rows["wp"] = prm["W"][p]
    pool = rng.normal(size=(K, prm["E"].shape[1])) * 0.5
    return prm, (s, o, p), rows, pool


def leaves(d):
    return {k: t(v).requires_grad_() for k, v in d.items()}


def jx(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize("name", NAMES)
def test_triple_scores_and_row_grads_match_jax(name):
    jm, tm = models(name)
    _, _, rows, _ = make_rows(name)
    w = np.linspace(-1.0, 2.0, B)
    want = jm.score_from_rows(jx(rows), {})
    want_g = jax.jit(jax.grad(
        lambda r: jnp.sum(jnp.asarray(w) * jm.score_from_rows(r, {}))))(jx(rows))
    trows = leaves(rows)
    got = tm.score_from_rows(trows, {})
    grads = torch.autograd.grad(torch.sum(t(w) * got), list(trows.values()))
    assert got.shape == (B,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for k, g in zip(trows, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g[k]), **TOL, err_msg=k)


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("name", NAMES)
def test_score_pool_values_and_grads_match_jax(name, mode):
    jm, tm = models(name)
    _, _, rows, pool = make_rows(name, seed=4 + mode)
    w = np.random.default_rng(mode).normal(size=(B, K))
    want = jm.score_pool(jx(rows), jnp.asarray(pool), {}, mode)
    want_g = jax.jit(jax.grad(
        lambda r, pl: jnp.sum(jnp.asarray(w) * jm.score_pool(r, pl, {}, mode)),
        argnums=(0, 1)))(jx(rows), jnp.asarray(pool))
    trows, tpool = leaves(rows), t(pool).requires_grad_()
    got = tm.score_pool(trows, tpool, {}, mode)
    assert got.shape == (B, K)
    grads = torch.autograd.grad(torch.sum(t(w) * got), [*trows.values(), tpool],
                                materialize_grads=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for g, wg in zip(grads, [*(want_g[0][k] for k in trows), want_g[1]]):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_score_pool_modes_match_jax(name):
    jm, tm = models(name)
    _, _, rows, pool = make_rows(name, seed=7)
    want = jm.score_pool_modes(jx(rows), jnp.asarray(pool), {}, (0, 1))
    got = tm.score_pool_modes({k: t(v) for k, v in rows.items()}, t(pool), {}, (0, 1))
    assert len(got) == 2
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), **TOL)


@pytest.mark.parametrize("direction", ["o", "s"])
@pytest.mark.parametrize("name", NAMES)
def test_score_all_and_score_triples_match_jax(name, direction):
    jm, tm = models(name)
    prm, (s, o, p), _, _ = make_rows(name, seed=6)
    jprm, tprm = jx(prm), params_from_numpy(prm, "cpu")
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


@pytest.mark.parametrize("slot", ["es", "eo", "rp"])
@pytest.mark.parametrize("name", NAMES)
def test_scores_broadcast_over_stacked_rows(name, slot):
    """A (n, B, ·) stack of one slot's rows scores as n separate batches."""
    _, tm = models(name)
    _, _, rows, _ = make_rows(name, seed=2)
    trows = {k: t(v) for k, v in rows.items()}
    stack = t(np.random.default_rng(3).normal(size=(4, B, rows[slot].shape[1])))
    got = tm.score_from_rows({**trows, slot: stack}, {})
    assert got.shape == (4, B)
    for i in range(4):
        want = tm.score_from_rows({**trows, slot: stack[i]}, {})
        np.testing.assert_allclose(got[i].numpy(), want.numpy(), **TOL)


def test_transh_unit_floor_matches_jax():
    """TransH's normal held at |w| >= 1e-12 by a maximum: at a tie the
    gradient is split between the two sides, as `jnp.maximum`'s is; below
    the floor the norm gets none."""
    from skge_tpu.models import transh as jtransh
    from skge_torch.models import transh as ttransh

    r = np.random.default_rng(8).normal(size=(3, D))
    r[0] = 0.0
    r[0, 0] = 1e-12  # the floor exactly
    r[1] = 0.0
    r[1, 0] = 4e-13  # below it
    w = np.random.default_rng(9).normal(size=r.shape)
    want = jtransh._unit(jnp.asarray(r))
    want_g = jax.grad(lambda x: jnp.sum(jnp.asarray(w) * jtransh._unit(x)))(jnp.asarray(r))
    tr = t(r).requires_grad_()
    got = ttransh._unit(tr)
    (g,) = torch.autograd.grad(torch.sum(t(w) * got), [tr])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), **TOL)
    # the tie's share: d(a / max(|a|, eps))/da = 1/eps - a * 0.5 / eps^2
    assert float(g[0, 0] / t(w)[0, 0]) == pytest.approx(0.5e12, rel=1e-9)


def test_rotate_regularizes_entities_only():
    """`rparam` adds rparam * row to E's gradient rows and leaves the
    phases alone, in the port's `regularized` as in the JAX package."""
    jm, tm = models("rotate")
    assert tm.reg_row_params == jm.reg_row_params == ("E",)
    assert tm.regularization == jm.regularization == 0.01
    rng = np.random.default_rng(10)
    for pname, width in (("E", 2 * D), ("R", D)):
        g, rows = t(rng.normal(size=(5, width))), t(rng.normal(size=(5, width)))
        want = g + 0.01 * rows if pname == "E" else g
        np.testing.assert_array_equal(training.regularized(tm, pname, g, rows).numpy(),
                                      want.numpy())


@pytest.mark.parametrize("kw, e_bound, r_bound", [
    ({}, math.sqrt(6.0 / (N_E + 2 * D)), math.pi),
    ({"phase_init": "nunif"}, math.sqrt(6.0 / (N_E + 2 * D)), math.sqrt(6.0 / (40 + D))),
    ({"gamma_init": 4.0}, 6.0 / D, math.pi),
])
def test_rotate_inits(kw, e_bound, r_bound):
    """Uniform phases U(-pi, pi) by default, nunif phases on request, and
    the paper's gamma-coupled entity range; the JAX package's shapes."""
    jm = JMODELS["rotate"](N_E, 40, D, **kw)
    tm = MODELS["rotate"](N_E, 40, D, **kw)
    prm = tm.init_params(torch.Generator().manual_seed(0))
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    for k, v in shapes.items():
        assert prm[k].shape == v.shape and prm[k].dtype == torch.float32, k
    assert float(prm["E"].abs().max()) <= e_bound
    assert float(prm["R"].abs().max()) <= r_bound
    # 40 x 6 phases spread over most of their range
    assert float(prm["R"].abs().max()) > 0.8 * r_bound
    with pytest.raises(ValueError, match="phase_init"):
        MODELS["rotate"](N_E, N_R, D, phase_init="other").init_params(torch.Generator())


@pytest.mark.parametrize("name", NAMES)
def test_static_metadata_and_init(name):
    jm, tm = models(name)
    assert tm.name == jm.name == name
    assert MODELS[name] is type(tm)
    assert tm.slot_spec() == jm.slot_spec()
    assert tm.reg_row_params == jm.reg_row_params
    assert tm.regularization == jm.regularization
    assert tm.dense_param_names == jm.dense_param_names == ()
    assert tm.pairwise_af == jm.pairwise_af
    assert tm.post_constraints == jm.post_constraints
    prm = tm.init_params(torch.Generator().manual_seed(0))
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    assert set(prm) == set(shapes)
    for k, v in shapes.items():
        assert prm[k].shape == v.shape and prm[k].dtype == torch.float64, k
