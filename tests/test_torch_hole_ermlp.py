"""The port's HolE and ER-MLP (skge_torch/models/hole.py, ermlp.py) and
circular correlation (skge_torch/ops/circulant.py) against the JAX
package's, in fp64 at 1e-9:

- cconv/ccorr values and gradients, at an even d (with its Nyquist bin)
  and an odd d;
- triple, pool (modes 0 and 1) and all-entity scores, with gradients;
- one shared-pool step of each model;
- filtered ranking of HolE and ER-MLP;
- ER-MLP's 1-D C through `state_from_numpy`, and the static metadata.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skge_tpu import training as jtraining
from skge_tpu.evaluation import FilteredRankingEval as JEval
from skge_tpu.models import ERMLP as JERMLP
from skge_tpu.models import HolE as JHolE
from skge_tpu.ops import circulant as jcirc
from skge_tpu.optim import AdaGrad as JAdaGrad
from skge_torch import MODELS, ERMLP, AdaGrad, FilteredRankingEval, HolE, training
from skge_torch.convert import params_from_numpy, state_from_numpy
from skge_torch.data import synthetic_kg
from skge_torch.ops import circulant

torch.set_num_threads(1)

N_E, N_R, D, B, K, NH = 29, 5, 12, 9, 11, 7
TOL = dict(rtol=1e-9, atol=1e-11)


def t(x):
    return torch.as_tensor(np.asarray(x))


def models(name):
    if name == "hole":
        return (JHolE(N_E, N_R, D, dtype="float64", rparam=0.01),
                HolE(N_E, N_R, D, dtype="float64", rparam=0.01))
    return (JERMLP(N_E, N_R, D, dtype="float64", nhidden=NH),
            ERMLP(N_E, N_R, D, dtype="float64", nhidden=NH))


def make_params(name, seed=0, n_e=N_E, n_r=N_R, d=D):
    rng = np.random.default_rng(seed)
    prm = {"E": rng.normal(size=(n_e, d)) * 0.5, "R": rng.normal(size=(n_r, d)) * 0.5}
    if name == "ermlp":
        prm["W"] = rng.normal(size=(3 * d, NH)) * 0.3
        prm["C"] = rng.normal(size=(NH,)) * 0.5
    return prm


def make_rows(name, seed=1):
    prm = make_params(name, seed)
    rng = np.random.default_rng(seed + 100)
    s, o, p = rng.integers(0, N_E, B), rng.integers(0, N_E, B), rng.integers(0, N_R, B)
    rows = {"es": prm["E"][s], "eo": prm["E"][o], "rp": prm["R"][p]}
    dense = {k: prm[k] for k in ("W", "C") if k in prm}
    return prm, (s, o, p), rows, dense, rng.normal(size=(K, D)) * 0.5


@pytest.mark.parametrize("d", [16, 15])
@pytest.mark.parametrize("op", ["cconv", "ccorr"])
def test_circulant_values_and_grads_match_jax(op, d):
    rng = np.random.default_rng(d)
    a, b = rng.normal(size=(2, 7, d))
    w = rng.normal(size=(7, d))
    jfn, tfn = getattr(jcirc, op), getattr(circulant, op)
    want = jfn(jnp.asarray(a), jnp.asarray(b))
    want_ga, want_gb = jax.grad(
        lambda x, y: jnp.sum(jnp.asarray(w) * jfn(x, y)), argnums=(0, 1)
    )(jnp.asarray(a), jnp.asarray(b))
    ta, tb = t(a).requires_grad_(), t(b).requires_grad_()
    got = tfn(ta, tb)
    ga, gb = torch.autograd.grad(torch.sum(t(w) * got), [ta, tb])
    assert got.shape == (7, d) and got.dtype == torch.float64
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(ga.numpy(), np.asarray(want_ga), **TOL)
    np.testing.assert_allclose(gb.numpy(), np.asarray(want_gb), **TOL)


@pytest.mark.parametrize("name", ["hole", "ermlp"])
def test_triple_scores_and_grads_match_jax(name):
    jm, tm = models(name)
    _, _, rows, dense, _ = make_rows(name)
    w = np.linspace(-1.0, 2.0, B)
    jrows = {k: jnp.asarray(v) for k, v in rows.items()}
    jdense = {k: jnp.asarray(v) for k, v in dense.items()}
    want = jm.score_from_rows(jrows, jdense)
    want_gr, want_gd = jax.grad(
        lambda r, dn: jnp.sum(jnp.asarray(w) * jm.score_from_rows(r, dn)),
        argnums=(0, 1),
    )(jrows, jdense)
    trows = {k: t(v).requires_grad_() for k, v in rows.items()}
    tdense = {k: t(v).requires_grad_() for k, v in dense.items()}
    got = tm.score_from_rows(trows, tdense)
    grads = torch.autograd.grad(torch.sum(t(w) * got),
                                [*trows.values(), *tdense.values()])
    assert got.shape == (B,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for k, g in zip([*trows, *tdense], grads):
        want_g = want_gr[k] if k in want_gr else want_gd[k]
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g), **TOL, err_msg=k)


@pytest.mark.parametrize("name", ["hole", "ermlp"])
def test_scores_broadcast_over_stacked_rows(name):
    """A (n, B, d) stack of corrupted rows scores as n separate batches."""
    _, tm = models(name)
    _, _, rows, dense, _ = make_rows(name, seed=2)
    trows = {k: t(v) for k, v in rows.items()}
    tdense = {k: t(v) for k, v in dense.items()}
    stack = t(np.random.default_rng(3).normal(size=(4, B, D)))
    for slot in ("es", "eo"):
        got = tm.score_from_rows({**trows, slot: stack}, tdense)
        assert got.shape == (4, B)
        for i in range(4):
            want = tm.score_from_rows({**trows, slot: stack[i]}, tdense)
            np.testing.assert_allclose(got[i].numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("name", ["hole", "ermlp"])
def test_score_pool_values_and_grads_match_jax(name, mode):
    jm, tm = models(name)
    _, _, rows, dense, pool = make_rows(name, seed=4 + mode)
    w = np.random.default_rng(mode).normal(size=(B, K))
    args = ({k: jnp.asarray(v) for k, v in rows.items()}, jnp.asarray(pool),
            {k: jnp.asarray(v) for k, v in dense.items()})
    want = jm.score_pool(*args, mode)
    want_g = jax.grad(
        lambda r, pl, dn: jnp.sum(jnp.asarray(w) * jm.score_pool(r, pl, dn, mode)),
        argnums=(0, 1, 2),
    )(*args)
    trows = {k: t(v).requires_grad_() for k, v in rows.items()}
    tpool = t(pool).requires_grad_()
    tdense = {k: t(v).requires_grad_() for k, v in dense.items()}
    got = tm.score_pool(trows, tpool, tdense, mode)
    assert got.shape == (B, K)
    grads = torch.autograd.grad(torch.sum(t(w) * got),
                                [*trows.values(), tpool, *tdense.values()],
                                materialize_grads=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    wants = [*(want_g[0][k] for k in trows), want_g[1],
             *(want_g[2][k] for k in tdense)]
    for g, wg in zip(grads, wants):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **TOL)


@pytest.mark.parametrize("direction", ["o", "s"])
@pytest.mark.parametrize("name", ["hole", "ermlp"])
def test_score_all_matches_jax(name, direction):
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


def test_ermlp_score_all_chunks_over_entities(monkeypatch):
    """More entities than one chunk: the chunks join in entity order."""
    from skge_torch.models import ermlp

    _, tm = models("ermlp")
    prm, (s, o, p), _, _, _ = make_rows("ermlp", seed=7)
    tprm = params_from_numpy(prm, "cpu")
    want = tm.score_all_o(tprm, t(s), t(p))
    monkeypatch.setattr(ermlp, "ALL_CHUNK", 4)
    np.testing.assert_allclose(tm.score_all_o(tprm, t(s), t(p)).numpy(),
                               want.numpy(), **TOL)


@pytest.mark.parametrize("name", ["hole", "ermlp"])
def test_shared_pool_step_matches_jax(name):
    jm, tm = models(name)
    prm = make_params(name, seed=8)
    rng = np.random.default_rng(9)
    p2 = {k: rng.random(v.shape) for k, v in prm.items()}
    pos = np.stack([rng.integers(0, N_E // 2, B), rng.integers(0, N_E, B),
                    rng.integers(0, N_R, B)], axis=1)
    pool = rng.integers(0, N_E, K)
    mask = np.ones(B)
    mask[-2:] = 0.0
    margin = 0.3
    jprm = {k: jnp.asarray(v) for k, v in prm.items()}
    loss, nviol, occ, g_dense = jtraining.pairwise_grads_shared(
        jm, jprm, jnp.asarray(pos), jnp.asarray(pool), jnp.asarray(mask), margin)
    jnew, jost = jtraining.apply_gradients(
        jm, JAdaGrad(lr=0.1), jprm, {k: {"p2": jnp.asarray(v)} for k, v in p2.items()},
        occ, g_dense, "dense", premasked=True)

    tprm = params_from_numpy(prm, "cpu")
    tl, tn, tocc, tg = training.pairwise_grads_shared(
        tm, tprm, t(pos), t(pool), t(mask), margin)
    tnew, tost = training.apply_gradients(
        tm, AdaGrad(lr=0.1), tprm, {k: {"p2": t(v)} for k, v in p2.items()},
        tocc, tg, "dense_pallas", premasked=True)
    assert int(tn) == int(nviol) > 0
    np.testing.assert_allclose(float(tl), float(loss), rtol=1e-9)
    for k in prm:
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]), **TOL, err_msg=k)
        np.testing.assert_allclose(tost[k]["p2"].numpy(), np.asarray(jost[k]["p2"]),
                                   **TOL, err_msg=k)


@pytest.mark.parametrize("ties", ["mean", "optimistic"])
@pytest.mark.parametrize("name", ["hole", "ermlp"])
def test_filtered_ranking_matches_jax(name, ties):
    ds = synthetic_kg(N_E, N_R, 150, n_test=20, seed=10)
    prm = make_params(name, seed=11)
    prm["E"][3] = prm["E"][4]  # two entities tied everywhere
    jm, tm = models(name)
    known = ds.all_triples()
    want = JEval(jm, ds.test, known, batch_size=8, ties=ties)(
        {k: jnp.asarray(v) for k, v in prm.items()})
    got = FilteredRankingEval(tm, ds.test, known, batch_size=8, ties=ties)(
        params_from_numpy(prm, "cpu"))
    np.testing.assert_array_equal(got.ranks, want.ranks)
    np.testing.assert_array_equal(got.ranks_raw, want.ranks_raw)
    assert got.summary() == pytest.approx(want.summary())


def test_ermlp_state_crosses_from_jax():
    """ER-MLP's 1-D C and its accumulator cross `state_from_numpy`, and the
    port then scores as JAX does."""
    jm, tm = models("ermlp")
    jopt = JAdaGrad(lr=0.1)
    jstate = jtraining.init_state(jm, jopt, jax.random.PRNGKey(3))
    state = state_from_numpy(jax.device_get(jstate), "cpu")
    assert state.params["C"].shape == (NH,) and state.params["W"].shape == (3 * D, NH)
    assert state.opt_state["C"]["p2"].shape == (NH,)
    assert state.params["C"].dtype == torch.float64
    s, o, p = np.arange(5), np.arange(5, 10), np.arange(5) % N_R
    want = jm.score(jstate.params, jnp.asarray(s), jnp.asarray(o), jnp.asarray(p))
    got = tm.score(state.params, t(s), t(o), t(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["hole", "ermlp"])
def test_static_metadata_and_init(name):
    jm, tm = models(name)
    assert tm.slot_spec() == jm.slot_spec()
    assert tm.reg_row_params == jm.reg_row_params
    assert tm.regularization == jm.regularization
    assert tm.dense_param_names == jm.dense_param_names
    assert tm.pairwise_af == jm.pairwise_af
    assert MODELS[name] is type(tm)
    prm = tm.init_params(torch.Generator().manual_seed(0))
    jprm = jm.init_params(jax.random.PRNGKey(0))
    for k, v in jprm.items():
        assert prm[k].shape == v.shape and prm[k].dtype == torch.float64
    if name == "ermlp":
        # C: the bound of an (nhidden, 1) table, as JAX's
        assert float(prm["C"].abs().max()) <= np.sqrt(6.0) / np.sqrt(NH + 1)
