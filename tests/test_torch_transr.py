"""The port's TransR (skge_torch/models/transr.py) against the JAX package's,
fp64 at 1e-9:

- the quadratic and the direct sweep against each other and against JAX,
  pool (each mode, with gradients, and `score_pool_modes`) and all-entity
  sweeps, including more than 2,048 candidates (chunked, with a remainder
  chunk) and rcomp != ncomp;
- the factored form against JAX and against the full-rank model holding
  its materialized matrices I + u v^T;
- triple scores and their row gradients, and stacked (n, B, ·) rows;
- M's identity start as a real copy: an update of one relation's rows
  leaves the others unchanged;
- `segment_mean_dense` on rows at least 4,096 wide (its separate-scatter
  branch, which full-rank TransR's M gradients take) against JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skge_tpu.models import TransR as JTransR
from skge_tpu.ops import aggregate as jaggregate
from skge_torch import AdaGrad
from skge_torch.convert import params_from_numpy
from skge_torch.models import TransR
from skge_torch.ops import aggregate
from skge_torch.ops.aggregate import UniqueGrads

torch.set_num_threads(1)

N_E, N_R, D, B, K = 19, 4, 5, 6, 8
TOL = dict(rtol=1e-9, atol=1e-11)
# (rcomp, sweep, factored)
FORMS = [(0, "quadratic", False), (3, "quadratic", False), (0, "direct", False),
         (3, "direct", False), (0, "quadratic", True)]
FORM_IDS = ["quadratic", "quadratic-rcomp3", "direct", "direct-rcomp3", "factored"]


def t(x):
    return torch.as_tensor(np.asarray(x))


def jx(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def models(rcomp, sweep, factored, n_e=N_E, d=D):
    kw = dict(dtype="float64", rcomp=rcomp, sweep=sweep, factored=factored)
    return JTransR(n_e, N_R, d, **kw), TransR(n_e, N_R, d, **kw)


def make_params(rcomp, factored, n_e=N_E, d=D, seed=0):
    rng = np.random.default_rng(seed)
    r = rcomp or d
    prm = {"E": rng.normal(size=(n_e, d)) * 0.5, "R": rng.normal(size=(N_R, r)) * 0.5}
    if factored:
        prm["U"] = rng.normal(size=(N_R, d)) * 0.5
        prm["V"] = rng.normal(size=(N_R, d)) * 0.5
    else:
        prm["M"] = np.eye(r, d) + rng.normal(size=(N_R, r, d)) * 0.3
    return prm


def make_rows(rcomp, factored, seed=1, n_pool=K, d=D):
    prm = make_params(rcomp, factored, d=d, seed=seed)
    rng = np.random.default_rng(seed + 100)
    s, o, p = rng.integers(0, N_E, B), rng.integers(0, N_E, B), rng.integers(0, N_R, B)
    rows = {"es": prm["E"][s], "eo": prm["E"][o], "rp": prm["R"][p]}
    if factored:
        rows["up"], rows["vp"] = prm["U"][p], prm["V"][p]
    else:
        rows["mp"] = prm["M"][p]
    pool = rng.normal(size=(n_pool, d)) * 0.5
    return prm, (s, o, p), rows, pool


def leaves(d):
    return {k: t(v).requires_grad_() for k, v in d.items()}


def value_and_grads(fn, w, *args):
    """fn(*args) and the gradients of sum(w * fn) w.r.t. every arg, in one
    jitted JAX call."""
    def both(*a):
        return fn(*a), jax.grad(lambda *b: jnp.sum(jnp.asarray(w) * fn(*b)),
                                argnums=tuple(range(len(a))))(*a)
    return jax.jit(both)(*args)


@pytest.mark.parametrize("rcomp, sweep, factored", FORMS, ids=FORM_IDS)
def test_triple_scores_and_row_grads_match_jax(rcomp, sweep, factored):
    jm, tm = models(rcomp, sweep, factored)
    _, _, rows, _ = make_rows(rcomp, factored)
    w = np.linspace(-1.0, 2.0, B)
    want, (want_g,) = value_and_grads(lambda r: jm.score_from_rows(r, {}), w, jx(rows))
    trows = leaves(rows)
    got = tm.score_from_rows(trows, {})
    grads = torch.autograd.grad(torch.sum(t(w) * got), list(trows.values()))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for k, g in zip(trows, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g[k]), **TOL, err_msg=k)


# candidate counts over several chunks, the last a remainder: 2,048 + 52
# for the quadratic sweep, 2 x 128 + 44 for the direct one
CHUNKED = {"quadratic": 2100, "direct": 300}
# (rcomp, sweep, factored, candidates): each form at one chunk, the
# chunked sweeps also over several
SIZES = [(*f, n) for f in FORMS for n in (K, CHUNKED[f[1]]) if n == K or not f[2]]
SIZE_IDS = [f"{i}-{'chunked' if n > K else 'one-chunk'}"
            for i, f in zip(FORM_IDS, FORMS) for n in (K, CHUNKED[f[1]])
            if n == K or not f[2]]


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("rcomp, sweep, factored, n_pool", SIZES, ids=SIZE_IDS)
def test_score_pool_values_and_grads_match_jax(rcomp, sweep, factored, n_pool, mode):
    d = 3 if n_pool > K else D  # narrow rows for the long pools
    rc = min(rcomp, 2) if n_pool > K else rcomp
    jm, tm = models(rc, sweep, factored, d=d)
    _, _, rows, pool = make_rows(rc, factored, seed=4 + mode, n_pool=n_pool, d=d)
    w = np.random.default_rng(mode).normal(size=(B, n_pool))
    want, want_g = value_and_grads(lambda r, pl: jm.score_pool(r, pl, {}, mode), w,
                                   jx(rows), jnp.asarray(pool))
    trows, tpool = leaves(rows), t(pool).requires_grad_()
    got = tm.score_pool(trows, tpool, {}, mode)
    assert got.shape == (B, n_pool)
    grads = torch.autograd.grad(torch.sum(t(w) * got), [*trows.values(), tpool],
                                materialize_grads=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for k, g, wg in zip([*trows, "pool"], grads, [*(want_g[0][k] for k in trows),
                                                  want_g[1]]):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **TOL, err_msg=k)


@pytest.mark.parametrize("rcomp, sweep, factored", FORMS, ids=FORM_IDS)
def test_score_pool_modes_match_jax_and_each_mode(rcomp, sweep, factored):
    """Both modes at once equal JAX's and the port's one mode at a time;
    the quadratic and the direct sweep agree."""
    jm, tm = models(rcomp, sweep, factored)
    _, _, rows, pool = make_rows(rcomp, factored, seed=7)
    trows = {k: t(v) for k, v in rows.items()}
    want = jax.jit(lambda r, pl: jm.score_pool_modes(r, pl, {}, (0, 1)))(
        jx(rows), jnp.asarray(pool))
    got = tm.score_pool_modes(trows, t(pool), {}, (0, 1))
    for mode, g, wv in zip((0, 1), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), **TOL)
        np.testing.assert_allclose(g.numpy(), tm.score_pool(trows, t(pool), {}, mode),
                                   **TOL)
    if not factored:
        other = TransR(N_E, N_R, D, dtype="float64", rcomp=rcomp,
                       sweep="direct" if sweep == "quadratic" else "quadratic")
        for g, o in zip(got, other.score_pool_modes(trows, t(pool), {}, (0, 1))):
            np.testing.assert_allclose(g.numpy(), o.numpy(), **TOL)


@pytest.mark.parametrize("direction", ["o", "s"])
@pytest.mark.parametrize("rcomp, sweep, factored, n_e", SIZES, ids=SIZE_IDS)
def test_score_all_matches_jax(rcomp, sweep, factored, n_e, direction):
    n_e = N_E if n_e == K else n_e
    d = 3 if n_e > N_E else D
    rc = min(rcomp, 2) if n_e > N_E else rcomp
    jm, tm = models(rc, sweep, factored, n_e=n_e, d=d)
    prm = make_params(rc, factored, n_e=n_e, d=d, seed=6)
    rng = np.random.default_rng(16)
    e, p = rng.integers(0, n_e, B), rng.integers(0, N_R, B)
    jprm, tprm = jx(prm), params_from_numpy(prm, "cpu")
    triples = np.stack([e, rng.integers(0, n_e, B), p], axis=1)
    sweep_fn = jm.score_all_o if direction == "o" else jm.score_all_s
    want, want_t = jax.jit(lambda prm, tr: (sweep_fn(prm, tr[:, 0], tr[:, 2]),
                                            jm.score_triples(prm, tr)))(
        jprm, jnp.asarray(triples))
    got = (tm.score_all_o if direction == "o" else tm.score_all_s)(tprm, t(e), t(p))
    assert got.shape == (B, n_e)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tm.score_triples(tprm, t(triples)).numpy(),
                               np.asarray(want_t), **TOL)


def test_factored_equals_its_materialized_full_rank_matrix():
    """Factored scores and sweeps equal the full-rank model's with
    M_p = I + u_p v_p^T."""
    prm = make_params(0, True, seed=9)
    full = dict(prm)
    full["M"] = np.eye(D)[None] + prm["U"][:, :, None] * prm["V"][:, None, :]
    del full["U"], full["V"]
    fm = TransR(N_E, N_R, D, dtype="float64", factored=True)
    qm = TransR(N_E, N_R, D, dtype="float64")
    tf, tq = params_from_numpy(prm, "cpu"), params_from_numpy(full, "cpu")
    rng = np.random.default_rng(10)
    s, o, p = (t(rng.integers(0, n, B)) for n in (N_E, N_E, N_R))
    np.testing.assert_allclose(fm.score(tf, s, o, p).numpy(), qm.score(tq, s, o, p).numpy(),
                               **TOL)
    np.testing.assert_allclose(fm.score_all_o(tf, s, p).numpy(),
                               qm.score_all_o(tq, s, p).numpy(), **TOL)
    np.testing.assert_allclose(fm.score_all_s(tf, o, p).numpy(),
                               qm.score_all_s(tq, o, p).numpy(), **TOL)


@pytest.mark.parametrize("slot", ["es", "eo"])
@pytest.mark.parametrize("rcomp, sweep, factored", [FORMS[1], FORMS[3], FORMS[4]],
                         ids=["rcomp3", "direct-rcomp3", "factored"])
def test_scores_broadcast_over_stacked_rows(rcomp, sweep, factored, slot):
    """A (n, B, c) stack of entity rows against the (B, r, c) projections
    scores as n separate batches (the fused iid step's form)."""
    _, tm = models(rcomp, sweep, factored)
    _, _, rows, _ = make_rows(rcomp, factored, seed=2)
    trows = {k: t(v) for k, v in rows.items()}
    stack = t(np.random.default_rng(3).normal(size=(4, B, D)))
    got = tm.score_from_rows({**trows, slot: stack}, {})
    assert got.shape == (4, B)
    for i in range(4):
        want = tm.score_from_rows({**trows, slot: stack[i]}, {})
        np.testing.assert_allclose(got[i].numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("rcomp", [0, 3])
def test_identity_start_is_a_real_copy(rcomp):
    """M starts as the identity in every relation, in memory of its own:
    an in-place update of relation 0's rows (an optimizer's) leaves the
    others at the identity. The JAX package's shapes and `U` = 0."""
    jm, tm = models(rcomp, "quadratic", False)
    prm = tm.init_params(torch.Generator().manual_seed(0))
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in prm.items()} == {
        k: v.shape for k, v in shapes.items()}
    eye = torch.eye(rcomp or D, D, dtype=torch.float64)
    assert torch.equal(prm["M"], eye.expand(N_R, -1, -1))
    assert prm["M"].stride()[0] == (rcomp or D) * D
    opt = AdaGrad(lr=0.1)
    g = torch.ones((1, rcomp or D, D), dtype=torch.float64)
    m, _ = opt.apply_unique(prm["M"], opt.init({"M": prm["M"]})["M"],
                            UniqueGrads(uidx=torch.tensor([0]), grads=g,
                                        count=torch.ones(1, dtype=torch.float64)), None)
    assert not torch.equal(m[0], eye)
    for r in range(1, N_R):
        assert torch.equal(m[r], eye), r
    fm = TransR(N_E, N_R, D, factored=True).init_params(torch.Generator().manual_seed(0))
    assert set(fm) == {"E", "R", "U", "V"} and not fm["U"].any() and fm["V"].any()


def test_static_metadata_and_factored_check():
    jm, tm = models(0, "quadratic", False)
    assert tm.name == jm.name == "transr"
    assert tm.slot_spec() == jm.slot_spec()
    assert TransR(N_E, N_R, D, factored=True).slot_spec() == JTransR(
        N_E, N_R, D, factored=True).slot_spec()
    assert tm.post_constraints == jm.post_constraints
    assert tm.reg_row_params == jm.reg_row_params == ()
    assert tm.num_rows("M") == N_R
    with pytest.raises(ValueError, match="rcomp == ncomp"):
        TransR(N_E, N_R, D, rcomp=3, factored=True)


@pytest.mark.parametrize("premasked", [False, True])
def test_segment_mean_dense_wide_rows_match_jax(premasked):
    """Rows of 65 x 64 = 4,160 features: gradients and counts scatter
    separately (the branch of full-rank TransR's M), ids >= R (padding)
    dropped; JAX's in fp64 takes its XLA scatter. Negative ids stay out:
    that scatter wraps them, numpy-style, where its Pallas kernel and the
    port drop them."""
    rng = np.random.default_rng(11)
    t_, r = 40, 7
    idx = rng.integers(0, r + 2, t_)
    grads = rng.normal(size=(t_, 65, 64))
    mask = (rng.random(t_) > 0.3).astype(np.float64) * (2.0 if premasked else 1.0)
    want = jax.jit(lambda i, g, m: jaggregate.segment_mean_dense(i, g, m, r, premasked))(
        jnp.asarray(idx), jnp.asarray(grads), jnp.asarray(mask))
    got = aggregate.segment_mean_dense(t(idx), t(grads), t(mask), r, premasked)
    assert got.grads.shape == (r, 65, 64)
    np.testing.assert_allclose(got.grads.numpy(), np.asarray(want.grads), **TOL)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
