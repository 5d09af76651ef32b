"""The port's ConvE (skge_torch/models/conve.py) against the JAX package's,
fp64 at 1e-9:

- `_auto_grid` and the configuration errors of `__post_init__`;
- triple scores with the gradients of the rows and of F, bF, W, bW;
- object pool scores with gradients, and the refusal of subject pools;
- `score_all_o`, and `score_all_s` reciprocal (through the inverse
  relation) and non-reciprocal (a candidate hidden table per distinct
  relation, over entity chunks of 4,096 and a remainder);
- `reg_grad_rows` leaving E's bias column out of `rparam`;
- stacked (n, B, ·) rows;
- the JAX package's initial tables carried over unchanged (F in OIHW, the
  NCHW flatten order), giving its scores;
- the cuDNN guard: TF32 off inside it, the caller's other flags kept.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skge_tpu.models import ConvE as JConvE
from skge_tpu.models import conve as jconve
from skge_torch.convert import params_from_numpy
from skge_torch.models import ConvE
from skge_torch.models import conve as tconve

torch.set_num_threads(1)

N_E, N_R, D, C, B, K = 23, 6, 6, 3, 7, 9
TOL = dict(rtol=1e-9, atol=1e-11)


def t(x):
    return torch.as_tensor(np.array(x))


def jx(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def models(n_e=N_E, **kw):
    kw = {"nfilters": C, "rparam": 0.01, **kw}
    return (JConvE(n_e, N_R, D, dtype="float64", **kw),
            ConvE(n_e, N_R, D, dtype="float64", **kw))


def make_params(n_e=N_E, seed=0):
    """Scaled normals, biases nonzero so that every term counts."""
    rng = np.random.default_rng(seed)
    tm = ConvE(n_e, N_R, D, nfilters=C)
    oh, ow = tm.conv_out
    return {"E": rng.normal(size=(n_e, D + 1)) * 0.5,
            "R": rng.normal(size=(N_R, D)) * 0.5,
            "F": rng.normal(size=(C, 1, 3, 3)) * 0.5,
            "bF": rng.normal(size=(C,)) * 0.1,
            "W": rng.normal(size=(C * oh * ow, D)) * 0.5,
            "bW": rng.normal(size=(D,)) * 0.1}


DENSE = ("F", "bF", "W", "bW")


def make_rows(seed=1):
    prm = make_params(seed=seed)
    rng = np.random.default_rng(seed + 100)
    s, o, p = rng.integers(0, N_E, B), rng.integers(0, N_E, B), rng.integers(0, N_R, B)
    rows = {"es": prm["E"][s], "eo": prm["E"][o], "rp": prm["R"][p]}
    dense = {k: prm[k] for k in DENSE}
    pool = rng.normal(size=(K, D + 1)) * 0.5
    return prm, rows, dense, pool


def leaves(d):
    return {k: t(v).requires_grad_() for k, v in d.items()}


def test_auto_grid_and_config_errors_match_jax():
    for d in range(1, 300):
        assert tconve._auto_grid(d) == jconve._auto_grid(d), d
    assert ConvE(10, 4, 128).grid == JConvE(10, 4, 128).grid == (8, 16)
    assert ConvE(10, 4, 128).conv_out == JConvE(10, 4, 128).conv_out == (14, 14)
    for kw, match in (({"ncomp": 7, "eh": 2}, "factor"),
                      ({"ncomp": 4, "eh": 1, "ksize": 5}, "kernel"),
                      ({"ncomp": 9, "n_relations": 5}, "DOUBLED")):
        args = {"n_entities": 10, "n_relations": 4, **kw}
        for cls in (JConvE, ConvE):
            with pytest.raises(ValueError, match=match):
                cls(**args)
    ConvE(10, 5, 9, reciprocal=False)  # an odd count is fine without it


def test_triple_scores_and_grads_match_jax():
    jm, tm = models()
    _, rows, dense, _ = make_rows()
    w = np.linspace(-1.0, 2.0, B)

    def both(r, dn):
        return jm.score_from_rows(r, dn), jax.grad(
            lambda r, dn: jnp.sum(jnp.asarray(w) * jm.score_from_rows(r, dn)),
            argnums=(0, 1))(r, dn)

    want, (want_gr, want_gd) = jax.jit(both)(jx(rows), jx(dense))
    trows, tdense = leaves(rows), leaves(dense)
    got = tm.score_from_rows(trows, tdense)
    grads = torch.autograd.grad(torch.sum(t(w) * got), [*trows.values(), *tdense.values()])
    assert got.shape == (B,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for k, g in zip([*trows, *tdense], grads):
        wg = want_gr[k] if k in want_gr else want_gd[k]
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **TOL, err_msg=k)


def test_score_pool_objects_match_jax_and_subjects_are_refused():
    jm, tm = models()
    _, rows, dense, pool = make_rows(seed=4)
    w = np.random.default_rng(1).normal(size=(B, K))

    def both(r, pl, dn):
        return jm.score_pool(r, pl, dn, 1), jax.grad(
            lambda *a: jnp.sum(jnp.asarray(w) * jm.score_pool(*a, 1)),
            argnums=(0, 1, 2))(r, pl, dn)

    want, (wr, wp, wd) = jax.jit(both)(jx(rows), jnp.asarray(pool), jx(dense))
    trows, tpool, tdense = leaves(rows), t(pool).requires_grad_(), leaves(dense)
    got = tm.score_pool(trows, tpool, tdense, 1)
    assert got.shape == (B, K)
    grads = torch.autograd.grad(torch.sum(t(w) * got),
                                [*trows.values(), tpool, *tdense.values()],
                                materialize_grads=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for k, g, wg in zip([*trows, "pool", *tdense], grads,
                        [*(wr[k] for k in trows), wp, *(wd[k] for k in tdense)]):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **TOL, err_msg=k)
    got_modes = tm.score_pool_modes({k: t(v) for k, v in rows.items()}, t(pool),
                                    {k: t(v) for k, v in dense.items()}, (1,))
    np.testing.assert_allclose(got_modes[0].numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="OBJECTS only"):
        tm.score_pool({k: t(v) for k, v in rows.items()}, t(pool), {}, 0)


# 4,100 entities: one chunk of 4,096 and a remainder of 4
@pytest.mark.parametrize("direction, reciprocal, n_e", [
    ("o", True, N_E), ("s", True, N_E), ("s", False, N_E), ("s", False, 4100),
], ids=["o", "s-reciprocal", "s-per-relation", "s-per-relation-chunked"])
def test_score_all_matches_jax(direction, reciprocal, n_e):
    jm, tm = models(n_e=n_e, reciprocal=reciprocal)
    prm = make_params(n_e=n_e, seed=6)
    rng = np.random.default_rng(16)
    e = rng.integers(0, n_e, B)
    p = rng.choice([1, 4, 5], B)  # three distinct relations, repeated
    triples = np.stack([e, rng.integers(0, n_e, B), p], axis=1)
    jfn = jm.score_all_o if direction == "o" else jm.score_all_s
    want, want_t = jax.jit(lambda prm, tr: (jfn(prm, tr[:, 0], tr[:, 2]),
                                            jm.score_triples(prm, tr)))(
        jx(prm), jnp.asarray(triples))
    tprm = params_from_numpy(prm, "cpu")
    got = (tm.score_all_o if direction == "o" else tm.score_all_s)(tprm, t(e), t(p))
    assert got.shape == (B, n_e)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tm.score_triples(tprm, t(triples)).numpy(),
                               np.asarray(want_t), **TOL)
    if direction == "s" and reciprocal:
        inv = t(np.where(p < N_R // 2, p + N_R // 2, p - N_R // 2))
        np.testing.assert_array_equal(got.numpy(), tm.score_all_o(tprm, t(e), inv).numpy())


def test_reg_grad_rows_leaves_the_bias_column_out():
    jm, tm = models()
    assert tm.reg_row_params == jm.reg_row_params == ("E", "R")
    rng = np.random.default_rng(3)
    for pname, width in (("E", D + 1), ("R", D)):
        rows = rng.normal(size=(5, width))
        got = tm.reg_grad_rows(pname, t(rows)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jm.reg_grad_rows(pname,
                                                                       jnp.asarray(rows))))
        if pname == "E":
            assert not got[:, -1].any() and (got[:, :-1] == rows[:, :-1]).all()


@pytest.mark.parametrize("slot", ["es", "eo", "rp"])
def test_scores_broadcast_over_stacked_rows(slot):
    """A (n, B, ·) stack of one slot's rows scores as n separate batches;
    the convolution sees the leading axes flattened."""
    _, tm = models()
    _, rows, dense, _ = make_rows(seed=2)
    trows = {k: t(v) for k, v in rows.items()}
    tdense = {k: t(v) for k, v in dense.items()}
    stack = t(np.random.default_rng(3).normal(size=(4, B, rows[slot].shape[1])))
    got = tm.score_from_rows({**trows, slot: stack}, tdense)
    assert got.shape == (4, B)
    for i in range(4):
        want = tm.score_from_rows({**trows, slot: stack[i]}, tdense)
        np.testing.assert_allclose(got[i].numpy(), want.numpy(), **TOL)


def test_jax_tables_carry_over_unchanged():
    """The JAX package's initial tables (F in OIHW, W over the NCHW
    flatten) give the port the JAX package's scores, unchanged; the
    port's own init has the same shapes, a zero bias column and zero
    biases."""
    jm = JConvE(N_E, N_R, D, nfilters=C, dtype="float64")
    tm = ConvE(N_E, N_R, D, nfilters=C, dtype="float64")
    jprm = jm.init_params(jax.random.PRNGKey(0))
    jprm["E"] = jprm["E"].at[:, -1].set(0.3)
    jprm["bF"], jprm["bW"] = jprm["bF"] + 0.05, jprm["bW"] + 0.02
    host = jax.device_get(jprm)
    tprm = params_from_numpy(host, "cpu")
    s, p = jnp.arange(B), jnp.arange(B) % N_R
    want = jax.jit(jm.score_all_o)(jprm, s, p)
    np.testing.assert_allclose(tm.score_all_o(tprm, t(s), t(p)).numpy(), np.asarray(want),
                               **TOL)
    own = tm.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: v.shape for k, v in host.items()}
    assert not own["E"][:, -1].any() and not own["bF"].any() and not own["bW"].any()
    assert tm.dense_param_names == jm.dense_param_names == DENSE
    assert tm.slot_spec() == jm.slot_spec() and tm.name == jm.name == "conve"


def test_cudnn_guard_turns_tf32_off_and_keeps_the_other_flags():
    cudnn = torch.backends.cudnn
    before = (cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic, cudnn.enabled)
    try:
        cudnn.allow_tf32, cudnn.benchmark = True, True
        with tconve._fp32_cudnn():
            assert not cudnn.allow_tf32
            assert cudnn.benchmark and cudnn.enabled == before[3]
        assert cudnn.allow_tf32 and cudnn.benchmark
    finally:
        cudnn.allow_tf32, cudnn.benchmark = before[:2]
