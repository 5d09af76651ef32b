"""The nuclear 3-norm (`n3`) of the port against the JAX package's, fp64
at 1e-9:

- `n3_grad_rows`: the default x * |x| (DistMult, SimplE, TuckER), the
  complex modulus of ComplEx and the quaternion modulus of QuatE;
- the N3 term of `apply_gradients` under `unique` (the touched rows) and
  under `dense_pallas` (the whole table, then masked): ComplEx, whose E and
  R share one grouped scatter, and TuckER, whose R is narrower than E and
  whose core W takes the dense update;
- the full-table N3 term of `make_ce_step`;
- the CLI's refusal of `--n3` outside the factorization models.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skge_tpu import training as jtraining
from skge_tpu.models import MODELS as JMODELS
from skge_tpu.optim import AdaGrad as JAdaGrad
from skge_tpu.optim import Adam as JAdam
from skge_torch import MODELS, AdaGrad, Adam, experiment, training
from skge_torch.convert import params_from_numpy

torch.set_num_threads(1)

N_E, N_R, D, RC = 13, 4, 5, 3
TOL = dict(rtol=1e-9, atol=1e-11)
WIDTH = {"complex": 2, "simple": 2, "quate": 4}


def models(name, rparam=0.02, n3=0.05):
    kw = {"rcomp": RC} if name == "tucker" else {}
    return (JMODELS[name](N_E, N_R, D, dtype="float64", rparam=rparam, n3=n3, **kw),
            MODELS[name](N_E, N_R, D, dtype="float64", rparam=rparam, n3=n3, **kw))


def make_params(name, seed):
    rng = np.random.default_rng(seed)
    w = WIDTH.get(name, 1) * D
    prm = {"E": rng.normal(size=(N_E, w)) * 0.5,
           "R": rng.normal(size=(N_R, RC if name == "tucker" else w)) * 0.5}
    if name == "tucker":
        prm["W"] = rng.normal(size=(RC, D, D)) * 0.3
    return prm


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL, err_msg=what)


@pytest.mark.parametrize("name", ["distmult", "complex", "quate", "tucker"])
def test_n3_grad_rows_match_jax(name):
    jm, tm = models(name)
    for pname, rows in make_params(name, 0).items():
        if pname == "W":
            continue
        rows[0, 0] = 0.0
        close(tm.n3_grad_rows(pname, torch.as_tensor(rows)),
              jm.n3_grad_rows(pname, jnp.asarray(rows)), pname)


def test_n3_grad_rows_weigh_by_modulus():
    """ComplEx's and QuatE's N3 weigh each dimension by its modulus, not
    each entry by its absolute value."""
    x = torch.tensor([[3.0, 0.0, 4.0, 0.0]], dtype=torch.float64)  # (3+4i, 0)
    _, complex_ = models("complex")
    assert torch.equal(complex_.n3_grad_rows("E", x),
                       torch.tensor([[15.0, 0.0, 20.0, 0.0]], dtype=torch.float64))
    q = torch.tensor([[1.0, 2.0, 2.0, 4.0]], dtype=torch.float64)  # one quaternion, |q| = 5
    _, quate = models("quate")
    assert torch.equal(quate.n3_grad_rows("E", q), 5.0 * q)
    _, distmult = models("distmult")
    assert torch.equal(distmult.n3_grad_rows("E", q), q * q)


def _occurrences(name, seed):
    """Occurrence lists with duplicate ids, masked and out-of-range (padding)
    ids, and a dense gradient for TuckER's core."""
    rng = np.random.default_rng(seed)
    prm = make_params(name, seed)
    occ, g_dense = {}, {}
    for pname in ("E", "R"):
        n, w = prm[pname].shape
        t = 11
        idx = rng.integers(0, n + 1, t)  # id n: padding, dropped
        idx[:3] = idx[3]                 # a duplicate
        occ[pname] = (idx, rng.normal(size=(t, w)),
                      (rng.random(t) < 0.7).astype(np.float64))
    if name == "tucker":
        g_dense["W"] = rng.normal(size=prm["W"].shape)
    return prm, occ, g_dense


@pytest.mark.parametrize("aggregate", ["unique", "dense_pallas"])
@pytest.mark.parametrize("name", ["complex", "tucker"])
def test_apply_gradients_n3_matches_jax(name, aggregate):
    jm, tm = models(name)
    prm, occ, g_dense = _occurrences(name, 3)
    p2 = {k: np.random.default_rng(4).random(v.shape) for k, v in prm.items()}
    jagg = "unique" if aggregate == "unique" else "dense"
    jp, js = jax.jit(lambda a, b, c, d: jtraining.apply_gradients(
        jm, JAdaGrad(lr=0.1), a, b, c, d, jagg))(
        {k: jnp.asarray(v) for k, v in prm.items()},
        {k: {"p2": jnp.asarray(v)} for k, v in p2.items()},
        {k: tuple(jnp.asarray(x) for x in o) for k, o in occ.items()},
        {k: jnp.asarray(v) for k, v in g_dense.items()})
    tp, ts = training.apply_gradients(
        tm, AdaGrad(lr=0.1), params_from_numpy(prm, "cpu"),
        {k: {"p2": torch.as_tensor(v)} for k, v in p2.items()},
        {k: tuple(torch.as_tensor(x) for x in o) for k, o in occ.items()},
        params_from_numpy(g_dense, "cpu"), aggregate)
    for k in prm:
        close(tp[k], jp[k], k)
        close(ts[k]["p2"], js[k]["p2"], k)
    # the term moved the touched rows: without n3 they land elsewhere
    _, plain = models(name, n3=0.0)
    np_, _ = training.apply_gradients(
        plain, AdaGrad(lr=0.1), params_from_numpy(prm, "cpu"),
        {k: {"p2": torch.as_tensor(v)} for k, v in p2.items()},
        {k: tuple(torch.as_tensor(x) for x in o) for k, o in occ.items()},
        params_from_numpy(g_dense, "cpu"), aggregate)
    assert not torch.equal(np_["E"], tp["E"])
    untouched = np.setdiff1d(np.arange(N_E), occ["E"][0][occ["E"][2] > 0])
    close(tp["E"][untouched], prm["E"][untouched], "untouched rows of E")


@pytest.mark.parametrize("name, opt", [("complex", "adam"), ("tucker", "adagrad"),
                                       ("quate", "adagrad")])
def test_ce_step_n3_matches_jax(name, opt):
    """One full-CE step: the N3 term over every row of E and R."""
    jm, tm = models(name)
    prm = make_params(name, 5)
    rng = np.random.default_rng(6)
    pos = np.stack([rng.integers(0, N_E, 8), rng.integers(0, N_E, 8),
                    rng.integers(0, N_R, 8)], axis=1)
    mask = np.ones(8)
    mask[-2:] = 0.0
    if opt == "adam":
        jopt, topt = JAdam(lr=0.05), Adam(lr=0.05)
        slots = {k: {"m": rng.normal(size=v.shape) * 0.1, "v": rng.random(v.shape),
                     "t": rng.integers(0, 4, v.shape[0]).astype(np.float64)}
                 for k, v in prm.items()}
    else:
        jopt, topt = JAdaGrad(lr=0.1), AdaGrad(lr=0.1)
        slots = {k: {"p2": rng.random(v.shape)} for k, v in prm.items()}
    jstate = jtraining.TrainState(
        {k: jnp.asarray(v) for k, v in prm.items()},
        {k: {s: jnp.asarray(v) for s, v in sl.items()} for k, sl in slots.items()},
        jax.random.PRNGKey(0), jnp.asarray(2, jnp.int32))
    jstate, jm_ = jax.jit(jtraining.make_ce_step(jm, jopt, ("o", "s"), 0.1))(
        jstate, jnp.asarray(pos), jnp.asarray(mask))
    tstate = training.TrainState(
        params_from_numpy(prm, "cpu"),
        {k: params_from_numpy(sl, "cpu") for k, sl in slots.items()},
        torch.Generator(), 2)
    tstate, tm_ = training.make_ce_step(tm, topt, ("o", "s"), 0.1)(
        tstate, torch.as_tensor(pos), torch.as_tensor(mask))
    close(tm_.loss, jm_.loss, "loss")
    for k in prm:
        close(tstate.params[k], jstate.params[k], k)
        for s in slots[k]:
            close(tstate.opt_state[k][s], jstate.opt_state[k][s], f"{k} {s}")


@pytest.mark.parametrize("model", ["transe", "hole", "rescal", "ermlp"])
def test_cli_refuses_n3_outside_the_factorization_models(model):
    with pytest.raises(SystemExit, match=f"--n3 is not supported for --model {model} "
                       r"\(factorization models only: distmult, complex, tucker, "
                       r"simple, quate\)"):
        experiment.main(["--cpu", "--model", model, "--n3", "0.1",
                         "--synthetic-entities", "30", "--synthetic-train", "200",
                         "--ncomp", "4", "--me", "1"])
