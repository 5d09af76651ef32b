"""The port's copies of the reference API's NumPy modules (skge_torch/sample.py,
param.py, actfun.py, util.py) against the JAX package's (skge_tpu/...):
the same outputs from the same inputs and the same random state, exactly.
"""

import numpy as np
import pytest

from skge_torch import actfun, param, sample, util
from skge_tpu import actfun as jactfun
from skge_tpu import param as jparam
from skge_tpu import sample as jsample
from skge_tpu import util as jutil

N_E, N_R = 30, 4
SZ = (N_E, N_E, N_R)


def triples(n=200, seed=0):
    rng = np.random.default_rng(seed)
    return [(int(s), int(o), int(p)) for s, o, p in zip(
        rng.integers(0, N_E, n), rng.integers(0, N_E, n), rng.integers(0, N_R, n))]


def samplers(pkg, xs):
    return {
        "random-mode": pkg.RandomModeSampler(2, [0, 1], xs, SZ),
        "lcwa": pkg.LCWASampler(1, [1, 0], xs, SZ),
        "corrupted": pkg.CorruptedSampler(2, xs, pkg.type_index(xs)),
        "bernoulli": pkg.BernoulliSampler(3, xs, SZ),
    }


def test_type_index_matches_jax():
    xs = triples()
    assert sample.type_index(xs) == jsample.type_index(xs)


@pytest.mark.parametrize("name", ["random-mode", "lcwa", "corrupted", "bernoulli"])
@pytest.mark.parametrize("seed", [0, 5])
def test_sampler_matches_jax_from_the_same_rng_state(name, seed):
    xs = triples()
    got, want = samplers(sample, xs)[name], samplers(jsample, xs)[name]
    got.rng, want.rng = np.random.default_rng(seed), np.random.default_rng(seed)
    xys = [(x, 1.0) for x in xs[:40]]
    negs = got.sample(xys)
    assert negs == want.sample(xys)
    assert len(negs) > 0 and all(y == -1.0 for _, y in negs)


def test_lcwa_gives_up_after_ntries():
    """Every object corruption of (0, ., 0) is a training triple: no
    negative after `ntries` draws, in both packages."""
    xs = [(0, o, 0) for o in range(N_E)]
    for pkg in (sample, jsample):
        s = pkg.LCWASampler(1, [1], xs, SZ)
        s.rng = np.random.default_rng(1)
        assert s.sample([(xs[0], 1.0)]) == []


def test_bernoulli_probs_match_jax():
    xs = triples(seed=3)
    np.testing.assert_array_equal(sample.BernoulliSampler(1, xs, SZ).probs,
                                  jsample.BernoulliSampler(1, xs, SZ).probs)


@pytest.mark.parametrize("init", ["normal", "nunif"])
@pytest.mark.parametrize("shape", [(6, 4), (3, 5, 5)])
def test_parameter_init_matches_jax(init, shape):
    np.random.seed(11)
    got = param.Parameter(shape, init=init, post="normless1")
    np.random.seed(11)
    want = jparam.Parameter(shape, init=init, post="normless1")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert got.post == want.post == "normless1"
    assert got[1:].post == "normless1"  # carried by views


@pytest.mark.parametrize("update", ["SGD", "AdaGrad"])
@pytest.mark.parametrize("idx", [None, [0, 2, 5]])
def test_parameter_updates_match_jax(update, idx):
    rng = np.random.default_rng(2)
    value = 2.0 * rng.standard_normal((6, 4))
    grads = [rng.standard_normal((6, 4) if idx is None else (len(idx), 4))
             for _ in range(3)]
    out = []
    for pkg in (param, jparam):
        p = pkg.Parameter((6, 4), post="normless1", value=value)
        upd = getattr(pkg, update)(p, 0.3)
        for g in grads:
            upd(g, idx)
        out.append(np.asarray(p))
        if update == "AdaGrad":
            out.append(upd.p2)
            upd.reset()
            assert not upd.p2.any()
    for got, want in zip(out[: len(out) // 2], out[len(out) // 2:]):
        np.testing.assert_array_equal(got, want)
    rows = slice(None) if idx is None else idx
    assert np.linalg.norm(out[0][rows], axis=1).max() <= 1.0 + 1e-12


def test_normless1_matches_jax():
    rng = np.random.default_rng(4)
    a = 3.0 * rng.standard_normal((8, 5))
    b = a.copy()
    param.normless1(a, [1, 3, 6])
    jparam.normless1(b, [1, 3, 6])
    np.testing.assert_array_equal(a, b)
    assert param.INITS.keys() == jparam.INITS.keys()
    assert param.CONSTRAINTS.keys() == jparam.CONSTRAINTS.keys()


@pytest.mark.parametrize("name", ["Linear", "Sigmoid", "Tanh", "ReLU"])
def test_activation_matches_jax(name):
    x = np.linspace(-4.0, 4.0, 33)
    got, want = getattr(actfun, name), getattr(jactfun, name)
    assert got.name == want.name
    fx = got.f(x)
    np.testing.assert_array_equal(fx, want.f(x))
    np.testing.assert_array_equal(got.g_given_f(fx), want.g_given_f(fx))


def test_circular_products_match_jax():
    rng = np.random.default_rng(5)
    a, b = rng.standard_normal((3, 7, 16)), rng.standard_normal((3, 7, 16))
    np.testing.assert_array_equal(util.cconv(a, b), jutil.cconv(a, b))
    np.testing.assert_array_equal(util.ccorr(a, b), jutil.ccorr(a, b))


def test_grad_sum_matrix_matches_jax():
    idx = [4, 1, 4, 9, 1, 4]
    (u, m, n), (ju, jm, jn) = util.grad_sum_matrix(idx), jutil.grad_sum_matrix(idx)
    np.testing.assert_array_equal(u, ju)
    np.testing.assert_array_equal(m.toarray(), jm.toarray())
    np.testing.assert_array_equal(n, jn)


@pytest.mark.parametrize("with_ys", [False, True])
def test_unzip_triples_matches_jax(with_ys):
    xs = triples(20)
    data = [(x, float(i % 2)) for i, x in enumerate(xs)] if with_ys else xs
    for got, want in zip(util.unzip_triples(data, with_ys),
                         jutil.unzip_triples(data, with_ys)):
        np.testing.assert_array_equal(got, want)


def test_to_tensor_and_init_nvecs_match_jax():
    xs = sorted(set(triples(300, seed=6)))
    ys = [1.0] * len(xs)
    for got, want in zip(util.to_tensor(xs, ys, SZ), jutil.to_tensor(xs, ys, SZ)):
        np.testing.assert_array_equal(got.toarray(), want.toarray())
    # the same eigsh call on the same matrix; the starting vector is random
    # in both, so the eigenvectors agree up to sign
    np.random.seed(0)
    e, t = util.init_nvecs(xs, ys, SZ, 3, with_T=True)
    np.random.seed(0)
    je = jutil.init_nvecs(xs, ys, SZ, 3)
    assert e.shape == je.shape == (N_E, 3) and len(t) == N_R
    np.testing.assert_allclose(np.abs(e.T @ je), np.eye(3), atol=1e-8)
