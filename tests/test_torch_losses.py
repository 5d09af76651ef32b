"""The port's self-adversarial and full cross-entropy gradients
(skge_torch/training.py) against the JAX package's, fp64 at 1e-9, on the
same inputs made by numpy from a seed: `selfadv_grads_shared` and
`ce_grads_all` for TransE-L1, TransE-L2, RESCAL, HolE and ER-MLP, with
padded (masked) rows.

Sampled CE: test_torch_sampled_ce.py; the steps and
`apply_gradients(combine="sum")`: test_torch_loss_steps.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skge_tpu import training as jtraining
from skge_tpu.models import ERMLP as JERMLP
from skge_tpu.models import HolE as JHolE
from skge_tpu.models import RESCAL as JRESCAL
from skge_tpu.models import TransE as JTransE
from skge_torch import ERMLP, RESCAL, HolE, TransE, training
from skge_torch.convert import params_from_numpy

torch.set_num_threads(1)

N_E, N_R, D, B, K = 23, 5, 6, 14, 9
TOL = dict(rtol=1e-9, atol=1e-11)

MODELS = {
    "transe-l1": (lambda: JTransE(N_E, N_R, D, dtype="float64"),
                  lambda: TransE(N_E, N_R, D, dtype="float64")),
    "transe-l2": (lambda: JTransE(N_E, N_R, D, dtype="float64", l1=False),
                  lambda: TransE(N_E, N_R, D, dtype="float64", l1=False)),
    "rescal": (lambda: JRESCAL(N_E, N_R, D, dtype="float64", rparam=0.03),
               lambda: RESCAL(N_E, N_R, D, dtype="float64", rparam=0.03)),
    "hole": (lambda: JHolE(N_E, N_R, D, dtype="float64", rparam=0.02),
             lambda: HolE(N_E, N_R, D, dtype="float64", rparam=0.02)),
    "ermlp": (lambda: JERMLP(N_E, N_R, D, dtype="float64", nhidden=4),
              lambda: ERMLP(N_E, N_R, D, dtype="float64", nhidden=4)),
}


def inputs(name, seed=0, k=K):
    """Params, positives (with duplicates), a pool holding the first
    positive's object and subject, and a mask with 3 padded rows."""
    rng = np.random.default_rng(seed)
    shapes = {"E": (N_E, D), "R": (N_R, D), "W": (N_R, D, D)}
    if name == "ermlp":
        shapes.update(W=(3 * D, 4), C=(4,))
    if name != "rescal":
        shapes.setdefault("R", (N_R, D))
    pnames = {"rescal": ("E", "W"), "ermlp": ("E", "R", "W", "C")}.get(name, ("E", "R"))
    params = {p: rng.normal(size=shapes[p]) * 0.5 for p in pnames}
    pos = np.stack([rng.integers(0, N_E // 2, B), rng.integers(0, N_E, B),
                    rng.integers(0, N_R, B)], axis=1)
    pool = rng.integers(0, N_E, k)
    pool[:2] = pos[0, 1], pos[0, 0]
    mask = np.ones(B)
    mask[-3:] = 0.0
    return params, pos, pool, mask


def jx(a):
    return jnp.asarray(a)


def jparams(params):
    return {k: jx(v) for k, v in params.items()}


def jit_call(fn, *args):
    """The JAX reference under `jax.jit`: one compile is cheaper than the
    eager dispatch of every op."""
    return jax.jit(fn)(*args)


def th(a):
    return torch.as_tensor(np.asarray(a))


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL, err_msg=what)


def assert_same_occ(tocc, jocc):
    assert set(tocc) == set(jocc)
    for p in jocc:
        for part, g, w in zip(("idx", "grads", "counts"), tocc[p], jocc[p]):
            close(g, w, f"{p} {part}")


@pytest.mark.parametrize("alpha", [0.0, 2.0])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_selfadv_grads_match_jax(name, alpha):
    jm, tm = (f() for f in MODELS[name])
    params, pos, pool, mask = inputs(name, seed=1)
    jl, jocc, jgd = jit_call(
        lambda *a: jtraining.selfadv_grads_shared(jm, *a, 0.7, alpha),
        jparams(params), jx(pos), jx(pool), jx(mask))
    tl, tocc, tgd = training.selfadv_grads_shared(
        tm, params_from_numpy(params, "cpu"), th(pos), th(pool), th(mask), 0.7, alpha)
    close(tl, jl, "loss")
    assert_same_occ(tocc, jocc)
    assert set(tgd) == set(jgd)
    for k in jgd:
        close(tgd[k], jgd[k], k)


@pytest.mark.parametrize("directions, ls", [(("o", "s"), 0.0), (("o",), 0.1)])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_ce_grads_all_match_jax(name, directions, ls):
    jm, tm = (f() for f in MODELS[name])
    params, pos, _, mask = inputs(name, seed=2)
    jl, jg = jit_call(lambda *a: jtraining.ce_grads_all(jm, *a, directions, ls),
                      jparams(params), jx(pos), jx(mask))
    tl, tg = training.ce_grads_all(tm, params_from_numpy(params, "cpu"), th(pos),
                                   th(mask), directions, ls)
    close(tl, jl, "loss")
    assert set(tg) == set(jg)
    for k in jg:
        close(tg[k], jg[k], k)
