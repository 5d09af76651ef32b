"""`KGEModel.compute_dtype` in the port against the JAX package's.

- The default "" (and `compute_dtype == dtype`) is `mxu_dot` bit for bit,
  for every model: scores and their gradients equal those of a model whose
  `mxu` is `mxu_dot`, today's path.
- "bfloat16": the scoring matmuls take bf16 inputs and accumulate in fp32,
  on the CPU as in JAX, and the backward rounds each input's cotangent to
  bf16 where JAX's transpose does. Pool and all-entity scores and their
  gradients with respect to the rows, the pool and the dense params match
  JAX's bf16 mode within TOL, in fp32: the products of bf16 values are
  exact in fp32, so the two differ only in the order of the fp32 sums (and
  where an fp32 input lies within that difference of a bf16 rounding
  boundary, which these inputs do not hit).
- One bf16 shared-pool margin step (SGD, so the param change is lr times
  the gradient) matches JAX's within TOL, with the same violations.
- `tests/test_training.py`'s bf16 checks, ported: pool scores within 0.03
  of fp32, params stay fp32, HolE trains on a shared pool.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skge_tpu import training as jtraining
from skge_tpu.models import MODELS as JMODELS
from skge_tpu.optim import SGD as JSGD
from skge_torch import (MODELS, SGD, AdaGrad, SharedNegativeSampler, init_state,
                        make_epoch_fn, make_pairwise_step, training)
from skge_torch.data import synthetic_kg
from skge_torch.models.base import KGEModel, mxu_dot

torch.set_num_threads(1)

N_E, N_R, D, B = 19, 4, 6, 7
TOL = dict(rtol=1e-5, atol=1e-5)  # fp32 sums in another order
# name: (model, constructor keywords); every model of the package
CONFIGS = {
    "transe": ("transe", {}),
    "transe-l2": ("transe", {"l1": False}),
    "rescal": ("rescal", {}),
    "hole": ("hole", {}),
    "ermlp": ("ermlp", {"nhidden": 5}),
    "distmult": ("distmult", {}),
    "complex": ("complex", {}),
    "simple": ("simple", {}),
    "tucker": ("tucker", {"rcomp": 4}),
    "quate": ("quate", {}),
    "rotate": ("rotate", {}),
    "transh": ("transh", {}),
    "pairre": ("pairre", {}),
    "transr": ("transr", {"rcomp": 4}),
    "transr-direct": ("transr", {"rcomp": 4, "sweep": "direct"}),
    "transr-factored": ("transr", {"factored": True}),
    "conve": ("conve", {"nfilters": 3}),
}


def modes_of(config):
    return (1,) if config == "conve" else (0, 1)


def models(config, compute_dtype):
    name, kw = CONFIGS[config]
    return (JMODELS[name](N_E, N_R, D, compute_dtype=compute_dtype, **kw),
            MODELS[name](N_E, N_R, D, compute_dtype=compute_dtype, **kw))


def numpy_params(jm, seed=3):
    rng = np.random.default_rng(seed)
    shapes = {k: v.shape for k, v in jax.eval_shape(
        jm.init_params, jax.random.PRNGKey(0)).items()}
    return {k: (rng.normal(size=s) * 0.5).astype(np.float32) for k, s in shapes.items()}


def inputs(seed=4):
    rng = np.random.default_rng(seed)
    s, o, p = rng.integers(0, N_E, B), rng.integers(0, N_E, B), rng.integers(0, N_R, B)
    return s, o, p, rng.integers(0, N_E, 5)


def torch_scores(tm, params, s, o, p, pool_idx, mode):
    """(pool scores, all-entity scores, grads of a weighted sum of the pool
    scores w.r.t. the rows, the pool rows and the dense params)."""
    t = {k: torch.as_tensor(v) for k, v in params.items()}
    idx = [torch.as_tensor(a) for a in (s, o, p)]
    rows = {k: v.detach().requires_grad_() for k, v in tm.gather_rows(t, *idx).items()}
    dense = {k: v.detach().requires_grad_() for k, v in tm.dense_params(t).items()}
    pool = t["E"][torch.as_tensor(pool_idx)].detach().requires_grad_()
    out = tm.score_pool(rows, pool, dense, mode)
    cot = torch.as_tensor(np.random.default_rng(9).normal(size=tuple(out.shape))
                          .astype(np.float32))
    grads = torch.autograd.grad((out * cot).sum(), [*rows.values(), pool, *dense.values()],
                                allow_unused=True, materialize_grads=True)
    with torch.no_grad():
        full = tm.score_all_o(t, idx[0], idx[2]) if mode == 1 else tm.score_all_s(
            t, idx[1], idx[2])
    return out.detach(), full, [g.numpy() for g in grads], cot.numpy()


def jax_scores(jm, params, s, o, p, pool_idx, mode, cot):
    """`torch_scores` in JAX, jitted (one compile beats eager dispatch)."""
    @jax.jit
    def run(j, s, o, p, pool_idx, cot):
        rows = jm.gather_rows(j, s, o, p)
        dense = jm.dense_params(j)
        out, vjp = jax.vjp(lambda r, q, d: jm.score_pool(r, q, d, mode), rows,
                           j["E"][pool_idx], dense)
        g_rows, g_pool, g_dense = vjp(cot)
        full = jm.score_all_o(j, s, p) if mode == 1 else jm.score_all_s(j, o, p)
        return out, full, [*(g_rows[k] for k in rows), g_pool,
                           *(g_dense[k] for k in dense)]

    return run({k: jnp.asarray(v) for k, v in params.items()},
               *map(jnp.asarray, (s, o, p, pool_idx, cot)))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_default_is_mxu_dot_bit_for_bit(config, monkeypatch):
    """compute_dtype "" and "float32" (= dtype) against today's path."""
    jm, _ = models(config, "")
    params = numpy_params(jm)
    s, o, p, pool_idx = inputs()
    got = {cd: [torch_scores(models(config, cd)[1], params, s, o, p, pool_idx, m)
                for m in modes_of(config)] for cd in ("", "float32")}
    monkeypatch.setattr(KGEModel, "mxu", lambda self, a, b: mxu_dot(a, b))
    want = [torch_scores(models(config, "")[1], params, s, o, p, pool_idx, m)
            for m in modes_of(config)]
    for runs in got.values():
        for (out, full, grads, _), (w_out, w_full, w_grads, _) in zip(runs, want):
            assert torch.equal(out, w_out) and torch.equal(full, w_full)
            for g, wg in zip(grads, w_grads):
                np.testing.assert_array_equal(g, wg)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_bf16_scores_and_grads_match_jax(config):
    jm, tm = models(config, "bfloat16")
    params = numpy_params(jm)
    s, o, p, pool_idx = inputs()
    for mode in modes_of(config):
        out, full, grads, cot = torch_scores(tm, params, s, o, p, pool_idx, mode)
        j_out, j_full, j_grads = jax_scores(jm, params, s, o, p, pool_idx, mode, cot)
        assert out.dtype == torch.float32 and full.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
        np.testing.assert_allclose(full.numpy(), np.asarray(j_full), **TOL)
        assert len(grads) == len(j_grads)
        for g, jg in zip(grads, j_grads):
            np.testing.assert_allclose(g, np.asarray(jg), **TOL)


def test_bf16_rounds_where_jax_rounds():
    """The low-precision matmul itself, in fp32 and fp64: the forward is
    the exact product of the rounded inputs, each input's gradient is
    rounded to bf16, as JAX's."""
    rng = np.random.default_rng(0)
    for dtype in ("float32", "float64"):
        a, b = rng.normal(size=(5, 9)).astype(dtype), rng.normal(size=(9, 4)).astype(dtype)
        cot = rng.normal(size=(5, 4)).astype(dtype)
        jm, tm = models("hole", "bfloat16")
        ta, tb = (torch.as_tensor(x).requires_grad_() for x in (a, b))
        out = tm.mxu(ta, tb)
        ga, gb = torch.autograd.grad((out * torch.as_tensor(cot)).sum(), [ta, tb])
        j_out, vjp = jax.vjp(jm.mxu, jnp.asarray(a), jnp.asarray(b))
        j_ga, j_gb = vjp(jnp.asarray(cot))
        assert out.dtype == ga.dtype == gb.dtype == getattr(torch, dtype)
        tol = TOL if dtype == "float32" else dict(rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **tol)
        for g, jg in ((ga, j_ga), (gb, j_gb)):
            np.testing.assert_allclose(g.numpy(), np.asarray(jg), **tol)
            # bf16 values: widening back from bf16 changes nothing
            assert torch.equal(g, g.to(torch.bfloat16).to(g.dtype))


class FixedPool:
    def __init__(self, ids, as_array, modes):
        self.ids, self.modes = as_array(np.array(ids)), modes

    def pool(self, key, pos, mask):
        return self.ids


@pytest.mark.parametrize("config", ["hole", "rescal", "transr", "rotate"])
def test_bf16_pool_step_matches_jax(config):
    """One shared-pool margin step under SGD: params after the step (lr
    times the gradient) and the violations equal JAX's."""
    jm, tm = models(config, "bfloat16")
    params = numpy_params(jm, seed=5)
    rng = np.random.default_rng(6)
    train = synthetic_kg(N_E, N_R, 40, seed=2).train
    batch, pool = train[rng.permutation(40)[:B]], rng.integers(0, N_E, 6)
    mask = np.ones(B, np.float32)
    mask[-1] = 0.0
    jstep = jax.jit(jtraining.make_pairwise_step(
        jm, JSGD(lr=0.1), FixedPool(pool, jnp.asarray, modes_of(config)), 0.5,
        aggregate="dense"))
    jstate = jtraining.TrainState({k: jnp.asarray(v) for k, v in params.items()},
                                  JSGD(lr=0.1).init(params), jax.random.PRNGKey(0),
                                  jnp.zeros((), jnp.int32))
    jstate, jm_ = jstep(jstate, jnp.asarray(batch), jnp.asarray(mask))
    tparams = {k: torch.as_tensor(v) for k, v in params.items()}
    tstate = training.TrainState(tparams, SGD(lr=0.1).init(tparams), torch.Generator(), 0)
    tstep = make_pairwise_step(tm, SGD(lr=0.1), FixedPool(
        pool, lambda a: torch.as_tensor(a), modes_of(config)), 0.5, aggregate="dense_pallas")
    tstate, tm_ = tstep(tstate, torch.as_tensor(batch, dtype=torch.int64),
                        torch.as_tensor(mask))
    assert float(tm_.nviolations) == float(jm_.nviolations) > 0
    np.testing.assert_allclose(float(tm_.loss), float(jm_.loss), **TOL)
    for k, v in tstate.params.items():
        assert v.dtype == torch.float32
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate.params[k]), **TOL,
                                   err_msg=k)


@pytest.fixture(scope="module")
def ds():
    return synthetic_kg(n_entities=120, n_relations=6, n_train=1200, n_test=40, seed=7)


def test_bf16_compute_dtype_scores_close_and_trains(ds):
    """tests/test_training.py's checks on the port: pool scores within bf16
    tolerance of the fp32 path, parameters stay fp32, training converges."""
    kw = dict(n_entities=ds.n_entities, n_relations=ds.n_relations, ncomp=32)
    exact, fast = MODELS["hole"](**kw), MODELS["hole"](**kw, compute_dtype="bfloat16")
    state = init_state(exact, AdaGrad(), torch.Generator().manual_seed(0))
    i = torch.arange(16)
    rows = exact.gather_rows(state.params, i % ds.n_entities, (i * 3) % ds.n_entities,
                             i % ds.n_relations)
    pool = state.params["E"][torch.arange(12)]
    a, b = exact.score_pool(rows, pool, {}, 1), fast.score_pool(rows, pool, {}, 1)
    assert b.dtype == a.dtype  # cast back to the param dtype
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=0.03)
    assert not torch.equal(a, b)  # the bf16 path was taken

    opt = AdaGrad(lr=0.1)
    step = make_pairwise_step(fast, opt, SharedNegativeSampler(ds.n_entities, k=32),
                              margin=0.2)
    st = init_state(fast, opt, torch.Generator().manual_seed(1))
    assert st.params["E"].dtype == torch.float32
    xs = torch.as_tensor(ds.train, dtype=torch.int64)
    epoch = make_epoch_fn(step, ds.train.shape[0], nbatches=10)
    first = last = None
    for _ in range(15):
        st, m = epoch(st, xs)
        v = int(m.nviolations.sum())
        first = v if first is None else first
        last = v
    assert st.params["E"].dtype == torch.float32
    assert all(v["p2"].dtype == torch.float32 for v in st.opt_state.values())
    assert last < 0.7 * first, (first, last)
