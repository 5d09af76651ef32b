"""The port's training step and evaluation (skge_torch/training.py,
skge_torch/evaluation.py) against the JAX package's.

- one shared-pool step, every aggregate mode, fp64 at 1e-9;
- one fp32 step against JAX's Pallas scatter (interpret mode) at 1e-6;
- an 8-step trajectory fed JAX's own random draws, fp64 at 1e-9 with
  identical violation counts;
- filtered ranking, both tie rules, identical ranks;
- learning: held-out MRR on a learnable KG.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skge_tpu import training as jtraining
from skge_tpu.evaluation import FilteredRankingEval as JEval
from skge_tpu.models import TransE as JTransE
from skge_tpu.optim import AdaGrad as JAdaGrad
from skge_tpu.sampling import SharedNegativeSampler as JSampler
from skge_torch import (AdaGrad, FilteredRankingEval, SharedNegativeSampler,
                        TransE, init_state, make_epoch_fn, make_pairwise_step,
                        training)
from skge_torch.convert import params_from_numpy, params_to_numpy, state_from_numpy
from skge_torch.data import synthetic_kg

torch.set_num_threads(1)

N_E, N_R, D, B, K = 29, 5, 10, 24, 11
MARGIN = 0.8
TOL = dict(rtol=1e-9, atol=1e-11)


def batch_and_pool(seed, n_e=N_E, n_r=N_R, b=B, k=K):
    rng = np.random.default_rng(seed)
    pos = np.stack(
        [rng.integers(0, n_e // 2, b), rng.integers(0, n_e, b),
         rng.integers(0, n_r, b)], axis=1,
    )  # duplicate subjects likely
    pool = rng.integers(0, n_e, k)
    pool[0] = pos[0, 1]  # a pool entity equal to a true object
    mask = np.ones(b)
    mask[-3:] = 0.0  # padding rows
    return pos, pool, mask


def start_state(seed, dtype):
    rng = np.random.default_rng(seed)
    params = {"E": rng.normal(size=(N_E, D)) * 0.4, "R": rng.normal(size=(N_R, D)) * 0.4}
    p2 = {k: rng.random(v.shape) for k, v in params.items()}
    cast = lambda d: {k: v.astype(dtype) for k, v in d.items()}  # noqa: E731
    return cast(params), cast(p2)


def run_jax(model, params, p2, pos, pool, mask, aggregate):
    jprm = {k: jnp.asarray(v) for k, v in params.items()}
    jost = {k: {"p2": jnp.asarray(v)} for k, v in p2.items()}
    loss, nviol, occ, g_dense = jtraining.pairwise_grads_shared(
        model, jprm, jnp.asarray(pos), jnp.asarray(pool),
        jnp.asarray(mask, jprm["E"].dtype), MARGIN,
    )
    new, ost = jtraining.apply_gradients(
        model, JAdaGrad(lr=0.1), jprm, jost, occ, g_dense, aggregate,
        premasked=True,
    )
    return float(loss), int(nviol), new, ost


def run_torch(model, params, p2, pos, pool, mask, aggregate):
    tprm = params_from_numpy(params, "cpu")
    tost = {k: {"p2": v} for k, v in params_from_numpy(p2, "cpu").items()}
    loss, nviol, occ, g_dense = training.pairwise_grads_shared(
        model, tprm, torch.as_tensor(pos), torch.as_tensor(pool),
        torch.as_tensor(mask, dtype=torch.float32), MARGIN,
    )
    new, ost = training.apply_gradients(
        model, AdaGrad(lr=0.1), tprm, tost, occ, g_dense, aggregate,
        premasked=True,
    )
    return float(loss), int(nviol), new, ost


@pytest.mark.parametrize("l1", [True, False])
@pytest.mark.parametrize(
    "aggregate", ["unique", "dense", "dense_pallas", "dense_sorted"]
)
def test_shared_step_matches_jax_fp64(aggregate, l1):
    params, p2 = start_state(0, np.float64)
    pos, pool, mask = batch_and_pool(1)
    jl, jn, jnew, jost = run_jax(
        JTransE(N_E, N_R, D, dtype="float64", l1=l1), params, p2, pos, pool,
        mask, aggregate,
    )
    tl, tn, tnew, tost = run_torch(
        TransE(N_E, N_R, D, dtype="float64", l1=l1), params, p2, pos, pool,
        mask, aggregate,
    )
    assert tn == jn > 0
    np.testing.assert_allclose(tl, jl, rtol=1e-12)
    for k in params:
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]), **TOL,
                                   err_msg=k)
        np.testing.assert_allclose(tost[k]["p2"].numpy(), np.asarray(jost[k]["p2"]),
                                   **TOL, err_msg=k)


def test_fp32_step_matches_jax_pallas_scatter():
    """fp32, the JAX side's scatter in the Pallas kernel (interpret mode),
    the port's through its segment sum: params within 1e-6."""
    from jax.experimental.pallas import tpu as pltpu

    params, p2 = start_state(2, np.float32)
    pos, pool, mask = batch_and_pool(3)
    jm = JTransE(N_E, N_R, D)
    with pltpu.force_tpu_interpret_mode():
        _, jn, jnew, jost = run_jax(jm, params, p2, pos, pool, mask, "dense_pallas")
    _, tn, tnew, tost = run_torch(
        TransE(N_E, N_R, D), params, p2, pos, pool, mask, "dense_pallas"
    )
    assert tn == jn > 0
    for k in params:
        assert tnew[k].dtype == torch.float32
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(tost[k]["p2"].numpy(), np.asarray(jost[k]["p2"]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


class ReplayPool:
    """A `pool`-protocol sampler that hands out given pools in order."""

    def __init__(self, pools, modes=(0, 1)):
        self.pools = list(pools)
        self.modes = modes

    def pool(self, generator, pos, mask):
        return torch.as_tensor(self.pools.pop(0), device=pos.device)


def test_trajectory_with_jax_draws_matches_jax():
    """2 epochs x 4 steps: the port, fed JAX's epoch permutations and pool
    draws, follows JAX's trajectory (fp64, 1e-9; counts identical)."""
    n_e, n_r, d, k, nb, epochs = 40, 6, 12, 9, 4, 2
    ds = synthetic_kg(n_e, n_r, 150, seed=4)
    jm = JTransE(n_e, n_r, d, dtype="float64")
    jopt = JAdaGrad(lr=0.1)
    jsampler = JSampler(n_e, k=k)
    jepoch = jax.jit(jtraining.make_epoch_fn(
        jtraining.make_pairwise_step(jm, jopt, jsampler, 0.5, aggregate="dense"),
        ds.train.shape[0], nb,
    ))
    jstate = jtraining.init_state(jm, jopt, jax.random.PRNGKey(7))

    # replay the JAX key splits of make_epoch_fn and the pool step
    key, perms, pools = jstate.key, [], []
    for _ in range(epochs):
        key, pk = jax.random.split(key)
        perms.append(np.array(jax.random.permutation(pk, ds.train.shape[0])))
        for _ in range(nb):
            key, sk = jax.random.split(key)
            pools.append(np.array(jsampler.pool(sk, None, None)))

    tm = TransE(n_e, n_r, d, dtype="float64")
    tepoch = make_epoch_fn(
        make_pairwise_step(tm, AdaGrad(lr=0.1), ReplayPool(pools), 0.5,
                           aggregate="dense_pallas"),
        ds.train.shape[0], nb,
    )
    tstate = state_from_numpy(jax.device_get(jstate), "cpu")
    xs_j, xs_t = jnp.asarray(ds.train), torch.as_tensor(ds.train, dtype=torch.int64)
    for e in range(epochs):
        jstate, jmet = jepoch(jstate, xs_j)
        tstate, tmet = tepoch(tstate, xs_t, perm=torch.as_tensor(perms[e]))
        np.testing.assert_array_equal(
            tmet.nviolations.numpy(), np.asarray(jmet.nviolations)
        )
        for name in ("E", "R"):
            np.testing.assert_allclose(
                tstate.params[name].numpy(), np.asarray(jstate.params[name]), **TOL
            )
            np.testing.assert_allclose(
                tstate.opt_state[name]["p2"].numpy(),
                np.asarray(jstate.opt_state[name]["p2"]), **TOL,
            )
    assert tstate.step == int(jstate.step) == epochs * nb
    assert int(tmet.nviolations.sum()) > 0


@pytest.mark.parametrize("ties", ["mean", "optimistic"])
def test_filtered_ranking_matches_jax(ties):
    ds = synthetic_kg(30, 4, 200, n_test=25, seed=5)
    rng = np.random.default_rng(6)
    params = {"E": rng.normal(size=(30, 8)), "R": rng.normal(size=(4, 8))}
    params["E"][3] = params["E"][4]  # two entities tied everywhere
    known = ds.all_triples()
    want = JEval(JTransE(30, 4, 8, dtype="float64"), ds.test, known,
                 batch_size=10, ties=ties)({k: jnp.asarray(v) for k, v in params.items()})
    got = FilteredRankingEval(TransE(30, 4, 8, dtype="float64"), ds.test, known,
                              batch_size=10, ties=ties)(params_from_numpy(params, "cpu"))
    np.testing.assert_array_equal(got.ranks, want.ranks)
    np.testing.assert_array_equal(got.ranks_raw, want.ranks_raw)
    assert got.summary() == pytest.approx(want.summary())


def test_shared_pool_generalizes_on_latent_kg():
    """The port learns: held-out filtered MRR > 0.1 on the learnable KG of
    tests/test_training.py (built by the JAX package, handed over as NumPy)."""
    from skge_tpu.data import latent_kg

    kg = latent_kg(n_entities=400, n_relations=8, n_train=2400, n_test=300,
                   latent_dim=8, seed=3)
    model = TransE(kg.n_entities, kg.n_relations, ncomp=32, l1=False)
    opt = AdaGrad(lr=0.1)
    step = make_pairwise_step(model, opt, SharedNegativeSampler(kg.n_entities, k=64),
                              margin=1.0, aggregate="dense_pallas")
    epoch = make_epoch_fn(step, kg.train.shape[0], nbatches=8)
    state = init_state(model, opt, torch.Generator().manual_seed(1))
    xs = torch.as_tensor(kg.train, dtype=torch.int64)
    for _ in range(30):
        state, _ = epoch(state, xs)
    assert float(state.params["E"].norm(dim=1).max()) <= 1.0 + 1e-5
    res = FilteredRankingEval(model, kg.test, kg.all_triples(), batch_size=150)(
        state.params
    )
    assert res.mrr > 0.1, res.summary()
    assert params_to_numpy(state.params)["E"].shape == (400, 32)
