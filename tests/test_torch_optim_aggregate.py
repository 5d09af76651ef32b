"""The port's aggregation (`ops/aggregate.py`) and optimizers (`optim.py`
of skge_torch) against the JAX package's, in fp64 at 1e-9.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skge_tpu import optim as joptim
from skge_tpu.ops import aggregate as jagg
from skge_torch import optim as toptim
from skge_torch import training
from skge_torch.models import TransE
from skge_torch.ops import aggregate as tagg

torch.set_num_threads(1)

TOL = dict(rtol=1e-9, atol=1e-12)


def occurrences(seed, t, r, feat):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, r + 1, t)  # r = the padding id, dropped
    grads = rng.normal(size=(t,) + feat)
    mask = (rng.random(t) < 0.6).astype(np.float64)
    return idx, grads, mask


@pytest.mark.parametrize("premasked", [False, True])
@pytest.mark.parametrize(
    "feat", [(7,), (150,), (151,), (3,), (64, 64)],
    ids=["fused_count", "count_pads_to_152", "count_needs_no_pad", "count_pads_to_4",
         "wide_rows"],
)
def test_segment_mean_dense_matches_jax(feat, premasked):
    r = 9
    idx, grads, mask = occurrences(0, 40, r, feat)
    if premasked:
        mask = mask * 3.0  # counts, as the fused gradient paths pass them
    want = jagg.segment_mean_dense(
        jnp.asarray(idx), jnp.asarray(grads), jnp.asarray(mask), r, premasked
    )
    got = tagg.segment_mean_dense(
        torch.as_tensor(idx), torch.as_tensor(grads), torch.as_tensor(mask), r,
        premasked,
    )
    assert got.grads.shape == (r,) + feat
    np.testing.assert_allclose(got.grads.numpy(), np.asarray(want.grads), **TOL)
    np.testing.assert_allclose(got.count.numpy(), np.asarray(want.count), **TOL)


def test_segment_mean_unique_matches_jax():
    r = 9
    idx, grads, mask = occurrences(1, 40, r, (5,))
    want = jagg.segment_mean_unique(
        jnp.asarray(idx), jnp.asarray(grads), jnp.asarray(mask), r
    )
    keep = np.asarray(want.uidx) < r  # JAX pads its unique list with r
    got = tagg.segment_mean_unique(
        torch.as_tensor(idx), torch.as_tensor(grads), torch.as_tensor(mask), r
    )
    np.testing.assert_array_equal(got.uidx.numpy(), np.asarray(want.uidx)[keep])
    np.testing.assert_allclose(got.grads.numpy(), np.asarray(want.grads)[keep], **TOL)
    np.testing.assert_allclose(got.count.numpy(), np.asarray(want.count)[keep], **TOL)


def table_and_grads(seed, r=11, d=6):
    rng = np.random.default_rng(seed)
    param = rng.normal(size=(r, d)) * 0.6  # some rows above norm 1
    p2 = rng.random((r, d))
    idx, grads, mask = occurrences(seed + 1, 30, r, (d,))
    return param, p2, idx, grads, mask


@pytest.mark.parametrize("post", [None, "normless1"])
@pytest.mark.parametrize("name", ["adagrad", "sgd"])
def test_apply_dense_masked_matches_jax(name, post):
    param, p2, idx, grads, mask = table_and_grads(2)
    r = param.shape[0]
    jopt, topt = joptim.OPTIMIZERS[name](lr=0.1), toptim.OPTIMIZERS[name](lr=0.1)
    jstate = {"p2": jnp.asarray(p2)} if name == "adagrad" else {}
    tstate = {"p2": torch.as_tensor(p2)} if name == "adagrad" else {}
    jdg = jagg.segment_mean_dense(
        jnp.asarray(idx), jnp.asarray(grads), jnp.asarray(mask), r
    )
    tdg = tagg.segment_mean_dense(
        torch.as_tensor(idx), torch.as_tensor(grads), torch.as_tensor(mask), r
    )
    want, want_st = jopt.apply_dense_masked(jnp.asarray(param), jstate, jdg, post)
    got, got_st = topt.apply_dense_masked(torch.as_tensor(param), tstate, tdg, post)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in want_st:
        np.testing.assert_allclose(got_st[k].numpy(), np.asarray(want_st[k]), **TOL)
    untouched = tdg.count.numpy() == 0
    assert untouched.any()
    np.testing.assert_array_equal(got.numpy()[untouched], param[untouched])


def test_apply_unique_matches_jax():
    param, p2, idx, grads, mask = table_and_grads(3)
    r = param.shape[0]
    jug = jagg.segment_mean_unique(
        jnp.asarray(idx), jnp.asarray(grads), jnp.asarray(mask), r
    )
    tug = tagg.segment_mean_unique(
        torch.as_tensor(idx), torch.as_tensor(grads), torch.as_tensor(mask), r
    )
    want, want_st = joptim.AdaGrad(lr=0.1).apply_unique(
        jnp.asarray(param), {"p2": jnp.asarray(p2)}, jug, "normless1"
    )
    got, got_st = toptim.AdaGrad(lr=0.1).apply_unique(
        torch.as_tensor(param), {"p2": torch.as_tensor(p2)}, tug, "normless1"
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_st["p2"].numpy(), np.asarray(want_st["p2"]), **TOL)


def test_normless1_rows_matches_jax():
    rows = np.random.default_rng(4).normal(size=(20, 5)) * 0.7
    want = joptim.normless1_rows(jnp.asarray(rows))
    got = toptim.normless1_rows(torch.as_tensor(rows))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got.norm(dim=1).max()) <= 1.0 + 1e-12


@pytest.mark.parametrize(
    "aggregate", ["unique", "dense", "dense_pallas", "dense_sorted"]
)
def test_batch_without_violations_changes_nothing(aggregate):
    """No violating pair => params and AdaGrad state bit-for-bit unchanged."""
    n_e, n_r, d, b = 20, 4, 8, 16
    model = TransE(n_e, n_r, d, dtype="float64")
    opt = toptim.AdaGrad(lr=0.1)
    gen = torch.Generator().manual_seed(0)
    params = model.init_params(gen)
    state = {k: {"p2": torch.rand(v.shape, generator=gen, dtype=v.dtype)}
             for k, v in params.items()}
    rng = np.random.default_rng(5)
    pos = torch.as_tensor(np.stack(
        [rng.integers(0, n_e, b), rng.integers(0, n_e, b), rng.integers(0, n_r, b)],
        axis=1))
    pool = torch.as_tensor(rng.integers(0, n_e, 7))
    _, nviol, occ, g_dense = training.pairwise_grads_shared(
        model, params, pos, pool, torch.ones(b), margin=-1e6
    )
    assert float(nviol) == 0.0
    new, new_state = training.apply_gradients(
        model, opt, params, state, occ, g_dense, aggregate, premasked=True
    )
    for k in params:
        assert torch.equal(new[k], params[k]), k
        assert torch.equal(new_state[k]["p2"], state[k]["p2"]), k
