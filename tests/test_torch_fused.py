"""The port's iid gradient paths (skge_torch/training.py) against the JAX
package's, fp64 at 1e-9 with identical occurrence counts, for the models of
`tests/test_parity.py` (TransE L1/L2, HolE, RESCAL, ER-MLP):

- `pairwise_grads_fused` + `apply_gradients` under `unique`, `dense` and
  `dense_pallas`, with corruptions of both modes in mixed order (the port
  stacks each mode's corruptions into one score call), with valid masks
  below 1, and at `bench.py --negatives 8`'s 16 corruptions;
- the fused path against `tests/oracle/oracle_numpy.py`, the second judge;
- the zero-violation no-op.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skge_tpu import training as jtraining
from skge_tpu.optim import AdaGrad as JAdaGrad
from skge_torch import ERMLP, RESCAL, AdaGrad, HolE, TransE, training
from skge_torch.convert import params_from_numpy
from test_parity import B, CASES, LR, N_E, N_R, D, make_batch, make_params, oracle_apply

torch.set_num_threads(1)

TOL = dict(rtol=1e-9, atol=1e-11)
MARGIN = 0.8
# unsorted, with a repeated mode: the port's per-mode stacking reorders them
MODES = (0, 1, 1, 0, 1)

PORT = {
    "transe": lambda: TransE(N_E, N_R, D, dtype="float64", l1=True),
    "transe_l2": lambda: TransE(N_E, N_R, D, dtype="float64", l1=False),
    "hole": lambda: HolE(N_E, N_R, D, dtype="float64", rparam=0.01),
    "rescal": lambda: RESCAL(N_E, N_R, D, dtype="float64", rparam=0.02),
    "ermlp": lambda: ERMLP(N_E, N_R, D, dtype="float64", nhidden=7),
}


def t(x):
    return torch.as_tensor(np.asarray(x))


def start(case, seed=0):
    """(JAX model, port model, params, warm AdaGrad accumulators)."""
    jm, tm = CASES[case][0](), PORT[case]()
    prm = make_params(jm.name, seed)
    rng = np.random.default_rng(seed + 50)
    return jm, tm, prm, {k: rng.random(v.shape) for k, v in prm.items()}


def corruption_draws(seed, modes=MODES, partial=False):
    rng = np.random.default_rng(seed)
    return [
        (mode, rng.integers(0, N_E, B),
         (rng.random(B) < 0.6).astype(np.float64) if partial else np.ones(B))
        for mode in modes
    ]


def batch_mask():
    mask = np.ones(B)
    mask[-4:] = 0.0  # padding rows
    return mask


def jax_apply(jm, prm, p2, occ, g_dense, aggregate, premasked):
    return jtraining.apply_gradients(
        jm, JAdaGrad(lr=LR), {k: jnp.asarray(v) for k, v in prm.items()},
        {k: {"p2": jnp.asarray(v)} for k, v in p2.items()}, occ, g_dense,
        aggregate, premasked=premasked,
    )


def torch_apply(tm, prm, p2, occ, g_dense, aggregate, premasked):
    return training.apply_gradients(
        tm, AdaGrad(lr=LR), params_from_numpy(prm, "cpu"),
        {k: {"p2": t(v)} for k, v in p2.items()}, occ, g_dense, aggregate,
        premasked=premasked,
    )


def row_counts(occ, pname, n_rows):
    """Occurrence count per table row, summed over the occurrence list."""
    idx, _, counts = occ[pname]
    return np.bincount(np.asarray(idx), weights=np.asarray(counts), minlength=n_rows)


def assert_same_update(jm, jout, tout, jocc, tocc):
    (jnew, jost), (tnew, tost) = jout, tout
    for pname in jocc:
        np.testing.assert_array_equal(
            row_counts(tocc, pname, jm.num_rows(pname)),
            row_counts(jocc, pname, jm.num_rows(pname)), err_msg=pname,
        )
    for k in jnew:
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]), **TOL,
                                   err_msg=f"param {k}")
        np.testing.assert_allclose(tost[k]["p2"].numpy(),
                                   np.asarray(jost[k]["p2"]), **TOL,
                                   err_msg=f"p2 {k}")


def fused_both(case, aggregate, corr, seed=0, margin=MARGIN):
    jm, tm, prm, p2 = start(case, seed)
    pos, mask = make_batch(seed=13), batch_mask()
    jl, jn, jocc, jg = jtraining.pairwise_grads_fused(
        jm, {k: jnp.asarray(v) for k, v in prm.items()}, jnp.asarray(pos),
        [(m, jnp.asarray(r), jnp.asarray(v)) for m, r, v in corr],
        jnp.asarray(mask), margin,
    )
    tl, tn, tocc, tg = training.pairwise_grads_fused(
        tm, params_from_numpy(prm, "cpu"), t(pos),
        [(m, t(r), t(v)) for m, r, v in corr], t(mask), margin,
    )
    assert int(tn) == int(jn)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-9)
    assert_same_update(
        jm, jax_apply(jm, prm, p2, jocc, jg, aggregate, True),
        torch_apply(tm, prm, p2, tocc, tg, aggregate, True), jocc, tocc,
    )
    return int(tn)


@pytest.mark.parametrize("aggregate", ["unique", "dense", "dense_pallas"])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_step_matches_jax(case, aggregate):
    assert fused_both(case, aggregate, corruption_draws(14)) > 0


@pytest.mark.parametrize("case", list(CASES))
def test_fused_valid_masks_below_one_match_jax(case):
    """Sampler masks (LCWA's exhausted rows, Bernoulli's slots) gate the
    violation mask as the batch mask does."""
    assert fused_both(case, "dense_pallas", corruption_draws(15, partial=True)) > 0


def test_fused_bench_negatives_match_jax():
    """`bench.py --sampler random-mode --negatives 8`: 16 corruptions."""
    corr = corruption_draws(16, modes=(0, 1) * 8, partial=True)
    assert fused_both("transe", "dense_pallas", corr) > 0


@pytest.mark.parametrize("case", ["transe", "hole", "ermlp"])
def test_fused_zero_violations_is_noop(case):
    jm, tm, prm, p2 = start(case)
    _, nviol, occ, g_dense = training.pairwise_grads_fused(
        tm, params_from_numpy(prm, "cpu"), t(make_batch(seed=17)),
        [(m, t(r), t(v)) for m, r, v in corruption_draws(18)], t(batch_mask()),
        -1e6,
    )
    new, ost = torch_apply(tm, prm, p2, occ, g_dense, "dense_pallas", True)
    assert int(nviol) == 0
    for k in prm:
        np.testing.assert_array_equal(new[k].numpy(), prm[k])
        np.testing.assert_array_equal(ost[k]["p2"].numpy(), p2[k])


@pytest.mark.parametrize("case", list(CASES))
def test_fused_matches_oracle(case):
    """The second judge: the reference-style expanded pair lists through
    the framework-free NumPy oracle, from AdaGrad's zero state."""
    tm = PORT[case]()
    prm = make_params(tm.name, seed=3)
    oracle = CASES[case][1](prm, margin=MARGIN)
    pos = make_batch(seed=24)
    corr = corruption_draws(25, modes=(1, 0, 1))
    negs = []
    for mode, repl, _ in corr:
        neg = pos.copy()
        neg[:, mode] = repl
        negs.append(neg)
    grads, nviol = oracle.pairwise_gradients(
        [tuple(map(int, x)) for x in np.concatenate([pos] * len(corr))],
        [tuple(map(int, x)) for x in np.concatenate(negs)],
    )
    want_prm, want_p2 = oracle_apply(grads, {k: v.copy() for k, v in prm.items()}, tm)
    _, tn, occ, g_dense = training.pairwise_grads_fused(
        tm, params_from_numpy(prm, "cpu"), t(pos),
        [(m, t(r), t(v)) for m, r, v in corr], torch.ones(B, dtype=torch.float64),
        MARGIN,
    )
    new, ost = torch_apply(tm, prm, {k: np.zeros_like(v) for k, v in prm.items()},
                           occ, g_dense, "unique", True)
    assert int(tn) == nviol > 0
    for k in prm:
        np.testing.assert_allclose(new[k].numpy(), want_prm[k], **TOL, err_msg=k)
        np.testing.assert_allclose(ost[k]["p2"].numpy(), want_p2[k], **TOL, err_msg=k)
