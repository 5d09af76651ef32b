"""Triple classification (skge_torch/evaluation.py) and the runtime checks
(skge_torch/utils/debug.py) of the port against the JAX package's:

- `_best_threshold` equal to JAX's on scores with ties, and the best
  accuracy over every cut;
- `classification_negatives` equal to JAX's for the same seed, and its
  refusal when the negatives cannot avoid the known triples;
- `triple_classification` thresholds (fp64 at 1e-9) and accuracies equal to
  JAX's for a ComplEx on a latent KG;
- `validate_triples`, `assert_finite_state`, and `checked_step` on a clean
  step, on an injected NaN, and with its index check.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skge_tpu import evaluation as jevaluation
from skge_tpu.models import ComplEx as JComplEx
from skge_tpu.utils import debug as jdebug
from skge_torch import AdaGrad, ComplEx, SharedNegativeSampler, TransE, evaluation
from skge_torch.convert import params_from_numpy
from skge_torch.data import latent_kg, synthetic_kg
from skge_torch.training import init_state, make_pairwise_step
from skge_torch.utils.debug import (CheckError, assert_finite_state, checked_step,
                                    validate_triples)

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", range(6))
def test_best_threshold_matches_jax(seed):
    rng = np.random.default_rng(seed)
    s = np.round(rng.normal(size=40), 1)  # rounded: tied scores
    y = np.where(rng.random(40) < 0.5, 1.0, -1.0)
    if seed == 4:
        y[:] = 1.0  # every label positive: the open bottom end
    tau = evaluation._best_threshold(s, y)
    assert tau == jevaluation._best_threshold(s, y)
    cuts = np.concatenate([[-np.inf, np.inf], (np.sort(s)[:-1] + np.sort(s)[1:]) / 2])
    best = max(np.mean(np.where(s >= c, 1.0, -1.0) == y) for c in cuts)
    assert np.mean(np.where(s >= tau, 1.0, -1.0) == y) == best


def test_classification_negatives_match_jax():
    ds = synthetic_kg(40, 3, 200, n_valid=30, seed=1)
    known = ds.all_triples()
    for n_relations in (None, 3):
        got = evaluation.classification_negatives(ds.valid, 40, known, seed=2,
                                                  n_relations=n_relations)
        want = jevaluation.classification_negatives(ds.valid, 40, known, seed=2,
                                                    n_relations=n_relations)
        np.testing.assert_array_equal(got, want)
    known_set = {tuple(t) for t in known.tolist()}
    assert not any(tuple(t) in known_set for t in got.tolist())
    # every (s, o) of one relation is known: no negative exists
    full = np.array([[s, o, 0] for s in range(4) for o in range(4)], np.int32)
    with pytest.raises(ValueError, match="still collide"):
        evaluation.classification_negatives(full[:2], 4, full, ntries=5)


def test_triple_classification_matches_jax():
    ds = latent_kg(60, 4, 120, n_valid=30, n_test=30, latent_dim=6, seed=3,
                   kind="bilinear", device="cpu")
    known = ds.all_triples()
    neg_v = evaluation.classification_negatives(ds.valid, 60, known, seed=1)
    neg_t = evaluation.classification_negatives(ds.test, 60, known, seed=2)
    # relation 3 only in test: it takes the global threshold
    valid = ds.valid[ds.valid[:, 2] != 3]
    neg_v = neg_v[ds.valid[:, 2] != 3]
    rng = np.random.default_rng(4)
    prm = {"E": rng.normal(size=(60, 8)), "R": rng.normal(size=(4, 8))}
    want = jevaluation.triple_classification(
        JComplEx(60, 4, 4, dtype="float64"), {k: jnp.asarray(v) for k, v in prm.items()},
        valid, neg_v, ds.test, neg_t, batch_size=16)
    got = evaluation.triple_classification(
        ComplEx(60, 4, 4, dtype="float64"), params_from_numpy(prm, "cpu"),
        valid, neg_v, ds.test, neg_t, batch_size=16)
    assert 3 not in got["thresholds"] and 3 in got["per_relation"]
    assert got["accuracy"] == want["accuracy"]
    assert got["per_relation"] == want["per_relation"]
    assert got["thresholds"].keys() == want["thresholds"].keys()
    for p, tau in want["thresholds"].items():
        np.testing.assert_allclose(got["thresholds"][p], tau, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(got["global_threshold"], want["global_threshold"],
                               rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("triples, n_e, n_r, message", [
    ([[0, 1, 0], [2, 0, 1]], 3, 2, None),
    ([[0, 5, 0]], 3, 2, "out of range"),
    ([[0, 1, 7]], 3, 2, "out of range"),
    ([[-1, 1, 0]], 3, 2, "out of range"),
    ([[0, 1], [1, 0]], 3, 2, r"\(N, 3\)"),
])
def test_validate_triples_matches_jax(triples, n_e, n_r, message):
    t = np.asarray(triples, np.int32)
    if message is None:
        validate_triples(t, n_e, n_r)
        jdebug.validate_triples(t, n_e, n_r)
        return
    msgs = []
    for fn in (validate_triples, jdebug.validate_triples):
        with pytest.raises(ValueError, match=message) as err:
            fn(t, n_e, n_r)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


@pytest.fixture(scope="module")
def setup():
    ds = synthetic_kg(50, 4, n_train=200, seed=11)
    model = TransE(ds.n_entities, ds.n_relations, ncomp=8)
    opt = AdaGrad(lr=0.1)
    step = make_pairwise_step(model, opt, SharedNegativeSampler(ds.n_entities, k=16),
                              0.5, aggregate="dense_pallas")
    state = init_state(model, opt, torch.Generator().manual_seed(0))
    batch = torch.as_tensor(ds.train[:32], dtype=torch.int64)
    return step, state, batch


def test_assert_finite_state(setup):
    _, state, _ = setup
    assert_finite_state(state)
    bad = dict(state.params)
    bad["R"] = bad["R"].clone()
    bad["R"][0, 0] = torch.inf
    with pytest.raises(FloatingPointError, match="param 'R'"):
        assert_finite_state(state._replace(params=bad))
    slots = {k: dict(v) for k, v in state.opt_state.items()}
    slots["E"]["p2"] = torch.full_like(slots["E"]["p2"], torch.nan)
    with pytest.raises(FloatingPointError, match="optimizer slot 'E'/'p2'"):
        assert_finite_state(state._replace(opt_state=slots))


def test_checked_step_clean_run(setup):
    step, state, batch = setup
    err, (new_state, m) = checked_step(step)(state, batch, torch.ones(32))
    err.throw()  # no error
    assert err.get() is None and new_state.step == 1
    assert torch.isfinite(m.loss)


def test_checked_step_catches_nan(setup):
    step, state, batch = setup
    bad = dict(state.params)
    bad["E"] = bad["E"].clone()
    bad["E"][int(batch[0, 0]), 0] = torch.nan
    err, _ = checked_step(step)(state._replace(params=bad), batch, torch.ones(32))
    assert isinstance(err, CheckError) and "nan" in err.get()
    with pytest.raises(FloatingPointError, match="nan"):
        err.throw()


def test_checked_step_index_check(setup):
    """Off by default; with the bounds it flags an out-of-range id before
    the step runs (a gather would raise on the CPU and stop the card)."""
    step, state, batch = setup
    bad = batch.clone()
    bad[5, 1] = 50
    err, (same, m) = checked_step(step, index_bounds=(50, 4))(state, bad, torch.ones(32))
    assert same is state and m is None
    with pytest.raises(IndexError, match="out-of-bounds entity id"):
        err.throw()
    bad = batch.clone()
    bad[7, 2] = -1
    err, _ = checked_step(step, index_bounds=(50, 4))(state, bad, torch.ones(32))
    with pytest.raises(IndexError, match="out-of-bounds relation id"):
        err.throw()
    err, _ = checked_step(step, index_bounds=(50, 4))(state, batch, torch.ones(32))
    assert err.get() is None
