"""The port's streamed filtered ranking (`OutOfCoreTrainer.evaluate`)
against the JAX package's `OutOfCoreTrainer.evaluate` on the same state
and against the port's in-core `FilteredRankingEval` on the gathered
table: the rank arrays are equal exactly (fp64), mean and optimistic
ties, and with `reciprocal=True` against `ReciprocalEvalWrapper`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skge_tpu import AdaGrad as JAdaGrad
from skge_tpu.models import DistMult as JDistMult
from skge_tpu.models import TransE as JTransE
from skge_tpu.outofcore import OutOfCoreTrainer as JOutOfCoreTrainer
from skge_torch import AdaGrad, DistMult, TransE
from skge_torch.data import add_reciprocal_relations, synthetic_kg
from skge_torch.evaluation import FilteredRankingEval, ReciprocalEvalWrapper
from skge_torch.outofcore import OutOfCoreTrainer

torch.set_num_threads(1)


def trained(reciprocal):
    ds = synthetic_kg(90, 5, 900, n_test=80, seed=9 if reciprocal else 8, clustered=True)
    train_ds = add_reciprocal_relations(ds) if reciprocal else ds
    n_e, n_r = train_ds.n_entities, train_ds.n_relations
    if reciprocal:
        jm, tm = JDistMult(n_e, n_r, 16, dtype="float64"), DistMult(n_e, n_r, 16,
                                                                     dtype="float64")
        kw = dict(loss="ce", ce_directions=("o",))
    else:
        jm, tm = JTransE(n_e, n_r, 16, dtype="float64"), TransE(n_e, n_r, 16,
                                                                 dtype="float64")
        kw = {}
    args = dict(n_parts=3, k=32, nbatches=6, seed=1, **kw)
    ttr = OutOfCoreTrainer(tm, AdaGrad(lr=0.1), train_ds.train, device="cpu",
                           **args).fit(epochs=2)
    jtr = JOutOfCoreTrainer(jm, JAdaGrad(lr=0.1), train_ds.train, **args)
    jtr.e_host["param"][:] = ttr.e_host["param"].numpy()
    jtr.dev_params = {kk: jnp.asarray(v.numpy()) for kk, v in ttr.dev_params.items()}
    return ds, tm, jtr, ttr


@pytest.mark.parametrize("reciprocal", [False, True], ids=["native", "reciprocal"])
@pytest.mark.parametrize("ties", ["mean", "optimistic"])
def test_streamed_ranks_equal_jax_and_incore(ties, reciprocal):
    ds, tm, jtr, ttr = trained(reciprocal)
    got = ttr.evaluate(ds.test, ds.all_triples(), batch_size=32, ties=ties,
                       reciprocal=reciprocal)
    want = jtr.evaluate(ds.test, ds.all_triples(), batch_size=32, ties=ties,
                        reciprocal=reciprocal)
    np.testing.assert_array_equal(got.ranks, want.ranks)
    np.testing.assert_array_equal(got.ranks_raw, want.ranks_raw)
    assert got.mrr == want.mrr and got.hits == want.hits
    params = {k: torch.as_tensor(v) for k, v in ttr.params().items()}
    model = ReciprocalEvalWrapper(tm) if reciprocal else tm
    incore = FilteredRankingEval(model, ds.test, ds.all_triples(), batch_size=32,
                                 ties=ties)(params)
    np.testing.assert_array_equal(got.ranks, incore.ranks)
    np.testing.assert_array_equal(got.ranks_raw, incore.ranks_raw)
    assert got.mrr == incore.mrr
    np.testing.assert_array_equal(got.test, ds.test)
