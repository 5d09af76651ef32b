"""The port's training-quality gates at the reference operating point, the
counterpart of tests/test_quality_gates.py: HolE and RESCAL must train at
the reference hyperparameters (margin 0.2, lr 0.1, iid corruption,
sigmoid before the margin for HolE) on a learnable latent KG, with the
port's own draws and the JAX package's thresholds.

The three 2,000-entity geometry gates of that file (RESCAL and TransE on
the bilinear KG, RotatE on the rotational KG, selfadv, 100 epochs) run at
their real size on the card, in `chip_smoke.py` phase 14c: on the CPU
they take minutes.
"""

import torch

from skge_torch import (AdaGrad, HolE, RESCAL, RandomModeSampler, evaluate,
                        init_state, make_epoch_fn, make_pairwise_step)
from skge_torch.data import latent_kg

torch.set_num_threads(1)


def _train_eval(model, ds, epochs, nbatches=10, seed=0):
    opt = AdaGrad(lr=0.1)  # reference _DEF_LEARNING_RATE
    sampler = RandomModeSampler(ds.n_entities, modes=(0, 1))
    step = make_pairwise_step(model, opt, sampler, margin=0.2)  # ref margin
    epoch = make_epoch_fn(step, ds.train.shape[0], nbatches)
    gen = torch.Generator()
    gen.manual_seed(seed)
    state = init_state(model, opt, gen)
    xs = torch.as_tensor(ds.train, dtype=torch.int64)
    first = last = None
    for e in range(epochs):
        state, m = epoch(state, xs)
        v = float(m.nviolations.sum())
        if e == 0:
            first = v
        last = v
    return first, last, evaluate(model, state.params, ds.test, ds.all_triples())


def test_hole_trains_at_reference_config():
    ds = latent_kg(n_entities=400, n_relations=8, n_train=2500, n_test=200,
                   latent_dim=8, seed=3, device="cpu")
    model = HolE(ds.n_entities, ds.n_relations, 32, dtype="float32")
    assert model.pairwise_af == "sigmoid"  # skge/hole.py ~70 semantics
    first, last, res = _train_eval(model, ds, epochs=120)
    # random filtered MRR ~0.016, H@10 ~10/400
    assert last < 0.35 * first, (first, last)
    assert res.mrr > 0.08, res
    assert res.hits[10] > 0.15, res


def test_rescal_trains_at_reference_config():
    ds = latent_kg(n_entities=400, n_relations=8, n_train=2500, n_test=200,
                   latent_dim=8, seed=4, device="cpu")
    model = RESCAL(ds.n_entities, ds.n_relations, 16, dtype="float32", rparam=0.0)
    first, last, res = _train_eval(model, ds, epochs=120)
    assert last < 0.5 * first, (first, last)
    assert res.mrr > 0.08, res
