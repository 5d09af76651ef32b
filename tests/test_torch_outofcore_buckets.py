"""One out-of-core bucket epoch of the port against the JAX package's, at
P=3, diagonal and off-diagonal, for each loss, fp64 at 1e-9.

Both trainers start from the same state: the JAX trainer's host table and
relation params, with warm optimizer slots. The JAX package's draws (the
bucket's permutation, each step's pool from its bucket sampler, through
its key splits) are replayed into the port. The JAX epoch appends a
masked sentinel row to every minibatch; the port appends none, so this
also checks that the row adds nothing.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skge_tpu import AdaGrad as JAdaGrad
from skge_tpu import Adam as JAdam
from skge_tpu.models import DistMult as JDistMult
from skge_tpu.models import TransE as JTransE
from skge_tpu.outofcore import BucketPoolSampler as JBucketPoolSampler
from skge_tpu.outofcore import OutOfCoreTrainer as JOutOfCoreTrainer
from skge_torch import AdaGrad, Adam, DistMult, TransE
from skge_torch.data import synthetic_kg
from skge_torch.outofcore import BucketPoolSampler, OutOfCoreTrainer

torch.set_num_threads(1)

TOL = dict(rtol=1e-9, atol=1e-11)
K, NB = 16, 3
LOSSES = {  # loss: (model, optimizer, trainer keywords)
    "margin": ("transe-l1", "adagrad", {}),
    "pointwise": ("transe-l1", "adagrad", {"pairwise": False}),
    "selfadv": ("transe-l2", "adagrad", {"loss": "selfadv", "margin": 2.0,
                                         "adv_alpha": 1.5}),
    "ce": ("distmult", "adagrad", {"loss": "ce", "label_smoothing": 0.1}),
    "sampled_ce": ("distmult", "adam", {"loss": "sampled_ce", "label_smoothing": 0.1}),
}


class Replay(BucketPoolSampler):
    """The port's bucket sampler, handing out recorded pools."""

    def __init__(self, base, pools):
        super().__init__(base.slot_stride, base.k, base.modes)
        self.pools = list(pools)

    def pool(self, generator, pos, mask):
        return torch.as_tensor(self.pools.pop(0))


def jax_draws(jtr, loss, diag, pi, pj):
    """The permutation and pools JAX's bucket epoch draws from `jtr.key`."""
    key, pk = jax.random.split(jtr.key)
    perm = np.asarray(jax.random.permutation(pk, jtr.bucket_len))
    sampler = JBucketPoolSampler(slot_stride=0 if diag else jtr.part_size, k=K)
    sentinel = jnp.asarray([[jtr.part_counts[pi], jtr.part_counts[pj], 0]], jnp.int32)
    pools = []
    for _ in range(max(1, min(NB, jtr.bucket_len))):
        key, sk = jax.random.split(key)
        if loss != "ce":
            pools.append(np.asarray(sampler.pool(sk, sentinel, None)).astype(np.int64))
    return perm, pools


def trainers(loss):
    name, opt, kw = LOSSES[loss]
    ds = synthetic_kg(90, 5, 900, seed=8, clustered=True)
    if name == "distmult":
        jm = JDistMult(ds.n_entities, ds.n_relations, 8, dtype="float64")
        tm = DistMult(ds.n_entities, ds.n_relations, 8, dtype="float64")
    else:
        l1 = name == "transe-l1"
        jm = JTransE(ds.n_entities, ds.n_relations, 8, l1=l1, dtype="float64")
        tm = TransE(ds.n_entities, ds.n_relations, 8, l1=l1, dtype="float64")
    jopt, topt = ((JAdam(lr=0.05), Adam(lr=0.05)) if opt == "adam"
                  else (JAdaGrad(lr=0.1), AdaGrad(lr=0.1)))
    args = dict(n_parts=3, k=K, nbatches=NB, seed=1, **kw)
    jtr = JOutOfCoreTrainer(jm, jopt, ds.train, **args)
    ttr = OutOfCoreTrainer(tm, topt, ds.train, device="cpu", **args)
    # warm slots, the same in both
    rng = np.random.default_rng(3)
    for kk, v in jtr.e_host.items():
        if kk != "param":
            v[:] = (rng.integers(0, 5, v.shape) if kk == "t" else rng.random(v.shape))
    jtr.dev_opt = {kk: {sn: jnp.asarray(rng.integers(0, 5, v.shape).astype(v.dtype)
                                        if sn == "t" else rng.random(v.shape))
                        for sn, v in slots.items()}
                   for kk, slots in jtr.dev_opt.items()}
    for kk, v in jtr.e_host.items():
        ttr.e_host[kk][:] = torch.as_tensor(v)
    ttr.dev_params = {kk: torch.as_tensor(np.array(v)) for kk, v in jtr.dev_params.items()}
    ttr.dev_opt = {kk: {sn: torch.as_tensor(np.array(v)) for sn, v in slots.items()}
                   for kk, slots in jtr.dev_opt.items()}
    ttr.step = int(jtr.step)
    return jtr, ttr


@pytest.mark.parametrize("diag", [True, False], ids=["diagonal", "off-diagonal"])
@pytest.mark.parametrize("loss", list(LOSSES))
def test_bucket_epoch_matches_jax(loss, diag):
    jtr, ttr = trainers(loss)
    pi, pj = next(b for b in jtr._bucket_order() if (b[0] == b[1]) == diag)
    perm, pools = jax_draws(jtr, loss, diag, pi, pj)
    ttr._samplers[diag] = Replay(ttr._samplers[diag], pools)
    jloss, jviol = jtr._bucket_epoch(pi, pj)
    tloss, tviol = ttr._bucket_epoch(pi, pj, perm=torch.as_tensor(np.array(perm)))
    assert not ttr._samplers[diag].pools
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    assert float(tviol) == float(jviol)
    jtr.flush()
    ttr.flush()
    for kk, v in jtr.e_host.items():
        np.testing.assert_allclose(ttr.e_host[kk].numpy(), v, **TOL, err_msg=kk)
    for kk, v in jtr.dev_params.items():
        np.testing.assert_allclose(ttr.dev_params[kk].numpy(), np.asarray(v), **TOL)
    for kk, slots in jtr.dev_opt.items():
        for sn, v in slots.items():
            np.testing.assert_allclose(ttr.dev_opt[kk][sn].numpy(), np.asarray(v),
                                       **TOL, err_msg=f"{kk} {sn}")
    assert ttr.step == int(jtr.step)
