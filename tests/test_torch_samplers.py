"""The port's samplers and their index helpers (skge_torch/sampling.py,
skge_torch/data.py) against the JAX package's.

Philox and threefry never agree, so each sampler's pure part (`corrupt`,
`expand`) is fed the JAX package's raw draws, reproduced here from the
same key splits, and must give JAX's corruptions and expanded pairs
exactly: LCWA with exhausted rows, Corrupted with an empty relation,
Bernoulli's disjoint slots. The index helpers must equal
`skge_tpu.data`'s; draws land on the generator's device.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import skge_tpu.data as jdata
from skge_tpu import sampling as jsampling
from skge_torch import sampling
from skge_torch.data import (Dataset, bernoulli_probs, encode_keys_np, sorted_train_keys,
                             type_index_arrays)

torch.set_num_threads(1)

N_E, N_R, B = 7, 4, 30


def t(x):
    return torch.as_tensor(np.array(x))


def make_data():
    """A dense little KG: subject 0 under relation 0 holds every object
    (LCWA's object corruptions of it exhaust), relation 3 is empty
    (Corrupted's uniform fallback)."""
    rng = np.random.default_rng(0)
    rand = np.stack([rng.integers(0, N_E, 40), rng.integers(0, N_E, 40),
                     rng.integers(0, 3, 40)], axis=1)
    full = np.stack([np.zeros(N_E, int), np.arange(N_E), np.zeros(N_E, int)], axis=1)
    train = np.unique(np.concatenate([rand, full]), axis=0).astype(np.int32)
    pos = train[rng.integers(0, len(train), B)].copy()
    pos[:5] = full[:5]
    pos[5:8, 2] = 3  # the empty relation (a positive need not be a train triple)
    mask = np.ones(B)
    mask[-3:] = 0.0
    return Dataset(train, train[:0], train[:0], N_E, N_R), pos, mask


def build(name, ds, modes=(0, 1)):
    """(JAX sampler, port sampler, raw draws from a key in the port's
    layout), the draws replaying the JAX sampler's own key splits."""
    n_e, n_r = ds.n_entities, ds.n_relations
    if name == "random-mode":
        def raw(key, b):
            return np.stack([jax.random.randint(k, (b,), 0, n_e)
                             for k in jax.random.split(key, len(modes))])
        return (jsampling.RandomModeSampler(n_e, modes),
                sampling.RandomModeSampler(n_e, modes), raw)
    if name == "lcwa":
        keys = sorted_train_keys(ds)

        def raw(key, b):
            return np.stack([jax.random.randint(k, (b, 3), 0, n_e)
                             for k in jax.random.split(key, len(modes))])
        return (jsampling.LCWASampler(n_e, n_r, jnp.asarray(keys), modes, ntries=3),
                sampling.LCWASampler(n_e, n_r, t(keys), modes, ntries=3), raw)
    if name == "bernoulli":
        probs = bernoulli_probs(ds.train, n_r)

        def raw(key, b):
            ks, ke = jax.random.split(key)
            return (t(jax.random.uniform(ks, (b,))),
                    t(jax.random.randint(ke, (b,), 0, n_e)))
        return (jsampling.BernoulliSampler(n_e, jnp.asarray(probs)),
                sampling.BernoulliSampler(n_e, t(probs)), raw)
    arrays = type_index_arrays(ds.train, n_r)

    def raw(key, b):
        us, fbs = [], []
        for k in jax.random.split(key, len(modes)):
            ku, kf = jax.random.split(k)
            us.append(jax.random.uniform(ku, (b,)))
            fbs.append(jax.random.randint(kf, (b,), 0, n_e))
        return t(np.stack(us)), t(np.stack(fbs))
    return (jsampling.CorruptedSampler(n_e, *map(jnp.asarray, arrays), modes=modes),
            sampling.CorruptedSampler(n_e, *map(t, arrays), modes=modes), raw)


SAMPLER_NAMES = ["random-mode", "lcwa", "bernoulli", "corrupted"]


def as_draws(draws):
    return t(draws) if isinstance(draws, np.ndarray) else draws


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", SAMPLER_NAMES)
def test_corruptions_match_jax_from_its_draws(name, seed):
    ds, pos, mask = make_data()
    jsm, tsm, raw = build(name, ds)
    key = jax.random.PRNGKey(seed)
    want = jsm.corruptions(key, jnp.asarray(pos), jnp.asarray(mask))
    draws = raw(key, B)
    got = tsm.corrupt(t(pos), t(mask), as_draws(draws))
    assert [m for m, _, _ in got] == [m for m, _, _ in want]
    for (_, repl, valid), (_, jrepl, jvalid) in zip(got, want):
        np.testing.assert_array_equal(repl.numpy(), np.asarray(jrepl))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


@pytest.mark.parametrize("name", SAMPLER_NAMES)
def test_expanded_pairs_match_jax_from_its_draws(name):
    ds, pos, mask = make_data()
    jsm, tsm, raw = build(name, ds)
    key = jax.random.PRNGKey(2)
    want = jsm(key, jnp.asarray(pos), jnp.asarray(mask))
    draws = raw(key, B)
    got = tsm.expand(t(pos), t(mask), as_draws(draws))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_lcwa_masks_exhausted_rows():
    """Object corruptions of (0, ., 0) collide with a training triple for
    every candidate: those pairs are masked out, the others are not."""
    ds, pos, mask = make_data()
    _, tsm, raw = build("lcwa", ds, modes=(1,))
    (_, repl, valid), = tsm.corrupt(t(pos), t(mask), t(raw(jax.random.PRNGKey(3), B)))
    assert np.all(valid[:5].numpy() == 0.0)
    known = set(map(int, sorted_train_keys(ds)))
    neg = pos.copy()
    neg[:, 1] = repl.numpy()
    for key, v, m in zip(encode_keys_np(neg, N_E, N_R), valid.numpy(), mask):
        assert v == 0.0 or (int(key) not in known and m == 1.0)
    assert valid.sum() > 0


def test_lcwa_takes_the_first_free_candidate():
    """`argmax` over the int-cast free mask picks the FIRST free
    candidate, as `jnp.argmax` does; no free candidate keeps candidate 0
    and masks the pair."""
    train = np.array([[0, 1, 0], [0, 2, 0], [0, 3, 0]], np.int32)
    ds = Dataset(train, train[:0], train[:0], N_E, N_R)
    smp = sampling.LCWASampler(N_E, N_R, t(sorted_train_keys(ds)), modes=(1,), ntries=4)
    pos = t(np.array([[0, 1, 0]] * 3))
    cands = t(np.array([[[1, 4, 5, 2], [2, 3, 1, 6], [3, 1, 2, 3]]]))
    (_, repl, valid), = smp.corrupt(pos, torch.ones(3), cands)
    assert repl.tolist() == [4, 6, 3] and valid.tolist() == [1.0, 1.0, 0.0]


def test_bernoulli_slots_are_disjoint():
    ds, pos, mask = make_data()
    _, tsm, raw = build("bernoulli", ds)
    (m0, r0, v0), (m1, r1, v1) = tsm.corrupt(t(pos), t(mask), raw(jax.random.PRNGKey(4), B))
    assert (m0, m1) == (0, 1) and torch.equal(r0, r1)
    np.testing.assert_array_equal((v0 + v1).numpy(), mask)
    assert float((v0 * v1).sum()) == 0.0
    assert 0 < float(v0.sum()) < float(mask.sum())


def test_corrupted_draws_by_relation_type():
    """Replacements come from the relation's observed entities in that
    role; the empty relation falls back to the uniform draw."""
    ds, pos, mask = make_data()
    _, tsm, raw = build("corrupted", ds)
    draws = raw(jax.random.PRNGKey(5), B)
    out = tsm.corrupt(t(pos), t(mask), draws)
    for (mode, repl, _), fallback in zip(out, draws[1]):
        for i, (r, p) in enumerate(zip(repl.tolist(), pos[:, 2])):
            seen = set(ds.train[ds.train[:, 2] == p, mode].tolist())
            assert r in seen if seen else r == int(fallback[i])


def test_keys_and_membership_match_jax():
    ds, pos, _ = make_data()
    skeys = sorted_train_keys(ds)
    probe = np.concatenate([pos, ds.train[:9], [[N_E - 1, N_E - 1, N_R - 1]]])
    np.testing.assert_array_equal(
        sampling.encode_keys(t(probe), N_E, N_R).numpy(),
        np.asarray(jsampling.encode_keys(jnp.asarray(probe), N_E, N_R)))
    keys = encode_keys_np(probe, N_E, N_R)  # includes a key above the last
    np.testing.assert_array_equal(
        sampling._is_member(t(skeys), t(keys)).numpy(),
        np.asarray(jsampling._is_member(jnp.asarray(skeys), jnp.asarray(keys))))


@pytest.mark.parametrize("seed", [0, 3])
def test_index_helpers_match_jax(seed):
    ds = jdata.synthetic_kg(40, 6, 300, seed=seed)
    train = ds.train[ds.train[:, 2] != 4]  # relation 4 empty
    port_ds = Dataset(train, ds.valid, ds.test, ds.n_entities, ds.n_relations)
    jds = jdata.Dataset(train, ds.valid, ds.test, ds.n_entities, ds.n_relations)
    got, want = sorted_train_keys(port_ds), jdata.sorted_train_keys(jds)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    for g, w in zip(type_index_arrays(train, 6), jdata.type_index_arrays(train, 6)):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    got, want = bernoulli_probs(train, 6), jdata.bernoulli_probs(train, 6)
    assert got.dtype == want.dtype == np.float32 and got[4] == 0.5
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", SAMPLER_NAMES)
def test_draws_land_on_the_generator_device(name):
    ds, pos, mask = make_data()
    _, tsm, _ = build(name, ds)
    gen = torch.Generator(device="cpu").manual_seed(0)
    draws = tsm.draw(gen, B)
    for x in (draws if isinstance(draws, tuple) else (draws,)):
        assert x.device == gen.device
    corr = tsm.corruptions(gen, t(pos), t(mask))
    assert all(r.shape == (B,) and r.device == gen.device for _, r, _ in corr)
    pos_rep, neg, pair_mask = tsm(gen, t(pos), t(mask))
    assert pos_rep.shape == neg.shape and pair_mask.shape == (neg.shape[0],)
    again = tsm.draw(torch.Generator().manual_seed(0), B)
    for x, y in zip(draws if isinstance(draws, tuple) else (draws,),
                    again if isinstance(again, tuple) else (again,)):
        assert torch.equal(x, y)


def test_sampler_registry_matches_jax():
    assert sampling.SAMPLERS.keys() == jsampling.SAMPLERS.keys()
    for name, cls in sampling.SAMPLERS.items():
        assert cls.__name__ == jsampling.SAMPLERS[name].__name__
