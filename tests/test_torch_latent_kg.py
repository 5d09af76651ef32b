"""The port's learnable synthetic KGs (skge_torch/data.py `latent_kg`,
`_lattice_kg`) against the JAX package's, for all four kinds:

- `lattice` (host NumPy, no sweep) is bit-equal, with and without noise;
- the swept kinds at small n_e equal JAX's exactly wherever this test's
  own top-2-gap check (fp64 scores of every candidate) finds no near-tie,
  and the port's objects are the fp64 argmax there;
- the blocked sweep, its threshold lowered, equals the single matmul, and
  keeps the earlier block on a tie;
- JAX's ValueErrors are raised.
"""

import numpy as np
import pytest
import torch

from skge_tpu import data as jdata
from skge_torch import data

torch.set_num_threads(1)

GAP = 1e-4  # a near-tie: the best two candidates closer than this in fp64
SWEPT = ("translational", "bilinear", "rotational")


def splits(ds):
    return ds.train, ds.valid, ds.test


def assert_same(a, b):
    for x, y in zip(splits(a), splits(b)):
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)
    assert (a.n_entities, a.n_relations) == (b.n_entities, b.n_relations)


@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_lattice_is_bit_equal(noise):
    kw = dict(n_entities=5 ** 3, n_relations=6, n_train=300, n_valid=20, n_test=30,
              latent_dim=3, noise=noise, seed=4)
    want = jdata.latent_kg(kind="lattice", **kw)
    assert_same(data.latent_kg(kind="lattice", device="cpu", **kw), want)
    assert_same(data._lattice_kg(*(kw[k] for k in (
        "n_entities", "n_relations", "n_train", "n_valid", "n_test", "latent_dim",
        "noise", "seed"))), want)


def fp64_scores(kind, Z, Rel, s, p):
    """(n, n_e) fp64 scores of every candidate for the queries (s, p)."""
    Z, Rel = Z.astype(np.float64), Rel.astype(np.float64)
    if kind == "translational":
        q = Z[s] + Rel[p]
    elif kind == "rotational":
        h = Z.shape[1] // 2
        a, b = Z[s, :h], Z[s, h:]
        c, sn = np.cos(Rel[p]), np.sin(Rel[p])
        q = np.concatenate([a * c - b * sn, a * sn + b * c], axis=1)
    else:
        q = np.einsum("bd,bde->be", Z[s], Rel[p])
        return q @ Z.T
    return -np.sum((q[:, None, :] - Z[None, :, :]) ** 2, axis=2)


@pytest.mark.parametrize("kind", SWEPT)
def test_swept_kinds_equal_jax_away_from_near_ties(kind):
    n_e, n_r, dim, seed = 80, 5, 8, 6
    kw = dict(n_entities=n_e, n_relations=n_r, n_train=220, n_valid=20, n_test=20,
              latent_dim=dim, seed=seed, kind=kind)
    want = jdata.latent_kg(**kw)
    got = data.latent_kg(device="cpu", **kw)
    Z, Rel = data.latent_tables(np.random.default_rng(seed), n_e, n_r, dim, kind)
    # noise-free, the object is a function of (s, p): check every query
    # that appears in either dataset
    objs = [{(s, p): o for s, o, p in ds.all_triples().tolist()} for ds in (got, want)]
    queries = np.array(sorted(set(objs[0]) | set(objs[1])))
    sc = fp64_scores(kind, Z, Rel, queries[:, 0], queries[:, 1])
    top2 = np.sort(sc, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > GAP
    best = np.argmax(sc, axis=1)
    for (s, p), ok, o in zip(queries.tolist(), clear, best):
        if ok:
            for which in objs:
                assert which.get((s, p), o) == o, (kind, s, p)
    if clear.all():
        assert_same(got, want)


@pytest.mark.parametrize("kind", SWEPT)
def test_blocked_sweep_equals_single_matmul(kind, monkeypatch):
    kw = dict(n_entities=500, n_relations=4, n_train=900, latent_dim=8, seed=2,
              kind=kind, device="cpu")
    ref = data.latent_kg(**kw)
    monkeypatch.setattr(data, "_BLOCKED_SWEEP_THRESHOLD", 100)
    assert_same(data.latent_kg(**kw), ref)


@pytest.mark.parametrize("kind", SWEPT)
def test_blocked_sweep_keeps_the_earlier_block_on_a_tie(kind):
    """Entities 7 and 130 (blocks 0 and 1 of 100) are the same point, the
    best one for query 0: the single argmax and the blocked running argmax
    both give 7."""
    Z, Rel = data.latent_tables(np.random.default_rng(3), 250, 3, 8, kind)
    s = np.arange(250, dtype=np.int32)
    p = (s % 3).astype(np.int32)
    Zt, Rt = torch.as_tensor(Z), torch.as_tensor(Rel)
    q = data.latent_queries(kind, Zt, Rt, torch.tensor([0]), torch.tensor([0]),
                            torch.zeros(1, 8))[0]
    Zt[7] = Zt[130] = q / q.norm() if kind == "bilinear" else q
    zn = torch.sum(Zt * Zt, dim=1)
    eps = np.zeros((1, 8), np.float32)
    single = data.latent_assign(kind, Zt, Rt, zn, s, p, eps, None)
    blocked = data.latent_assign(kind, Zt, Rt, zn, s, p, eps, 100)
    np.testing.assert_array_equal(single, blocked)
    assert single[0] == 7
    assert not np.any(single == 130)


@pytest.mark.parametrize("kwargs, message", [
    (dict(n_entities=20, n_relations=2, n_train=10, kind="spiral"),
     "unknown latent kind 'spiral'"),
    (dict(n_entities=20, n_relations=2, n_train=10, latent_dim=5, kind="rotational"),
     "rotational geometry needs an even latent_dim"),
    (dict(n_entities=10, n_relations=2, n_train=100), "unique noise-free"),
    (dict(n_entities=8, n_relations=2, n_train=100, latent_dim=3, kind="lattice"),
     "unique noise-free"),
    (dict(n_entities=65, n_relations=5, n_train=10, latent_dim=3, kind="lattice"),
     "perfect"),
])
def test_value_errors_match_jax(kwargs, message):
    msgs = []
    for fn in (jdata.latent_kg, data.latent_kg):
        with pytest.raises(ValueError, match=message) as err:
            fn(**kwargs)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
