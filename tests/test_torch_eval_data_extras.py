"""The port's evaluation breakdowns, reciprocal ranking and data helpers
against the JAX package's: `RankingResult.by_direction`/`by_relation`/
`by_category`, `relation_categories`, `ReciprocalEvalWrapper` and
`evaluate`, `unigram_logits`, `add_reciprocal_relations`, the reference
pickle both ways, `load_tsv` through the native and the Python reader; and
the unigram pool draw, whose frequencies follow softmax(logits) (JAX's
categorical draws cannot be matched id for id).
"""

import numpy as np
import pytest
import torch
from scipy import stats

from skge_tpu import data as jdata
from skge_tpu import evaluation as jeval
from skge_tpu.models import RESCAL as JRESCAL
from skge_torch import RESCAL, SharedNegativeSampler, evaluation
from skge_torch import data as tdata
from skge_torch import native
from skge_torch.convert import params_from_numpy

torch.set_num_threads(1)


def _ranks(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 30, (2, n)).astype(np.float64)


def test_breakdowns_match_jax():
    ds = jdata.synthetic_kg(30, 6, 400, n_test=60, seed=1)
    ranks, raw = _ranks(2, 60), _ranks(3, 60)
    common = dict(mrr=0.1, mrr_raw=0.1, mean_rank=3.0, mean_rank_raw=3.0, hits={},
                  hits_raw={}, ranks=ranks, ranks_raw=raw, test=ds.test)
    want, got = jeval.RankingResult(**common), evaluation.RankingResult(**common)
    assert got.by_direction() == want.by_direction()
    assert got.by_direction((1, 5)) == want.by_direction((1, 5))
    assert got.by_relation() == want.by_relation()
    cats = jeval.relation_categories(ds.train)
    assert evaluation.relation_categories(ds.train) == cats
    assert evaluation.relation_categories(ds.train, threshold=3.0) == \
        jeval.relation_categories(ds.train, threshold=3.0)
    del cats[int(ds.test[0, 2])]  # an uncategorized relation
    assert got.by_category(cats) == want.by_category(cats)
    no_test = evaluation.RankingResult(**{**common, "test": None})
    with pytest.raises(ValueError):
        no_test.by_relation()


def test_reciprocal_wrapper_and_evaluate_match_jax():
    ds = jdata.add_reciprocal_relations(jdata.synthetic_kg(25, 3, 300, n_test=40, seed=4))
    rng = np.random.default_rng(5)
    params = {"E": rng.normal(size=(25, 5)), "W": rng.normal(size=(6, 5, 5))}
    jm, tm = JRESCAL(25, 6, 5, dtype="float64"), RESCAL(25, 6, 5, dtype="float64")
    jp = {k: np.asarray(v) for k, v in params.items()}
    want = jeval.evaluate(jeval.ReciprocalEvalWrapper(jm), jp, ds.test, ds.all_triples(),
                          batch_size=16)
    got = evaluation.evaluate(evaluation.ReciprocalEvalWrapper(tm),
                              params_from_numpy(params, "cpu"), ds.test,
                              ds.all_triples(), batch_size=16)
    np.testing.assert_array_equal(got.ranks, want.ranks)
    np.testing.assert_array_equal(got.ranks_raw, want.ranks_raw)
    assert got.summary() == pytest.approx(want.summary(), rel=1e-12)
    plain = evaluation.evaluate(tm, params_from_numpy(params, "cpu"), ds.test)
    assert not np.array_equal(plain.ranks[1], got.ranks[1])  # head queries differ
    with pytest.raises(ValueError):
        evaluation.ReciprocalEvalWrapper(RESCAL(25, 3, 5))


def test_unigram_logits_and_reciprocal_relations_match_jax():
    ds = jdata.synthetic_kg(50, 4, 300, n_valid=20, n_test=20, seed=6)
    ds.relations = [f"rel{i}" for i in range(4)]
    for alpha, smoothing in ((0.75, 1.0), (1.0, 0.5)):
        np.testing.assert_array_equal(
            tdata.unigram_logits(ds.train, 60, alpha, smoothing),
            jdata.unigram_logits(ds.train, 60, alpha, smoothing))
    want = jdata.add_reciprocal_relations(ds)
    got = tdata.add_reciprocal_relations(tdata.Dataset(
        ds.train, ds.valid, ds.test, 50, 4, relations=ds.relations))
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(getattr(got, split), getattr(want, split))
    assert got.train.dtype == np.int32
    assert (got.n_relations, got.relations) == (want.n_relations, want.relations)


def test_reference_pickle_both_ways(tmp_path):
    ds = jdata.synthetic_kg(20, 3, 50, n_valid=5, n_test=6, seed=7)
    jdata.save_dataset(ds, str(tmp_path / "j.pkl"))
    got = tdata.load_dataset(str(tmp_path / "j.pkl"))
    tdata.save_dataset(got, str(tmp_path / "t.pkl"))
    back = jdata.load_dataset(str(tmp_path / "t.pkl"))
    for d in (got, back):
        for split in ("train", "valid", "test"):
            np.testing.assert_array_equal(getattr(d, split), getattr(ds, split))
        assert (d.n_entities, d.n_relations) == (20, 3)
        assert d.entities == [f"e{i}" for i in range(20)]


@pytest.mark.parametrize("order", ["spo", "sop"])
@pytest.mark.parametrize("use_native", [True, False])
def test_load_tsv_matches_jax(tmp_path, order, use_native):
    if use_native:
        assert native.native_available()
    rng = np.random.default_rng(8)
    paths = []
    for split, n in (("train", 40), ("valid", 6), ("test", 7)):
        p = tmp_path / f"{split}.txt"
        lines = []
        for s, o, r in zip(rng.integers(0, 15, n), rng.integers(0, 15, n),
                           rng.integers(0, 4, n)):
            cols = {"s": f"/m/e{s}", "p": f"rel_{r}", "o": f"/m/e{o}"}
            lines.append("\t".join(cols[c] for c in order))
        p.write_text("\n".join(lines + [""]))
        paths.append(str(p))
    want = jdata.load_tsv(*paths, order=order, use_native=False)
    got = tdata.load_tsv(*paths, order=order, use_native=use_native)
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(getattr(got, split), getattr(want, split))
        assert getattr(got, split).dtype == np.int32
    assert (got.entities, got.relations) == (want.entities, want.relations)
    assert (got.n_entities, got.n_relations) == (want.n_entities, want.n_relations)


def test_unigram_pool_draw_follows_softmax():
    n_e, k, rounds = 12, 500, 40
    logits = tdata.unigram_logits(
        np.random.default_rng(9).integers(0, n_e, (300, 3)).astype(np.int32), n_e, 1.0)
    sampler = SharedNegativeSampler(n_e, k=k, logits=logits)
    gen = torch.Generator().manual_seed(10)
    ids = torch.cat([sampler.pool(gen, None, None) for _ in range(rounds)])
    assert ids.dtype == torch.int64 and ids.shape == (k * rounds,)
    assert int(ids.min()) >= 0 and int(ids.max()) < n_e
    counts = np.bincount(ids.numpy(), minlength=n_e)
    p = torch.softmax(torch.as_tensor(logits, dtype=torch.float64), 0).numpy()
    assert stats.chisquare(counts, p * counts.sum()).pvalue > 1e-3
    # uniform without logits; the draw is the generator's
    uniform = SharedNegativeSampler(n_e, k=k)
    a = uniform.draw(torch.Generator().manual_seed(1))
    assert torch.equal(a, uniform.pool(torch.Generator().manual_seed(1), None, None))
    with pytest.raises(ValueError):
        SharedNegativeSampler(n_e + 1, logits=logits)
