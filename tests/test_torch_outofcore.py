"""The port's out-of-core trainer (skge_torch/outofcore.py) on the CPU.

- P=1 is the in-core `init_state` + `make_epoch_fn` run, exactly (fp64),
  for the margin, pointwise, selfadv, CE and sampled-CE losses;
- a full part's diagonal bucket runs with no index error (the JAX package
  appends a sentinel row there that indexes one past the part; the port
  appends none);
- rows no bucket touches keep their initial values; each bucket
  transition costs at most one upload; prefetch, `cache_parts` and
  `host_buckets` leave the trajectory unchanged; a save and restore
  resumes it exactly;
- checkpoints read both ways with the JAX package: params, slots and step
  exact; a different partition is refused;
- `choose_ce_loss` and `auto_ce`.

The bucket epochs against the JAX package's: test_torch_outofcore_buckets.py;
the streamed ranking: test_torch_outofcore_eval.py.
"""

import json
import os

import numpy as np
import pytest
import torch

from skge_tpu import AdaGrad as JAdaGrad
from skge_tpu.models import TransE as JTransE
from skge_tpu.outofcore import OutOfCoreTrainer as JOutOfCoreTrainer
from skge_torch import (AdaGrad, Adam, DistMult, SharedNegativeSampler, TransE,
                        init_state, make_ce_step, make_epoch_fn, make_pairwise_step,
                        make_pointwise_step, make_sampled_ce_step, make_selfadv_step)
from skge_torch.data import synthetic_kg
from skge_torch.outofcore import OutOfCoreTrainer, choose_ce_loss

torch.set_num_threads(1)

K, NB = 32, 10


def incore(model, opt, loss, train, epochs, margin):
    sampler = SharedNegativeSampler(model.n_entities, k=K)
    step = {
        "margin": lambda: make_pairwise_step(model, opt, sampler, margin, "dense"),
        "pointwise": lambda: make_pointwise_step(model, opt, sampler, "dense"),
        "selfadv": lambda: make_selfadv_step(model, opt, sampler, margin, 1.0, "dense"),
        "ce": lambda: make_ce_step(model, opt, ("o", "s"), 0.1),
        "sampled_ce": lambda: make_sampled_ce_step(model, opt, sampler, ("o", "s"),
                                                   0.1, "dense"),
    }[loss]()
    state = init_state(model, opt, torch.Generator().manual_seed(0))
    epoch = make_epoch_fn(step, len(train), NB)
    xs = torch.as_tensor(train, dtype=torch.int64)
    losses = []
    for _ in range(epochs):
        state, m = epoch(state, xs)
        losses.append(float(m.loss.sum()))
    return state, losses


@pytest.mark.parametrize("loss", ["margin", "pointwise", "selfadv", "ce", "sampled_ce"])
def test_single_part_is_the_incore_run(loss):
    ds = synthetic_kg(80, 5, 600, seed=5)
    model = TransE(ds.n_entities, ds.n_relations, 16, l1=loss in ("margin", "pointwise"),
                   dtype="float64")
    opt = AdaGrad(lr=0.1)
    margin = 2.0 if loss == "selfadv" else 1.0
    ooc = OutOfCoreTrainer(
        model, opt, ds.train, n_parts=1, margin=margin, k=K, nbatches=NB, seed=0,
        loss="margin" if loss == "pointwise" else loss, pairwise=loss != "pointwise",
        label_smoothing=0.1, device="cpu",
    ).fit(epochs=2)
    state, losses = incore(model, opt, loss, ds.train, 2, margin)
    got = ooc.params()
    for name in ("E", "R"):
        np.testing.assert_array_equal(got[name], state.params[name].numpy(), err_msg=name)
    np.testing.assert_array_equal(ooc.e_host["p2"].numpy(), state.opt_state["E"]["p2"].numpy())
    assert [m["loss"] for m in ooc.metrics] == losses
    assert ooc.step == state.step == 2 * NB


def test_full_part_diagonal_bucket_runs():
    """P=1 (every bucket a full part) and P=3's largest part, whose diagonal
    bucket holds size_i == S real rows: no index error."""
    ds = synthetic_kg(120, 4, 500, seed=9)
    model = TransE(ds.n_entities, ds.n_relations, 8, dtype="float64")
    for n_parts in (1, 3):
        ooc = OutOfCoreTrainer(model, AdaGrad(lr=0.1), ds.train, n_parts=n_parts,
                               k=16, nbatches=4, seed=1, device="cpu")
        full = [p for p in range(n_parts) if ooc.part_counts[p] == ooc.part_size]
        assert any((p, p) in ooc.buckets for p in full)
        ooc.fit(epochs=1)
        assert np.isfinite(ooc.metrics[0]["loss"])


def test_untouched_rows_preserved_and_upload_bound():
    ds = synthetic_kg(120, 4, 800, seed=3, clustered=True)
    model = TransE(ds.n_entities, ds.n_relations, 8)
    ooc = OutOfCoreTrainer(model, AdaGrad(), ds.train, n_parts=3, k=16, nbatches=2,
                           seed=1, device="cpu")
    init_e = ooc.e_host["param"].clone()
    s = ooc.part_size
    touched = np.zeros(init_e.shape[0], bool)
    for (pi, pj), rows in ooc.buckets.items():
        touched[rows[:, 0]] = touched[rows[:, 1]] = True
        for p in (pi, pj):  # pool negatives touch every real row of a part
            touched[p * s : p * s + ooc.part_counts[p]] = True
    order = ooc._bucket_order()
    assert sorted(order) == sorted(ooc.buckets)
    assert all(set(a) & set(b) for a, b in zip(order, order[1:]))
    ooc.fit(epochs=1)
    assert ooc.uploads <= len(order) + 1
    before = ooc.uploads
    ooc.fit(epochs=1)
    assert ooc.uploads - before <= len(order) + 1
    assert ooc.bytes_uploaded == ooc.uploads * s * 8 * 4 * 2  # rows and p2, fp32
    assert torch.equal(ooc.e_host["param"][~touched], init_e[~touched])
    assert torch.isfinite(ooc.e_host["param"]).all()
    assert ooc.part_size <= int(ds.n_entities / 3 * 1.5)


def _ooc(ds, **kw):
    model = TransE(ds.n_entities, ds.n_relations, 16, dtype="float64")
    args = dict(n_parts=3, k=K, nbatches=6, seed=1, device="cpu")
    args.update(kw)
    return OutOfCoreTrainer(model, AdaGrad(lr=0.1), ds.train, **args)


def test_prefetch_cache_parts_and_host_buckets_keep_the_trajectory():
    ds = synthetic_kg(90, 5, 900, seed=8, clustered=True)
    ref = _ooc(ds, prefetch=False, cache_parts=3).fit(epochs=2)
    for kw in (dict(prefetch=True, cache_parts=3), dict(cache_parts=2),
               dict(host_buckets=True)):
        got = _ooc(ds, **kw).fit(epochs=2)
        for name, v in ref.params().items():
            np.testing.assert_array_equal(got.params()[name], v, err_msg=f"{kw} {name}")
        if kw.get("prefetch"):
            assert got.uploads <= ref.uploads + 1


def test_fit_part_of_an_epoch_runs_its_first_buckets():
    ds = synthetic_kg(90, 5, 900, seed=8, clustered=True)
    part = _ooc(ds).fit(epochs=1, buckets=2)
    ref = _ooc(ds)
    for pi, pj in ref._bucket_order()[:2]:
        ref._bucket_epoch(pi, pj)
    ref.flush()
    assert part.step == ref.step == 2 * 6 and len(part.metrics) == 1
    for name, v in ref.params().items():
        np.testing.assert_array_equal(part.params()[name], v, err_msg=name)


def test_save_restore_resumes_exactly(tmp_path):
    ds = synthetic_kg(90, 5, 900, seed=8, clustered=True)
    full = _ooc(ds, cache_parts=2).fit(epochs=4)
    t = _ooc(ds, cache_parts=2).fit(epochs=2)
    ck = str(tmp_path / "ooc_ck")
    t.save(ck)
    assert sorted(os.listdir(ck)) == [
        "manifest.json", "part_00000.npz", "part_00001.npz", "part_00002.npz",
        "replicated.npz"]
    t2 = _ooc(ds, cache_parts=2).restore(ck)
    assert t2.metrics == t.metrics and t2.step == t.step
    t2.fit(epochs=2)
    for name, v in full.params().items():
        np.testing.assert_array_equal(t2.params()[name], v, err_msg=name)


def _same_state(j, t):
    for kk, v in j.e_host.items():
        np.testing.assert_array_equal(t.e_host[kk].numpy(), v, err_msg=kk)
    for kk, v in j.dev_params.items():
        np.testing.assert_array_equal(t.dev_params[kk].numpy(), np.asarray(v))
    for kk, slots in j.dev_opt.items():
        for sn, v in slots.items():
            np.testing.assert_array_equal(t.dev_opt[kk][sn].numpy(), np.asarray(v))
    assert int(t.step) == int(j.step)


def test_checkpoints_read_both_ways(tmp_path):
    ds = synthetic_kg(90, 5, 900, seed=8, clustered=True)
    jm = JTransE(ds.n_entities, ds.n_relations, 16, dtype="float64")

    def jtrainer():
        return JOutOfCoreTrainer(jm, JAdaGrad(lr=0.1), ds.train, n_parts=3, k=K,
                                 nbatches=6, seed=1)

    port = _ooc(ds).fit(epochs=1)
    ck = str(tmp_path / "from_port")
    port.save(ck)
    j = jtrainer().restore(ck)
    _same_state(j, port)
    np.testing.assert_array_equal(j.new_of_old, port.new_of_old)

    j = jtrainer().fit(epochs=1)
    ck = str(tmp_path / "from_jax")
    j.save(ck)
    port = _ooc(ds).restore(ck)
    _same_state(j, port)
    assert port.metrics == j.metrics
    port.fit(epochs=1)  # a fresh generator seeded from the seed and the step
    assert np.isfinite(port.metrics[-1]["loss"])

    with open(os.path.join(ck, "manifest.json")) as f:
        meta = json.load(f)
    meta["partition_crc"] += 1
    with open(os.path.join(ck, "manifest.json"), "w") as f:
        json.dump(meta, f)
    for trainer in (_ooc(ds), jtrainer()):
        with pytest.raises(ValueError, match="DIFFERENT entity partition"):
            trainer.restore(ck)
    with pytest.raises(ValueError, match="geometry"):
        _ooc(ds, n_parts=2).restore(ck)


def test_choose_ce_loss_and_auto_ce():
    assert [choose_ce_loss(p)[0] for p in (1, 2, 3, 4)] == ["ce", "ce", "sampled_ce",
                                                             "sampled_ce"]
    ds = synthetic_kg(60, 3, 300, seed=3)
    model = DistMult(ds.n_entities, ds.n_relations, 8)
    lo = OutOfCoreTrainer(model, AdaGrad(lr=0.05), ds.train, n_parts=2, k=16,
                          nbatches=4, loss="auto_ce", ce_directions=("o",), device="cpu")
    assert lo.loss == "ce" and lo.loss_report["n_parts"] == 2
    hi = OutOfCoreTrainer(model, Adam(lr=0.05), ds.train, n_parts=4, k=16,
                          nbatches=4, loss="auto_ce", ce_directions=("o",), device="cpu")
    assert hi.loss == "sampled_ce" and "measured A/B" in hi.loss_report["rule"]
    hi.fit(epochs=1)
    assert np.isfinite(hi.metrics[-1]["loss"])


def test_refusals():
    ds = synthetic_kg(40, 5, 200, n_test=20, seed=2)
    model = TransE(ds.n_entities, ds.n_relations, 8)
    ooc = OutOfCoreTrainer(model, AdaGrad(lr=0.1), ds.train, n_parts=2, device="cpu")
    with pytest.raises(ValueError, match="DOUBLED"):
        ooc.evaluate(ds.test, ds.all_triples(), reciprocal=True)
    with pytest.raises(ValueError, match="unknown out-of-core loss"):
        OutOfCoreTrainer(model, AdaGrad(), ds.train, n_parts=2, loss="hinge", device="cpu")
    with pytest.raises(ValueError, match="cache_parts"):
        OutOfCoreTrainer(model, AdaGrad(), ds.train, n_parts=2, cache_parts=1,
                         device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            OutOfCoreTrainer(model, AdaGrad(), ds.train, n_parts=2)


def test_multipart_learns_on_latent_kg():
    """The JAX package's gate (tests/test_outofcore.py), on the CPU."""
    from skge_torch.data import latent_kg
    from skge_torch.evaluation import FilteredRankingEval

    ds = latent_kg(n_entities=600, n_relations=8, n_train=3000, n_valid=0, n_test=80,
                   latent_dim=8, seed=3, device="cpu")
    model = TransE(ds.n_entities, ds.n_relations, 24, l1=False)
    ooc = OutOfCoreTrainer(model, AdaGrad(lr=0.1), ds.train, n_parts=2, k=64,
                           nbatches=10, seed=0, device="cpu").fit(epochs=15)
    m = ooc.metrics
    assert m[-1]["nviolations"] < m[0]["nviolations"] * 0.7
    params = {k: torch.as_tensor(v) for k, v in ooc.params().items()}
    r = FilteredRankingEval(model, ds.test, ds.all_triples(), batch_size=32)(params)
    assert r.mrr > 2.0 / ds.n_entities
