"""The port's 10^7-entity flagship (skge_torch/flagship.py) against the JAX
package's (scripts/flagship_10m.py), both run through their `main` on a
tiny lattice KG on the CPU, every cache and checkpoint under tmp_path:

- the same KG, partition, part size, buckets and host-table size, and
  the JAX script's keys in every phase line and in the report;
- one bucket epoch at the flagship's configuration (TransE-L2, Adam, label
  smoothing 0.1, object-direction sampled CE, host buckets) with JAX's
  draws replayed, in fp64 at 1e-9;
- the same streamed ranks (MRR, H@10, MR) for the same params, JAX's
  carried across, in fp64 at 1e-9;
- checkpoints that each package restores from the other;
- the streamed ranking's restricted filter index (`data.rows_with_keys`)
  against the full one.
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import skge_tpu.outofcore as jooc
from skge_tpu import Adam as JAdam
from skge_tpu.data import add_reciprocal_relations as jadd_reciprocal
from skge_tpu.models import TransE as JTransE
from skge_tpu.outofcore import BucketPoolSampler as JBucketPoolSampler
from skge_torch import flagship
from skge_torch import outofcore as ooc
from skge_torch.data import (add_reciprocal_relations, rows_with_keys, synthetic_kg,
                             true_triple_index)
from skge_torch.outofcore import BucketPoolSampler

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts")
)

import flagship_10m as jflag  # noqa: E402

torch.set_num_threads(1)

TINY = ["--cpu", "--entities", "729", "--latent-dim", "6", "--relations", "8",
        "--ntrain", "2916", "--nheld", "40", "--dim", "16", "--parts", "2",
        "--cache-parts", "2", "--k", "64", "--epochs", "1", "--nbatches", "4",
        "--eval-n", "32"]
TOL = dict(rtol=1e-9, atol=1e-11)


class _TmpPath:
    """`os.path` with the JAX script's hard-coded /tmp moved to `tmp`."""

    def __init__(self, tmp):
        self.tmp = str(tmp)

    def join(self, first, *rest):
        return os.path.join(self.tmp if first == "/tmp" else first, *rest)

    def __getattr__(self, name):
        return getattr(os.path, name)


class _TmpOs:
    def __init__(self, tmp):
        self.path = _TmpPath(tmp)

    def __getattr__(self, name):
        return getattr(os, name)


def _lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both mains at TINY: (jax lines, jax trainer, jax ckpt dir, port
    report, port lines, port trainer, port args)."""
    tmp = tmp_path_factory.mktemp("flagship")
    mp = pytest.MonkeyPatch()
    made = []

    class Recorded(jooc.OutOfCoreTrainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    mp.setattr(jooc, "OutOfCoreTrainer", Recorded)
    mp.setattr(jflag, "os", _TmpOs(tmp))
    mp.setattr(flagship, "CACHE_DIR", tmp / "port_cache")
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            jflag.main(TINY + ["--ckpt", str(tmp / "jax_ckpt")])
        jlines = _lines(out.getvalue())
        args = flagship.parse_args(TINY + ["--ckpt", str(tmp / "port_ckpt")])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            report, tr = flagship.run(args)
        plines = _lines(out.getvalue()) + [json.loads(json.dumps(report))]  # main's last
    finally:
        mp.undo()
    return dict(tmp=tmp, jlines=jlines, jtr=made[0], jckpt=str(tmp / "jax_ckpt"),
                report=report, plines=plines, tr=tr, args=args)


def _cached(runs, which):
    tmp = runs["tmp"]
    if which == "jax":
        path = tmp / "latent_kg_lattice-e729-r8-t2916-h40-l6-s0.npz"
    else:
        path = flagship.cache_path(runs["args"], torch.device("cpu")).name
        path = tmp / "port_cache" / path
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("split", ["train", "valid", "test"])
def test_kg_equals_jax(runs, split):
    np.testing.assert_array_equal(_cached(runs, "port")[split], _cached(runs, "jax")[split])


@pytest.mark.parametrize("what", ["new_of_old", "part_size", "part_counts", "buckets",
                                  "bucket_len"])
def test_partition_equals_jax(runs, what):
    got, want = getattr(runs["tr"], what), getattr(runs["jtr"], what)
    if what == "buckets":
        assert list(got) == list(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("phase", ["build", "init", "train", "eval", "report"])
def test_lines_carry_the_jax_keys(runs, phase):
    def pick(lines):
        if phase == "report":
            return lines[-1]
        return next(line for line in lines if line.get("phase") == phase)

    got, want = pick(runs["plines"]), pick(runs["jlines"])
    assert set(want) <= set(got), set(want) - set(got)
    for key in ("host_table_gb", "part_size", "buckets", "device_rows_resident",
                "random_mrr", "config"):
        if key in want:
            assert got[key] == want[key], key
    if phase == "report":
        assert got["ckpt_bit_equal"] is True
        assert got["partitioner"] == "native"
        assert got["k1_launches"] == [0]  # the CPU runs the plain version
        assert got["steps_per_epoch"] == got["buckets"] * 4
        assert isinstance(got["scored_per_s"], int) and got["scored_per_s"] > 0


def _draws(jtr, diag, pi, pj, k, nb):
    """The permutation and pools JAX's bucket epoch draws from `jtr.key`."""
    import jax

    key, pk = jax.random.split(jtr.key)
    perm = np.asarray(jax.random.permutation(pk, jtr.bucket_len))
    sampler = JBucketPoolSampler(slot_stride=0 if diag else jtr.part_size, k=k)
    sentinel = jnp.asarray([[jtr.part_counts[pi], jtr.part_counts[pj], 0]], jnp.int32)
    pools = []
    for _ in range(max(1, min(nb, jtr.bucket_len))):
        key, sk = jax.random.split(key)
        pools.append(np.asarray(sampler.pool(sk, sentinel, None)).astype(np.int64))
    return perm, pools


class _Replay(BucketPoolSampler):
    def __init__(self, base, pools):
        super().__init__(base.slot_stride, base.k, base.modes)
        self.pools = list(pools)

    def pool(self, generator, pos, mask):
        return torch.as_tensor(self.pools.pop(0))


def _fp64_pair(runs, host_buckets=True):
    """A JAX and a port trainer in fp64 at the flagship's configuration."""
    args = runs["args"]
    ds = _dataset(runs)
    aug = add_reciprocal_relations(ds)
    jaug = jadd_reciprocal(ds)
    ttr = flagship.make_trainer(args, aug, torch.device("cpu"), dtype="float64",
                                host_buckets=host_buckets)
    jm = JTransE(jaug.n_entities, jaug.n_relations, args.dim, l1=False, dtype="float64")
    jtr = jooc.OutOfCoreTrainer(
        jm, JAdam(lr=args.lr), jaug.train, n_parts=args.parts, k=args.k,
        nbatches=args.nbatches, seed=0, loss="sampled_ce", label_smoothing=0.1,
        ce_directions=("o",), host_buckets=host_buckets,
        cache_parts=min(args.cache_parts, args.parts))
    assert ttr.host_buckets is host_buckets
    return ds, aug, jtr, ttr


def _dataset(runs):
    from skge_torch.data import Dataset

    z = _cached(runs, "port")
    return Dataset(train=z["train"], valid=z["valid"], test=z["test"],
                   n_entities=729, n_relations=8)


def _carry(jtr, ttr, rng=None):
    """JAX's host table and params into the port (warm slots from `rng`)."""
    if rng is not None:
        for kk, v in jtr.e_host.items():
            if kk != "param":
                v[:] = rng.integers(0, 5, v.shape) if kk == "t" else rng.random(v.shape)
        jtr.dev_opt = {kk: {sn: jnp.asarray(rng.integers(0, 5, v.shape).astype(v.dtype)
                                            if sn == "t" else rng.random(v.shape))
                            for sn, v in slots.items()}
                       for kk, slots in jtr.dev_opt.items()}
    for kk, v in jtr.e_host.items():
        ttr.e_host[kk][:] = torch.as_tensor(np.asarray(v, np.float64)).to(
            ttr.e_host[kk].dtype)
    ttr.dev_params = {kk: torch.as_tensor(np.array(v)) for kk, v in jtr.dev_params.items()}
    ttr.dev_opt = {kk: {sn: torch.as_tensor(np.array(v)) for sn, v in slots.items()}
                   for kk, slots in jtr.dev_opt.items()}
    ttr.step = int(jtr.step)


@pytest.mark.parametrize("diag", [True, False], ids=["diagonal", "off-diagonal"])
def test_bucket_epoch_matches_jax(runs, diag):
    _, _, jtr, ttr = _fp64_pair(runs)
    _carry(jtr, ttr, np.random.default_rng(3))
    pi, pj = next(b for b in jtr._bucket_order() if (b[0] == b[1]) == diag)
    perm, pools = _draws(jtr, diag, pi, pj, runs["args"].k, runs["args"].nbatches)
    ttr._samplers[diag] = _Replay(ttr._samplers[diag], pools)
    jloss, _ = jtr._bucket_epoch(pi, pj)
    tloss, _ = ttr._bucket_epoch(pi, pj, perm=torch.as_tensor(np.array(perm)))
    assert not ttr._samplers[diag].pools
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    jtr.flush()
    ttr.flush()
    for kk, v in jtr.e_host.items():
        np.testing.assert_allclose(ttr.e_host[kk].numpy(), v, **TOL, err_msg=kk)
    for kk, v in jtr.dev_params.items():
        np.testing.assert_allclose(ttr.dev_params[kk].numpy(), np.asarray(v), **TOL)
    for kk, slots in jtr.dev_opt.items():
        for sn, v in slots.items():
            np.testing.assert_allclose(ttr.dev_opt[kk][sn].numpy(), np.asarray(v), **TOL,
                                       err_msg=f"{kk} {sn}")


@pytest.mark.parametrize("host_buckets", [True, False])
def test_ranks_equal_jax_for_jax_params(runs, host_buckets):
    ds, aug, jtr, ttr = _fp64_pair(runs, host_buckets)
    trained = runs["jtr"]  # JAX's trained fp32 state, carried into both
    jtr.e_host["param"][:] = trained.e_host["param"].astype(np.float64)
    jtr.dev_params = {kk: jnp.asarray(np.asarray(v, np.float64))
                      for kk, v in trained.dev_params.items()}
    _carry(jtr, ttr)
    args = runs["args"]
    test, known = ds.test[: args.eval_n], aug.all_triples()
    got = ttr.evaluate(test, known, batch_size=args.eval_batch, reciprocal=True)
    want = jtr.evaluate(test, known, batch_size=args.eval_batch, reciprocal=True)
    np.testing.assert_array_equal(got.ranks, want.ranks)
    for a, b in ((got.mrr, want.mrr), (got.hits[10], want.hits[10]),
                 (got.mean_rank, want.mean_rank)):
        np.testing.assert_allclose(a, b, **TOL)
    assert got.mrr > 0


def test_jax_restores_the_ports_checkpoint(runs):
    tr, args = runs["tr"], runs["args"]
    fresh = jooc.OutOfCoreTrainer(
        JTransE(tr.full_model.n_entities, tr.full_model.n_relations, args.dim, l1=False),
        JAdam(lr=args.lr), _aug_train(runs), n_parts=args.parts, k=args.k,
        nbatches=args.nbatches, seed=0, loss="sampled_ce", label_smoothing=0.1,
        ce_directions=("o",), cache_parts=2)
    fresh.restore(args.ckpt)
    for kk, v in tr.e_host.items():
        np.testing.assert_array_equal(fresh.e_host[kk], v.numpy(), err_msg=kk)
    for kk, v in tr.dev_params.items():
        np.testing.assert_array_equal(np.asarray(fresh.dev_params[kk]), v.numpy())
    assert int(fresh.step) == tr.step


def test_port_restores_the_jax_checkpoint(runs):
    jtr, args = runs["jtr"], runs["args"]
    aug = add_reciprocal_relations(_dataset(runs))
    fresh = flagship.make_trainer(args, aug, torch.device("cpu"))
    fresh.restore(runs["jckpt"])
    for kk, v in jtr.e_host.items():
        np.testing.assert_array_equal(fresh.e_host[kk].numpy(), v, err_msg=kk)
    for kk, v in jtr.dev_params.items():
        np.testing.assert_array_equal(fresh.dev_params[kk].numpy(), np.asarray(v))
    assert fresh.step == int(jtr.step)


def _aug_train(runs):
    return add_reciprocal_relations(_dataset(runs)).train


@pytest.mark.parametrize("col", [0, 1])
def test_rows_with_keys_keep_every_key_a_query_reads(col):
    ds = synthetic_kg(300, 7, 4000, n_test=200, seed=4, clustered=True)
    known = ds.all_triples()
    sub = rows_with_keys(known, ds.test, col)
    full, restricted = true_triple_index(known)[col], true_triple_index(sub)[col]
    keys = {(int(r[col]), int(r[2])) for r in ds.test}
    assert set(restricted) == keys
    for key in keys:
        np.testing.assert_array_equal(restricted[key], full[key])
    # the kept rows in their order, and no row of another key
    mask = np.array([(int(r[col]), int(r[2])) in keys for r in known])
    np.testing.assert_array_equal(sub, known[mask])


@pytest.mark.parametrize("reciprocal", [False, True], ids=["native", "reciprocal"])
@pytest.mark.parametrize("ties", ["mean", "optimistic"])
def test_restricted_filter_index_gives_the_full_ranks(monkeypatch, ties, reciprocal):
    from skge_torch import Adam, TransE

    ds = synthetic_kg(90, 5, 900, n_test=60, seed=6, clustered=True)
    data = add_reciprocal_relations(ds) if reciprocal else ds
    tr = ooc.OutOfCoreTrainer(TransE(data.n_entities, data.n_relations, 8, l1=False,
                                     dtype="float64"),
                              Adam(lr=0.05), data.train, n_parts=3, k=16, nbatches=3,
                              seed=2, device="cpu").fit(epochs=2)
    got = tr.evaluate(ds.test, data.all_triples(), batch_size=16, ties=ties,
                      reciprocal=reciprocal)
    monkeypatch.setattr(ooc, "rows_with_keys", lambda t, q, col: np.asarray(t))
    want = tr.evaluate(ds.test, data.all_triples(), batch_size=16, ties=ties,
                       reciprocal=reciprocal)
    np.testing.assert_array_equal(got.ranks, want.ranks)
    np.testing.assert_array_equal(got.ranks_raw, want.ranks_raw)
    assert (got.ranks < got.ranks_raw).any()  # the filter removed something


def test_bucket_stack_is_int32_and_the_steps_see_int64(runs):
    tr = flagship.make_trainer(runs["args"], add_reciprocal_relations(_dataset(runs)),
                               torch.device("cpu"))
    assert tr._all_local.dtype == torch.int32
    seen = []
    step = tr._epoch_fn(True)

    def spy(state, xs, valid, perm=None):
        seen.append(xs.dtype)
        return step(state, xs, valid, perm)

    tr._epochs[True] = spy
    pi = next(b for b in tr._bucket_order() if b[0] == b[1])[0]
    tr._bucket_epoch(pi, pi)
    tr.flush()
    assert seen == [torch.int64]


def test_without_native_partitioner_a_large_run_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(flagship, "CACHE_DIR", tmp_path)
    monkeypatch.setattr(flagship, "native_available", lambda: False)
    monkeypatch.setattr(flagship, "HOST_BUCKETS_ABOVE", 100)
    with pytest.raises(RuntimeError, match="native partitioner"):
        flagship.run(flagship.parse_args(TINY + ["--ckpt", str(tmp_path / "c")]))


def test_gpu_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--cpu"):
        flagship.main(["--entities", "729"])
