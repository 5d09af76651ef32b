"""The port's reference class API (skge_torch/compat.py) against the JAX
package's (skge_tpu/compat.py), on `tests/test_compat.py`'s eight flows
and the same small `synthetic_kg` (80 entities, 5 relations, 600 triples).

Each port model starts from the JAX model's params (`set_params`). The
device paths (a recognized sampler, or the pre-split pairs) are fed JAX's
epoch permutations (`_epoch_perm`) and its samplers' raw draws, replayed
from the JAX compat trainer's key splits (one split an epoch for the
permutation, one a step for the sampler); the host paths share the
`default_rng(seed)` permutations by construction and call seeded numpy
samplers, one per package, that give the same negatives. Both packages
train in fp32 and must follow the same trajectory: the same violation
counts, and losses and params within TOL, fp32 sums taken in another
order (XLA's and PyTorch's CPU kernels) over a few epochs of AdaGrad.
Beyond JAX's flows: the port takes the device path for its own four
sampler classes and never calls them on the host, takes the host path
for the JAX package's samplers, reads the model and config files of
`skge_tpu.compat`, and refuses to run on a missing GPU.
"""

import pickle

import numpy as np
import pytest
import torch

import jax

from skge_torch import compat
from skge_torch import sample
from skge_torch import sampling as tsampling
from skge_torch.data import synthetic_kg
from skge_tpu import compat as jcompat
from skge_tpu import sample as jsample
from test_torch_iid_step import ReplayDraws

torch.set_num_threads(1)

N_E, N_R = 80, 5
SZ = (N_E, N_E, N_R)
TOL = dict(rtol=2e-5, atol=2e-6)  # fp32 trajectories, sums in another order


@pytest.fixture(scope="module")
def ds():
    return synthetic_kg(N_E, N_R, n_train=600, seed=11)


def xs_list(ds):
    return [tuple(map(int, t)) for t in ds.train]


def pair(cls_name, *args, **kw):
    """(JAX model, port model on the CPU starting from the JAX params)."""
    jm = getattr(jcompat, cls_name)(SZ, *args, **kw)
    tm = getattr(compat, cls_name)(SZ, *args, device="cpu", **kw)
    tm.set_params(jm.params)
    return jm, tm


def raw_draws(kind, modes, ntries=100):
    """The JAX device sampler's raw draws from one step key, in the port's
    layout (see tests/test_torch_samplers.py)."""
    if kind == "random-mode":
        def raw(key, b):
            return torch.as_tensor(np.stack([np.array(jax.random.randint(k, (b,), 0, N_E))
                                             for k in jax.random.split(key, len(modes))]))
    elif kind == "lcwa":
        def raw(key, b):
            return torch.as_tensor(np.stack([
                np.array(jax.random.randint(k, (b, ntries), 0, N_E))
                for k in jax.random.split(key, len(modes))]))
    else:  # bernoulli
        def raw(key, b):
            ks, ke = jax.random.split(key)
            return (torch.as_tensor(np.array(jax.random.uniform(ks, (b,)))),
                    torch.as_tensor(np.array(jax.random.randint(ke, (b,), 0, N_E))))
    return raw


def jax_key_splits(seed, epochs, n, nbatches, raw=None):
    """JAX compat's permutations and per-step sampler draws for `epochs`
    device epochs from PRNGKey(seed)."""
    key, perms, draws = jax.random.PRNGKey(seed), [], []
    b = -(-n // nbatches)
    for _ in range(epochs):
        key, pk = jax.random.split(key)
        perms.append(torch.as_tensor(np.array(jax.random.permutation(pk, n))))
        for _ in range(nbatches if raw is not None else 0):  # the pairs path draws none
            key, sk = jax.random.split(key)
            draws.append(raw(sk, b))
    return perms, draws


def replay(monkeypatch, trainer, perms, draws):
    """The port trainer's device path on JAX's permutations and draws."""
    perms = list(perms)
    trainer._epoch_perm = lambda: perms.pop(0)
    if draws:
        real = compat._device_sampler
        monkeypatch.setattr(compat, "_device_sampler",
                            lambda f, sz, dev: ReplayDraws(real(f, sz, dev), draws))
    return perms


def recorder(log):
    def callback(trainer):
        log.append((trainer.epoch, trainer.nviolations, trainer.loss))
        return True
    return callback


def assert_same_run(tlog, jlog, tm, jm):
    assert [(e, v) for e, v, _ in tlog] == [(e, v) for e, v, _ in jlog]
    np.testing.assert_allclose([l for *_, l in tlog], [l for *_, l in jlog], **TOL)
    assert tm.params.keys() == jm.params.keys()
    for k, v in jm.params.items():
        assert tm.params[k].dtype == np.float32
        np.testing.assert_allclose(tm.params[k], v, **TOL, err_msg=k)


def test_reference_usage_pattern_pairwise(ds, monkeypatch):
    """The README-style flow: model + sampler + pairwise trainer + fit, on
    JAX's draws: JAX's trajectory."""
    xs = xs_list(ds)
    ys = [1.0] * len(xs)
    jm, tm = pair("TransE", 24)
    logs = {"jax": [], "port": []}
    kw = dict(nbatches=10, max_epochs=15, margin=0.3, learning_rate=0.1)
    jcompat.PairwiseStochasticTrainer(
        jm, samplef=jsample.RandomModeSampler(1, [0, 1], xs, SZ).sample,
        post_epoch=[recorder(logs["jax"])], **kw).fit(xs, ys)
    tr = compat.PairwiseStochasticTrainer(
        tm, samplef=sample.RandomModeSampler(1, [0, 1], xs, SZ).sample,
        post_epoch=[recorder(logs["port"])], device="cpu", **kw)
    replay(monkeypatch, tr, *jax_key_splits(0, 15, len(xs), 10,
                                             raw_draws("random-mode", (0, 1))))
    tr.fit(xs, ys)
    seen = [v for _, v, _ in logs["port"]]
    assert len(seen) == 15
    assert seen[-1] < 0.6 * seen[0], seen
    assert np.linalg.norm(tm.E, axis=1).max() <= 1.0 + 1e-5
    assert_same_run(logs["port"], logs["jax"], tm, jm)


def test_early_stop_contract(ds, monkeypatch):
    xs, ys = xs_list(ds), [1.0] * len(ds.train)
    jm, tm = pair("HolE", 16)
    calls = {"jax": [], "port": []}

    def stop_after_3(log):
        def callback(trainer):
            log.append((trainer.epoch, trainer.nviolations, trainer.loss))
            return trainer.epoch < 3
        return callback

    jcompat.PairwiseStochasticTrainer(
        jm, nbatches=5, max_epochs=50, samplef=jsample.RandomModeSampler(
            1, [0, 1], xs, SZ).sample, post_epoch=[stop_after_3(calls["jax"])]).fit(xs, ys)
    tr = compat.PairwiseStochasticTrainer(
        tm, nbatches=5, max_epochs=50, samplef=sample.RandomModeSampler(
            1, [0, 1], xs, SZ).sample, post_epoch=[stop_after_3(calls["port"])],
        device="cpu")
    perms = replay(monkeypatch, tr, *jax_key_splits(0, 3, len(xs), 5,
                                                    raw_draws("random-mode", (0, 1))))
    tr.fit(xs, ys)
    assert [e for e, _, _ in calls["port"]] == [1, 2, 3] and not perms
    assert_same_run(calls["port"], calls["jax"], tm, jm)


def test_pointwise_trainer_with_lcwa(ds, monkeypatch):
    xs, ys = xs_list(ds), [1.0] * len(ds.train)
    jm, tm = pair("RESCAL", 12, rparam=0.01)
    logs = {"jax": [], "port": []}
    jcompat.StochasticTrainer(
        jm, nbatches=8, max_epochs=10, samplef=jsample.LCWASampler(1, [0, 1], xs, SZ).sample,
        post_epoch=[recorder(logs["jax"])]).fit(xs, ys)
    tr = compat.StochasticTrainer(
        tm, nbatches=8, max_epochs=10, samplef=sample.LCWASampler(1, [0, 1], xs, SZ).sample,
        post_epoch=[recorder(logs["port"])], device="cpu")
    replay(monkeypatch, tr, *jax_key_splits(0, 10, len(xs), 8, raw_draws("lcwa", (0, 1))))
    tr.fit(xs, ys)
    losses = [l for *_, l in logs["port"]]
    assert losses[-1] < losses[0]
    assert_same_run(logs["port"], logs["jax"], tm, jm)


def seeded_samplef(pkg, xs, calls):
    """An arbitrary callable (no recognized sampler): a random-mode sampler
    on a seeded numpy generator, counting its calls."""
    inner = pkg.RandomModeSampler(1, [0, 1], xs, SZ)
    inner.rng = np.random.default_rng(3)

    def samplef(xys):
        calls.append(len(xys))
        return inner.sample(xys)
    return samplef


@pytest.mark.parametrize("trainer", ["PairwiseStochasticTrainer", "StochasticTrainer"])
def test_host_samplef_fallback(ds, trainer):
    """An arbitrary callable (not a recognized sampler) must still work,
    through the host loop, as JAX's does."""
    xs = xs_list(ds)[:200]
    ys = [1.0] * len(xs)
    jm, tm = pair("TransE", 8)
    calls = {"jax": [], "port": []}
    logs = {"jax": [], "port": []}
    kw = dict(nbatches=4, max_epochs=2, margin=0.3, seed=5)
    getattr(jcompat, trainer)(jm, samplef=seeded_samplef(jsample, xs, calls["jax"]),
                              post_epoch=[recorder(logs["jax"])], **kw).fit(xs, ys)
    tr = getattr(compat, trainer)(tm, samplef=seeded_samplef(sample, xs, calls["port"]),
                                  post_epoch=[recorder(logs["port"])], device="cpu", **kw)
    tr.fit(xs, ys)
    assert len(calls["port"]) > 0 and calls["port"] == calls["jax"]  # the host path
    assert tr.nviolations >= 0
    assert_same_run(logs["port"], logs["jax"], tm, jm)


def test_pairwise_without_samplef_pre_split(ds, monkeypatch):
    """samplef=None: labeled negatives are paired with positives."""
    pos = xs_list(ds)[:150]
    rng = np.random.default_rng(0)
    neg = [(int(rng.integers(N_E)), int(rng.integers(N_E)), p) for _, _, p in pos[:50]]
    xs = pos + neg
    ys = [1.0] * len(pos) + [-1.0] * len(neg)
    jm, tm = pair("TransE", 8)
    logs = {"jax": [], "port": []}
    kw = dict(nbatches=4, max_epochs=3, margin=0.3)
    jcompat.PairwiseStochasticTrainer(jm, post_epoch=[recorder(logs["jax"])], **kw).fit(
        xs, ys)
    tr = compat.PairwiseStochasticTrainer(tm, post_epoch=[recorder(logs["port"])],
                                          device="cpu", **kw)
    replay(monkeypatch, tr, *jax_key_splits(0, 3, len(pos), 4))
    tr.fit(xs, ys)
    assert tr.nviolations >= 0
    assert_same_run(logs["port"], logs["jax"], tm, jm)


def test_model_save_load_roundtrip(tmp_path, ds):
    model = compat.HolE(SZ, 16, rparam=0.01, device="cpu")
    xs, ys = xs_list(ds), [1.0] * len(ds.train)
    sampler = sample.RandomModeSampler(1, [0, 1], xs, SZ)
    compat.PairwiseStochasticTrainer(
        model, nbatches=5, max_epochs=3, samplef=sampler.sample, device="cpu"
    ).fit(xs, ys)
    path = str(tmp_path / "model.bin")
    model.save(path)
    loaded = compat.Model.load(path, device="cpu")
    assert isinstance(loaded, compat.HolE)
    assert loaded.ncomp == 16 and loaded.rparam == 0.01
    test = np.asarray(ds.train[:40])
    np.testing.assert_allclose(
        loaded.score_triples(test), model.score_triples(test), rtol=1e-6
    )
    # the same file format as the JAX package's: its compat API reads it
    with open(path, "rb") as f:
        assert pickle.load(f).__class__.__module__ == "skge_torch.compat"


def test_config_save_load(tmp_path, ds):
    model = compat.TransE(SZ, 8, device="cpu")
    trainer = compat.PairwiseStochasticTrainer(model, nbatches=4, max_epochs=1,
                                               device="cpu")
    path = str(tmp_path / "config.bin")
    compat.Config(model, trainer).save(path)
    cfg = compat.Config.load(path, device="cpu")
    assert cfg.model.ncomp == 8
    assert cfg.trainer.hyperparams["nbatches"] == 4
    assert isinstance(cfg.trainer, compat.PairwiseStochasticTrainer)
    assert cfg.trainer.device == cfg.model.device == torch.device("cpu")


def test_ermlp_compat_trains(ds, monkeypatch):
    xs, ys = xs_list(ds), [1.0] * len(ds.train)
    jm, tm = pair("ERMLP", 12, nhidden=8)
    logs = {"jax": [], "port": []}
    jcompat.StochasticTrainer(
        jm, nbatches=6, max_epochs=8, samplef=jsample.BernoulliSampler(1, xs, SZ).sample,
        post_epoch=[recorder(logs["jax"])]).fit(xs, ys)
    tr = compat.StochasticTrainer(
        tm, nbatches=6, max_epochs=8, samplef=sample.BernoulliSampler(1, xs, SZ).sample,
        post_epoch=[recorder(logs["port"])], device="cpu")
    replay(monkeypatch, tr, *jax_key_splits(0, 8, len(xs), 6, raw_draws("bernoulli", ())))
    tr.fit(xs, ys)
    losses = [l for *_, l in logs["port"]]
    assert losses[-1] < losses[0]
    assert_same_run(logs["port"], logs["jax"], tm, jm)


def recognized(xs):
    return {
        "random-mode": (sample.RandomModeSampler(2, [0, 1], xs, SZ),
                        tsampling.RandomModeSampler),
        "lcwa": (sample.LCWASampler(1, [1, 0], xs, SZ), tsampling.LCWASampler),
        "bernoulli": (sample.BernoulliSampler(1, xs, SZ), tsampling.BernoulliSampler),
        "corrupted": (sample.CorruptedSampler(1, xs, sample.type_index(xs)),
                      tsampling.CorruptedSampler),
    }


@pytest.mark.parametrize("name", ["random-mode", "lcwa", "bernoulli", "corrupted"])
def test_port_samplers_take_the_device_path(ds, name):
    """Each of the port's four sampler classes becomes its device sampler,
    with the same modes; fit never calls it on the host."""
    xs = xs_list(ds)
    host, cls = recognized(xs)[name]
    dev = compat._device_sampler(host.sample, SZ, torch.device("cpu"))
    assert type(dev) is cls
    if name != "bernoulli":
        assert dev.modes == tuple(host.modes) * host.n

    class NoHostDraws:
        def __getattr__(self, name):
            raise AssertionError("the host sampler was called")

    host.rng = NoHostDraws()  # every host draw goes through `rng`
    model = compat.TransE(SZ, 8, device="cpu")
    before = model.E.copy()
    for trainer in (compat.PairwiseStochasticTrainer, compat.StochasticTrainer):
        trainer(model, nbatches=4, max_epochs=1, samplef=host.sample,
                device="cpu").fit(xs, [1.0] * len(xs))
    with pytest.raises(AssertionError, match="host sampler"):
        host.sample([(xs[0], 1.0)])
    assert not np.array_equal(model.E, before)


def test_corrupted_sampler_index_matches_the_type_index(ds):
    """The device sampler's CSR arrays hold the host type index."""
    xs = xs_list(ds)
    host = sample.CorruptedSampler(1, xs, sample.type_index(xs))
    dev = compat._device_sampler(host, SZ, torch.device("cpu"))
    for mode, (flat, off, cnt) in enumerate(((dev.sub_flat, dev.sub_off, dev.sub_cnt),
                                             (dev.obj_flat, dev.obj_off, dev.obj_cnt))):
        for p in range(N_R):
            got = flat[int(off[p]): int(off[p]) + int(cnt[p])].tolist()
            assert got == host.idx.get(p, {}).get(mode, [])


def test_jax_package_samplers_take_the_host_path(ds):
    """An instance of `skge_tpu.sample` is any callable to the port."""
    xs = xs_list(ds)[:120]
    inner = jsample.RandomModeSampler(1, [0, 1], xs, SZ)
    assert compat._device_sampler(inner.sample, SZ, torch.device("cpu")) is None
    calls = []
    real = inner.sample
    inner.sample = lambda xys: calls.append(len(xys)) or real(xys)
    compat.PairwiseStochasticTrainer(compat.TransE(SZ, 8, device="cpu"), nbatches=3,
                                     max_epochs=1, samplef=inner.sample,
                                     device="cpu").fit(xs, [1.0] * len(xs))
    assert sum(calls) == len(xs)


@pytest.mark.parametrize("cls_name, args, kw", [
    ("TransE", (8,), {"l1": False}),
    ("RESCAL", (6,), {"rparam": 0.01}),
    ("HolE", (16,), {"rparam": 0.01, "af": "tanh"}),
    ("ERMLP", (8,), {"nhidden": 5}),
])
def test_jax_model_file_loads_in_the_port(tmp_path, ds, cls_name, args, kw):
    """A model file written by `skge_tpu.compat` loads as the port's class
    of the same name, with the same hyperparams, params and scores."""
    jm = getattr(jcompat, cls_name)(SZ, *args, seed=4, **kw)
    path = str(tmp_path / "jax_model.bin")
    jm.save(path)
    tm = compat.Model.load(path, device="cpu")
    assert type(tm) is getattr(compat, cls_name)
    assert tm.hyperparams == jm.hyperparams
    for k, v in jm.params.items():
        np.testing.assert_array_equal(tm.params[k], v)
    test = np.asarray(ds.train[:40])
    np.testing.assert_allclose(tm.score_triples(test), jm.score_triples(test), **TOL)
    np.testing.assert_allclose(tm._scores(test[:, 0], test[:, 2], test[:, 1]),
                               jm._scores(test[:, 0], test[:, 2], test[:, 1]), **TOL)


def test_jax_config_file_loads_in_the_port(tmp_path):
    jm = jcompat.HolE(SZ, 8)
    jtr = jcompat.StochasticTrainer(jm, nbatches=7, max_epochs=2, optimizer="sgd")
    jtr.epoch = 2
    path = str(tmp_path / "jax_config.bin")
    jcompat.Config(jm, jtr).save(path)
    cfg = compat.Config.load(path, device="cpu")
    assert type(cfg.trainer) is compat.StochasticTrainer
    assert type(cfg.model) is type(cfg.trainer.model) is compat.HolE
    assert cfg.trainer.hyperparams == jtr.hyperparams and cfg.trainer.epoch == 2
    np.testing.assert_array_equal(cfg.model.E, jm.E)


def test_load_refuses_other_jax_package_names(tmp_path):
    class Foreign:  # pickled as skge_tpu.models.TransE
        def __reduce__(self):
            from skge_tpu.models import TransE as JTransE
            return (JTransE, (3, 2, 4))

    path = str(tmp_path / "foreign.bin")
    with open(path, "wb") as f:
        pickle.dump(Foreign(), f)
    with pytest.raises(pickle.UnpicklingError, match="skge_tpu.models"):
        compat.Model.load(path, device="cpu")


def test_init_params_from_a_seeded_cpu_generator():
    a, b = compat.HolE(SZ, 8, seed=3, device="cpu"), compat.HolE(SZ, 8, seed=3, device="cpu")
    c = compat.HolE(SZ, 8, seed=4, device="cpu")
    np.testing.assert_array_equal(a.E, b.E)
    assert a.E.dtype == np.float32 and not np.array_equal(a.E, c.E)
    tensors = a.fmodel.init_params(torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(a.R, tensors["R"].numpy())


def test_without_a_gpu_models_and_trainers_refuse(monkeypatch, tmp_path):
    """No quiet fallback: without `device="cpu"` the card is required."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compat.TransE(SZ, 8)
    model = compat.TransE(SZ, 8, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compat.PairwiseStochasticTrainer(model)
    path = str(tmp_path / "m.bin")
    model.save(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compat.Model.load(path)
    with open(path, "rb") as f:  # unpickled without `load`: the card by default
        unpickled = pickle.load(f)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        unpickled.score_triples(np.zeros((2, 3), np.int64))
