"""scikit-kge-compatible class surface on top of the port's functional core.

The counterpart of the JAX package's `skge_tpu/compat.py`. A user of the
reference (skge/base.py Model/trainers) can switch with near-identical
code (SURVEY.md §1 data flow):

    from skge_torch.compat import HolE, PairwiseStochasticTrainer
    from skge_torch import sample

    model = HolE((n_e, n_e, n_r), ncomp)
    sampler = sample.RandomModeSampler(1, [0, 1], xs, (n_e, n_e, n_r))
    trainer = PairwiseStochasticTrainer(
        model, nbatches=100, max_epochs=500, margin=0.2,
        samplef=sampler.sample, post_epoch=[callback])
    trainer.fit(xs, ys)
    model.save("model.bin")

Differences from the reference (all documented):
- training runs on the card; when `samplef` is one of `skge_torch.sample`'s
  samplers (or None) every epoch runs on the device, its negatives drawn
  there by the equivalent `skge_torch.sampling` sampler; any other
  callable (an instance of the JAX package's `skge_tpu.sample` too) falls
  back to a host loop calling the update per batch;
- models and trainers take `device=` (default "cuda", raising without a
  GPU; pass "cpu" to run on the CPU). The device is not pickled: `load`
  takes it;
- `Model.save` pickles a plain dict (class name + hyperparams + numpy
  params) instead of the object graph, as the JAX package's; `Model.load`
  and `Config.load` also read the files `skge_tpu.compat` writes;
- optimizer state lives on the trainer, and `Config` persists both, like
  the reference (skge/base.py ~15).

Reference constructor conventions: `Model(sz, ncomp, **kwargs)` with
sz=(n_e, n_e, n_r); `_scores(ss, ps, os)` argument order (subjects,
predicates, objects) per SURVEY.md §3.3.
"""

from __future__ import annotations

import pickle
import timeit
from typing import Callable, Dict, Optional

import numpy as np
import torch

from skge_torch import sample as host_sample
from skge_torch import sampling as dev_sampling
from skge_torch.data import encode_keys_np
from skge_torch.models import ERMLP as FERMLP
from skge_torch.models import HolE as FHolE
from skge_torch.models import RESCAL as FRESCAL
from skge_torch.models import TransE as FTransE
from skge_torch.optim import SGD as DevSGD
from skge_torch.optim import AdaGrad as DevAdaGrad
from skge_torch.training import (TrainState, make_epoch_fn, make_pairwise_update,
                                 make_pointwise_update)
from skge_torch.utils.device import resolve_device

_DEF_MAX_EPOCHS = 500
_DEF_NBATCHES = 100
_DEF_LEARNING_RATE = 0.1
_DEF_MARGIN = 1.0

# modules whose pickled classes `load` maps to this module's classes of the
# same name: the JAX package's compat API and the `skge` shim over it
_FOREIGN_COMPAT = ("skge_tpu.compat", "skge.base")


class _Unpickler(pickle.Unpickler):
    """Reads this module's files and `skge_tpu.compat`'s: a class of the
    JAX package's compat API becomes the port's class of the same name; any
    other name of `skge_tpu` or `skge` is refused (the port imports
    neither)."""

    def find_class(self, module, name):
        if module in _FOREIGN_COMPAT or module == __name__:
            cls = _PICKLED.get(name)
            if cls is None:
                raise pickle.UnpicklingError(f"{module}.{name} is no class of the compat API")
            return cls
        if module.split(".")[0] in ("skge_tpu", "skge"):
            raise pickle.UnpicklingError(f"{module}.{name} has no counterpart in {__name__}")
        return super().find_class(module, name)


def _load(fname):
    with open(fname, "rb") as f:
        return _Unpickler(f).load()


class Config:
    """Pickle wrapper bundling model + trainer (skge/base.py ~15)."""

    def __init__(self, model, trainer):
        self.model = model
        self.trainer = trainer

    def __getstate__(self):
        return {"model": self.model, "trainer": self.trainer}

    def __setstate__(self, st):
        self.model = st["model"]
        self.trainer = st["trainer"]

    def save(self, fname):
        with open(fname, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(fname, device=None):
        """The saved model and trainer, both on `device` (default "cuda")."""
        cfg = _load(fname)
        for part in (cfg.model, cfg.trainer):
            part._device = resolve_device(device, "runs")
        return cfg


class Model:
    """Mutable parameter-registry model mirroring skge/base.py ~30.

    `params` holds numpy arrays (`model.E`, ...); scoring copies them to
    the model's device. The initial params are the port model's
    `init_params` draws from a CPU generator seeded `seed` (default 0), the
    same on every device."""

    functional_cls = None  # set by subclasses

    def __init__(self, *args, **kwargs):
        self.params: Dict[str, np.ndarray] = {}
        self.hyperparams: Dict[str, object] = {}
        self._device = resolve_device(kwargs.pop("device", None), "scores")
        self.add_hyperparam("sz", args[0])
        self.add_hyperparam("ncomp", int(args[1]))
        self._init_kwargs(kwargs)
        self._fmodel = self._build_functional()
        self._init_params(kwargs.pop("seed", 0))

    # --- subclass hooks ---
    def _init_kwargs(self, kwargs):
        raise NotImplementedError

    def _build_functional(self):
        raise NotImplementedError

    # --- registry API (reference surface) ---
    def add_hyperparam(self, name, value):
        self.hyperparams[name] = value
        setattr(self, name, value)

    def add_param(self, name, value):
        value = np.asarray(value)
        self.params[name] = value
        setattr(self, name, value)

    def _init_params(self, seed):
        fp = self._fmodel.init_params(torch.Generator().manual_seed(int(seed)))
        for k, v in fp.items():
            self.add_param(k, v.numpy())

    # --- functional bridge ---
    @property
    def fmodel(self):
        return self._fmodel

    @property
    def device(self) -> torch.device:
        """Where scoring runs ("cuda" unless the model was made or loaded
        with another device)."""
        return resolve_device(self._device, "scores")

    def device_params(self, device=None):
        """Copies of the params as tensors on `device` (the model's by
        default)."""
        dev = self.device if device is None else device
        return {k: torch.tensor(v, device=dev) for k, v in self.params.items()}

    def set_params(self, params):
        for k, v in params.items():
            self.add_param(k, v.detach().cpu().numpy() if torch.is_tensor(v) else v)

    # --- scoring (reference `_scores(ss, ps, os)` argument order) ---
    @torch.no_grad()
    def _scores(self, ss, ps, os):
        dev = self.device
        s, o, p = (torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)
                   for a in (ss, os, ps))
        return self._fmodel.score(self.device_params(dev), s, o, p).cpu().numpy()

    @torch.no_grad()
    def score_triples(self, triples):
        """triples: (B, 3) in (s, o, p) order."""
        dev = self.device
        t = torch.as_tensor(np.asarray(triples), dtype=torch.int64, device=dev)
        return self._fmodel.score_triples(self.device_params(dev), t).cpu().numpy()

    # --- persistence (skge/base.py ~75-95) ---
    def __getstate__(self):
        return {
            "class": type(self).__name__,
            "hyperparams": self.hyperparams,
            "params": {k: np.asarray(v) for k, v in self.params.items()},
        }

    def __setstate__(self, st):
        self.params = {}
        self.hyperparams = {}
        self._device = None  # "cuda" until `load` places it
        for k, v in st["hyperparams"].items():
            self.add_hyperparam(k, v)
        self._fmodel = self._build_functional()
        for k, v in st["params"].items():
            self.add_param(k, v)

    def save(self, fname):
        with open(fname, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(fname, device=None):
        """The saved model (this module's file or `skge_tpu.compat`'s),
        scoring on `device` (default "cuda")."""
        model = _load(fname)
        model._device = resolve_device(device, "scores")
        return model


def _af_name(af) -> str:
    if af is None:
        return "sigmoid"
    if isinstance(af, str):
        return af
    return getattr(af, "name", getattr(af, "__name__", "sigmoid")).lower()


class TransE(Model):
    def _init_kwargs(self, kwargs):
        self.add_hyperparam("l1", bool(kwargs.pop("l1", True)))
        self.add_hyperparam("init", kwargs.pop("init", "nunif"))

    def _build_functional(self):
        sz, d = self.hyperparams["sz"], self.hyperparams["ncomp"]
        return FTransE(sz[0], sz[2], d, l1=self.l1, init=self.init)


class RESCAL(Model):
    def _init_kwargs(self, kwargs):
        self.add_hyperparam("rparam", float(kwargs.pop("rparam", 0.0)))
        self.add_hyperparam("init", kwargs.pop("init", "nunif"))

    def _build_functional(self):
        sz, d = self.hyperparams["sz"], self.hyperparams["ncomp"]
        return FRESCAL(sz[0], sz[2], d, rparam=self.rparam, init=self.init)


class HolE(Model):
    def _init_kwargs(self, kwargs):
        self.add_hyperparam("rparam", float(kwargs.pop("rparam", 0.0)))
        self.add_hyperparam("af", _af_name(kwargs.pop("af", "sigmoid")))
        self.add_hyperparam("init", kwargs.pop("init", "nunif"))

    def _build_functional(self):
        sz, d = self.hyperparams["sz"], self.hyperparams["ncomp"]
        return FHolE(sz[0], sz[2], d, rparam=self.rparam, af=self.af, init=self.init)


class ERMLP(Model):
    def _init_kwargs(self, kwargs):
        self.add_hyperparam("nhidden", int(kwargs.pop("nhidden", 10)))
        self.add_hyperparam("af", _af_name(kwargs.pop("af", "sigmoid")))
        self.add_hyperparam("init", kwargs.pop("init", "nunif"))

    def _build_functional(self):
        sz, d = self.hyperparams["sz"], self.hyperparams["ncomp"]
        return FERMLP(
            sz[0], sz[2], d, nhidden=self.nhidden, af=self.af, init=self.init
        )


MODELS = {"transe": TransE, "rescal": RESCAL, "hole": HolE, "ermlp": ERMLP}


# ---------------------------------------------------------------------------
# Sampler bridging: recognize skge_torch.sample's host samplers and build
# the equivalent sampler that draws on the trainer's device.
# ---------------------------------------------------------------------------

def _device_sampler(samplef, sz, device) -> Optional[Callable]:
    """The `skge_torch.sampling` sampler equivalent to `samplef` (a
    `skge_torch.sample` sampler or its bound `sample`), its tables on
    `device`; None for any other callable."""
    owner = getattr(samplef, "__self__", samplef)
    n_e, _, n_r = sz

    def put(a):
        return torch.as_tensor(np.asarray(a), device=device)

    # LCWASampler first: it is a RandomModeSampler
    if isinstance(owner, host_sample.LCWASampler):
        keys = np.sort(
            encode_keys_np(np.asarray(list(owner.xs), np.int64), n_e, n_r)
        )
        return dev_sampling.LCWASampler(
            n_e, n_r, put(keys), modes=tuple(owner.modes) * owner.n, ntries=owner.ntries,
        )
    if isinstance(owner, host_sample.RandomModeSampler):
        return dev_sampling.RandomModeSampler(
            n_e, modes=tuple(owner.modes) * owner.n
        )
    if isinstance(owner, host_sample.BernoulliSampler):
        return dev_sampling.BernoulliSampler(n_e, put(owner.probs))
    if isinstance(owner, host_sample.CorruptedSampler):
        arrays = []
        for mode in (0, 1):  # the type index as flat CSR arrays
            flat, off, cnt = [], np.zeros(n_r, np.int32), np.zeros(n_r, np.int32)
            for p in range(n_r):
                cands = owner.idx.get(p, {}).get(mode, [])
                off[p], cnt[p] = len(flat), len(cands)
                flat.extend(cands)
            arrays += [np.asarray(flat or [0], np.int32), off, cnt]
        return dev_sampling.CorruptedSampler(
            n_e, *map(put, arrays), modes=tuple(owner.modes) * owner.n,
        )
    return None


# ---------------------------------------------------------------------------
# Trainers
# ---------------------------------------------------------------------------

class StochasticTrainer:
    """Pointwise logistic-loss trainer (skge/base.py ~100-195)."""

    pairwise = False

    def __init__(self, model: Model, **kwargs):
        self.model = model
        self.hyperparams = {}
        self.add_hyperparam("max_epochs", int(kwargs.pop("max_epochs", _DEF_MAX_EPOCHS)))
        self.add_hyperparam("nbatches", int(kwargs.pop("nbatches", _DEF_NBATCHES)))
        self.add_hyperparam(
            "learning_rate", float(kwargs.pop("learning_rate", _DEF_LEARNING_RATE))
        )
        self.add_hyperparam("margin", float(kwargs.pop("margin", _DEF_MARGIN)))
        self.add_hyperparam("optimizer", kwargs.pop("optimizer", "adagrad"))
        self.samplef = kwargs.pop("samplef", None)
        self.post_epoch = list(kwargs.pop("post_epoch", []))
        self.seed = int(kwargs.pop("seed", 0))
        self.aggregate = kwargs.pop("aggregate", "unique")
        self._device = resolve_device(kwargs.pop("device", None))
        self.loss = float("nan")
        self.nviolations = 0
        self.epoch = 0
        self.epoch_start = None

    def add_hyperparam(self, name, value):
        self.hyperparams[name] = value
        setattr(self, name, value)

    @property
    def device(self) -> torch.device:
        """Where training runs ("cuda" unless the trainer was made or loaded
        with another device)."""
        return resolve_device(self._device)

    def __getstate__(self):
        """Picklable trainer state (for Config): hyperparams + progress.

        Device state, the device, callbacks and samplef (possibly
        unpicklable closures) are dropped; `fit` rebuilds them.
        """
        return {
            "hyperparams": self.hyperparams,
            "seed": self.seed,
            "aggregate": self.aggregate,
            "epoch": self.epoch,
            "loss": self.loss,
            "nviolations": self.nviolations,
            "model": self.model,
        }

    def __setstate__(self, st):
        self.model = st["model"]
        self.hyperparams = {}
        for k, v in st["hyperparams"].items():
            self.add_hyperparam(k, v)
        self.seed = st["seed"]
        self.aggregate = st["aggregate"]
        self.epoch = st["epoch"]
        self.loss = st["loss"]
        self.nviolations = st["nviolations"]
        self.samplef = None
        self.post_epoch = []
        self.epoch_start = None
        self._device = None  # "cuda" until `Config.load` places it

    def _opt(self):
        cls = {"adagrad": DevAdaGrad, "sgd": DevSGD}[str(self.optimizer).lower()]
        return cls(lr=self.learning_rate)

    def _epoch_perm(self) -> Optional[torch.Tensor]:
        """The next device epoch's permutation; None draws it from the
        state's generator (tests replay another run's permutations here)."""
        return None

    def _init_state(self, opt) -> TrainState:
        params = self.model.device_params(self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return TrainState(params=params, opt_state=opt.init(params), generator=gen, step=0)

    def _tensor(self, a, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    # -- shared epoch plumbing --
    def _run_epochs(self, run_one_epoch, n_epochs):
        for _ in range(n_epochs):
            self.epoch += 1
            self.epoch_start = timeit.default_timer()
            run_one_epoch()
            stop = False
            for f in self.post_epoch:
                if not f(self):
                    stop = True
            if stop:
                break

    def _fit_epochs(self, state, epoch_fn, *data) -> TrainState:
        """`max_epochs` device epochs of `epoch_fn(state, *data, perm=)`,
        each followed by the `post_epoch` callbacks."""
        holder = {"state": state}

        def one_epoch():
            holder["state"], m = epoch_fn(holder["state"], *data, perm=self._epoch_perm())
            self.loss = float(m.loss.sum())
            self.nviolations = int(m.nviolations.sum())

        self._run_epochs(one_epoch, self.max_epochs)
        return holder["state"]

    def _finish(self, state) -> "StochasticTrainer":
        self.model.set_params(state.params)
        self._state = state
        return self

    def fit(self, xs, ys):
        xs = np.asarray(list(xs), np.int64).reshape(-1, 3)
        ys = np.asarray(list(ys), np.float32).reshape(-1)
        opt = self._opt()
        state = self._init_state(opt)
        dev = None if self.samplef is None else _device_sampler(
            self.samplef, self.model.sz, self.device
        )
        if self.samplef is None or dev is not None:
            state = self._fit_device(opt, state, xs, ys, dev)
        else:
            state = self._fit_host(opt, state, xs, ys)
        return self._finish(state)

    def make_step(self, sampler=None, opt=None):
        """The device path's step, `step(state, batch, mask, ys)` ->
        (state, metrics): the pointwise update on the labelled batch with
        `sampler`'s negatives (a `skge_torch.sampling` sampler, or None for
        none) appended at y = -1."""
        update = make_pointwise_update(self.model.fmodel, opt or self._opt(),
                                       self.aggregate)

        def step(st, batch, mask, ys_b):
            if sampler is None:
                return update(st, batch, ys_b, mask)
            _, neg, pm = sampler(st.generator, batch, mask)
            triples = torch.cat([batch, neg])
            yy = torch.cat([ys_b, -torch.ones(neg.shape[0], dtype=ys_b.dtype,
                                              device=ys_b.device)])
            return update(st, triples, yy, torch.cat([mask, pm]))

        return step

    # -- fully on-device path --
    def _fit_device(self, opt, state, xs, ys, dev_sampler):
        """`make_epoch_fn` over row ids, so that each minibatch carries its
        triples' labels (padding rows: row 0, masked)."""
        n = xs.shape[0]
        step = self.make_step(dev_sampler, opt)
        xs_d, ys_d = self._tensor(xs), self._tensor(ys, torch.float32)

        def by_row(st, rows, mask):
            return step(st, xs_d[rows[:, 0]], mask, ys_d[rows[:, 0]])

        epoch_fn = make_epoch_fn(by_row, n, min(self.nbatches, n))
        return self._fit_epochs(state, epoch_fn, self._tensor(np.arange(n)[:, None]))

    # -- host samplef fallback (arbitrary callables) --
    def _fit_host(self, opt, state, xs, ys):
        update = make_pointwise_update(self.model.fmodel, opt, self.aggregate)
        n = xs.shape[0]
        nb = min(self.nbatches, n)
        bs = -(-n // nb)
        rng = np.random.default_rng(self.seed)
        holder = {"state": state}

        def one_epoch():
            perm = rng.permutation(n)
            total_loss = 0.0
            for b in range(nb):
                sel = perm[b * bs : (b + 1) * bs]
                if sel.size == 0:
                    continue
                bx, by = xs[sel], ys[sel]
                xys = [((int(s), int(o), int(p)), float(y)) for (s, o, p), y in zip(bx, by)]
                negs = self.samplef(xys)
                if negs:
                    nx = np.asarray([t for t, _ in negs], np.int64)
                    ny = np.asarray([y for _, y in negs], np.float32)
                    bx = np.concatenate([bx, nx])
                    by = np.concatenate([by, ny])
                width = _round_up(bx.shape[0], bs)
                pad = width - bx.shape[0]
                mask = np.concatenate([np.ones(bx.shape[0]), np.zeros(pad)]).astype(np.float32)
                bx = np.concatenate([bx, np.zeros((pad, 3), np.int64)])
                by = np.concatenate([by, np.zeros(pad, np.float32)])
                holder["state"], m = update(
                    holder["state"], self._tensor(bx), self._tensor(by, torch.float32),
                    self._tensor(mask, torch.float32)
                )
                total_loss += float(m.loss)
            self.loss = total_loss

        self._run_epochs(one_epoch, self.max_epochs)
        return holder["state"]


class PairwiseStochasticTrainer(StochasticTrainer):
    """Margin-ranking trainer (skge/base.py ~210-265)."""

    pairwise = True

    def fit(self, xs, ys):
        xs = np.asarray(list(xs), np.int64).reshape(-1, 3)
        ys = np.asarray(list(ys), np.float32).reshape(-1)
        opt = self._opt()
        state = self._init_state(opt)
        if self.samplef is None:
            # reference pre-splits by label and pairs pos[i] with neg[i % n]
            pos = xs[ys > 0]
            neg = xs[ys <= 0]
            if len(neg) == 0:
                raise ValueError(
                    "pairwise training without samplef needs negative-labeled triples"
                )
            rep = neg[np.arange(len(pos)) % len(neg)]
            state = self._fit_device_pairs(opt, state, pos, rep)
        else:
            dev = _device_sampler(self.samplef, self.model.sz, self.device)
            if dev is not None:
                state = self._fit_device_sampled(opt, state, xs[ys > 0], dev)
            else:
                state = self._fit_host_pairwise(opt, state, xs[ys > 0])
        return self._finish(state)

    def make_step(self, sampler=None, opt=None):
        """The device path's step, `step(state, batch, mask)` -> (state,
        metrics): the margin update on `sampler`'s expanded pairs (a
        `skge_torch.sampling` sampler) of the positives `batch`, or, with
        no sampler, on pre-paired (N, 6) rows (positive, negative)."""
        update = make_pairwise_update(self.model.fmodel, opt or self._opt(), self.margin,
                                      self.aggregate)

        def step(st, batch, mask):
            if sampler is None:
                return update(st, batch[:, :3], batch[:, 3:], mask)
            pos_rep, neg, pm = sampler(st.generator, batch, mask)
            return update(st, pos_rep, neg, pm)

        return step

    def _fit_device_sampled(self, opt, state, xs, dev_sampler):
        n = xs.shape[0]
        epoch_fn = make_epoch_fn(self.make_step(dev_sampler, opt), n, min(self.nbatches, n))
        return self._fit_epochs(state, epoch_fn, self._tensor(xs))

    def _fit_device_pairs(self, opt, state, pos, neg):
        """Pre-paired (samplef=None) path: scan fixed pairs each epoch."""
        n = pos.shape[0]
        epoch_fn = make_epoch_fn(self.make_step(None, opt), n, min(self.nbatches, n))
        return self._fit_epochs(state, epoch_fn,
                                self._tensor(np.concatenate([pos, neg], axis=1)))

    def _fit_host_pairwise(self, opt, state, xs):
        """Arbitrary samplef: reference pairs each positive with each of its
        sampled negatives (skge/base.py ~265)."""
        update = make_pairwise_update(self.model.fmodel, opt, self.margin, self.aggregate)
        n = xs.shape[0]
        nb = min(self.nbatches, n)
        bs = -(-n // nb)
        rng = np.random.default_rng(self.seed)
        holder = {"state": state}

        def one_epoch():
            perm = rng.permutation(n)
            nviol = 0
            total_loss = 0.0
            for b in range(nb):
                sel = perm[b * bs : (b + 1) * bs]
                if sel.size == 0:
                    continue
                pxs, nxs = [], []
                for row in xs[sel]:
                    xy = ((int(row[0]), int(row[1]), int(row[2])), 1.0)
                    for t, _ in self.samplef([xy]):
                        pxs.append(tuple(row))
                        nxs.append(t)
                if not pxs:
                    continue
                pa = np.asarray(pxs, np.int64)
                na = np.asarray(nxs, np.int64)
                width = _round_up(pa.shape[0], bs)
                pad = width - pa.shape[0]
                mask = np.concatenate([np.ones(pa.shape[0]), np.zeros(pad)]).astype(np.float32)
                pa = np.concatenate([pa, np.zeros((pad, 3), np.int64)])
                na = np.concatenate([na, np.zeros((pad, 3), np.int64)])
                holder["state"], m = update(
                    holder["state"], self._tensor(pa), self._tensor(na),
                    self._tensor(mask, torch.float32)
                )
                nviol += int(m.nviolations)
                total_loss += float(m.loss)
            self.nviolations = nviol
            self.loss = total_loss

        self._run_epochs(one_epoch, self.max_epochs)
        return holder["state"]


_PICKLED = {cls.__name__: cls for cls in (
    Config, Model, TransE, RESCAL, HolE, ERMLP, StochasticTrainer,
    PairwiseStochasticTrainer)}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m
