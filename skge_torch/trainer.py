"""The port's high-level trainer, `skge_tpu.trainer`'s counterpart.

`Trainer` runs epochs of `training.make_epoch_fn` over one of four losses
(`TrainConfig.loss`): the margin pair (pairwise, or pointwise logistic with
`pairwise=False`), `selfadv`, `ce` and `sampled_ce`. `post_epoch` callbacks
receive the trainer, and a falsy return stops training, as in the
reference. Each epoch logs one metrics record and, with `checkpoint_path`
and `checkpoint_every`, writes a checkpoint (`utils.checkpoint`).

Training runs on the card unless the caller asks for the CPU: `device`
defaults to "cuda", and without a GPU the trainer raises rather than fall
back. The host syncs once per epoch, to read the summed loss and violation
count, never once per step.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from skge_torch.models.base import KGEModel
from skge_torch.optim import OPTIMIZERS, Optimizer, make_schedule
from skge_torch.training import (
    TrainState,
    init_state,
    make_ce_step,
    make_epoch_fn,
    make_pairwise_step,
    make_pointwise_step,
    make_sampled_ce_step,
    make_selfadv_step,
)
from skge_torch.utils.checkpoint import save_checkpoint
from skge_torch.utils.device import resolve_device
from skge_torch.utils.metrics import MetricsLogger, StepTimer

# reference module defaults (skge/base.py)
DEF_MAX_EPOCHS = 500
DEF_NBATCHES = 100
DEF_LEARNING_RATE = 0.1
DEF_MARGIN = 1.0

LOSSES = ("margin", "selfadv", "ce", "sampled_ce")


@dataclass(frozen=True)
class TrainConfig:
    max_epochs: int = DEF_MAX_EPOCHS
    nbatches: int = DEF_NBATCHES
    learning_rate: float = DEF_LEARNING_RATE
    margin: float = DEF_MARGIN
    pairwise: bool = True
    # 'margin' (the pairwise/pointwise pair above), 'selfadv' (needs a pool
    # sampler), 'ce' (full 1-vs-all cross entropy, no sampler) or
    # 'sampled_ce' (needs a pool sampler). `adv_alpha` is selfadv's softmax
    # temperature; `label_smoothing`/`ce_directions` parameterize the CEs.
    loss: str = "margin"
    adv_alpha: float = 1.0
    label_smoothing: float = 0.0
    ce_directions: tuple = ("o", "s")
    optimizer: str = "adagrad"
    # lr schedule ('linear'/'cosine'/None) over max_epochs * nbatches steps;
    # its position is TrainState.step, which checkpoints keep
    schedule: Optional[str] = None
    warmup: int = 0
    schedule_min: float = 0.0
    aggregate: str = "unique"
    # mesh runs of the JAX package only; kept so configs carry across
    shard_relations: bool = False
    seed: int = 0
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0  # epochs; 0 = only on completion if path set
    metrics_jsonl: Optional[str] = None

    def to_meta(self) -> dict:
        return dataclasses.asdict(self)


def make_optimizer(config: TrainConfig) -> Optimizer:
    """`config.optimizer` at `config.learning_rate`, with its lr schedule over
    `max_epochs * nbatches` steps."""
    return OPTIMIZERS[config.optimizer](
        lr=config.learning_rate,
        schedule=make_schedule(config.schedule, warmup=config.warmup,
                               total=config.max_epochs * config.nbatches,
                               min_scale=config.schedule_min),
    )


class Trainer:
    """Drives epochs of the step for `config.loss`; owns the state, the
    metrics and the callbacks. `post_epoch`: `f(trainer) -> truthy to
    continue`. `device` is "cuda" by default; without a GPU the trainer
    raises unless the CPU is asked for."""

    def __init__(
        self,
        model: KGEModel,
        sampler: Optional[Callable],
        config: TrainConfig = TrainConfig(),
        post_epoch: Sequence[Callable] = (),
        optimizer: Optional[Optimizer] = None,
        device=None,
        mesh=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "mesh training is not ported yet (ROADMAP.md queue 9)")
        if config.loss not in LOSSES:
            raise ValueError(f"unknown loss {config.loss!r}")
        self.device = resolve_device(device)
        self.model = model
        self.config = config
        self.sampler = sampler
        self.post_epoch = list(post_epoch)
        self.opt = make_optimizer(config) if optimizer is None else optimizer
        self.metrics = MetricsLogger(config.metrics_jsonl)
        self.state: Optional[TrainState] = None
        # per-epoch scalars for callbacks (reference attribute contract)
        self.epoch = 0
        self.loss = float("nan")
        self.nviolations = 0

    def make_step(self):
        """The train step of `config.loss`: (state, batch, mask) -> (state,
        metrics)."""
        cfg, model, opt, sampler = self.config, self.model, self.opt, self.sampler
        if cfg.loss == "sampled_ce":
            return make_sampled_ce_step(model, opt, sampler, tuple(cfg.ce_directions),
                                        cfg.label_smoothing, cfg.aggregate)
        if cfg.loss == "ce":
            return make_ce_step(model, opt, tuple(cfg.ce_directions), cfg.label_smoothing)
        if cfg.loss == "selfadv":
            return make_selfadv_step(model, opt, sampler, cfg.margin, cfg.adv_alpha,
                                     cfg.aggregate)
        if cfg.pairwise:
            return make_pairwise_step(model, opt, sampler, cfg.margin, cfg.aggregate)
        return make_pointwise_step(model, opt, sampler, cfg.aggregate)

    def fit(
        self,
        xs: np.ndarray,
        state: Optional[TrainState] = None,
        start_epoch: int = 0,
    ) -> TrainState:
        """Train on (N, 3) int triples. Resumable via (state, start_epoch)."""
        xs = torch.as_tensor(np.asarray(xs).reshape(-1, 3), dtype=torch.int64,
                             device=self.device)
        n = xs.shape[0]
        cfg = self.config
        epoch_fn = make_epoch_fn(self.make_step(), n, min(cfg.nbatches, n))
        if state is None:
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
            state = init_state(self.model, self.opt, gen)
        self.state = state
        timer = StepTimer()
        for epoch in range(start_epoch, cfg.max_epochs):
            self.epoch = epoch + 1
            self.state, m = epoch_fn(self.state, xs)
            # the epoch's one sync
            loss, nviol = torch.stack([m.loss.sum().double(),
                                       m.nviolations.sum().double()]).tolist()
            self.loss, self.nviolations = loss, int(nviol)
            dt = timer.reset()
            self.metrics.log({
                "epoch": self.epoch,
                "loss": self.loss,
                "nviolations": self.nviolations,
                "epoch_seconds": dt,
                "triples_per_second": n / max(dt, 1e-9),
            })
            if (cfg.checkpoint_path and cfg.checkpoint_every
                    and self.epoch % cfg.checkpoint_every == 0):
                self.save(cfg.checkpoint_path)
            stop = False
            for f in self.post_epoch:
                if not f(self):
                    stop = True
            if stop:
                break
        if cfg.checkpoint_path:
            self.save(cfg.checkpoint_path)
        return self.state

    def save(self, path: str) -> None:
        if self.state is None:
            raise RuntimeError("nothing to save before fit()")
        save_checkpoint(path, self.state, meta={
            "model": self.model.name,
            "epoch": self.epoch,
            "config": self.config.to_meta(),
        })
