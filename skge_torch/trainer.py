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

With `mesh` (`parallel.mesh.make_mesh`), every process of the mesh runs
the same `Trainer` on the same triples: the entity table (and, with
`shard_relations`, the relation tables) row-sharded over 'model', each
batch split over 'data'. The steps draw for the global batch from the
same generator on every rank, so the trajectory is the single-device one.
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
    # mesh runs only: row-shard the relation tables over 'model' too (the
    # shard_map steps, not full CE), the memory mode of wide relation tables
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
    raises unless the CPU is asked for.

    `mesh`: a ('data', 'model') `parallel.mesh.Mesh`; the trainer then runs
    on the mesh's device, the steps of `parallel.shardmap_step` (CE: the
    vocab-parallel step; sampled CE, selfadv, pairwise and pointwise on a
    pool: `cfg.shard_relations` applies) or, for pointwise with an iid
    sampler, `parallel.sharded`'s, over `make_epoch_fn(..., pad_to=D)`.
    `state` is this rank's part; loss and violations are global on every
    rank, and `save` writes the full tables."""

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
        if config.loss not in LOSSES:
            raise ValueError(f"unknown loss {config.loss!r}")
        self.mesh = mesh
        if mesh is not None:
            if device is not None and torch.device(device).type != mesh.device.type:
                raise ValueError(f"device={device!r} but the mesh runs on {mesh.device}")
            self.device = mesh.device
        else:
            self.device = resolve_device(device)
        self.model = model
        self.config = config
        self.sampler = sampler
        self.post_epoch = list(post_epoch)
        self.opt = make_optimizer(config) if optimizer is None else optimizer
        # on a mesh only the world's rank 0 writes the metrics file
        self.metrics = MetricsLogger(
            config.metrics_jsonl if mesh is None or mesh.rank == 0 else None)
        self.state: Optional[TrainState] = None
        # per-epoch scalars for callbacks (reference attribute contract)
        self.epoch = 0
        self.loss = float("nan")
        self.nviolations = 0

    def make_step(self):
        """The train step of `config.loss`: (state, batch, mask) -> (state,
        metrics)."""
        cfg, model, opt, sampler = self.config, self.model, self.opt, self.sampler
        if self.mesh is not None:
            return self._mesh_step()
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

    @property
    def _shard_relations(self) -> bool:
        """Relation tables row-sharded: the shard_map routes but full CE."""
        cfg = self.config
        return cfg.shard_relations and cfg.loss != "ce" and (
            cfg.loss != "margin" or cfg.pairwise or hasattr(self.sampler, "pool"))

    def _mesh_step(self):
        """The mesh step of `config.loss`, routed as the JAX package's
        `Trainer._build_mesh_epoch`."""
        from skge_torch.parallel import sharded, shardmap_step as sm

        cfg, model, opt, sampler, mesh = (self.config, self.model, self.opt,
                                          self.sampler, self.mesh)
        rel = self._shard_relations
        if cfg.loss == "ce":
            return sm.make_shardmap_ce_step(model, opt, mesh, tuple(cfg.ce_directions),
                                            cfg.label_smoothing)
        if cfg.loss == "sampled_ce":
            return sm.make_shardmap_sampled_ce_step(
                model, opt, sampler, mesh, tuple(cfg.ce_directions),
                cfg.label_smoothing, shard_relations=rel)
        if cfg.loss == "selfadv":
            return sm.make_shardmap_selfadv_step(model, opt, sampler, cfg.margin, mesh,
                                                 alpha=cfg.adv_alpha, shard_relations=rel)
        if cfg.pairwise:
            return sm.make_shardmap_pairwise_step(model, opt, sampler, cfg.margin, mesh,
                                                  shard_relations=rel)
        if hasattr(sampler, "pool"):
            return sm.make_shardmap_pointwise_step(model, opt, sampler, mesh,
                                                   shard_relations=rel)
        return sharded.make_sharded_pointwise_step(model, opt, sampler, mesh)

    def _place(self, state: TrainState) -> TrainState:
        """On a mesh, this rank's part of a full state (a state already
        split, as `self.state`, stays as it is)."""
        from skge_torch.parallel.mesh import shard_state

        if self.mesh is None:
            return state
        return shard_state(state, self.model, self.mesh, self._shard_relations)

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
        pad_to = 1 if self.mesh is None else self.mesh.data.size
        epoch_fn = make_epoch_fn(self.make_step(), n, min(cfg.nbatches, n), pad_to=pad_to)
        if state is None:
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
            state = init_state(self.model, self.opt, gen)
        self.state = self._place(state)
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

    def full_state(self) -> TrainState:
        """The whole state: on a mesh, every row-sharded table and its slots
        all-gathered over 'model' (a collective: every rank calls it)."""
        if self.state is None:
            raise RuntimeError("no state before fit()")
        if self.mesh is None:
            return self.state
        from skge_torch.parallel.mesh import unshard_state

        return unshard_state(self.state, self.model, self.mesh, self._shard_relations)

    def save(self, path: str) -> None:
        """An npz checkpoint of the full state; on a mesh every rank must
        call it (the tables are gathered) and the world's rank 0 writes."""
        state = self.full_state()
        if self.mesh is not None and self.mesh.rank != 0:
            return
        save_checkpoint(path, state, meta={
            "model": self.model.name,
            "epoch": self.epoch,
            "config": self.config.to_meta(),
        })
