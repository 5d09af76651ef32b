"""Sparse row optimizers of the port, and learning-rate schedules.

- AdaGrad: ``p2[idx] += g*g; param[idx] -= lr * g / max(sqrt(p2[idx]), EPS)``
  — the accumulator is updated FIRST and only at touched rows.
- SGD: ``param[idx] -= lr * g``.
- Adam: lazy; moments and the bias-correction count ``t`` are kept per row
  and move only on touched rows.
- Post-constraint ``normless1`` renormalizes ONLY the touched rows whose L2
  norm exceeds 1, after the update.

A `Schedule` multiplies lr by a function of the global step
(`TrainState.step`, a Python int), computed in Python floats (fp64), so a
schedule costs no device work and resumes with the step a checkpoint holds.

Updates are functional: every apply returns new tensors and leaves its
inputs as they were. Rows whose occurrence count is zero keep their old
values bit for bit, so a batch with zero violations changes nothing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from skge_torch.ops.aggregate import DenseGrads, UniqueGrads

OptState = Dict[str, Dict[str, torch.Tensor]]

EPS = 1e-6


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (ndim - 1))


def normless1_rows(rows: torch.Tensor) -> torch.Tensor:
    """Project rows with L2 norm > 1 onto the unit ball.

    For 3-D parameters the norm is over all trailing axes.
    """
    dims = tuple(range(1, rows.dim()))
    norm = torch.sqrt(torch.sum(rows * rows, dim=dims, keepdim=True))
    return torch.where(norm > 1.0, rows / torch.clamp(norm, min=1e-30), rows)


POST_CONSTRAINTS = {"normless1": normless1_rows}


@dataclass(frozen=True)
class Schedule:
    """lr multiplier as a function of the global step."""

    def __call__(self, step: int) -> float:
        raise NotImplementedError


def _warmup_frac(step: int, warmup: int, total: int) -> Tuple[float, float]:
    """(warmup factor, fraction of the decay done) at `step`."""
    s = float(step)
    w = min(s / max(float(warmup), 1.0), 1.0) if warmup > 0 else 1.0
    span = max(float(total - warmup), 1.0)
    return w, min(max((s - float(warmup)) / span, 0.0), 1.0)


@dataclass(frozen=True)
class WarmupLinear(Schedule):
    """Linear warmup over `warmup` steps, then linear decay to
    `min_scale` * lr at `total` steps (constant afterwards)."""

    warmup: int = 0
    total: int = 10_000
    min_scale: float = 0.0

    def __call__(self, step: int) -> float:
        w, frac = _warmup_frac(step, self.warmup, self.total)
        return w * (1.0 - (1.0 - self.min_scale) * frac)


@dataclass(frozen=True)
class WarmupCosine(Schedule):
    """Linear warmup over `warmup` steps, then cosine decay to
    `min_scale` * lr at `total` steps (constant afterwards)."""

    warmup: int = 0
    total: int = 10_000
    min_scale: float = 0.0

    def __call__(self, step: int) -> float:
        w, frac = _warmup_frac(step, self.warmup, self.total)
        cos = 0.5 * (1.0 + math.cos(math.pi * frac))
        return w * (self.min_scale + (1.0 - self.min_scale) * cos)


SCHEDULES = {"linear": WarmupLinear, "cosine": WarmupCosine}


def make_schedule(name: Optional[str], warmup: int = 0, total: int = 10_000,
                  min_scale: float = 0.0) -> Optional[Schedule]:
    """None or 'constant' -> None, else SCHEDULES[name](...)."""
    if name is None or name == "constant":
        return None
    return SCHEDULES[name](warmup=warmup, total=total, min_scale=min_scale)


@dataclass(frozen=True)
class Optimizer:
    """Base for sparse row optimizers. With a `schedule`, lr is multiplied
    by `schedule(step)` for the `step` the apply methods are given (every
    step factory passes `TrainState.step`); without a step, by 1."""

    lr: float = 0.1
    schedule: Optional[Schedule] = None

    def lr_at(self, step: Optional[int] = None) -> float:
        if self.schedule is None or step is None:
            return self.lr
        return self.lr * self.schedule(step)

    def init(self, params) -> OptState:
        raise NotImplementedError

    def _step(
        self, rows: torch.Tensor, g: torch.Tensor,
        slots: Dict[str, torch.Tensor], lr: float,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Return (new_rows, new_state_slots) for touched rows."""
        raise NotImplementedError

    # --- unique-row (batch-local) sparse update ---
    def apply_unique(
        self,
        param: torch.Tensor,
        state: Dict[str, torch.Tensor],
        ug: UniqueGrads,
        post: Optional[str] = None,
        step: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        old_rows = param[ug.uidx]
        old_state = {k: v[ug.uidx] for k, v in state.items()}
        new_rows, new_state = self._step(old_rows, ug.grads, old_state,
                                         self.lr_at(step))
        if post is not None:
            new_rows = POST_CONSTRAINTS[post](new_rows)
        valid = ug.count > 0
        new_rows = torch.where(_bcast(valid, new_rows.dim()), new_rows, old_rows)
        param = param.index_copy(0, ug.uidx, new_rows)
        out_state = {}
        for k in state:
            ns = torch.where(
                _bcast(valid, new_state[k].dim()), new_state[k], old_state[k]
            )
            out_state[k] = state[k].index_copy(0, ug.uidx, ns)
        return param, out_state

    # --- dense (full-table) masked update ---
    def apply_dense_masked(
        self,
        param: torch.Tensor,
        state: Dict[str, torch.Tensor],
        dg: DenseGrads,
        post: Optional[str] = None,
        step: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        new_rows, new_state = self._step(param, dg.grads, state, self.lr_at(step))
        if post is not None:
            new_rows = POST_CONSTRAINTS[post](new_rows)
        valid = dg.count > 0
        param = torch.where(_bcast(valid, param.dim()), new_rows, param)
        out_state = {
            k: torch.where(_bcast(valid, state[k].dim()), new_state[k], state[k])
            for k in state
        }
        return param, out_state

    # --- dense unconditional update ---
    def apply_full(
        self, param: torch.Tensor, state: Dict[str, torch.Tensor],
        g: torch.Tensor, step: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return self._step(param, g, state, self.lr_at(step))


@dataclass(frozen=True)
class AdaGrad(Optimizer):
    """Row-sparse AdaGrad."""

    eps: float = EPS

    def init(self, params) -> OptState:
        return {k: {"p2": torch.zeros_like(v)} for k, v in params.items()}

    def _step(self, rows, g, slots, lr):
        p2 = slots["p2"] + g * g
        h = torch.clamp(torch.sqrt(p2), min=self.eps)
        return rows - lr * g / h, {"p2": p2}


@dataclass(frozen=True)
class SGD(Optimizer):
    """Plain SGD. Stateless."""

    def init(self, params) -> OptState:
        return {k: {} for k in params}

    def _step(self, rows, g, slots, lr):
        return rows - lr * g, {}


@dataclass(frozen=True)
class Adam(Optimizer):
    """Row-sparse (lazy) Adam: moments decay and update only at touched
    rows, and the bias correction uses a per-row count `t` of the row's
    updates, so a row's trajectory does not depend on how many batches
    skipped it. Zero-count rows are left bit for bit, as with AdaGrad."""

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params) -> OptState:
        # `t` in at least fp32: in bf16, t + 1 == t after 256 updates
        return {
            k: {
                "m": torch.zeros_like(v),
                "v": torch.zeros_like(v),
                "t": torch.zeros(v.shape[0], device=v.device,
                                 dtype=torch.promote_types(v.dtype, torch.float32)),
            }
            for k, v in params.items()
        }

    def _step(self, rows, g, slots, lr):
        t = slots["t"] + 1.0
        m = self.b1 * slots["m"] + (1.0 - self.b1) * g
        v = self.b2 * slots["v"] + (1.0 - self.b2) * g * g
        tb = _bcast(t, rows.dim())
        mhat = m / (1.0 - self.b1 ** tb)
        vhat = v / (1.0 - self.b2 ** tb)
        new = rows - lr * mhat / (torch.sqrt(vhat) + self.eps)
        return new, {"m": m, "v": v, "t": t}


OPTIMIZERS = {"adagrad": AdaGrad, "sgd": SGD, "adam": Adam}
