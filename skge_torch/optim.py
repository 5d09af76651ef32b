"""Sparse row optimizers of the port.

- AdaGrad: ``p2[idx] += g*g; param[idx] -= lr * g / max(sqrt(p2[idx]), EPS)``
  — the accumulator is updated FIRST and only at touched rows.
- SGD: ``param[idx] -= lr * g``.
- Post-constraint ``normless1`` renormalizes ONLY the touched rows whose L2
  norm exceeds 1, after the update.

Updates are functional: every apply returns new tensors and leaves its
inputs as they were. Rows whose occurrence count is zero keep their old
values bit for bit, so a batch with zero violations changes nothing.
"""

from __future__ import annotations

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
class Optimizer:
    """Base for sparse row optimizers."""

    lr: float = 0.1

    def init(self, params) -> OptState:
        raise NotImplementedError

    def _step(
        self, rows: torch.Tensor, g: torch.Tensor,
        slots: Dict[str, torch.Tensor],
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
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        old_rows = param[ug.uidx]
        old_state = {k: v[ug.uidx] for k, v in state.items()}
        new_rows, new_state = self._step(old_rows, ug.grads, old_state)
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
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        new_rows, new_state = self._step(param, dg.grads, state)
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
        g: torch.Tensor,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return self._step(param, g, state)


@dataclass(frozen=True)
class AdaGrad(Optimizer):
    """Row-sparse AdaGrad."""

    eps: float = EPS

    def init(self, params) -> OptState:
        return {k: {"p2": torch.zeros_like(v)} for k, v in params.items()}

    def _step(self, rows, g, slots):
        p2 = slots["p2"] + g * g
        h = torch.clamp(torch.sqrt(p2), min=self.eps)
        return rows - self.lr * g / h, {"p2": p2}


@dataclass(frozen=True)
class SGD(Optimizer):
    """Plain SGD. Stateless."""

    def init(self, params) -> OptState:
        return {k: {} for k in params}

    def _step(self, rows, g, slots):
        return rows - self.lr * g, {}


OPTIMIZERS = {"adagrad": AdaGrad, "sgd": SGD}
