"""Model abstraction for the PyTorch port.

As in `skge_tpu.models.base`, a model is a FROZEN hyperparameter dataclass;
its parameters live in a plain dict of tensors that the training functions
pass around. A model contributes:

- `init_params(generator)`: parameter construction on the generator's device.
- `slot_spec()`: which parameter table is gathered by which triple role.
- `score_from_rows(rows, dense)`: scoring from gathered rows. Rows may
  carry extra leading axes that broadcast against each other: the fused
  pairwise step scores the corruptions of one mode as one (n, B, ·) stack
  against the positives' (B, ·) rows.
- `score_pool` / `score_all_o` / `score_all_s`: batched sweeps against a
  shared negative pool and against every entity.

Triple role convention everywhere: columns (s, o, p).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Tuple

import torch

Params = Dict[str, torch.Tensor]
Rows = Dict[str, torch.Tensor]

# (slot_name, param_name, role) where role in {'s', 'o', 'p'}
SlotSpec = Tuple[Tuple[str, str, str], ...]


def _sigmoid_g(fx):
    return fx * (1.0 - fx)


# activation name -> (f, derivative given the forward value)
ACTIVATIONS: Mapping[str, Tuple[Callable, Callable]] = {
    "linear": (lambda x: x, torch.ones_like),
    "sigmoid": (torch.sigmoid, _sigmoid_g),
    "tanh": (torch.tanh, lambda fx: 1.0 - fx * fx),
    "relu": (lambda x: torch.clamp(x, min=0.0), lambda fx: (fx > 0).to(fx.dtype)),
}


def acc_dtype(x: torch.Tensor) -> torch.dtype:
    """Matmul accumulation dtype: at least float32, never below the input's."""
    return torch.promote_types(x.dtype, torch.float32)


def mxu_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul with >= fp32 accumulation (TF32 must be off on the card for
    this to hold)."""
    acc = acc_dtype(a)
    return torch.matmul(a.to(acc), b.to(acc))


def nunif(generator: torch.Generator, shape: Tuple[int, ...],
          dtype=torch.float32) -> torch.Tensor:
    """Normalized-uniform (Glorot-style) init: U(-b, b), b=sqrt(6/(d0+d1))."""
    bnd = math.sqrt(6.0) / math.sqrt(shape[0] + shape[1])
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return u * (2.0 * bnd) - bnd


def normal(generator: torch.Generator, shape: Tuple[int, ...],
           dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device)


INITIALIZERS = {"nunif": nunif, "normal": normal}


@dataclass(frozen=True)
class KGEModel:
    """Base class: frozen hyperparams + pure scoring functions."""

    n_entities: int
    n_relations: int
    ncomp: int
    dtype: str = "float32"
    init: str = "nunif"

    # static metadata, overridden per model
    name = "base"
    dense_param_names = ()
    post_constraints = {}
    # row params receiving `rparam * row` regularization on touched rows
    reg_row_params = ()

    @property
    def pairwise_af(self) -> str:
        """Activation applied to scores before the pairwise margin test."""
        return "linear"

    @property
    def regularization(self) -> float:
        """L2 coefficient applied per touched row (`rparam`); 0 when absent."""
        return float(getattr(self, "rparam", 0.0))

    def reg_grad_rows(self, pname: str, rows: torch.Tensor) -> torch.Tensor:
        """Row-L2 (`rparam`) gradient contribution for `pname` rows:
        identity by default."""
        return rows

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def mxu(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Scoring matmul, `mxu_dot`."""
        return mxu_dot(a, b)

    # --- interface ---
    def slot_spec(self) -> SlotSpec:
        raise NotImplementedError

    def init_params(self, generator: torch.Generator) -> Params:
        raise NotImplementedError

    def score_from_rows(self, rows: Rows, dense: Params) -> torch.Tensor:
        raise NotImplementedError

    def score_pool(
        self, rows: Rows, pool_rows: torch.Tensor, dense: Params, mode: int
    ) -> torch.Tensor:
        """Scores of every positive against every pool entity: (B, K).

        Pool row k is substituted into role `mode` (0 = subject, 1 = object).
        """
        raise NotImplementedError

    def score_pool_modes(
        self, rows: Rows, pool_rows: torch.Tensor, dense: Params, modes
    ) -> Tuple[torch.Tensor, ...]:
        """`score_pool` for several corruption modes at once."""
        return tuple(self.score_pool(rows, pool_rows, dense, m) for m in modes)

    def score_all_o(self, params: Params, s, p) -> torch.Tensor:
        """Scores of (s, e, p) for every entity e: shape (B, n_entities)."""
        raise NotImplementedError

    def score_all_s(self, params: Params, o, p) -> torch.Tensor:
        """Scores of (e, o, p) for every entity e: shape (B, n_entities)."""
        raise NotImplementedError

    # --- generic helpers ---
    def gather_rows(self, params: Params, s, o, p) -> Rows:
        idx = {"s": s, "o": o, "p": p}
        return {
            slot: params[pname][idx[role]]
            for slot, pname, role in self.slot_spec()
        }

    def dense_params(self, params: Params) -> Params:
        return {k: params[k] for k in self.dense_param_names}

    def num_rows(self, pname: str) -> int:
        """Table length for a row-indexed parameter (via its slot role)."""
        for _, name, role in self.slot_spec():
            if name == pname:
                return self.n_entities if role in ("s", "o") else self.n_relations
        raise KeyError(pname)

    def score(self, params: Params, s, o, p) -> torch.Tensor:
        """Batched triple scores; (s, o, p) are (B,) int64 tensors."""
        return self.score_from_rows(
            self.gather_rows(params, s, o, p), self.dense_params(params)
        )
