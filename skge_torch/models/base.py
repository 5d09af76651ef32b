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
- `n3_grad_rows`: the row gradient of the nuclear 3-norm (`n3`), for the
  factorization models.

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


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return ACTIVATIONS[name][0]


def acc_dtype(x: torch.Tensor) -> torch.dtype:
    """Matmul accumulation dtype: at least float32, never below the input's."""
    return torch.promote_types(x.dtype, torch.float32)


def mxu_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul with >= fp32 accumulation (TF32 must be off on the card for
    this to hold)."""
    acc = acc_dtype(a)
    return torch.matmul(a.to(acc), b.to(acc))


def _acc_matmul(a: torch.Tensor, b: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """a @ b of two low-precision tensors, accumulated and returned in
    `acc`. On the card a bf16 x bf16 -> fp32 product is one tensor-core GEMM
    (`torch.mm(..., out_dtype=)`; `torch.matmul` of two bf16 tensors would
    round its result to bf16). Elsewhere the inputs are widened first: the
    products of bf16 values are exact in fp32, so both give the exact
    products summed in `acc`, in another order."""
    if a.is_cuda and acc == torch.float32:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=acc)
        return out.reshape(a.shape[:-1] + b.shape[-1:])
    return torch.matmul(a.to(acc), b.to(acc))


class _LowPrecisionMatmul(torch.autograd.Function):
    """`KGEModel.mxu` with a `compute_dtype`: both inputs rounded to it, the
    product accumulated in `acc_dtype(a)` and returned as `a.dtype`.

    The backward rounds where JAX's transpose of the same program does
    (`jnp.dot(a.astype(cd), b.astype(cd), preferred_element_type=acc)`):
    each input's cotangent is the unrounded output cotangent times the
    other ROUNDED input, summed in `acc`, then rounded to `compute_dtype`
    (the transpose of `astype`) and widened to the input's dtype."""

    @staticmethod
    def forward(ctx, a, b, cd):
        acc = acc_dtype(a)
        ac, bc = a.to(cd), b.to(cd)
        ctx.save_for_backward(ac, bc)
        ctx.dtypes = (a.dtype, b.dtype, cd, acc)
        return _acc_matmul(ac, bc, acc).to(a.dtype)

    @staticmethod
    def backward(ctx, g):
        ac, bc = ctx.saved_tensors
        a_dtype, b_dtype, cd, acc = ctx.dtypes
        g = g.to(acc)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g, bc.to(acc).T).to(cd).to(a_dtype)
        if ctx.needs_input_grad[1]:
            a2 = ac.reshape(-1, ac.shape[-1]).to(acc)
            gb = (a2.T @ g.reshape(-1, g.shape[-1])).to(cd).to(b_dtype)
        return ga, gb, None


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
    """Base class: frozen hyperparams + pure scoring functions.

    `compute_dtype` (default: `dtype`) sets the input precision of the
    batched scoring matmuls (`mxu`: the pool and all-entity sweeps):
    parameters, the gradients outside those products and the optimizer
    stay in `dtype`, and the products accumulate in >= fp32. 'bfloat16'
    runs them on the card's bf16 tensor cores for about 3 decimal digits
    of score precision; the parity tests use the exact default.
    """

    n_entities: int
    n_relations: int
    ncomp: int
    dtype: str = "float32"
    init: str = "nunif"
    compute_dtype: str = ""

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

    @property
    def regularization_n3(self) -> float:
        """Nuclear-3-norm coefficient (`n3`, Lacroix et al. 2018); 0 when
        absent. Applied where `rparam` is, through `n3_grad_rows`."""
        return float(getattr(self, "n3", 0.0))

    def n3_grad_rows(self, pname: str, rows: torch.Tensor) -> torch.Tensor:
        """d(sum_j w(x)_j^3)/dx divided by 3, per row. The default factor
        weight is |x| per entry, so the gradient is x * |x|; ComplEx and
        QuatE weigh each dimension by its complex or quaternion modulus."""
        return rows * torch.abs(rows)

    def reg_grad_rows(self, pname: str, rows: torch.Tensor) -> torch.Tensor:
        """Row-L2 (`rparam`) gradient contribution for `pname` rows:
        identity by default."""
        return rows

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def mxu(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Scoring matmul in `compute_dtype` with >= fp32 accumulation, cast
        back to the parameter dtype (`_LowPrecisionMatmul`); `mxu_dot` when
        `compute_dtype` is empty or `dtype`."""
        if not self.compute_dtype or self.compute_dtype == self.dtype:
            return mxu_dot(a, b)
        return _LowPrecisionMatmul.apply(a, b, getattr(torch, self.compute_dtype))

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

    def score_triples(self, params: Params, triples: torch.Tensor) -> torch.Tensor:
        """triples: (B, 3) int64 tensor in (s, o, p) column order."""
        return self.score(params, triples[:, 0], triples[:, 1], triples[:, 2])


def entity_param(model: KGEModel) -> str:
    """The name of the table that holds subjects and objects alike (the
    entity table that the sharded and serving paths split or quantize)."""
    by_role = {role: pname for _, pname, role in model.slot_spec()}
    if by_role["s"] != by_role["o"]:
        raise ValueError("subjects and objects must share one entity table")
    return by_role["s"]
