"""RotatE — relations as rotations in the complex plane (Sun et al., ICLR
2019).

    score(s, o, p) = -|| E[s] * r_p - E[o] ||^2,   r_p = exp(i * theta_p)

Entity rows are real (n_e, 2d) complex-layout tables, real half first,
so gathers, scatters and the optimizer are those of every other model;
relations hold the (n_r, d) phases theta, so |r_p| = 1 by construction
and `rparam` regularizes entity rows only. Rotation is an isometry, so
both corruption directions are a squared distance between a rotated
(B, 2d) query and the candidates (mode 1 rotates e_s by +theta, mode 0
e_o by -theta), and ||q - e||^2 = |q|^2 - 2 q.e + |e|^2 makes each sweep
one matmul.

`distance="modulus"` scores the published distance instead (a port-only
option; the JAX package has the squared one alone):

    score(s, o, p) = -sum_i |(E[s] * r_p - E[o])_i|,

the sum over the ncomp complex dimensions of each difference's modulus
sqrt(re^2 + im^2). Its gradient at an exactly zero modulus is 0, as
`torch.linalg.vector_norm` gives it (the RotatE authors' code takes the
modulus through `.norm(dim=0)`). The sum is no matmul: the pool and
all-entity sweeps go through `ops/cuda_rotate.modulus_sweep`, K6
(csrc/rotate_pool.cu) on the card, the plain chunked sweep on the CPU;
`score_pool_modes` stacks the modes' rotated queries into one call. The
modulus sweep runs in the parameters' dtype (`compute_dtype` sets the
squared distance's matmul alone), which on the card must be fp32: K6
raises on any other.

Phases start U(-pi, pi) (`phase_init="uniform"`, the paper's
distribution) or from the model's `init` (`"nunif"`); `gamma_init` > 0
selects the paper's coupled init, entities U(-b, b) with
b = (gamma_init + 2) / ncomp and phases U(-pi, pi).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from skge_torch.models.base import INITIALIZERS, KGEModel, Params
from skge_torch.ops.cuda_rotate import complex_moduli, modulus_sweep

DISTANCES = ("squared", "modulus")


def _uniform(generator: torch.Generator, shape, dtype, bound: float) -> torch.Tensor:
    """U(-bound, bound) on the generator's device."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
    return u * (2.0 * bound) - bound


@dataclass(frozen=True)
class RotatE(KGEModel):
    """`ncomp` is the complex rank: entity rows are 2*ncomp wide, relation
    rows hold ncomp phases. `distance`: "squared" (the JAX package's) or
    "modulus" (the published sum of moduli)."""

    rparam: float = 0.0
    gamma_init: float = 0.0
    phase_init: str = "uniform"
    distance: str = "squared"

    name = "rotate"
    reg_row_params = ("E",)  # phases are scale-free

    def __post_init__(self):
        if self.distance not in DISTANCES:
            raise ValueError(f"unknown distance {self.distance!r}; want one of {DISTANCES}")

    @property
    def modulus(self) -> bool:
        return self.distance == "modulus"

    def slot_spec(self):
        return (("es", "E", "s"), ("eo", "E", "o"), ("rp", "R", "p"))

    def init_params(self, generator: torch.Generator) -> Params:
        e_shape = (self.n_entities, 2 * self.ncomp)
        r_shape = (self.n_relations, self.ncomp)
        if self.gamma_init > 0.0:
            b = (self.gamma_init + 2.0) / self.ncomp
            return {"E": _uniform(generator, e_shape, self.tdtype, b),
                    "R": _uniform(generator, r_shape, self.tdtype, math.pi)}
        init = INITIALIZERS[self.init]
        if self.phase_init not in ("uniform", "nunif"):
            raise ValueError(f"unknown phase_init {self.phase_init!r}")
        E = init(generator, e_shape, self.tdtype)
        if self.phase_init == "uniform":
            phases = _uniform(generator, r_shape, self.tdtype, math.pi)
        else:
            phases = init(generator, r_shape, self.tdtype)
        return {"E": E, "R": phases}

    @staticmethod
    def _split(x):
        d = x.shape[-1] // 2
        return x[..., :d], x[..., d:]

    @staticmethod
    def _rotate(x, theta, sign=1.0):
        """Complex-layout rows rotated by `sign * theta` per dimension."""
        a, b = RotatE._split(x)
        c, s = torch.cos(theta), sign * torch.sin(theta)
        return torch.cat([a * c - b * s, a * s + b * c], dim=-1)

    def score_from_rows(self, rows, dense):
        d = self._rotate(rows["es"], rows["rp"]) - rows["eo"]
        if self.modulus:
            return -torch.sum(complex_moduli(d), dim=-1)
        return -torch.sum(d * d, dim=-1)

    def _query(self, rows, mode):
        if mode == 1:
            return self._rotate(rows["es"], rows["rp"])
        return self._rotate(rows["eo"], rows["rp"], sign=-1.0)

    def _dist_matmul(self, q, cand):
        qn = torch.sum(q * q, dim=-1, keepdim=True)
        cn = torch.sum(cand * cand, dim=-1)[None, :]
        return -(qn - 2.0 * self.mxu(q, cand.T) + cn)

    def _sweep(self, q, cand):
        if self.modulus:
            return modulus_sweep(q, cand)
        return self._dist_matmul(q, cand)

    def score_pool(self, rows, pool_rows, dense, mode):
        return self._sweep(self._query(rows, mode), pool_rows)

    def score_pool_modes(self, rows, pool_rows, dense, modes):
        """With the modulus distance, the modes' (B, 2d) rotated queries
        stacked into one sweep."""
        if not self.modulus:
            return super().score_pool_modes(rows, pool_rows, dense, modes)
        q = torch.cat([self._query(rows, m) for m in modes])
        return torch.split(modulus_sweep(q, pool_rows), rows["rp"].shape[0])

    def score_all_o(self, params: Params, s, p):
        q = self._rotate(params["E"][s], params["R"][p])
        return self._sweep(q, params["E"])

    def score_all_s(self, params: Params, o, p):
        q = self._rotate(params["E"][o], params["R"][p], sign=-1.0)
        return self._sweep(q, params["E"])
