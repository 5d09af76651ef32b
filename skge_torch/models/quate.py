"""QuatE — quaternion embeddings with relational rotation (Zhang et al.,
NeurIPS 2019).

    score(s, o, p) = < q_s (x) r^_p , q_o >     r^ = r / |r| per component

(x) is the Hamilton product. Quaternion rows are one real (n, 4d) table
with component blocks [a | b | c | d]; the relation is normalized inside
scoring, with the norm held at 1e-12 or above by `torch.maximum`, whose
gradient at a tie is split as `jnp.maximum`'s is. Both sweeps are one
(B, 4d) query and one matmul, through the adjoint
< p (x) q, s > = < p, s (x) conj(q) >: mode 1 queries q_s (x) r^, mode 0
q_o (x) conj(r^). The N3 weight of a dimension is its quaternion modulus.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from skge_torch.models.base import INITIALIZERS, KGEModel, Params

_EPS = 1e-12


@dataclass(frozen=True)
class QuatE(KGEModel):
    """`ncomp` is the quaternion rank; rows are 4 * ncomp reals wide."""

    rparam: float = 0.0
    n3: float = 0.0

    name = "quate"
    reg_row_params = ("E", "R")

    def slot_spec(self):
        return (("es", "E", "s"), ("eo", "E", "o"), ("rp", "R", "p"))

    def n3_grad_rows(self, pname, rows):
        """Quaternion N3: with the modulus m_j = |(a_j, b_j, c_j, d_j)|,
        d(sum m^3)/d(a, b, c, d) / 3 = m * (a, b, c, d)."""
        a, b, c, d = self._split(rows)
        m = torch.sqrt(a * a + b * b + c * c + d * d)
        return torch.cat([m * a, m * b, m * c, m * d], dim=-1)

    def init_params(self, generator: torch.Generator) -> Params:
        init = INITIALIZERS[self.init]
        return {
            "E": init(generator, (self.n_entities, 4 * self.ncomp), self.tdtype),
            "R": init(generator, (self.n_relations, 4 * self.ncomp), self.tdtype),
        }

    @staticmethod
    def _split(x):
        d = x.shape[-1] // 4
        return x[..., :d], x[..., d:2 * d], x[..., 2 * d:3 * d], x[..., 3 * d:]

    @classmethod
    def _hamilton(cls, x, y):
        """Componentwise Hamilton product of quaternion-block rows."""
        a1, b1, c1, d1 = cls._split(x)
        a2, b2, c2, d2 = cls._split(y)
        return torch.cat([
            a1 * a2 - b1 * b2 - c1 * c2 - d1 * d2,
            a1 * b2 + b1 * a2 + c1 * d2 - d1 * c2,
            a1 * c2 - b1 * d2 + c1 * a2 + d1 * b2,
            a1 * d2 + b1 * c2 - c1 * b2 + d1 * a2,
        ], dim=-1)

    @classmethod
    def _conj(cls, x):
        a, b, c, d = cls._split(x)
        return torch.cat([a, -b, -c, -d], dim=-1)

    @classmethod
    def _unit(cls, r):
        a, b, c, d = cls._split(r)
        n = torch.sqrt(a * a + b * b + c * c + d * d)
        n = torch.maximum(n, n.new_full((), _EPS))  # on the card: no host copy
        return torch.cat([a / n, b / n, c / n, d / n], dim=-1)

    def score_from_rows(self, rows, dense):
        rot = self._hamilton(rows["es"], self._unit(rows["rp"]))
        return torch.sum(rot * rows["eo"], dim=-1)

    def _query(self, rows, mode):
        rhat = self._unit(rows["rp"])
        if mode == 1:
            return self._hamilton(rows["es"], rhat)
        return self._hamilton(rows["eo"], self._conj(rhat))

    def score_pool(self, rows, pool_rows, dense, mode):
        return self.mxu(self._query(rows, mode), pool_rows.T)

    def score_all_o(self, params: Params, s, p):
        rows = {"es": params["E"][s], "rp": params["R"][p]}
        return self.mxu(self._query(rows, 1), params["E"].T)

    def score_all_s(self, params: Params, o, p):
        rows = {"eo": params["E"][o], "rp": params["R"][p]}
        return self.mxu(self._query(rows, 0), params["E"].T)
