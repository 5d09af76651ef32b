"""ComplEx — complex-valued bilinear factorization (Trouillon et al. 2016).

score = Re(<R[p], E[s], conj(E[o])>) over C^d. Complex rows are stored as
real (n, 2d) tables, real part first, imaginary part second, so the
gathers, the gradient scatters and the optimizer are those of every other
model. With es = (a, b), rp = (c, d), eo = (e, f):

    score = sum[ (ca - db) e + (cb + da) f ]
          = q(mode=1) . eo,   q = (ca - db, cb + da)
          = q(mode=0) . es,   q = (ce + df, cf - de)

so the pool and all-entity sweeps are one (B, 2d) query and one matmul.
The N3 weight of a dimension is its complex modulus.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from skge_torch.models.base import INITIALIZERS, KGEModel, Params


@dataclass(frozen=True)
class ComplEx(KGEModel):
    """`ncomp` is the complex rank; rows are 2 * ncomp reals wide."""

    rparam: float = 0.0
    n3: float = 0.0

    name = "complex"
    reg_row_params = ("E", "R")

    def slot_spec(self):
        return (("es", "E", "s"), ("eo", "E", "o"), ("rp", "R", "p"))

    def n3_grad_rows(self, pname, rows):
        """Canonical ComplEx N3 (Lacroix et al. 2018): with the modulus
        m_j = sqrt(a_j^2 + b_j^2), d(sum m^3)/d(a, b) / 3 = m * (a, b)."""
        a, b = self._split(rows)
        m = torch.sqrt(a * a + b * b)
        return torch.cat([m * a, m * b], dim=-1)

    def init_params(self, generator: torch.Generator) -> Params:
        init = INITIALIZERS[self.init]
        return {
            "E": init(generator, (self.n_entities, 2 * self.ncomp), self.tdtype),
            "R": init(generator, (self.n_relations, 2 * self.ncomp), self.tdtype),
        }

    @staticmethod
    def _split(x):
        d = x.shape[-1] // 2
        return x[..., :d], x[..., d:]

    def _query_o(self, es, rp):
        """q with score(s, e, p) = q . e for every entity row e."""
        a, b = self._split(es)
        c, d = self._split(rp)
        return torch.cat([c * a - d * b, c * b + d * a], dim=-1)

    def _query_s(self, eo, rp):
        """q with score(e, o, p) = q . e for every entity row e."""
        e, f = self._split(eo)
        c, d = self._split(rp)
        return torch.cat([c * e + d * f, c * f - d * e], dim=-1)

    def score_from_rows(self, rows, dense):
        q = self._query_o(rows["es"], rows["rp"])
        return torch.sum(q * rows["eo"], dim=-1)

    def score_pool(self, rows, pool_rows, dense, mode):
        q = (self._query_o(rows["es"], rows["rp"]) if mode == 1
             else self._query_s(rows["eo"], rows["rp"]))
        return self.mxu(q, pool_rows.T)

    def score_all_o(self, params: Params, s, p):
        q = self._query_o(params["E"][s], params["R"][p])
        return self.mxu(q, params["E"].T)

    def score_all_s(self, params: Params, o, p):
        q = self._query_s(params["E"][o], params["R"][p])
        return self.mxu(q, params["E"].T)
