"""PairRE — paired relation vectors scaling both endpoints (Chao et al.,
ACL 2021).

    score(s, o, p) = -|| e_s * r^H_p  -  e_o * r^T_p ||^2

Each relation holds a head scale and a tail scale, in ONE (n_r, 2d) row
table `R` = [r^H | r^T], so one gather and one gradient scatter serve
both. Entity rows keep the `normless1` unit-ball constraint. With the
fixed side's query a (mode 1: a = e_s * r^H, scale r^T), the square
expands into two matmuls against the candidates:

    ||a - e * s||^2 = |a|^2 - 2 (a * s) . e + (s * s) . (e * e)

the candidate-norm term depending on the relation, so it is itself a
matmul of the squared scale against the squared candidate rows.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from skge_torch.models.base import INITIALIZERS, KGEModel, Params


@dataclass(frozen=True)
class PairRE(KGEModel):
    """`ncomp` is the entity dim; relation rows are [r^H | r^T] = 2*ncomp."""

    name = "pairre"
    post_constraints = {"E": "normless1"}

    def slot_spec(self):
        return (("es", "E", "s"), ("eo", "E", "o"), ("rp", "R", "p"))

    def init_params(self, generator: torch.Generator) -> Params:
        init = INITIALIZERS[self.init]
        return {
            "E": init(generator, (self.n_entities, self.ncomp), self.tdtype),
            "R": init(generator, (self.n_relations, 2 * self.ncomp), self.tdtype),
        }

    @staticmethod
    def _split(r):
        d = r.shape[-1] // 2
        return r[..., :d], r[..., d:]

    def score_from_rows(self, rows, dense):
        rh, rt = self._split(rows["rp"])
        d = rows["es"] * rh - rows["eo"] * rt
        return -torch.sum(d * d, dim=-1)

    def _sweep(self, q, scale, cand):
        """-||q - e * scale||^2 for every candidate row e."""
        qn = torch.sum(q * q, dim=-1, keepdim=True)          # (B, 1)
        cross = self.mxu(q * scale, cand.T)                   # (B, N)
        en = self.mxu(scale * scale, (cand * cand).T)         # (B, N)
        return -(qn - 2.0 * cross + en)

    def _query(self, rows, mode):
        rh, rt = self._split(rows["rp"])
        if mode == 1:
            return rows["es"] * rh, rt
        return rows["eo"] * rt, rh

    def score_pool(self, rows, pool_rows, dense, mode):
        return self._sweep(*self._query(rows, mode), pool_rows)

    def score_all_o(self, params: Params, s, p):
        rows = {"es": params["E"][s], "rp": params["R"][p]}
        return self._sweep(*self._query(rows, 1), params["E"])

    def score_all_s(self, params: Params, o, p):
        rows = {"eo": params["E"][o], "rp": params["R"][p]}
        return self._sweep(*self._query(rows, 0), params["E"])
